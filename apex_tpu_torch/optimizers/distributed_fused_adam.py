"""DistributedFusedAdam and DistributedFusedLAMB — ZeRO-2 sharding of the
optimizer state and the gradients over the data-parallel group
(counterpart of apex_tpu/optimizers/distributed_fused_adam.py, itself ≡
apex.contrib.optimizers.DistributedFusedAdam / DistributedFusedLAMB).

The layout is the JAX package's, so that a gathered state dict moves
between the two packages: the params flatten into one buffer (with
`n_buckets` > 1, one per contiguous run of leaves of about equal size,
`_bucket_ranges`), each padded to `num_shards * FLAT_TILE`; rank r keeps
the r-th of `num_shards` equal chunks of every bucket, concatenated
bucket by bucket, in `master_dtype` (p, m and v).

A step, per bucket: the grads (flattened in `grad_sync_dtype`) are
reduce-scattered over the group and divided by `num_shards` (the dp
mean), the rank's chunk goes through the Adam kernel IN PLACE
(`adam_flat`, or `adam_flat_seg` at the shard's row offset when
`wd_mask` / `lr_scales` give per-tensor values), and the updated chunk
is all-gathered in `param_sync_dtype` into the full params.  Every
bucket's reduce-scatter is issued before the first bucket's update
(`async_op`), so the collectives of later buckets run under the
updates of earlier ones; overlapping them with the backward itself is
not done here.  `gather_params=False` skips the gather: the train step
gathers at the start of the next step (`full_params`).

DistributedFusedLAMB keeps one bucket (a lane-aligned layout): the
reduce-scatter, one all-reduce of the grads' sum of squares (the global
norm and its clip ratio), phase 1 on the shard at its row offset, the
per-tensor partial sums of squares of p and u over the shard
(`per_tensor_sumsq_shard`), summed by one small all-reduce into the
trust ratios, phase 2 at the shard's offset, and the gather.

The group is the one `axis_name` names (`parallel.mesh.group_of`): the
dp group of `parallel.mesh.initialize_model_parallel` (`"dp"`, the
default), or for an expert-parallel model the combined group of
`axis_name=("dp", "ep")` with `num_shards = dp·ep` and `ep_shards = ep`
(the JAX package's MoE wiring; `shard_layout()` then records
`ep_shards`); without a mesh, the torch.distributed world, else none (a
world of one, where the collectives are copies).  `init` checks that
`num_shards` is the group's size: a world of one is stated, not assumed.
Every scalar of a step (the overflow flag, the norms, the ratios) stays
on the device: a step makes no host sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops import optimizer_kernels as K
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import mesh as M


def _bucket_ranges(sizes, n_buckets):
    """Contiguous leaf ranges with about equal element counts (≡ the JAX
    package's `_bucket_ranges`)."""
    n_buckets = max(1, min(n_buckets, len(sizes)))
    total = sum(sizes)
    ranges, start, acc = [], 0, 0
    for i, s in enumerate(sizes):
        acc += s
        if (len(ranges) < n_buckets - 1
                and acc * n_buckets >= total * (len(ranges) + 1)):
            ranges.append((start, i + 1))
            start = i + 1
    ranges.append((start, len(sizes)))
    return [r for r in ranges if r[0] < r[1]]


def _leaves(tree):
    """A grad tree (nested dicts) or a list of leaves, as a list."""
    return list(tree) if isinstance(tree, (list, tuple)) else \
        F.tree_leaves(tree)


class DistributedFusedAdamState(NamedTuple):
    step: torch.Tensor           # int32 scalar
    params_shard: torch.Tensor   # this rank's master chunk, bucket-major
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor


class DistributedFusedLAMBState(NamedTuple):
    step: torch.Tensor
    params_shard: torch.Tensor
    exp_avg: torch.Tensor
    exp_avg_sq: torch.Tensor


class _ShardedFlat(F.FlatCheckpointMixin):
    """The flat shard layout both ZeRO optimizers share: one definition
    of the buckets, their (dtype, align, pad_to) flattening, the rank's
    chunks and the gathers."""

    _ALIGN = 1

    def _setup(self, num_shards, axis_name, ep_shards, master_dtype,
               grad_sync_dtype, param_sync_dtype):
        names = ((axis_name,) if isinstance(axis_name, str)
                 else tuple(axis_name))
        if names not in ((M.DP_AXIS,), (M.DP_AXIS, M.EP_AXIS)):
            raise ValueError(
                f"axis_name={axis_name!r}: the sharded state lives on the "
                f"{M.DP_AXIS!r} axis or the combined "
                f"{(M.DP_AXIS, M.EP_AXIS)!r} axes")
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        # the JAX package's check and message (`_set_ep_shards`)
        if ep_shards < 1 or num_shards % ep_shards:
            raise ValueError(
                f"ep_shards={ep_shards} must be >= 1 and divide "
                f"num_shards={num_shards} (num_shards = dp * ep)")
        self.axis_name = axis_name
        self.ep_shards = ep_shards
        self.num_shards = num_shards
        self.master_dtype = master_dtype
        self.grad_sync_dtype = grad_sync_dtype
        self.param_sync_dtype = param_sync_dtype
        self.spec: Optional[F.FlatSpec] = None
        self.device: Optional[torch.device] = None
        self.padded_total = None

    # -- the group ----------------------------------------------------------
    def _group(self):
        return M.group_of(self.axis_name)

    def _rank(self) -> int:
        group = self._group()
        world = M.group_size(group)
        if world != self.num_shards:
            raise ValueError(
                f"{type(self).__name__}(num_shards={self.num_shards}) over "
                f"a data-parallel group of {world} rank(s): num_shards must "
                "be the group's size")
        return M.group_rank(group)

    # -- the layout ---------------------------------------------------------
    def _init_layout(self, params, n_buckets):
        leaves = F.tree_leaves(params)
        self.spec = F.make_spec(params, align=self._ALIGN)
        sizes = [int(leaf.numel()) for leaf in leaves]
        self._ranges = _bucket_ranges(sizes, n_buckets)
        # a bucket's spec: its leaves keyed by their index in the bucket
        self.bucket_specs = [
            F.make_spec(dict(enumerate(leaves[a:b])), align=self._ALIGN)
            for a, b in self._ranges]
        flats = self._bucket_flats(leaves, self.master_dtype)
        self._bucket_padded = [int(f.numel()) for f in flats]
        self.padded_total = sum(self._bucket_padded)
        self._rank_ = self._rank()
        self.device = flats[0].device if flats else torch.device("cpu")
        return flats

    def _bucket_flats(self, leaves, dtype):
        """Each bucket's leaves flattened in `dtype`, padded to
        num_shards * FLAT_TILE (the JAX package's `_bucket_flats`)."""
        return [F.flatten(leaves[a:b], dtype, align=self._ALIGN,
                          pad_to=self.num_shards * K.FLAT_TILE)
                for a, b in self._ranges]

    def _chunks(self):
        """(offset in the shard, chunk size, bucket size) per bucket."""
        out, off = [], 0
        for padded in self._bucket_padded:
            sz = padded // self.num_shards
            out.append((off, sz, padded))
            off += sz
        return out

    def _shard_of(self, flats):
        """This rank's chunk of every bucket, concatenated."""
        r = self._rank_
        return torch.cat([f[r * sz:(r + 1) * sz]
                          for f, (_, sz, _) in zip(flats, self._chunks())])

    def flatten_grads(self, grads):
        """A grad tree (or list of leaves in spec order) as the list of
        bucket buffers the step takes, in `grad_sync_dtype`."""
        return self._bucket_flats(_leaves(grads), self.grad_sync_dtype)

    def _param_sync_dt(self):
        if self.param_sync_dtype is not None:
            return self.param_sync_dtype
        dts = set(self.spec.dtypes)
        return dts.pop() if len(dts) == 1 else self.master_dtype

    def _start_gather(self, piece, padded, dtype, group):
        full = torch.empty(padded, dtype=dtype, device=piece.device)
        work = M.all_gather(full, piece.to(dtype), group, async_op=True)
        return full, work

    def _gather_leaves(self, shard, dtype=None, cast=True):
        """Every bucket's chunk all-gathered into the whole buffer and
        read out as the spec's leaves (views of the gathered buffers, in
        the leaves' own dtypes unless `cast` is False)."""
        group = self._group()
        dtype = dtype or shard.dtype
        pending = [self._start_gather(shard[off:off + sz], padded, dtype,
                                      group)
                   for off, sz, padded in self._chunks()]
        leaves = []
        for (full, work), spec_i in zip(pending, self.bucket_specs):
            if work is not None:
                work.wait()
            leaves += F.unflatten_leaves(full, spec_i,
                                         cast_to_leaf_dtype=cast)
        return leaves

    def full_leaves(self, state):
        """The full params as the spec's leaves, gathered in
        `param_sync_dtype` (the fwd-side half of ZeRO-2)."""
        return self._gather_leaves(state.params_shard, self._param_sync_dt())

    def full_params(self, state):
        """The full params tree, all-gathered from the ranks' chunks."""
        return F.tree_from_leaves(self.spec, self.full_leaves(state))

    def shard_layout(self) -> dict:
        """The shard layout (≡ the JAX package's `shard_layout`): enough to
        reassemble the whole flat buffer from per-rank shards at any
        (num_shards, n_buckets); `ep_shards` when the state is sharded
        over (dp, ep)."""
        if self.spec is None:
            raise RuntimeError(
                f"{type(self).__name__}.shard_layout() before init(); "
                "call init(params) first so the flat layout is fixed")
        d = {"align": int(self.spec.align),
             "total": int(self.spec.total),
             "n_tensors": len(self.spec.sizes),
             "num_shards": int(self.num_shards),
             "n_buckets": len(self._ranges),
             "bucket_totals": [int(s.total) for s in self.bucket_specs],
             "bucket_padded": [int(p) for p in self._bucket_padded],
             "master_dtype": str(self.master_dtype).replace("torch.", "")}
        if self.ep_shards > 1:
            # the expert sharding named, as the JAX package records it
            # (dense layouts omit the key)
            d["ep_shards"] = int(self.ep_shards)
        return d

    # -- gathered (layout-independent) checkpoints ---------------------------
    def gather_state_dict(self, state) -> dict:
        """The state in model-tree form, every buffer all-gathered (≡ the
        JAX package's `gather_state_dict`): written at one (num_shards,
        n_buckets), it restores at any other, in either package."""
        def tree_of(shard):
            return F.tree_from_leaves(
                self.spec, self._gather_leaves(shard, cast=False))

        return {"step": state.step,
                "params": tree_of(state.params_shard),
                "exp_avg": tree_of(state.exp_avg),
                "exp_avg_sq": tree_of(state.exp_avg_sq)}

    def load_gathered_state_dict(self, d: dict):
        """Inverse of `gather_state_dict` under this optimizer's layout;
        leaves may be tensors or numpy arrays."""
        if "params" not in d or "params_shard" in d:
            raise ValueError(
                "not a gathered checkpoint — use load_state_dict for "
                "layout-exact shard checkpoints")
        if self.spec is None:
            raise RuntimeError("call init(params) before "
                               "load_gathered_state_dict()")

        def shard_of(tree):
            leaves = [F._as_tensor(x, self.device) for x in F.tree_leaves(
                tree)]
            return self._shard_of(self._bucket_flats(leaves,
                                                     self.master_dtype))

        step = F._as_tensor(d["step"], self.device).to(torch.int32)
        return self._STATE(step=step.reshape(()),
                           params_shard=shard_of(d["params"]),
                           exp_avg=shard_of(d["exp_avg"]),
                           exp_avg_sq=shard_of(d["exp_avg_sq"]))

    def step(self, state, grads, lr=None, inv_scale=1.0, found_inf=False,
             gather_params=True):
        """One step from the rank's grad tree (or list of leaves).
        Returns (full params tree, new state), or (None, new state) with
        gather_params=False."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step()")
        return self.step_flat(state, self.flatten_grads(grads), lr=lr,
                              inv_scale=inv_scale, found_inf=found_inf,
                              gather_params=gather_params)

    def _new_state(self, flats):
        shard = self._shard_of(flats)
        return self._STATE(
            step=torch.zeros((), dtype=torch.int32, device=shard.device),
            params_shard=shard, exp_avg=torch.zeros_like(shard),
            exp_avg_sq=torch.zeros_like(shard))

    def _per_leaf(self, params, dev):
        seg_wd, seg_lrs = F.resolve_per_leaf(
            self.wd_mask, self.lr_scales, self.weight_decay, params,
            type(self).__name__)
        self._seg_wd = torch.from_numpy(seg_wd).to(dev)
        self._seg_lrs = torch.from_numpy(seg_lrs).to(dev)


class DistributedFusedAdam(_ShardedFlat):
    """ZeRO-2 Adam.  opt = DistributedFusedAdam(num_shards=world, ...);
    state = opt.init(params) on every rank; params, state =
    opt.step(state, grads[, lr=, inv_scale=, found_inf=]), where `grads`
    are the rank's own (unsynced) grads: the reduce-scatter averages
    them over the group.  `master_dtype=torch.bfloat16` keeps bf16
    p, m, v chunks (the kernel's math stays fp32)."""

    _STATE = DistributedFusedAdamState

    def __init__(self, num_shards: int, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, adam_w_mode=True,
                 weight_decay=0.0, axis_name=M.DP_AXIS,
                 grad_sync_dtype=torch.float32, param_sync_dtype=None,
                 n_buckets: int = 1, master_dtype=torch.float32,
                 wd_mask=None, lr_scales=None, ep_shards: int = 1):
        self._setup(num_shards, axis_name, ep_shards, master_dtype,
                    grad_sync_dtype, param_sync_dtype)
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.n_buckets = n_buckets
        self.wd_mask = wd_mask
        self.lr_scales = lr_scales
        self._seg_wd = self._seg_lrs = None
        if wd_mask is not None or lr_scales is not None:
            # per-leaf hyperparameters need lane-aligned leaf segments
            self._ALIGN = K._LANES

    def init(self, params) -> DistributedFusedAdamState:
        """This rank's state for `params` (the same tree on every rank), on
        the params' device.  With per-leaf values the per-tensor tables of
        this rank's rows are built here, once."""
        flats = self._init_layout(params, self.n_buckets)
        if self._ALIGN == K._LANES:
            self._per_leaf(params, self.device)
            for (_, sz, padded), spec_i in zip(self._chunks(),
                                               self.bucket_specs):
                rows = sz // K._LANES
                K.shard_tables(spec_i, padded // K._LANES,
                               self._rank_ * rows, rows, self.device)
        return self._new_state(flats)

    def state_dict(self, state) -> dict:
        d = super().state_dict(state)
        d["flat_layout"]["n_buckets"] = self.n_buckets
        return d

    def load_state_dict(self, d: dict):
        lay = d.get("flat_layout") or {}
        if int(lay.get("n_buckets", 1)) != self.n_buckets:
            raise ValueError(
                f"DistributedFusedAdam: checkpoint n_buckets "
                f"{lay.get('n_buckets', 1)} != configured "
                f"{self.n_buckets} — the bucket-major shard layouts differ")
        return super().load_state_dict(d)

    def step_flat(self, state, g_buckets, lr=None, inv_scale=1.0,
                  found_inf=False, gather_params=True):
        """One step from the bucket buffers of `flatten_grads`."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        group = self._group()
        rank = self._rank_
        dev = state.params_shard.device
        found = K.device_scalar(found_inf, torch.bool, dev)
        step_next = state.step + (~found).to(torch.int32)
        common = dict(lr=self.lr if lr is None else lr, step=step_next,
                      beta1=self.beta1, beta2=self.beta2, eps=self.eps,
                      adam_w_mode=self.adam_w_mode,
                      bias_correction=self.bias_correction,
                      inv_scale=inv_scale, found_inf=found)
        chunks = self._chunks()
        # every bucket's reduce-scatter first: later buckets' collectives
        # run under earlier buckets' updates
        pending = []
        for gb, (_, sz, padded) in zip(g_buckets, chunks):
            if gb.numel() != padded:
                raise ValueError(f"a grad bucket of {gb.numel()} elements "
                                 f"for a layout of {padded}")
            g_b = torch.empty(sz, dtype=gb.dtype, device=dev)
            pending.append((g_b, M.reduce_scatter(g_b, gb, group,
                                                  async_op=True)))
        sync_dt = self._param_sync_dt()
        gathers = []
        for (a, b), spec_i, (off, sz, padded), (g_b, work) in zip(
                self._ranges, self.bucket_specs, chunks, pending):
            if work is not None:
                work.wait()
            if self.num_shards > 1:
                g_b.div_(self.num_shards)          # the dp mean
            p = state.params_shard[off:off + sz]
            m = state.exp_avg[off:off + sz]
            v = state.exp_avg_sq[off:off + sz]
            if self._seg_wd is not None:
                K.adam_flat_seg(p, m, v, g_b, wd_values=self._seg_wd[a:b],
                                lr_scale_values=self._seg_lrs[a:b],
                                spec=spec_i,
                                row_offset=rank * (sz // K._LANES),
                                padded_total=padded, **common)
            else:
                K.adam_flat(p, m, v, g_b, weight_decay=self.weight_decay,
                            **common)
            if gather_params:
                gathers.append(self._start_gather(p, padded, sync_dt, group))
        new_state = DistributedFusedAdamState(
            step=step_next, params_shard=state.params_shard,
            exp_avg=state.exp_avg, exp_avg_sq=state.exp_avg_sq)
        if not gather_params:
            return None, new_state
        leaves = []
        for (full, work), spec_i in zip(gathers, self.bucket_specs):
            if work is not None:
                work.wait()
            leaves += F.unflatten_leaves(full, spec_i)
        return F.tree_from_leaves(self.spec, leaves), new_state


class DistributedFusedLAMB(_ShardedFlat):
    """ZeRO-sharded LAMB (≡ the JAX package's DistributedFusedLAMB):
    one lane-aligned bucket, the global grad norm and the per-tensor
    norms summed over the group by small all-reduces."""

    _STATE = DistributedFusedLAMBState
    _ALIGN = K._LANES

    def __init__(self, num_shards: int, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 max_grad_norm=1.0, axis_name=M.DP_AXIS,
                 grad_sync_dtype=torch.float32, param_sync_dtype=None,
                 master_dtype=torch.float32, wd_mask=None, lr_scales=None,
                 ep_shards: int = 1):
        self._setup(num_shards, axis_name, ep_shards, master_dtype,
                    grad_sync_dtype, param_sync_dtype)
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.wd_mask = wd_mask
        self.lr_scales = lr_scales
        self._seg_wd = self._seg_lrs = None

    def init(self, params) -> DistributedFusedLAMBState:
        """This rank's state for `params`; the per-tensor tables of this
        rank's rows are built here, once."""
        flats = self._init_layout(params, 1)
        if self.wd_mask is not None or self.lr_scales is not None:
            self._per_leaf(params, self.device)
        rows = self.padded_total // self.num_shards // K._LANES
        K.shard_tables(self.spec, self.padded_total // K._LANES,
                       self._rank_ * rows, rows, self.device)
        return self._new_state(flats)

    def step_flat(self, state, g_buckets, lr=None, inv_scale=1.0,
                  found_inf=False, gather_params=True):
        """One step from the (one) bucket buffer of `flatten_grads`."""
        if self.spec is None:
            raise RuntimeError("call init(params) before step_flat()")
        (g_flat,) = g_buckets
        if g_flat.numel() != self.padded_total:
            raise ValueError(f"a grad buffer of {g_flat.numel()} elements "
                             f"for a layout of {self.padded_total}")
        group = self._group()
        rank = self._rank_
        spec = self.spec
        dev = state.params_shard.device
        size = self.padded_total // self.num_shards
        g = torch.empty(size, dtype=g_flat.dtype, device=dev)
        M.reduce_scatter(g, g_flat, group)
        if self.num_shards > 1:
            g.div_(self.num_shards)                # the dp mean
        found = K.device_scalar(found_inf, torch.bool, dev)
        step_next = state.step + (~found).to(torch.int32)
        lr_val = self.lr if lr is None else lr

        # the global grad norm: one all-reduce of the shards' sums of
        # squares; the norm is homogeneous, so unscaling multiplies it
        sq = torch.square(K.l2norm_flat(g)).reshape(1)
        gnorm = torch.sqrt(M.all_reduce(sq, "sum", group)[0]) * \
            K.device_scalar(inv_scale, torch.float32, dev)
        if self.max_grad_norm and self.max_grad_norm > 0:
            clip = torch.where(gnorm > self.max_grad_norm,
                               self.max_grad_norm / gnorm, 1.0)
        else:
            clip = 1.0
        rows = size // K._LANES
        kw = dict(clip_ratio=clip, step=step_next, beta1=self.beta1,
                  beta2=self.beta2, eps=self.eps,
                  bias_correction=self.bias_correction, inv_scale=inv_scale,
                  found_inf=found)
        if self._seg_wd is not None:
            m, v, u = K.lamb_phase1_seg(
                state.exp_avg, state.exp_avg_sq, g, state.params_shard,
                wd_values=self._seg_wd, spec=spec, row_offset=rank * rows,
                padded_total=self.padded_total, **kw)
        else:
            m, v, u = K.lamb_phase1_flat(
                state.exp_avg, state.exp_avg_sq, g, state.params_shard,
                weight_decay=self.weight_decay, **kw)
        del g
        # per-tensor norms: each rank's partial sums over its own rows,
        # one small all-reduce of the 2 x n_tensors partials
        sums = torch.cat([
            K.per_tensor_sumsq_shard(state.params_shard, spec, rank,
                                     self.padded_total),
            K.per_tensor_sumsq_shard(u, spec, rank, self.padded_total)])
        sums = M.all_reduce(sums, "sum", group)
        n_t = len(spec.sizes)
        wn, un = torch.sqrt(sums[:n_t]), torch.sqrt(sums[n_t:])
        ratio = torch.where((wn > 0) & (un > 0),
                            wn / torch.clamp_min(un, 1e-12), 1.0)
        if self._seg_lrs is not None:
            ratio = ratio * self._seg_lrs
        lr_eff = torch.where(found, 0.0,
                             K.device_scalar(lr_val, torch.float32, dev))
        p = K.lamb_phase2_seg(state.params_shard, u, ratio, spec, lr_eff,
                              row_offset=rank * rows,
                              padded_total=self.padded_total)
        new_state = DistributedFusedLAMBState(
            step=step_next, params_shard=p, exp_avg=m, exp_avg_sq=v)
        if not gather_params:
            return None, new_state
        return self.full_params(new_state), new_state

