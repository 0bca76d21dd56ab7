"""Data-parallel gradient synchronization and the train step (counterpart
of apex_tpu/parallel/ddp.py, itself ≡ apex.parallel.DistributedDataParallel
and Reducer, and the hot loop of apex's examples/imagenet/main_amp.py:
DDP forward, amp.scale_loss, backward with the gradient allreduce, the
fused optimizer step).

  * `sync_gradients` — the dp mean of the grads: an all-reduce over the
    data-parallel group, divided by its size (the identity without one)
  * `sync_gradients_bucketed` — the same through flat fp32 buckets (≡
    allreduce_bucket; collective granularity only)
  * `Reducer` / `DistributedDataParallel` — the reference's facades
  * `make_train_step` — the step the JAX package builds, run eagerly

The group is the dp group of
`parallel.mesh.initialize_model_parallel`, else the torch.distributed
world when it is initialized, else none: a world of one, where the sync
is the identity and no `init_process_group` is needed.

The step follows the JAX package's step for step: read the params out
of the optimizer's flat buffer (a ZeRO optimizer all-gathers them from
the ranks' chunks, `full_leaves`); cast them to the param dtype and
then, with the batch's floating leaves, to the compute dtype, outside
the gradient (O2, `Policy.keep_norm_fp32`: norm leaves stay fp32, as
apex's keep_batchnorm_fp32 keeps batch norm in fp32; the optimizer's
flat buffer in its master dtype is O2's master copy); take the scaled
loss of each microbatch (`num_microbatches` splits the local batch on
its leading axis) and differentiate with respect to the compute-dtype
leaves; accumulate (`main_grad_dtype=torch.float32`: into a persistent
fp32 buffer, whatever the grads' dtype) and divide by the number of
microbatches after the accumulation, as the JAX package does; sync the
grads once (a ZeRO optimizer's reduce-scatter is the sync, so the step
makes no all-reduce of the full grads); check them for overflow (for a
ZeRO optimizer each rank's local check, OR-ed over the group by a MAX
all-reduce of a device flag); update the loss scaler; and hand the
grads, `inv_scale` and `found_inf` to the fused optimizer, which applies
the unscale and the overflow skip inside its kernel.  No `.item()` and
no `torch.cuda.synchronize()` inside the step: the loss comes back as a
device tensor (each rank's own, as the JAX step returns a shard's).

The metrics and trace planes come with the monitor port (ROADMAP Queue 1
item 23) and raise until then.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch import amp as amp_lib
from apex_tpu_torch.amp.policy import is_norm_path
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.optimizer_kernels import FLAT_TILE
from apex_tpu_torch.optimizers import flat as F
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.transformer.training import _to_device


def _tensors(grads):
    if isinstance(grads, torch.Tensor):
        return [grads]
    if isinstance(grads, (list, tuple)):
        return list(grads)
    return F.tree_leaves(grads)


def sync_gradients(grads, average: bool = True):
    """All-reduce the grads over the data-parallel group, IN PLACE, and
    divide by its size with `average` (≡ the JAX package's
    `sync_gradients`, DDP's allreduce with gradient_average).  `grads`
    is one tensor (a flat buffer: one collective), a list or a tree of
    tensors.  Returns `grads`."""
    group = M.data_parallel_group()
    world = M.group_size(group)
    for g in _tensors(grads):
        M.all_reduce(g, "sum", group)
        if average and world > 1:
            g.div_(world)
    return grads


def sync_gradients_bucketed(grads, average: bool = True,
                            num_buckets: int = 1):
    """The dp mean through flat fp32 buckets (≡ the JAX package's
    `sync_gradients_bucketed`, apex's allreduce_bucket): flatten, one
    all-reduce per bucket of ceil(n / num_buckets) elements, unflatten
    into a new tree in the leaves' dtypes."""
    spec = F.make_spec(grads)
    flat = F.flatten(grads, torch.float32)
    n = flat.numel()
    per = -(-n // num_buckets)
    for b in range(num_buckets):
        if b * per < n:
            sync_gradients(flat[b * per:min(n, (b + 1) * per)], average)
    return F.unflatten(flat, spec)


class Reducer:
    """≡ apex.parallel.Reducer: `reduce(tree)` averages a tree over the
    group whenever the caller asks."""

    def reduce(self, tree):
        return sync_gradients(tree, average=True)


class DistributedDataParallel:
    """≡ apex.parallel.DistributedDataParallel as the JAX package's
    facade: `.apply` runs the wrapped function, `.sync` averages grads
    over the group (`bucketed` / `num_buckets`: collective
    granularity)."""

    def __init__(self, apply_fn: Callable, gradient_average: bool = True,
                 bucketed: bool = False, num_buckets: int = 1):
        self.apply_fn = apply_fn
        self.gradient_average = gradient_average
        self.bucketed = bucketed
        self.num_buckets = num_buckets

    def apply(self, params, *args, **kwargs):
        return self.apply_fn(params, *args, **kwargs)

    __call__ = apply

    def sync(self, grads):
        if self.bucketed:
            return sync_gradients_bucketed(grads, self.gradient_average,
                                           self.num_buckets)
        return sync_gradients(grads, self.gradient_average)


def _step_leaves(leaves, spec, policy):
    """The leaves the step differentiates: cast to the param dtype, then
    to the compute dtype when it is not fp32.  O2 (`keep_norm_fp32` with
    low-precision params) keeps the norm leaves fp32."""
    keep = policy.param_dtype != torch.float32 and policy.keep_norm_fp32
    out = []
    for path, leaf in zip(spec.paths, leaves):
        if leaf.is_floating_point():
            if keep and is_norm_path(path):
                leaf = leaf.float()
            else:
                leaf = leaf.to(policy.param_dtype)
                if policy.compute_dtype != torch.float32:
                    leaf = leaf.to(policy.compute_dtype)
        out.append(leaf)
    return out


def _split(batch, m):
    """The batch's leaves cut into m microbatches on the leading axis."""
    def cut(x):
        if isinstance(x, torch.Tensor):
            if x.shape[0] % m:
                raise ValueError(f"local batch dim {x.shape[0]} not "
                                 f"divisible by num_microbatches={m}")
            return x.chunk(m)
        if isinstance(x, (tuple, list)):
            parts = [cut(t) for t in x]
            return [type(x)(p[i] for p in parts) for i in range(m)]
        if isinstance(x, dict):
            parts = {k: cut(v) for k, v in x.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(m)]
        return [x] * m
    return cut(batch)


def _stack(trees):
    """Per-microbatch aux trees stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(ts)) for ts in zip(*trees))
    return first


class _MainGrads:
    """The microbatch accumulator: with one accumulation dtype, views of
    one flat buffer laid out as the optimizer's (`spec` offsets, zero
    padding), kept across steps and zeroed at each; with several, one
    tensor per leaf."""

    def __init__(self):
        self.buffers = {}

    def start(self, grads, spec, n, dtype, dev):
        dts = [dtype or g.dtype for g in grads]
        if len(set(dts)) == 1:
            key = (dts[0], n, dev)
            flat = self.buffers.get(key)
            if flat is None:
                flat = self.buffers[key] = torch.zeros(n, dtype=dts[0],
                                                       device=dev)
            else:
                flat.zero_()
            return flat, F.unflatten_leaves(flat, spec,
                                            cast_to_leaf_dtype=False)
        return None, [torch.zeros(g.shape, dtype=d, device=dev)
                      for g, d in zip(grads, dts)]


def make_train_step(loss_fn: Callable, optimizer, *,
                    amp_state: Optional[amp_lib.AmpState] = None,
                    has_aux: bool = False, with_state: bool = False,
                    device=None, num_microbatches: int = 1,
                    main_grad_dtype=None, metrics=None, trace=None):
    """Build the data-parallel train step (≡ the JAX package's
    `make_train_step`).

    `loss_fn(params, batch) -> loss` (or `(loss, aux)` with has_aux;
    with with_state: `loss_fn(params, model_state, batch) -> (loss,
    new_model_state)`, e.g. the batch norms' running statistics) runs
    on this rank's batch.  Returns `step(opt_state, scaler_state[,
    model_state], batch) -> (opt_state, scaler_state[, model_state],
    loss[, aux])`.  The optimizer (FusedSGD, FusedAdam, FusedLAMB, ... or
    a ZeRO optimizer, `DistributedFusedAdam` / `DistributedFusedLAMB`,
    detected by its `full_leaves` and `shard_layout`) updates its flat
    buffers in place.  With num_microbatches > 1 the aux is the stacked
    per-microbatch auxes (has_aux) or the model state threaded through
    the microbatches (with_state).  The step runs on `device`: the card
    unless the caller asks for the CPU (`device="cpu"`, the plain
    versions of the kernels)."""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")
    if metrics not in (None, False) or trace not in (None, False):
        raise NotImplementedError(
            "the metrics and trace planes come with the monitor port, "
            "ROADMAP Queue 1 item 23")
    dev = resolve_device(device)
    policy = amp_state.policy if amp_state is not None else None
    dynamic = amp_state.dynamic if amp_state is not None else False
    sharded = (hasattr(optimizer, "full_leaves")
               and hasattr(optimizer, "shard_layout"))
    group = M.data_parallel_group()
    m = num_microbatches
    main_grads = _MainGrads()

    def local_step(opt_state, scaler_state, model_state, batch):
        spec = optimizer.spec
        if spec is None:
            raise RuntimeError("build the state with optimizer.init before "
                               "stepping")
        buf = opt_state.params_shard if sharded else opt_state.params
        if buf.device != dev:
            raise ValueError(f"optimizer state lives on {buf.device}, the "
                             f"step on {dev}")
        batch = _to_device(batch, dev)
        leaves = (optimizer.full_leaves(opt_state) if sharded
                  else F.unflatten_leaves(opt_state.params, spec))
        if policy is not None:
            leaves = _step_leaves(leaves, spec, policy)
            if policy.compute_dtype != torch.float32:
                # O1/O2: the floating batch runs in the compute dtype;
                # batch norm and the loss return to fp32 inside
                batch = policy.cast_to_compute(batch)
        leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
        params = F.tree_from_leaves(spec, leaves)

        def grads_of(mstate, b):
            if with_state:
                loss, aux = loss_fn(params, mstate, b)
            else:
                out = loss_fn(params, b)
                loss, aux = (out[0], out[1]) if has_aux else (out, None)
            scaled = loss * scaler_state.scale if scaler_state is not None \
                else loss
            # a leaf the loss does not read gets a zero gradient, as
            # under jax.grad
            grads = torch.autograd.grad(scaled, leaves, allow_unused=True,
                                        materialize_grads=True)
            return list(grads), loss.detach(), _detach(aux)

        n_flat = None if sharded else opt_state.params.numel()
        if m == 1:
            grads, loss, aux = grads_of(model_state, batch)
            if main_grad_dtype is not None:
                grads = [g.to(main_grad_dtype) for g in grads]
            g_flat = None
        else:
            mbs = _split(batch, m)
            mstate, auxs = model_state, []
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            g_flat = acc = None
            for i in range(m):
                grads, loss_i, aux_i = grads_of(mstate, mbs[i])
                if acc is None:
                    g_flat, acc = main_grads.start(
                        grads, spec, n_flat or spec.total, main_grad_dtype,
                        dev)
                torch._foreach_add_(acc, grads)
                del grads
                loss_sum = loss_sum + loss_i.float()
                if with_state:
                    mstate = aux_i
                elif has_aux:
                    auxs.append(aux_i)
            # the mean after the accumulation, as the JAX package divides
            # after its scan
            if g_flat is not None:
                g_flat.div_(m)
            else:
                torch._foreach_div_(acc, m)
            grads = acc
            loss = loss_sum / m
            aux = mstate if with_state else (_stack(auxs) if has_aux
                                             else None)
        del leaves, params
        if sharded:
            # the optimizer's reduce-scatter is the sync
            g_sync = optimizer.flatten_grads(grads)
        else:
            if g_flat is None or n_flat != g_flat.numel():
                dtypes = {g.dtype for g in grads}
                gdt = dtypes.pop() if len(dtypes) == 1 else torch.float32
                g_flat = F.flatten(grads, gdt, pad_to=FLAT_TILE,
                                   align=spec.align)
            g_sync = sync_gradients(g_flat)
        del grads
        if scaler_state is not None:
            inv = 1.0 / scaler_state.scale
            found_inf = amp_lib.scaler.check_finite(g_sync)
            if sharded and group is not None:
                # each rank checked its own grads: OR the flags, so that
                # every rank takes the same skip and scale decision
                flag = found_inf.to(torch.int32).reshape(1)
                found_inf = M.all_reduce(flag, "max", group)[0] > 0
            new_scaler = amp_lib.scaler.update(scaler_state, found_inf,
                                               dynamic=dynamic)
        else:
            inv, found_inf, new_scaler = 1.0, False, None
        if sharded:
            _, new_opt_state = optimizer.step_flat(
                opt_state, g_sync, inv_scale=inv, found_inf=found_inf,
                gather_params=False)
        else:
            _, new_opt_state = optimizer.step_flat(
                opt_state, g_sync, inv_scale=inv, found_inf=found_inf)
        outs = (new_opt_state, new_scaler)
        if with_state:
            outs += (aux,)
        outs += (loss,)
        if has_aux and not with_state:
            outs += (aux,)
        return outs

    if with_state:
        def step(opt_state, scaler_state, model_state, batch):
            return local_step(opt_state, scaler_state, model_state, batch)
    else:
        def step(opt_state, scaler_state, batch):
            return local_step(opt_state, scaler_state, None, batch)
    return step


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(t) for t in tree)
    return tree
