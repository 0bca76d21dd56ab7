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

The group is the data-parallel group of
`parallel.mesh.initialize_model_parallel` (the dp group, or the combined
(dp, ep) group of an expert-parallel mesh; `make_train_step(axis_name=)`
names it as the JAX package's step does), else the torch.distributed
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

With `metrics=` / `trace=` the step also carries the monitor's planes
(`apex_tpu_torch.monitor`): a `MetricsState` folded on the device, the
flight recorder's per-layer taps (`TapState`) and the cross-rank timing
matrix, with no host sync; without them it is the step above, op for
op.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch import amp as amp_lib
from apex_tpu_torch.amp.policy import is_norm_path
from apex_tpu_torch.ops._common import (TapContext, device_step,
                                        resolve_device, tap_context)
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


def sync_gradients(grads, average: bool = True, group=None):
    """All-reduce the grads over the data-parallel group (or `group`), IN
    PLACE, and divide by its size with `average` (≡ the JAX package's
    `sync_gradients`, DDP's allreduce with gradient_average).  `grads`
    is one tensor (a flat buffer: one collective), a list or a tree of
    tensors.  Returns `grads`."""
    if group is None:
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
                    main_grad_dtype=None, axis_name=None, metrics=None,
                    trace=None):
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
    buffers in place, and with with_state the step writes the new model
    state into the `model_state` it was given and returns that tree, so
    no second copy of either outlives the step (`step.donate_argnums`
    names both; the JAX package donates the optimizer state only).  With
    num_microbatches > 1 the aux is the stacked per-microbatch auxes
    (has_aux) or the model state threaded through the microbatches
    (with_state).  `axis_name` (the JAX package's: "dp",
    or ("dp", "ep") for an expert-parallel model) names the group the
    grads and the loss scaler's overflow flag are averaged or OR-ed
    over; None is `mesh.data_parallel_group()`, which is that group at
    ep > 1.  The step runs on `device`: the card unless the caller asks
    for the CPU (`device="cpu"`, the plain versions of the kernels).

    metrics (True or a `monitor.MetricsConfig`): the step takes a
    trailing `monitor.MetricsState` and returns the updated one — the
    dp-mean loss, the unscaled grad norm (the synced grads; a ZeRO
    optimizer's local pre-reduction grads, as in the JAX package), the
    master param and update norms (a ZeRO optimizer's shards' squared
    sums and the loss go out in ONE all-reduce of a 3-vector), the
    loss scale, the overflow/skip counts and the tokens — on the device,
    with no host sync.

    trace (True or a `monitor.trace.TraceConfig`): with `taps` (the
    default) the forward runs under a `TapContext` and the step
    differentiates with respect to the params and the tap probes, so
    the per-layer stats leave through autograd; the step returns a
    `TapState` and `step.tap_names()` gives its row labels after the
    first call.  Taps need num_microbatches == 1.  With `rank_timing`
    the step takes this rank's (timing_dim,) duration vector and
    returns the (n_ranks, timing_dim) matrix all-gathered over the
    group (one small collective a step).

    Argument/output order with everything enabled (the JAX package's):
        step(opt_state, scaler_state[, model_state], batch,
             metrics_state, local_timing)
          -> (opt_state, scaler_state[, model_state], loss[, aux],
              metrics, tap_state, rank_timings)"""
    if num_microbatches < 1:
        raise ValueError(f"num_microbatches must be >= 1, got "
                         f"{num_microbatches}")
    metrics_cfg = None
    if metrics is not None and metrics is not False:
        from apex_tpu_torch.monitor import metrics as _mon
        if isinstance(metrics, _mon.MetricsState):
            raise TypeError(
                "make_train_step(metrics=...) takes True or a "
                "MetricsConfig at build time; pass the MetricsState to "
                "the built step as its trailing argument")
        metrics_cfg = _mon.MetricsConfig() if metrics is True else metrics
    trace_cfg = None
    if trace is not None and trace is not False:
        from apex_tpu_torch.monitor.trace import taps as _trc
        trace_cfg = _trc.TraceConfig() if trace is True else trace
        if trace_cfg.taps and num_microbatches != 1:
            raise ValueError(
                "trace taps require num_microbatches == 1 (merging "
                "per-microbatch tap stats across the accumulation is "
                "not defined); use TraceConfig(taps=False, "
                "rank_timing=True) for the timing plane alone")
    taps_on = trace_cfg is not None and trace_cfg.taps
    timing_on = trace_cfg is not None and trace_cfg.rank_timing
    # the tap names are known once the tapped loss has run (first call);
    # step.tap_names() reads them for the flight recorder's report
    tap_holder = {"names": None}
    dev = resolve_device(device)
    policy = amp_state.policy if amp_state is not None else None
    dynamic = amp_state.dynamic if amp_state is not None else False
    sharded = (hasattr(optimizer, "full_leaves")
               and hasattr(optimizer, "shard_layout"))
    group = (M.data_parallel_group() if axis_name is None
             else M.group_of(axis_name))
    m = num_microbatches
    main_grads = _MainGrads()

    @device_step
    def local_step(opt_state, scaler_state, model_state, batch, *extras):
        ex = list(extras)
        metrics_state = ex.pop(0) if metrics_cfg is not None else None
        local_timing = ex.pop(0) if timing_on else None
        raw_batch = batch
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

        def forward(mstate, b):
            if with_state:
                loss, aux = loss_fn(params, mstate, b)
            else:
                out = loss_fn(params, b)
                loss, aux = (out[0], out[1]) if has_aux else (out, None)
            return loss, aux

        def grads_of(mstate, b, probes=None):
            if probes is None:
                loss, aux = forward(mstate, b)
            else:
                # the tapped forward: every tap takes a row of `probes`
                # and its stats come back as that row's gradient
                ctx = TapContext(probes=probes)
                with tap_context(ctx):
                    loss, aux = forward(mstate, b)
                tap_holder["names"] = tuple(ctx.names)
            scaled = loss * scaler_state.scale if scaler_state is not None \
                else loss
            # a leaf the loss does not read gets a zero gradient, as
            # under jax.grad
            wrt = leaves if probes is None else leaves + [probes]
            grads = list(torch.autograd.grad(
                scaled, wrt, allow_unused=True, materialize_grads=True))
            return grads, loss.detach(), _detach(aux)

        n_flat = None if sharded else opt_state.params.numel()
        probe_grads = None
        if m == 1:
            probes = None
            if taps_on:
                probes = _trc.make_probes(trace_cfg.max_taps, dev)
                probes.requires_grad_(True)
            grads, loss, aux = grads_of(model_state, batch, probes)
            if probes is not None:
                probe_grads = grads.pop()
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
            g_sync = sync_gradients(g_flat, group=group)
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
        tap_state = None
        if probe_grads is not None:
            # the gradient plane's magnitudes unscaled (loss units); its
            # nonfinite count as observed on the raw scaled grads
            tap_state = _trc.finalize(probe_grads, len(tap_holder["names"]),
                                      inv_scale=inv)
        if metrics_cfg is not None:
            # read before the step: the optimizers update in place
            gnorm, p_old = _pre_step_metrics(
                metrics_cfg, g_sync, inv, opt_state, sharded)
        if sharded:
            _, new_opt_state = optimizer.step_flat(
                opt_state, g_sync, inv_scale=inv, found_inf=found_inf,
                gather_params=False)
        else:
            _, new_opt_state = optimizer.step_flat(
                opt_state, g_sync, inv_scale=inv, found_inf=found_inf)
        outs = (new_opt_state, new_scaler)
        if with_state:
            outs += (_write_model_state(model_state, aux),)
        outs += (loss,)
        if has_aux and not with_state:
            outs += (aux,)
        if metrics_cfg is not None:
            outs += (_post_step_metrics(
                metrics_cfg, metrics_state, raw_batch, group, loss, gnorm,
                p_old, new_opt_state, sharded, scaler_state, found_inf),)
        if taps_on:
            outs += (tap_state,)
        if timing_on:
            local_timing = _trc.timing_to_device(local_timing, dev)
            if local_timing.shape[-1] != trace_cfg.timing_dim:
                raise ValueError(
                    f"local_timing has {local_timing.shape[-1]} "
                    f"columns, TraceConfig.timing_dim is "
                    f"{trace_cfg.timing_dim}; pass this rank's "
                    f"({trace_cfg.timing_dim},) duration vector or set "
                    "timing_dim to match")
            outs += (_trc.gather_rank_timings(local_timing, group),)
        return outs

    if with_state:
        def step(opt_state, scaler_state, model_state, batch, *extras):
            return local_step(opt_state, scaler_state, model_state, batch,
                              *extras)
    else:
        def step(opt_state, scaler_state, batch, *extras):
            return local_step(opt_state, scaler_state, None, batch, *extras)
    step.tap_names = lambda: tap_holder["names"]
    # the observatory's labels (monitor.analyze_step / comms_report): the
    # arguments' names for the budget table, the state the step updates
    # in place (the optimizer's flat buffers, the model state), the
    # mesh's axes
    names = ["opt_state", "scaler_state"]
    if with_state:
        names.append("model_state")
    names.append("batch")
    if metrics_cfg is not None:
        names.append("metrics_state")
    if timing_on:
        names.append("local_timing")
    step.arg_names = tuple(names)
    step.donate_argnums = (0, 2) if with_state else (0,)
    step.mesh_axis_names, step.mesh_axis_sizes = M.mesh_axes()
    return step


def _write_model_state(model_state, new):
    """Write the step's new model state into the tensors of the
    `model_state` it was given (the step donates it) and return that
    tree; a step given no model state returns the new one."""
    if model_state is None:
        return new
    old, upd = (F.tree_leaves_with_paths(t) for t in (model_state, new))
    if [p for p, _ in old] != [p for p, _ in upd]:
        raise ValueError(
            "the loss function's new model state has the leaves "
            f"{[p for p, _ in upd]}, the model_state given to the step "
            f"{[p for p, _ in old]}: the step writes one into the other")
    with torch.no_grad():
        torch._foreach_copy_([x for _, x in old], [x for _, x in upd])
    return model_state


def _pre_step_metrics(cfg, g_sync, inv, opt_state, sharded):
    """What the metrics read before the optimizer updates its buffers in
    place: the unscaled grad norm and a copy of the master params (the
    rank's shard for a ZeRO optimizer; None without param norms)."""
    from apex_tpu_torch.monitor import metrics as _mon

    gnorm = _mon.global_norm(g_sync) * inv
    p_old = None
    if cfg.param_norms:
        p_old = (opt_state.params_shard if sharded
                 else opt_state.params).clone()
    return gnorm, p_old


def _post_step_metrics(cfg, state, batch, group, loss, gnorm, p_old,
                       new_opt_state, sharded, scaler_state, found_inf):
    """The step's MetricsState: the dp-mean loss and the param / update
    norms (a ZeRO optimizer's squared sums and the loss in ONE
    all-reduce of a 3-vector; a replicated optimizer's norms read its
    whole buffer, and only the loss is reduced)."""
    from apex_tpu_torch.monitor import metrics as _mon

    world = M.group_size(group)
    tokens = (cfg.tokens_per_step if cfg.tokens_per_step is not None
              else _mon.infer_tokens_per_step(batch) * world)
    loss = loss.float().reshape(())
    pn = un = p_flat = p_new = None
    if p_old is not None and sharded:
        p_new = new_opt_state.params_shard
        sums = torch.stack([
            torch.linalg.vector_norm(p_old, dtype=torch.float32).square(),
            torch.linalg.vector_norm(p_new.float() - p_old.float()).square(),
            loss])
        M.all_reduce(sums, "sum", group)
        pn, un = torch.sqrt(sums[0]), torch.sqrt(sums[1])
        loss = sums[2] / world
    else:
        if p_old is not None:
            p_flat, p_new = p_old, new_opt_state.params
        if world > 1:
            loss = M.all_reduce(loss.clone(), "sum", group) / world
    new = _mon.update_metrics(
        state, loss=loss, params_flat=p_flat, new_params_flat=p_new,
        param_norm=pn, update_norm=un,
        loss_scale=scaler_state.scale if scaler_state is not None else 1.0,
        found_inf=found_inf, tokens=tokens)
    return new._replace(grad_norm=gnorm.reshape(()))


def _detach(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_detach(t) for t in tree)
    return tree
