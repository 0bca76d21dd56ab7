"""`MetricsState` — the on-device telemetry record (counterpart of
apex_tpu/monitor/metrics.py).

Collection happens inside the train step: every field is a 0-dim device
tensor computed from values the step already holds (loss, synced grads,
the flat master buffer, the loss scaler's state), so enabling metrics
adds a handful of scalar reductions and no host sync: nothing here calls
`.item()` or reads a value on the host.  The host touches the record
only when `MetricsLogger.log_step` fetches it (one copy).

The dtypes are the JAX package's: i32 counters, f32 values, and an f32
`tokens_seen`, exact up to 2**24 and rounded to the nearest
representable value past it, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops._common import resolve_device


class MetricsState(NamedTuple):
    """Per-step telemetry riding through the step (one 0-dim tensor a
    field)."""

    step: torch.Tensor            # i32, steps attempted (incl. skipped)
    loss: torch.Tensor            # f32, last UNSCALED loss
    grad_norm: torch.Tensor       # f32, global L2 of unscaled synced grads
    param_norm: torch.Tensor      # f32, global L2 of master params
    update_norm: torch.Tensor     # f32, global L2 of the applied update
    loss_scale: torch.Tensor      # f32, current loss scale (1.0 if none)
    overflow_count: torch.Tensor  # i32, cumulative non-finite-grad steps
    skipped_steps: torch.Tensor   # i32, cumulative optimizer-skip steps
    tokens_seen: torch.Tensor     # f32, cumulative tokens (or samples)


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """Static knobs for in-step collection.

    tokens_per_step: global tokens consumed per optimizer step.  None
    infers them from the batch (`infer_tokens_per_step`) times the
    data-parallel group's size inside make_train_step.  param_norms: the
    param/update norms read the optimizer's flat master buffer (a copy
    of it and two reductions a step); disable where those passes over
    the master buffer show up."""

    tokens_per_step: Optional[int] = None
    param_norms: bool = True


def init_metrics(device=None) -> MetricsState:
    """A zeroed MetricsState (loss scale 1.0) on `device`: the card
    unless the caller asks for the CPU."""
    dev = resolve_device(device)

    def z(dtype, v=0):
        return torch.full((), v, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return MetricsState(step=z(i32), loss=z(f32), grad_norm=z(f32),
                        param_norm=z(f32), update_norm=z(f32),
                        loss_scale=z(f32, 1.0), overflow_count=z(i32),
                        skipped_steps=z(i32), tokens_seen=z(f32))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return []


def global_norm(tree) -> torch.Tensor:
    """Global L2 norm over a tree of tensors (or one flat buffer), each
    leaf's norm accumulated in f32 (a low-precision leaf is upcast as it
    is read, with no f32 copy) and the per-leaf norms combined, as the
    JAX package's per-leaf f32 sums are; no concatenated copy of the
    leaves.  It may differ from the clip norm in the last few ULPs
    (accumulation order)."""
    leaves = _leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = [torch.linalg.vector_norm(leaf, dtype=torch.float32)
             for leaf in leaves]
    if len(norms) == 1:
        return norms[0]
    return torch.linalg.vector_norm(torch.stack(norms))


def infer_tokens_per_step(batch, microbatch_dims: int = 0) -> int:
    """Token accounting for one step's LOCAL batch (callers multiply by
    the data-parallel size).  Heuristic on the FIRST leaf: integer
    leaves with a sequence dim are LM token ids and count every element;
    float leaves (images etc.) count samples.  `microbatch_dims=1` for
    batches stacked (num_microbatches, mb, ...).  Pass an explicit
    tokens_per_step when the heuristic is wrong."""
    leaves = _leaves(batch)
    if not leaves:
        return 0
    lead = leaves[0]
    if (not lead.is_floating_point() and not lead.is_complex()
            and lead.dtype != torch.bool
            and lead.ndim >= 2 + microbatch_dims):
        return int(lead.numel())
    n = 1
    for d in lead.shape[:1 + microbatch_dims]:
        n *= int(d)
    return n


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def require_metrics_state(state, where: str = "update_metrics") -> None:
    """Raise the TypeError that `update_metrics` gives for what is not a
    MetricsState (callers that update buffers in place check first)."""
    if not isinstance(state, MetricsState):
        raise TypeError(
            f"{where} needs a MetricsState, got "
            f"{type(state).__name__}; build one with init_metrics() "
            "(make_train_step's build-time metrics= flag is the one "
            "place that takes True/MetricsConfig instead)")


def update_metrics(state: MetricsState, *, loss=None, grads=None,
                   inv_scale=1.0, params_flat=None, new_params_flat=None,
                   param_norm=None, update_norm=None,
                   loss_scale=None, found_inf=None,
                   tokens: int = 0,
                   count_step: bool = True) -> MetricsState:
    """Fold one step's signals into the record, on the device.  Every
    argument is optional: a path that does not hold a signal leaves that
    field at its previous value.

    count_step=False updates fields WITHOUT advancing `step` (the second
    of two hooks in one iteration: `forward_backward_no_pipelining`
    then `FP16_Optimizer.step(metrics_count_step=False)`).

    grads: the step's (possibly still loss-scaled) gradients, a tree or
    a flat buffer; `inv_scale` unscales the recorded norm.  params_flat
    / new_params_flat: the optimizer's flat master buffers before and
    after the update (the update norm is the norm of their difference;
    the optimizers update in place, so `params_flat` must be a copy
    taken before the step).  param_norm / update_norm pass precomputed
    norms instead (they win over the flat buffers): the ZeRO-2 path
    reduces its shards' sums over the group itself."""
    require_metrics_state(state)
    ref = state.loss
    step = state.step + 1 if count_step else state.step
    loss_v = state.loss if loss is None else _f32(loss, ref)
    if grads is not None:
        gn = global_norm(grads) * inv_scale
    else:
        gn = state.grad_norm
    if param_norm is not None:
        pn = _f32(param_norm, ref)
    elif params_flat is not None:
        pn = torch.linalg.vector_norm(params_flat, dtype=torch.float32)
    else:
        pn = state.param_norm
    if update_norm is not None:
        un = _f32(update_norm, ref)
    elif new_params_flat is not None and params_flat is not None:
        un = torch.linalg.vector_norm(
            new_params_flat.float() - params_flat.float())
    else:
        un = state.update_norm
    scale_v = state.loss_scale if loss_scale is None else \
        _f32(loss_scale, ref)
    if found_inf is not None:
        inc = (found_inf.to(torch.int32).reshape(())
               if isinstance(found_inf, torch.Tensor) else int(found_inf))
        overflow = state.overflow_count + inc
        skipped = state.skipped_steps + inc
    else:
        overflow = state.overflow_count
        skipped = state.skipped_steps
    # a python scalar rides as a kernel argument (no host-to-device
    # copy); the add rounds it to f32 first, as jnp.asarray does
    tokens_seen = state.tokens_seen + float(tokens)
    return MetricsState(
        step=step, loss=loss_v, grad_norm=gn.reshape(()),
        param_norm=pn.reshape(()), update_norm=un.reshape(()),
        loss_scale=scale_v, overflow_count=overflow, skipped_steps=skipped,
        tokens_seen=tokens_seen)
