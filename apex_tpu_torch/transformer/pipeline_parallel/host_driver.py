"""Host-driven (MPMD) pipeline: one forward and one backward program per
stage, driven in 1F1B order from the host (counterpart of
apex_tpu/transformer/pipeline_parallel/host_driver.py:49-202, itself ≡
the reference's schedule engine running outside the compiled graph,
schedules/fwd_bwd_pipelining_without_interleaving.py).

  * Each stage runs its own forward and backward on its own device (one
    card a stage in production; any devices, or one card cut into
    several stages, here); `put` moves an activation or cotangent onto
    the stage's device, the place where a transfer library plugs in.
  * The host runs a dependency-driven 1F1B: ready backwards first (later
    stages first, so a cotangent moves a hop each sweep), then ready
    forwards, with a hard cap of n_stage − i saved inputs on stage i —
    the 1F1B activation bound (the last stage never holds more than
    one).  "gpipe" fills all microbatches first, then drains.
  * CUDA launches are asynchronous, so the host loop pipelines the way
    JAX's async dispatch does: stage k's kernels for microbatch m queue
    while stage k−1's for m+1 are issued.  The loop never synchronizes
    the host with a card.

The backward of a stage is recompute-based: `bwd(params, x, dy)` runs
the stage forward again under autograd from the saved stage input and
takes the vector-Jacobian product (`torch.autograd.grad`), as the JAX
`bwd` does inside one jitted program: no activation but the stage input
is kept between the forward and the backward.  Gradients are summed
across microbatches on each stage's own device and never leave it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    tree_flatten, tree_map)


class HostPipelineStage:
    """One pipeline stage: `apply_fn(params, x) -> y` run forward-only
    (`_fwd`) and forward + VJP (`_bwd`, `_loss_bwd`) on `device` (None:
    the card).  The LAST stage's apply_fn must return a scalar loss."""

    def __init__(self, apply_fn: Callable, device=None):
        self.apply_fn = apply_fn
        self.device = resolve_device(device)

    def put(self, x):
        """A tensor (or tree of them) on this stage's device: the transfer
        between stages (≡ p2p isend/irecv); asynchronous from the card."""
        return tree_map(lambda t: t.to(self.device, non_blocking=True), x)

    def _fwd(self, params, x):
        with torch.no_grad():
            return self.apply_fn(params, x)

    def _vjp(self, params, x, dy):
        """The stage forward under autograd from `x` (a tensor or a tree
        of them, e.g. an activation and the labels it carries) and its
        VJP at `dy` (a tree like the output; None: the scalar loss's
        seed 1.0).  Returns (y, dparams, dx), dx None at the integer
        leaves of x (JAX's float0)."""
        leaves, rebuild = tree_flatten(params)
        leaves = [p.detach().requires_grad_(p.is_floating_point())
                  for p in leaves]
        xs, rebuild_x = tree_flatten(x)
        xs = [v.detach().requires_grad_(v.is_floating_point()) for v in xs]
        with torch.enable_grad():
            y = self.apply_fn(rebuild(leaves), rebuild_x(xs))
        ys, _ = tree_flatten(y)
        seeds = ([torch.ones_like(ys[0])] if dy is None
                 else tree_flatten(dy)[0])
        pairs = [(o, g) for o, g in zip(ys, seeds)
                 if g is not None and o.requires_grad]
        wrt = [v for v in leaves + xs if v.requires_grad]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True, materialize_grads=True))
        dparams = rebuild([next(grads) if p.requires_grad else None
                           for p in leaves])
        dx = rebuild_x([next(grads) if v.requires_grad else None
                        for v in xs])
        return tree_map(lambda o: o.detach(), y), dparams, dx

    def _bwd(self, params, x, dy):
        _, dparams, dx = self._vjp(params, x, dy)
        return dparams, dx

    def _loss_bwd(self, params, x):
        """The last stage: its loss, seeded with 1.0."""
        return self._vjp(params, x, None)


def _tree_add(a, b):
    """Leaf-wise a + b (None: zero)."""
    la, rebuild = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return rebuild([x if y is None else (y if x is None else x + y)
                    for x, y in zip(la, lb)])


def host_pipeline_train_step(stages: Sequence[HostPipelineStage],
                             params_list: Sequence[Any],
                             microbatches: Sequence[Any],
                             schedule: str = "1f1b",
                             return_stats: bool = False):
    """One training step over `microbatches` with per-stage programs in
    1F1B (or fill-drain "gpipe") order ≡ the JAX package's
    `host_pipeline_train_step`.

    stages[-1].apply_fn must return a SCALAR loss (the mean over its
    microbatch).  Returns (mean_loss, [per-stage grad trees]): the loss a
    0-d tensor on the last stage's device (the JAX package hands back a
    host float; read it with float() when the step is done), each
    stage's gradients the mean over microbatches on its own device."""
    n_stage = len(stages)
    n_mb = len(microbatches)
    if schedule not in ("1f1b", "gpipe"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if n_stage == 0 or n_mb == 0:
        raise ValueError(
            f"need at least one stage and one microbatch, got "
            f"{n_stage} stage(s), {n_mb} microbatch(es)")
    if len(params_list) != n_stage:
        raise ValueError(
            f"params_list has {len(params_list)} entries for "
            f"{n_stage} stages")
    params_list = [st.put(p) for st, p in zip(stages, params_list)]

    saved_x: List[List[Any]] = [[] for _ in range(n_stage)]
    in_q: List[List[Any]] = [[] for _ in range(n_stage)]   # awaiting fwd
    dy_q: List[List[Any]] = [[] for _ in range(n_stage)]   # awaiting bwd
    in_q[0] = list(microbatches)
    grads: List[Optional[Any]] = [None] * n_stage
    losses: List[Any] = []
    fwd_done = [0] * n_stage
    bwd_done = [0] * n_stage
    peaks = [0] * n_stage

    # the 1F1B invariant, per stage: stage i keeps at most n_stage - i
    # saved inputs in flight; gpipe holds all n_mb during the fill
    def cap(i):
        return n_mb if schedule == "gpipe" else (n_stage - i)

    def do_fwd(i):
        st = stages[i]
        x = st.put(in_q[i].pop(0))
        saved_x[i].append(x)
        peaks[i] = max(peaks[i], len(saved_x[i]))
        fwd_done[i] += 1
        if i < n_stage - 1:
            in_q[i + 1].append(st._fwd(params_list[i], x))
        # the last stage's forward is fused into its loss_bwd

    def do_bwd(i):
        st = stages[i]
        x = saved_x[i].pop(0)               # FIFO ≡ 1F1B backward order
        if i == n_stage - 1:
            loss, dparams, dx = st._loss_bwd(params_list[i], x)
            losses.append(loss)
        else:
            dy = st.put(dy_q[i].pop(0))
            dparams, dx = st._bwd(params_list[i], x, dy)
        grads[i] = dparams if grads[i] is None else _tree_add(grads[i],
                                                              dparams)
        bwd_done[i] += 1
        if i > 0:
            dy_q[i - 1].append(dx)

    # dependency-driven sweeps: each round every stage runs its ready
    # backward (later stages first) and then its ready forward (earlier
    # stages first), gated by the in-flight cap; gpipe degenerates to
    # fill-then-drain because its backwards wait for the fill
    while bwd_done[0] < n_mb:
        progressed = False
        for i in range(n_stage - 1, -1, -1):
            bwd_ready = (len(saved_x[i]) > 0
                         and (dy_q[i] if i < n_stage - 1
                              else saved_x[i]))
            if schedule == "gpipe" and fwd_done[0] < n_mb:
                bwd_ready = False       # fill first
            if bwd_ready:
                do_bwd(i)
                progressed = True
        for i in range(n_stage):
            if in_q[i] and len(saved_x[i]) < cap(i):
                do_fwd(i)
                progressed = True
        if not progressed:
            raise RuntimeError(
                "host pipeline stalled — schedule invariant violated "
                f"(fwd_done={fwd_done}, bwd_done={bwd_done})")

    mean_loss = torch.stack([loss.float() for loss in losses]).sum() / n_mb
    # grads are per-microbatch sums of per-mb means: the global-batch
    # mean, each stage on its own device
    scale = 1.0 / n_mb
    grads_out = [tree_map(lambda g: g * scale, grads[i])
                 for i in range(n_stage)]
    if return_stats:
        return mean_loss, grads_out, {
            "peak_in_flight": max(peaks),
            "peak_in_flight_per_stage": peaks,
        }
    return mean_loss, grads_out
