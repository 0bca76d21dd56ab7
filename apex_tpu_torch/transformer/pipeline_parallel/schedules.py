"""Pipeline schedules — microbatched forward and backward over pp stages
(counterpart of apex_tpu/transformer/pipeline_parallel/schedules.py:38-348,
itself ≡ apex/transformer/pipeline_parallel/schedules/).

The JAX package runs one SPMD program in which every stage (a pp mesh
coordinate) steps the same clocked loop: microbatch m enters stage 0 at
clock m, activations shift stage → stage with `ppermute` each clock, and
reverse-mode AD of the clocked scan is the backward pipeline.  Here each
pp rank runs that clock loop itself, with the same arithmetic: m +
pp·chunks − 1 clocks; at clock t chunk c of stage s holds microbatch
k = t − c·pp − s (a bubble outside [0, m)); after each chunk every stage
hops its output one stage forward over the pp group
(`p2p_communication.shift`); stage 0 feeds microbatch t to chunk 0 and
gives chunk c > 0 the wrap of chunk c − 1 from the last stage
(schedules.py:139-170).

The backward is driven by hand, not by the autograd engine: the clock
loop is one `torch.autograd.Function` whose backward walks the clocks in
reverse, issues one backward hop (the −1 shift of the cotangent) for
every forward hop, and takes each computed (clock, chunk)'s
vector-Jacobian product locally (`torch.autograd.grad` through the
stage function).  Which hops are issued depends only on the clock
index, never on the stage, so every rank issues every hop, forward and
backward, in the same order, and no rank waits on a hop its neighbour
never sends.  Between hops a stage may skip work: bubble clocks run no
stage function (the JAX `where`/`cond` gates discard their outputs, so
their cotangents are exactly zero), and only the last stage writes
outputs and runs the head.  The hop after the last clock, whose result
the JAX scan drops, is not issued.  Parameter gradients are summed over
clocks in this order, not XLA's: they agree to rounding, not bit for
bit.  The stage function reads its parameters only from `stage_params`
(tensors it closes over get no gradient); the loss function may close
over anything, as it runs under ordinary autograd.

Memory (per stage), the JAX package's dials:
  * `checkpoint_window=None`: every computed clock keeps its autograd
    graph until the backward — GPipe-shaped, O(m) activations, as AD of
    the plain scan saves residuals for every clock.
  * `remat_stage=True`: each clock keeps only its stage input and
    recomputes the stage in the backward (`torch.utils.checkpoint`,
    non-reentrant; the stage function issues no hop).
  * `checkpoint_window=w` (< clocks): the forward keeps no graph, only
    the carry (the chunks' stage inputs) at the start of each window of
    w clocks; the backward recomputes one window at a time from its
    carry, graphs and all, and the head's loss of each microbatch is
    recomputed too (`torch.utils.checkpoint`), as `jax.checkpoint` of a
    window recomputes the collect.  In flight: O(w) clocks' graphs plus
    O(clocks / w) saved carries.  The recomputed window issues its
    forward hops again (but the one after its last clock, whose result
    is the next window's saved carry); every rank recomputes the same
    windows in the same order, so the hops pair as in the forward.
    w = pp gives the 1F1B bound O(pp + m/pp) at one extra forward.

Outputs: without `loss_fn` the (m, ...) stack of the last stage's
outputs, replicated to every stage by `_broadcast_from_last` (an
all-reduce over pp forward, the identity backward).  With
`loss_fn(y, loss_args[k])` the last stage evaluates each microbatch's
loss as it comes out and only the fp32 scalar sum crosses pp.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from apex_tpu_torch.ops._common import loop_iteration
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import (
    reduce_from_tensor_model_parallel_region as _bcast_from_last)
from apex_tpu_torch.parallel.mesh import DP_AXIS, PP_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    shift as _shift)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    tree_flatten, tree_map)


def _add(a, b):
    if a is None:
        return b
    return a if b is None else a + b


class _Clocks:
    """One call's clocked loop on this stage: the forward (with or
    without per-clock graphs) and the hand-driven backward."""

    def __init__(self, stage_fn, leaves, rebuild, microbatches, group,
                 chunks, remat_stage, window):
        self.stage_fn, self.rebuild = stage_fn, rebuild
        self.leaves = [leaf.detach() for leaf in leaves]
        self.mb = microbatches.detach()
        self.group = group
        self.pp, self.stage = M.group_size(group), M.group_rank(group)
        self.m, self.chunks = microbatches.shape[0], chunks
        self.clocks = self.m + self.pp * chunks - 1
        self.window = (window if window and window < self.clocks else None)
        self.remat_stage = remat_stage
        self.need_mb = False
        self.need_p = [False] * len(leaves)

    # ------------------------------ forward -------------------------------

    def computed(self, t, c):
        """Whether chunk c of this stage holds a microbatch at clock t."""
        return 0 <= t - c * self.pp - self.stage < self.m

    def written(self, t):
        """The microbatch this stage's last chunk completes at clock t,
        if this is the last stage and one does."""
        k = t - (self.pp * self.chunks - 1)
        if self.stage == self.pp - 1 and 0 <= k < self.m:
            return k
        return None

    def zeros(self):
        return self.mb.new_zeros(self.mb.shape[1:])

    def apply(self, t, c, x, graphs):
        params = [leaf[c] for leaf in self.leaves]
        if graphs is None:
            return self.stage_fn(self.rebuild(params), x, c)
        fn = self.stage_fn
        if self.remat_stage:
            from torch.utils.checkpoint import checkpoint

            def fn(p, x_, c_):
                return checkpoint(self.stage_fn, p, x_, c_,
                                  use_reentrant=False)
        with torch.enable_grad():
            params = [p.detach().requires_grad_(need)
                      for p, need in zip(params, self.need_p)]
            x = x.detach().requires_grad_(
                x.is_floating_point()
                and not (c == 0 and self.stage == 0 and not self.need_mb))
            y = fn(self.rebuild(params), x, c)
        graphs[(t, c)] = (x, params, y)
        return y.detach()

    def clock(self, t, xs, graphs, out=None):
        """Clock t's chunks in order; writes completed microbatches into
        `out`; returns the chunks' outputs."""
        ys = []
        for c in range(self.chunks):
            x = (self.mb[min(t, self.m - 1)] if c == 0 and self.stage == 0
                 else xs[c])
            y = self.apply(t, c, x, graphs) if self.computed(t, c) else x
            k = self.written(t) if c == self.chunks - 1 else None
            if out is not None and k is not None:
                out[k].copy_(y)
            ys.append(y)
        return ys

    def hop(self, ys):
        """Every chunk's output one stage on (chunk order), routed to the
        next clock's inputs: stage 0's chunk c > 0 takes the wrap of
        chunk c − 1, every other input its own chunk's shift."""
        r = [_shift(y, self.group, +1) for y in ys]
        return [r[0]] + [r[c - 1] if self.stage == 0 else r[c]
                         for c in range(1, self.chunks)]

    def forward(self, build):
        """The whole clock loop; `build` keeps what the backward needs.
        Returns the (m, ...) outputs (zeros but on the last stage)."""
        out = self.mb.new_zeros(self.mb.shape)
        xs = [self.zeros() for _ in range(self.chunks)]
        self.graphs = {} if build and not self.window else None
        self.carries = {}
        for t in range(self.clocks):
            if build and self.window and t % self.window == 0:
                self.carries[t] = xs
            with loop_iteration("clock", t):
                ys = self.clock(t, xs, self.graphs, out)
                if t < self.clocks - 1:
                    xs = self.hop(ys)
        return out

    # ------------------------------ backward ------------------------------

    def back_clock(self, t, dxs, graphs, dout, acc):
        """Clock t in reverse: the backward hops of its forward hops
        (chunk order reversed), then each computed chunk's VJP.  `dxs`:
        the cotangents of clock t+1's inputs (None: zero); returns clock
        t's."""
        C = self.chunks
        dys = [None] * C
        if t < self.clocks - 1:
            dr = [dxs[0]] + [None] * (C - 1)
            for c in range(1, C):
                j = c - 1 if self.stage == 0 else c
                dr[j] = _add(dr[j], dxs[c])
            for c in reversed(range(C)):
                g = dr[c] if dr[c] is not None else self.zeros()
                dys[c] = _shift(g, self.group, -1)
        new = [None] * C
        for c in reversed(range(C)):
            dy = dys[c]
            k = self.written(t) if c == C - 1 else None
            if k is not None:
                dy = _add(dy, dout[k])
            dx = None
            if self.computed(t, c):
                x, params, y = graphs.pop((t, c))
                if dy is None:
                    dy = torch.zeros_like(y)
                wrt = [p for p in params if p.requires_grad]
                if x.requires_grad:
                    wrt.append(x)
                grads = list(torch.autograd.grad(y, wrt, dy,
                                                 allow_unused=True))
                if x.requires_grad:
                    dx = grads.pop()
                it = iter(grads)
                for i, p in enumerate(params):
                    if p.requires_grad:
                        acc[c][i] = _add(acc[c][i], next(it))
            if c == 0 and self.stage == 0:
                if dx is not None:
                    self.dmb[t] += dx
            else:
                new[c] = dx
        return new

    def backward(self, dout):
        """The reverse clock loop (window by window under a checkpoint
        window).  Returns (d microbatches, d leaves)."""
        acc = [[None] * len(self.leaves) for _ in range(self.chunks)]
        self.dmb = (torch.zeros_like(self.mb)
                    if self.need_mb and self.stage == 0 else None)
        dxs = [None] * self.chunks
        if not self.window:
            for i, t in enumerate(reversed(range(self.clocks))):
                with loop_iteration("back_clock", i):
                    dxs = self.back_clock(t, dxs, self.graphs, dout, acc)
        else:
            starts = sorted(self.carries)
            for a in reversed(starts):
                b = min(a + self.window, self.clocks)
                graphs, xs = {}, self.carries.pop(a)
                for t in range(a, b):
                    with loop_iteration("clock", t - a):
                        ys = self.clock(t, xs, graphs)
                        if t < b - 1:
                            xs = self.hop(ys)
                for i, t in enumerate(reversed(range(a, b))):
                    with loop_iteration("back_clock", i):
                        dxs = self.back_clock(t, dxs, graphs, dout, acc)
        dleaves = []
        for i, leaf in enumerate(self.leaves):
            if not self.need_p[i]:
                dleaves.append(None)
                continue
            dleaves.append(torch.stack([
                g[i] if g[i] is not None else torch.zeros_like(leaf[c])
                for c, g in enumerate(acc)]))
        return self.dmb, dleaves


class _Pipeline(torch.autograd.Function):
    """The clock loop as one autograd node over the microbatches and the
    stage parameters; its backward is `_Clocks.backward`."""

    @staticmethod
    def forward(ctx, run, microbatches, *leaves):
        run.need_mb = ctx.needs_input_grad[1]
        run.need_p = list(ctx.needs_input_grad[2:])
        ctx.run = run
        out = run.forward(build=True)
        # a scalar output that keeps every stage's result on this node,
        # so the backward runs (and hops) on stages that write nothing
        return out, out.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, dout, _):
        run, ctx.run = ctx.run, None
        dmb, dleaves = run.backward(dout)
        return (None, dmb, *dleaves)


def spmd_pipeline(stage_fn: Callable, stage_params, microbatches, *,
                  axis_name: str = PP_AXIS, num_model_chunks: int = 1,
                  remat_stage: bool = False,
                  checkpoint_window: Optional[int] = None,
                  loss_fn: Optional[Callable] = None, loss_args=None):
    """Run `microbatches` through pp × num_model_chunks sequential stages
    (≡ the JAX package's `spmd_pipeline`; module docstring).

    stage_fn(chunk_params, x, chunk_index) -> y — the layers this rank
    owns in one chunk; x and y of one shape and dtype.  stage_params: a
    pytree (nested dicts) of this stage's leaves, each stacked over
    chunks on dim 0.  microbatches: (m, ...) stage-0 inputs.  Every rank
    of the pp group (of `axis_name`) calls this with the same m, shapes,
    chunk count and window.

    Returns the (m, ...) outputs of the last stage on every stage, or,
    with loss_fn(y, loss_args[k]) -> scalar, the fp32 sum of the
    microbatches' losses on every stage.  Differentiable: the backward
    is the reverse pipeline."""
    group = M.group_of(axis_name)
    leaves, rebuild = tree_flatten(stage_params)
    run = _Clocks(stage_fn, leaves, rebuild, microbatches, group,
                  num_model_chunks, remat_stage, checkpoint_window)
    if torch.is_grad_enabled() and (
            microbatches.requires_grad
            or any(leaf.requires_grad for leaf in leaves)):
        out, anchor = _Pipeline.apply(run, microbatches, *leaves)
    else:
        out, anchor = run.forward(build=False), None
    if loss_fn is not None:
        acc = (anchor if anchor is not None
               else out.new_zeros((), dtype=torch.float32))
        if run.stage == run.pp - 1:
            for k in range(run.m):
                args_k = tree_map(lambda a: a[k], loss_args)
                if run.window and torch.is_grad_enabled():
                    from torch.utils.checkpoint import checkpoint
                    loss = checkpoint(loss_fn, out[k], args_k,
                                      use_reentrant=False)
                else:
                    loss = loss_fn(out[k], args_k)
                acc = acc + loss.float()
        out = acc
    return _broadcast_from_last(out, run.stage, run.pp, axis_name)


def _broadcast_from_last(out, stage, pp, axis_name):
    """Replicate the last stage's output to every stage with the
    all-reduce-forward / identity-backward pair: each stage seeds its
    own loss cotangent in backward, and only the last stage's flows into
    the pipeline (the others are masked) — no double counting."""
    masked = out if stage == pp - 1 else out * 0
    return _bcast_from_last(masked, axis_name)


# ------------------------- reference-shaped drivers -------------------------

def forward_backward_no_pipelining(forward_step_func, batch, model_params, *,
                                   num_microbatches: int,
                                   grad_fn: Optional[Callable] = None,
                                   main_grad_dtype=None,
                                   metrics=None, tokens_per_step=None,
                                   rank_timing=None,
                                   rank_timing_axis: str = DP_AXIS):
    """≡ fwd_bwd_no_pipelining.py:23-120 (the JAX package's
    schedules.py:213-303): loop the microbatches, average the loss and
    accumulate the gradients (no sync: the caller syncs once after).

    forward_step_func(params, microbatch) -> scalar loss; batch: a pytree
    whose leaves have the microbatch count as dim 0.  Returns (mean_loss,
    grads), grads a tree like `model_params`.

    main_grad_dtype None: one backward of the fp32 sum of the
    microbatches' losses, each parameter's gradient accumulated in its
    own dtype (the JAX package's AD through the scan).  A floating dtype
    (torch.float32: Apex's persistent fp32 `main_grad`): one backward a
    microbatch, the running sum held in that dtype and the result its
    mean in that dtype.

    metrics: a `monitor.MetricsState` — the return becomes (mean_loss,
    grads, new_metrics) with the loss, the LOCAL grad norm (this rank's
    accumulation before the caller's sync) and the tokens
    (tokens_per_step, or inferred from the microbatched batch) folded in
    on the device; this path holds no scaler or optimizer state, so those
    fields carry over (give a following `FP16_Optimizer.step(metrics=)`
    metrics_count_step=False).  rank_timing: this rank's (k,) duration
    vector (`monitor.trace.TIMING_FIELDS`), a host vector or a tensor,
    moved to the loss's device; the (n_ranks, k) matrix all-gathered over
    `rank_timing_axis`'s group is the LAST return value (one small
    collective).  Without them nothing is added."""
    leaves, rebuild = tree_flatten(model_params)
    m = num_microbatches

    def finish(loss, grads):
        out = (loss, grads)
        if metrics is not None:
            from apex_tpu_torch.monitor import metrics as _mon
            tokens = tokens_per_step if tokens_per_step is not None else \
                _mon.infer_tokens_per_step(batch, microbatch_dims=1)
            out += (_mon.update_metrics(metrics, loss=loss, grads=grads,
                                        tokens=tokens),)
        if rank_timing is not None:
            from apex_tpu_torch.monitor.trace import taps as _trc
            from apex_tpu_torch.parallel import mesh as M
            out += (_trc.gather_rank_timings(
                rank_timing, M.group_of(rank_timing_axis),
                device=loss.device),)
        return out

    def fresh():
        return [leaf.detach().requires_grad_(leaf.is_floating_point())
                for leaf in leaves]

    def grads_of(loss, ps):
        wrt = [p for p in ps if p.requires_grad]
        gs = iter(torch.autograd.grad(loss, wrt, allow_unused=True,
                                      materialize_grads=True))
        return [next(gs) if p.requires_grad else None for p in ps]

    def microbatch(k):
        return tree_map(lambda a: a[k], batch)

    if main_grad_dtype is None:
        ps = fresh()
        p = rebuild(ps)
        acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for k in range(m):
            acc = acc + forward_step_func(p, microbatch(k))
        loss = acc / m
        return finish(loss.detach(), rebuild(grads_of(loss, ps)))

    dt = main_grad_dtype
    g_acc = [torch.zeros(leaf.shape, dtype=dt, device=leaf.device)
             for leaf in leaves]
    loss_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for k in range(m):
        ps = fresh()
        loss = forward_step_func(rebuild(ps), microbatch(k))
        for a, g in zip(g_acc, grads_of(loss, ps)):
            if g is not None:
                a.add_(g.to(dt))
        loss_acc = loss_acc + loss.detach().float()
    inv = torch.tensor(1.0 / m, dtype=dt)
    return finish(loss_acc * (1.0 / m), rebuild([a * inv for a in g_acc]))


def forward_backward_pipelining_without_interleaving(
        stage_fn, stage_params, microbatches, loss_fn, *,
        axis_name: str = PP_AXIS, remat_stage: bool = False,
        checkpoint_window: Optional[int] = None):
    """1F1B-equivalent clocked pipeline ≡
    fwd_bwd_pipelining_without_interleaving.py:241-597: the mean of
    loss_fn(y) over the microbatches, evaluated on the last stage;
    differentiate it for the backward pipeline."""
    total = spmd_pipeline(stage_fn, stage_params, microbatches,
                          axis_name=axis_name, remat_stage=remat_stage,
                          checkpoint_window=checkpoint_window,
                          loss_fn=lambda y, _: loss_fn(y), loss_args=None)
    return total / microbatches.shape[0]


def forward_backward_pipelining_with_interleaving(
        stage_fn, stage_params, microbatches, loss_fn, *,
        num_model_chunks: int, axis_name: str = PP_AXIS,
        remat_stage: bool = False,
        checkpoint_window: Optional[int] = None):
    """Interleaved (virtual-pp) schedule ≡
    fwd_bwd_pipelining_with_interleaving.py:27-744."""
    total = spmd_pipeline(stage_fn, stage_params, microbatches,
                          axis_name=axis_name,
                          num_model_chunks=num_model_chunks,
                          remat_stage=remat_stage,
                          checkpoint_window=checkpoint_window,
                          loss_fn=lambda y, _: loss_fn(y), loss_args=None)
    return total / microbatches.shape[0]


def get_forward_backward_func(virtual_pipeline_model_parallel_size,
                              pipeline_model_parallel_size):
    """≡ schedules/__init__.py:22-38 selector."""
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining
