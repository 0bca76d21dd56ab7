"""Shared kernel-layer plumbing (counterpart of apex_tpu/ops/_common.py).

Dispatch follows the tensor's device, with no environment switch: a
CPU tensor runs a kernel's plain PyTorch version, a CUDA tensor runs
the hand-written kernel or the call raises.  Entry points resolve their
device with `resolve_device`, which defaults to the card and refuses to
carry on without one.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  Raises when CUDA is asked for (explicitly or by
    default) and absent — an entry point never slides onto the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: apex_tpu_torch entry points run "
                "on the GPU by default; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:      # "cuda" → the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_kernel_device(*tensors: torch.Tensor) -> bool:
    """True when the kernel must run (every tensor on one CUDA device),
    False when the plain version must (every tensor on the CPU).
    Anything else — mixed devices, another backend — raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(
        "kernel inputs must all lie on the CPU (plain version) or all on "
        f"one CUDA device (kernel); got {sorted(str(t.device) for t in tensors)}")


# While a flop audit runs (`monitor.compile.analyze_step`,
# `monitor.comms.comms_report`) a one-element list the launchers of the
# port's matmul kernels add their flops to; None otherwise.
_KERNEL_FLOPS = None


def add_kernel_flops(n: int) -> None:
    """Count `n` flops of a hand-written kernel's launch into the active
    audit.  A flop counter (`torch.utils.flop_counter.FlopCounterMode`)
    sees ATen's ops only: on the CPU a kernel's plain version runs as
    ATen matmuls and is counted there, while on the card the kernel runs
    and only its launcher can say what it computed.  So each launcher of
    a matmul kernel calls this with the products of the function it
    computes (the plain version's products, as the flop accounting of
    `monitor.flops` counts them), and each product is counted once on
    either device."""
    if _KERNEL_FLOPS is not None:
        _KERNEL_FLOPS[0] += int(n)


@contextlib.contextmanager
def kernel_flop_count():
    """Collect `add_kernel_flops` inside the block: yields the
    one-element list the launchers add to."""
    global _KERNEL_FLOPS
    prev, box = _KERNEL_FLOPS, [0]
    _KERNEL_FLOPS = box
    try:
        yield box
    finally:
        _KERNEL_FLOPS = prev


_SMS = {}


def sm_count(device) -> int:
    """The card's SM count (a persistent grid's size), asked once a
    device."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def strict_matmul_numerics() -> None:
    """The GEMM numerics the JAX package gets from
    `preferred_element_type=float32`: bf16 products reduce in fp32
    (no reduced-precision split-K reduction), and fp32 matmuls run in
    full fp32 (no TF32 — prefill attention is an fp32 einsum).  Process
    wide, as PyTorch's switches are."""
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def host_seed(key: torch.Generator, low: int = -2 ** 31,
              high: int = 2 ** 31 - 1) -> int:
    """One draw in [low, high) from `key` as a host int.  `key` must be a
    CPU `torch.Generator`: the draw then never waits for the card."""
    if key.device.type != "cpu":
        raise ValueError(
            f"a key whose draws reach the host must be a CPU torch.Generator, "
            f"got one on {key.device} (reading its draw would wait for the "
            "card)")
    return int(torch.randint(low, high, (1,), generator=key))


def dropout(key: Optional[torch.Generator], rate: float, x: torch.Tensor):
    """Inverted-bernoulli dropout ≡ the JAX package's `_common.dropout`:
    zero each element with probability `rate` and scale the survivors by
    1/(1-rate) (`x / (1 - rate)` in x's dtype).  With rate 0 or no key it
    returns x itself.  The mask is `rand < 1 - rate` drawn from `key`, a
    `torch.Generator`, when it lives on x's device; otherwise (a CPU key
    for a CUDA tensor) from a generator on x's device seeded with one
    host draw from `key`.  The one implementation shared by the dense
    attention reference and the models (the flash kernels' in-kernel
    mask is a coordinate hash: `ops.flash_attention.dropout_keep_dense`)."""
    if rate == 0.0 or key is None:
        return x
    keep = 1.0 - rate
    gen = key
    if key.device.type != x.device.type:
        gen = torch.Generator(device=x.device).manual_seed(
            host_seed(key, 0, 2 ** 63 - 1))
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def row_block(rows: int, hidden: int, bytes_per_elt: int = 4,
              vmem_budget: int = 2 * 1024 * 1024, align: int = 8,
              cap: int = 1024) -> int:
    """Row-block size so a (block, hidden) fp32 tile fits the budget;
    aligned to 8 rows (the JAX package's heuristic, kept for the
    kernels that tile rows)."""
    b = max(align, vmem_budget // max(1, hidden * bytes_per_elt))
    b = min(b, cap, round_up(rows, align))
    return round_up(b, align) if b % align else b


# --------------------------- numerics taps ---------------------------
#
# The flight recorder's tap op (monitor.trace).  It lives here, not in
# monitor/, because the models call `tap()` on their hot path and must
# not import the monitor package (the JAX package's layout).
#
# Contract: `tap(x, name)` returns `x` itself when no TapContext is
# active (the default), so an untapped step runs the ops it always ran.
# Under an active context every tap takes a (2, 4) row of the context's
# `probes` (a leaf the step differentiates) and both stat planes leave
# through that row's *gradient*: `grad_tap`'s backward returns
# stack([tap_stats(x), tap_stats(grad)]) as the row's gradient (the JAX
# package's custom_vjp).  No hooks, no host callbacks, no collectives.
#
# Remat: a block under non-reentrant `torch.utils.checkpoint` runs its
# forward again during the backward.  The recompute's taps must not take
# new rows or append the names again, and must save what the first
# forward saved.  `grad_tap` saves no tensor (its forward stats ride on
# the node as an attribute) and the first forward's nodes keep their
# rows, so inside a backward pass (`_in_backward`) `tap` is the identity:
# the row assignment of the first forward stands, as the probes being an
# argument of `jax.grad` makes it stand in the JAX package.

TAP_STAT_FIELDS = ("absmax", "mean", "rms", "nonfinite")
TAP_STAT_DIM = len(TAP_STAT_FIELDS)
TAP_PLANES = ("fwd", "grad")


def tap_stats(x: torch.Tensor) -> torch.Tensor:
    """f32[4] = [absmax, mean, rms, nonfinite-element count] of x, in
    f32, with no autograd graph.  When x holds non-finite values the
    first three lanes are themselves non-finite (NaN propagates through
    the max and the sums) while lane 3, the count, stays finite:
    provenance keys on it.

    Plain ATen reductions that read x in its own dtype and strides (no
    f32 copy, no contiguous copy): the inf-norm, the f32 mean, the
    2-norm of the 2-norms of the rows of the last dim (a two-level sum
    keeps the f32 error of a long reduction down) and the count of the
    elements with x - x != 0, which are the non-finite ones."""
    with torch.no_grad():
        f32 = torch.float32
        rows = torch.linalg.vector_norm(x if x.ndim else x.reshape(1),
                                        dim=-1, dtype=f32)
        return torch.stack([
            torch.linalg.vector_norm(x, float("inf"), dtype=f32),
            torch.mean(x, dtype=f32),
            torch.linalg.vector_norm(rows) / math.sqrt(x.numel()),
            torch.count_nonzero(x - x).to(f32),
        ])


class _GradTap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, probe):
        # an attribute, not save_for_backward: a checkpointed block's
        # recompute must save what the first forward saved
        ctx.fwd_stats = tap_stats(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g, torch.stack([ctx.fwd_stats, tap_stats(g)])


def grad_tap(x: torch.Tensor, probe: torch.Tensor) -> torch.Tensor:
    """Identity on x whose backward returns stacked [tap_stats(x),
    tap_stats(grad)] as `probe`'s gradient (probe: an f32 (2, 4) row of
    the TapContext's probes)."""
    return _GradTap.apply(x, probe)


class TapContext:
    """Assigns probe rows to tap points for one forward.

    probes: f32 (max_taps, 2, 4) zeros that the step differentiates, so
    each tap's [fwd, grad] stats land in its row's gradient.  Rows are
    assigned in forward order; `names[i]` labels row i.
    `discover=True` records names only (no probe row) for tap
    enumeration."""

    def __init__(self, probes: Optional[torch.Tensor] = None,
                 discover: bool = False):
        self.probes = probes
        self.discover = discover
        self.names = []

    @property
    def max_taps(self) -> int:
        return 0 if self.probes is None else int(self.probes.shape[0])


_ACTIVE_TAPS = threading.local()


def active_tap_context() -> Optional[TapContext]:
    return getattr(_ACTIVE_TAPS, "ctx", None)


@contextlib.contextmanager
def tap_context(ctx: TapContext):
    prev = active_tap_context()
    _ACTIVE_TAPS.ctx = ctx
    try:
        yield ctx
    finally:
        _ACTIVE_TAPS.ctx = prev


def _in_backward() -> bool:
    """True while autograd runs a backward pass in this thread (where a
    checkpointed block's forward is recomputed)."""
    return torch._C._current_graph_task_id() != -1


def tap(x: torch.Tensor, name: str) -> torch.Tensor:
    """Named numerics tap point.  No active TapContext (the default), or
    a checkpoint's recompute inside the backward: returns x itself.
    Active: arms the [fwd, grad] stats probe of the next row."""
    ctx = active_tap_context()
    if ctx is None or _in_backward():
        return x
    i = len(ctx.names)
    ctx.names.append(str(name))
    if ctx.discover:
        return x
    if i >= ctx.max_taps:
        raise ValueError(
            f"tap {name!r} is tap #{i + 1} but the TapContext probes "
            f"array holds {ctx.max_taps} rows; raise "
            "TraceConfig.max_taps")
    return grad_tap(x, ctx.probes[i])
