"""Fused LayerNorm / RMSNorm, forward and backward (counterpart of
apex_tpu/ops/layer_norm.py).

Statistics are fp32 whatever the input dtype, the variance is centred
(mean of (x - mean)^2, not E[x^2] - mean^2), and the forward also yields
the fp32 mean and rstd per row that the backward reads.

Two implementations of each direction live here:

  * `norm_fwd_reference` / `norm_bwd_reference` — the plain PyTorch
    versions (and the `layer_norm_reference` / `rms_norm_reference`
    spellings of the JAX package).  CPU tensors run them (autograd
    differentiates the plain forward), and `chip_smoke.py` holds the
    kernels against them.
  * the CUDA C++ kernels of `apex_tpu_torch/csrc/layer_norm.cu`: the
    forward launched by `norm_fwd_cuda` under the host plan `fwd_plan`,
    the backward by `norm_bwd_cuda` under `bwd_plan`, for CUDA tensors.
    A CUDA call that needs a gradient goes through `_NormFn` (a
    `torch.autograd.Function`: the forward kernel saves x, mean and rstd,
    the backward kernel computes dx, dw, db); one that does not
    (`torch.inference_mode()`, `torch.no_grad()`, the serving engine)
    runs the forward kernel alone.

Forward kernel note.  Replaces apex_tpu/ops/layer_norm.py:_fwd_kernel
(launched by _fwd_pallas).  What bounds it on an H100: bytes at the
training steps' rows — x read and y written once, ~8 flops an element —
and the latency of one load, two row sums and a store at decode's 64
rows.  The TPU kernel takes a block of rows a grid step; here a row
belongs to a group of warps whose threads hold it in registers, sum it
by warp shuffles (one shared-memory step between the group's warps) and
centre the variance on the values they hold (`fwd_plan`): two 16-byte
vectors of x, w and b a thread at the training steps' rows (2 warps a
row at hidden 1024), one at decode's (4 warps), each group walking a run
of rows with the next row's loads in flight; rows past 8192 columns take
12 warps and stream through a ring of 1-D bulk copies.  One launch a
call, no atomics, the same bits every run.  The source note
(csrc/layer_norm.cu) has the details.

Backward kernel note.  Replaces apex_tpu/ops/layer_norm.py:_bwd_kernel
(launched by _bwd_pallas).  dx = rstd * (wg - mean(wg) - xhat *
mean(wg * xhat)) with wg = g * w (RMSNorm drops the mean(wg) term),
rounded once to x's dtype; dw = sum over rows of g * xhat, db = sum of g,
in fp32.  What bounds it on an H100: bytes — g and x read once, dx
written once, ~20 flops per element.  The TPU kernel accumulates dw and
db across its sequential grid; blocks on the card run in any order, so
the kernel runs about one persistent block an SM over a fixed run of
rows (`bwd_plan`): a warp a row at hidden <= 1024 (a group of warps a
wider row), each row group streaming its rows through a ring of slots
in shared memory filled by 1-D bulk copies several rows ahead, its dw
and db sums in fp32 registers.  Each block writes one partial row of
dw and db (its groups in order) and a finishing pass of one block a
4-column slice sums them in a fixed order.  No atomics: the same bits
on every run.  The source note (csrc/layer_norm.cu) has the details.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import nn

from apex_tpu_torch.ops._common import (check_kernel_device,
                                        sm_count as _sm_count)

_MAX_HIDDEN = 16384


# --------------------------- plain PyTorch version ---------------------------

def norm_fwd_reference(x2, weight=None, bias=None, eps=1e-5, rms=False):
    """Plain forward over (rows, hidden): returns (y in x.dtype, fp32
    mean (rows, 1), fp32 rstd (rows, 1)); mean is 0 for RMSNorm."""
    x = x2.float()
    if rms:
        mean = torch.zeros((x.shape[0], 1), dtype=torch.float32,
                           device=x.device)
        var = torch.mean(x * x, dim=1, keepdim=True)
    else:
        mean = torch.mean(x, dim=1, keepdim=True)
        xc = x - mean
        var = torch.mean(xc * xc, dim=1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean) * rstd
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x2.dtype), mean, rstd


def norm_bwd_reference(g2, x2, mean, rstd, weight=None, rms=False):
    """Plain backward over (rows, hidden), the formula of the JAX
    package's `_bwd_kernel`: returns (dx in x's dtype, fp32 dw, fp32 db);
    dw and db are None without a weight."""
    g = g2.float()
    x = x2.float()
    xhat = (x - mean) * rstd
    wg = g * weight.float() if weight is not None else g
    c2 = torch.mean(wg * xhat, dim=1, keepdim=True)
    if rms:
        dx = rstd * (wg - xhat * c2)
    else:
        c1 = torch.mean(wg, dim=1, keepdim=True)
        dx = rstd * (wg - c1 - xhat * c2)
    if weight is None:
        return dx.to(x2.dtype), None, None
    return (dx.to(x2.dtype), torch.sum(g * xhat, dim=0),
            torch.sum(g, dim=0))


def layer_norm_reference(x, weight=None, bias=None, eps=1e-5):
    """LayerNorm over the last dim, fp32 stats (≡ the JAX package's
    reference)."""
    y, _, _ = norm_fwd_reference(x.reshape(-1, x.shape[-1]), weight, bias,
                                 eps, rms=False)
    return y.reshape(x.shape)


def rms_norm_reference(x, weight=None, eps=1e-5):
    y, _, _ = norm_fwd_reference(x.reshape(-1, x.shape[-1]), weight, None,
                                 eps, rms=True)
    return y.reshape(x.shape)


# -------------------------------- CUDA kernels --------------------------------

# the plan's constants (csrc/layer_norm.cu): columns a thread holds (its
# dw and db sums live in registers) at up to 8 warps a row, warps a block,
# the warps of a row past 8 x 1024 columns, the shared memory of
# a block's ring and w's fp32 row, the ring's most slots, and the
# columns of a slice of the finishing pass
BWD_COLS = 32
BWD_WARPS = 8
BWD_WIDE_WARPS = 12
BWD_SMEM = 200 * 1024
BWD_MAX_STAGES = 4
BWD_FINISH_COLS = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LIB = None


class BwdPlan(NamedTuple):
    """What `csrc/layer_norm.cu` runs: `blocks` blocks of `warps` warps
    and `rows_per_block` rows (the last one short), `warps_per_row` warps
    a row, a ring of `stages` rows a row group, loads `load_width` bytes
    wide (16: bulk copies), and `finish_blocks` blocks summing the
    partial rows of dw and db."""
    blocks: int
    rows_per_block: int
    warps: int
    warps_per_row: int
    stages: int
    load_width: int
    finish_blocks: int


def bwd_plan(rows, hidden, itemsize, sms, align=16):
    """The backward kernel's plan for (rows, hidden) of `itemsize`-byte
    elements on a card of `sms` SMs, where `align` bytes divide every
    base and row stride of g, x and dx.  A row takes the fewest warps (a
    power of two) that hold it at `BWD_COLS` columns a thread, or past
    `BWD_WARPS` such warps `BWD_WIDE_WARPS` (up to 48 columns a thread);
    a block has `BWD_WARPS` warps (a row's when it takes more), each row
    group walking every `groups`-th row of its block's run; the runs are
    as even as whole rows a group allow, one block an SM at most.  Rows
    whose bytes and bases are 16-byte multiples stream through a ring of
    as many slots (at most 4) as `BWD_SMEM` holds beside w's fp32 row;
    others take 4- or 2-byte loads, one row at a time.  The finishing
    pass takes a block of `BWD_FINISH_COLS` columns each (256 at hidden
    1024)."""
    if not 0 < hidden <= _MAX_HIDDEN:
        raise ValueError(f"LayerNorm backward kernel takes hidden in "
                         f"(0, {_MAX_HIDDEN}], got {hidden}")
    wpr = _row_warps(hidden, BWD_COLS, BWD_WARPS, BWD_WIDE_WARPS)
    warps = max(wpr, BWD_WARPS)
    groups = warps // wpr
    row_bytes = hidden * itemsize
    width = _load_width(hidden, itemsize, align)
    stages = 1
    if width == 16:
        w_bytes = -(-hidden // 8) * 32
        stages = max(1, min(BWD_MAX_STAGES, (BWD_SMEM - w_bytes)
                            // (groups * 2 * row_bytes)))
    finish = -(-hidden // BWD_FINISH_COLS)
    if rows == 0:
        return BwdPlan(0, 0, warps, wpr, stages, width, finish)
    per_group = -(-rows // (sms * groups))
    rows_per_block = per_group * groups
    return BwdPlan(-(-rows // rows_per_block), rows_per_block, warps, wpr,
                   stages, width, finish)


# the forward plan's constants (csrc/layer_norm.cu): columns a thread
# holds at up to 8 warps a row, the most warps a block, the warps of a row
# past 8 x 1024 columns, 16-byte vectors a thread of many 16-byte rows,
# blocks an SM the 16-byte rows' form is compiled for by the vectors a
# thread holds (csrc's `FwdMinBlocks`; 1 for every other form), the
# shared memory of a 12-warp row's ring and w's and b's fp32 rows, the
# ring's most slots
FWD_COLS = 32
FWD_WARPS = 8
FWD_WIDE_WARPS = 12
FWD_VECS = 2
FWD_BLOCKS_PER_SM = {1: 4, 2: 2}
FWD_SMEM = 200 * 1024
FWD_MAX_STAGES = 8


class FwdPlan(NamedTuple):
    """What `csrc/layer_norm.cu`'s forward runs: `blocks` blocks of
    `warps` warps and `rows_per_block` rows (the last one short),
    `warps_per_row` warps a row, a ring of `stages` rows a row group (0:
    no ring, rows read straight from device memory), loads and stores
    `load_width` bytes wide."""
    blocks: int
    rows_per_block: int
    warps: int
    warps_per_row: int
    stages: int
    load_width: int


def _row_warps(hidden, cols, warps, wide_warps):
    """Warps a row: the fewest (a power of two) holding `hidden` at `cols`
    columns a thread, or past `warps` of them `wide_warps`."""
    wpr = 1
    while hidden > wpr * 32 * cols:
        wpr *= 2
    return wide_warps if wpr > warps else wpr


def _load_width(hidden, itemsize, align):
    """16 where the rows' bytes and `align` are 16-byte multiples, else 4
    where they are 4-byte multiples, else the element size."""
    row_bytes = hidden * itemsize
    if align % 16 == 0 and row_bytes % 16 == 0:
        return 16
    if align % 4 == 0 and row_bytes % 4 == 0:
        return 4
    return itemsize


def fwd_blocks_per_sm(hidden, itemsize, wpr, width):
    """Blocks an SM the forward kernel's form for rows of `hidden`
    `itemsize`-byte elements on `wpr` warps, loaded `width` bytes wide,
    is compiled for (its register cap): `FWD_BLOCKS_PER_SM` by the
    16-byte vectors a thread holds for 16-byte rows up to 8 warps, else
    1.  (Rows whose w or b is not a 16-byte aligned row of x's dtype run
    the narrow form under the same plan.)"""
    if width != 16 or wpr > FWD_WARPS:
        return 1
    vecs = -(-hidden * itemsize // (32 * wpr * 16))
    return FWD_BLOCKS_PER_SM.get(vecs, 1)


def fwd_plan(rows, hidden, itemsize, sms, align=16):
    """The forward kernel's plan for (rows, hidden) of `itemsize`-byte
    elements on a card of `sms` SMs, where `align` bytes divide every
    base and row stride of x and y.  A row takes the fewest warps (a
    power of two, up to `FWD_WARPS`) that hold a row of 16-byte multiples
    at `FWD_VECS` 16-byte vectors a thread (16 columns in 16-bit: 2 warps
    at hidden 1024), or at one for few rows (at most `FWD_WARPS` an SM:
    decode, prefill; 4 warps at hidden 1024, a shorter chain a row); other
    rows at up to `FWD_COLS` columns a thread; a block as many groups
    (up to `FWD_WARPS` warps) as spread the rows over the SMs, and each
    group a run of rows as even as whole rows a group allow over one wave
    of the blocks an SM that the kernel's form is compiled for
    (`fwd_blocks_per_sm`): one row a one-group block at decode's rows,
    runs of 12 rows of four two-warp groups a block, two blocks an SM, at
    GPT-350M's training rows.  Past
    `FWD_WARPS` such warps a row takes `FWD_WIDE_WARPS` on a block of its
    own, about one an SM over a run of rows, which stream through a ring
    of as many slots (at most `FWD_MAX_STAGES`) as `FWD_SMEM` holds
    beside w's and b's fp32 rows.  Rows whose bytes or bases are not
    16-byte multiples take 4- or 2-byte loads (no ring)."""
    if not 0 < hidden <= _MAX_HIDDEN:
        raise ValueError(f"LayerNorm forward kernel takes hidden in "
                         f"(0, {_MAX_HIDDEN}], got {hidden}")
    wpr = _row_warps(hidden, FWD_COLS, FWD_WARPS, FWD_WIDE_WARPS)
    width = _load_width(hidden, itemsize, align)
    if width == 16 and wpr != FWD_WIDE_WARPS:
        # 16-byte vectors a thread where 8 warps hold the row so
        vecs = 1 if rows <= sms * FWD_WARPS else FWD_VECS
        wpr = _row_warps(hidden, vecs * 16 // itemsize, FWD_WARPS,
                         FWD_WARPS)
    if rows == 0:
        return FwdPlan(0, 0, wpr, wpr, 0, width)
    if wpr == FWD_WIDE_WARPS:
        per_block = -(-rows // sms)
        stages = 0
        if width == 16:
            row_bytes = -(-hidden * itemsize // 16) * 16
            wb = 2 * -(-hidden // 8) * 32
            stages = max(1, min(FWD_MAX_STAGES, (FWD_SMEM - wb) // row_bytes))
        return FwdPlan(-(-rows // per_block), per_block, wpr, wpr, stages,
                       width)
    groups = min(FWD_WARPS // wpr, -(-rows // sms))
    per_sm = fwd_blocks_per_sm(hidden, itemsize, wpr, width)
    per_group = -(-rows // (sms * per_sm * groups))
    return FwdPlan(-(-rows // (per_group * groups)), per_group * groups,
                   groups * wpr, wpr, 0, width)


def _bind(lib):
    """`lib` (a build of csrc/layer_norm.cu) with its C entries' types."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_layer_norm_bwd.restype = i32
    lib.apex_layer_norm_bwd.argtypes = [
        i32, vp, i64, vp, i64, vp, vp, vp, i32, vp, i64, vp, vp, vp, vp, i32,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.apex_layer_norm_fwd.restype = i32
    lib.apex_layer_norm_fwd.argtypes = [
        i32, vp, i64, vp, i32, vp, i32, vp, i64, vp, vp, ctypes.c_float, i32,
        i32, i32, i32, i32, i32, i32, i32, i32, vp]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        _LIB = _bind(csrc.load("layer_norm"))
    return _LIB


def _align(*tensors):
    """The largest of 16, 4, 2 bytes dividing every base and row stride."""
    for a in (16, 4):
        if all(t.data_ptr() % a == 0 and t.stride(0) * t.element_size() % a
               == 0 for t in tensors):
            return a
    return 2


def _check_param(name, t, hidden):
    if t is not None and (tuple(t.shape) != (hidden,)
                          or not t.is_contiguous()
                          or t.dtype not in _DTYPE_CODES):
        raise ValueError(f"LayerNorm {name} must be contiguous ({hidden},) "
                         f"fp32/bf16/fp16, got {tuple(t.shape)} {t.dtype}")


def _launch_fwd(plan, x2, weight, bias, y, mean, rstd, eps, rms):
    """Launch the forward kernel on the current stream under `plan`: y,
    mean and rstd filled in place.  Counts the launch in
    `norm_fwd_cuda.launches`."""
    rows, hidden = x2.shape
    code = (lambda t: 0 if t is None else _DTYPE_CODES[t.dtype])
    err = _lib().apex_layer_norm_fwd(
        _DTYPE_CODES[x2.dtype], x2.data_ptr(), x2.stride(0),
        None if weight is None else weight.data_ptr(), code(weight),
        None if bias is None else bias.data_ptr(), code(bias), y.data_ptr(),
        y.stride(0), mean.data_ptr(), rstd.data_ptr(), eps, int(rms), rows,
        hidden, plan.blocks, plan.rows_per_block, plan.warps,
        plan.warps_per_row, plan.stages, plan.load_width,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"LayerNorm forward kernel launch failed (plan "
                           f"{tuple(plan)}): CUDA error {err}")
    norm_fwd_cuda.launches += 1


def norm_fwd_cuda(x2, weight, bias, eps, rms):
    """Launch the CUDA forward over a CUDA (rows, hidden) tensor whose
    last dim is contiguous, under `fwd_plan`.  Returns (y, mean, rstd)
    like `norm_fwd_reference`; `norm_fwd_cuda.launches` counts
    launches."""
    rows, hidden = x2.shape
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"LayerNorm kernel holds a row in registers: "
                         f"hidden {hidden} > {_MAX_HIDDEN}")
    if x2.stride(1) != 1:
        raise ValueError("LayerNorm kernel needs the hidden dim contiguous")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"LayerNorm forward kernel takes fp32/bf16/fp16 x, "
                        f"got {x2.dtype}")
    _check_param("weight", weight, hidden)
    _check_param("bias", bias, hidden)
    y = torch.empty((rows, hidden), dtype=x2.dtype, device=x2.device)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    if rows == 0:
        return y, mean, rstd
    plan = fwd_plan(rows, hidden, x2.element_size(), _sm_count(x2.device),
                    _align(x2, y))
    _launch_fwd(plan, x2, weight, bias, y, mean, rstd, eps, rms)
    return y, mean, rstd


norm_fwd_cuda.launches = 0


def _launch(plan, g2, x2, mean, rstd, weight, dx, dwdb, rms):
    """Launch the backward kernel (and its finishing pass) on the current
    stream under `plan`: dx, and with a weight dwdb = (dw, db) (2, hidden)
    fp32, filled in place.  Counts the launch in `norm_bwd_cuda.launches`."""
    rows, hidden = x2.shape
    pd = None
    if weight is not None:
        pd = torch.empty((2, plan.blocks, -(-hidden // 4) * 4),
                         dtype=torch.float32, device=x2.device)
    ptr = (lambda t, i: None if t is None else t[i].data_ptr())
    err = _lib().apex_layer_norm_bwd(
        _DTYPE_CODES[x2.dtype], g2.data_ptr(), g2.stride(0), x2.data_ptr(),
        x2.stride(0), mean.data_ptr(), rstd.data_ptr(),
        None if weight is None else weight.data_ptr(),
        0 if weight is None else _DTYPE_CODES[weight.dtype], dx.data_ptr(),
        dx.stride(0), ptr(pd, 0), ptr(pd, 1), ptr(dwdb, 0), ptr(dwdb, 1),
        int(rms), rows, hidden, plan.blocks, plan.rows_per_block,
        plan.warps, plan.warps_per_row, plan.stages, plan.load_width,
        plan.finish_blocks, torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"LayerNorm backward kernel launch failed "
                           f"(plan {tuple(plan)}): CUDA error {err}")
    norm_bwd_cuda.launches += 1


def norm_bwd_cuda(g2, x2, mean, rstd, weight, rms):
    """Launch the CUDA backward over CUDA (rows, hidden) tensors whose
    last dim is contiguous: returns (dx in x's dtype, fp32 dw, fp32 db),
    dw/db None without a weight.  One call launches the kernel under
    `bwd_plan` and, with a weight, its finishing pass;
    `norm_bwd_cuda.launches` counts calls."""
    rows, hidden = x2.shape
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"LayerNorm kernel holds a row in registers: "
                         f"hidden {hidden} > {_MAX_HIDDEN}")
    if g2.shape != x2.shape or g2.stride(1) != 1 or x2.stride(1) != 1:
        raise ValueError("LayerNorm backward needs g and x of one shape "
                         "with the hidden dim contiguous")
    if x2.dtype not in _DTYPE_CODES or g2.dtype != x2.dtype:
        raise TypeError(f"LayerNorm backward kernel takes g and x of one "
                        f"dtype in fp32/bf16/fp16, got {g2.dtype} and "
                        f"{x2.dtype}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or t.numel() != rows
                or not t.is_contiguous()):
            raise ValueError(f"LayerNorm backward {name} must be "
                             f"contiguous fp32 ({rows}, 1)")
    _check_param("weight", weight, hidden)
    dx = torch.empty((rows, hidden), dtype=x2.dtype, device=x2.device)
    dwdb = None
    if weight is not None:
        dwdb = torch.empty((2, hidden), dtype=torch.float32,
                           device=x2.device)
    if rows == 0:
        if dwdb is not None:
            dwdb.zero_()
    else:
        plan = bwd_plan(rows, hidden, x2.element_size(),
                        _sm_count(x2.device), _align(g2, x2, dx))
        _launch(plan, g2, x2, mean, rstd, weight, dx, dwdb, rms)
    if dwdb is None:
        return dx, None, None
    return dx, dwdb[0], dwdb[1]


norm_bwd_cuda.launches = 0


class _NormFn(torch.autograd.Function):
    """The kernels as one differentiable op over (rows, hidden):
    the forward saves x and the fp32 mean/rstd it computed; dw and db
    come back in the weight's and bias's dtypes (fp32 sums, one cast)."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps, rms):
        y, mean, rstd = norm_fwd_cuda(x2, weight, bias, eps, rms)
        ctx.save_for_backward(x2, weight, mean, rstd)
        ctx.rms = rms
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x2, weight, mean, rstd = ctx.saved_tensors
        g2 = gy if gy.stride(1) == 1 else gy.contiguous()
        dx, dw, db = norm_bwd_cuda(g2, x2, mean, rstd, weight, ctx.rms)
        if weight is not None:
            dw = dw.to(weight.dtype)
            db = None if ctx.bias_dtype is None else db.to(ctx.bias_dtype)
        return dx, dw, db, None, None


# --------------------------------- public API -------------------------------

def _norm(x, weight, bias, eps, rms):
    tensors = [t for t in (x, weight, bias) if t is not None]
    if not check_kernel_device(*tensors):
        if rms:
            return rms_norm_reference(x, weight, eps)
        return layer_norm_reference(x, weight, bias, eps)
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        y2 = _NormFn.apply(x2, weight, bias, eps, rms)
    else:
        y2, _, _ = norm_fwd_cuda(x2, weight, bias, eps, rms)
    return y2.reshape(x.shape)


def fused_layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Affine/plain LayerNorm over the last dim ≡ the JAX package's
    `fused_layer_norm`.  CPU tensors run the plain version; CUDA
    tensors run the CUDA kernels (the forward, and the backward when a
    gradient is needed) or raise."""
    return _norm(x, weight, bias, eps, False)


def fused_rms_norm(x, weight=None, eps: float = 1e-5):
    """RMSNorm over the last dim ≡ the JAX package's `fused_rms_norm`."""
    return _norm(x, weight, None, eps, True)


class FusedLayerNorm(nn.Module):
    """Module facade ≡ apex_tpu.ops.layer_norm.FusedLayerNorm (weight
    ones, bias zeros)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        if len(normalized_shape) != 1:
            raise NotImplementedError("only last-dim LayerNorm is supported")
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            h = self.normalized_shape[0]
            self.weight = nn.Parameter(
                torch.ones(h, device=device, dtype=dtype))
            self.bias = nn.Parameter(
                torch.zeros(h, device=device, dtype=dtype))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x):
        return fused_layer_norm(x, self.weight, self.bias, self.eps)


class FusedRMSNorm(nn.Module):
    """≡ apex_tpu.ops.layer_norm.FusedRMSNorm (weight ones)."""

    def __init__(self, normalized_shape, eps=1e-5, elementwise_affine=True,
                 *, device=None, dtype=torch.float32):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        if len(normalized_shape) != 1:
            raise NotImplementedError("only last-dim RMSNorm is supported")
        self.normalized_shape = tuple(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, device=device, dtype=dtype))
        else:
            self.register_parameter("weight", None)

    def forward(self, x):
        return fused_rms_norm(x, self.weight, self.eps)
