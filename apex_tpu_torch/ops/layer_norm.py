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
  * the Triton `_fwd_kernel`, launched by `norm_fwd_triton`, and the
    CUDA C++ backward in `apex_tpu_torch/csrc/layer_norm.cu`, launched by
    `norm_bwd_cuda` under the host plan `bwd_plan`, for CUDA tensors.  A
    CUDA call that needs a gradient goes through `_NormFn` (a
    `torch.autograd.Function`: the forward kernel saves x, mean and rstd,
    the backward kernel computes dx, dw, db); one that does not
    (`torch.inference_mode()`, `torch.no_grad()`, the serving engine)
    runs the forward kernel alone.

Forward kernel note.  Replaces apex_tpu/ops/layer_norm.py:_fwd_kernel
(launched by _fwd_pallas).  What bounds it on an H100: bytes — a row
reduction doing ~8 flops per element read.  Design: one program per row
holds the whole row (hidden masked up to the next power of two, at most
16384) in registers, so x is read once and y written once, with the
statistics reduced in fp32 in between; no tensor cores and no pipeline
to build.  Triton serves as well as CUDA C++ for this shape of work.

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

# triton.language, bound by `_jit` at the first launch: the kernels
# below are compiled only on a machine with a card, and importing this
# module must not need triton
tl = None

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


# ------------------------------- Triton forward ------------------------------

def _fwd_kernel(X, W, B, Y, Mean, Rstd, x_stride, y_stride, n_cols, eps,
                BLOCK: tl.constexpr, RMS: tl.constexpr,
                HAS_WEIGHT: tl.constexpr, HAS_BIAS: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    x = tl.load(X + row * x_stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    if RMS:
        mean = tl.sum(tl.zeros([BLOCK], dtype=tl.float32), axis=0)
        xc = x
    else:
        mean = tl.sum(x, axis=0) / n_cols
        xc = tl.where(mask, x - mean, 0.0)
    var = tl.sum(xc * xc, axis=0) / n_cols
    rstd = 1.0 / tl.sqrt(var + eps)
    y = xc * rstd
    if HAS_WEIGHT:
        w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
        y = y * w
    if HAS_BIAS:
        b = tl.load(B + cols, mask=mask, other=0.0).to(tl.float32)
        y = y + b
    tl.store(Y + row * y_stride + cols, y.to(Y.dtype.element_ty),
             mask=mask)
    tl.store(Mean + row, mean)
    tl.store(Rstd + row, rstd)


_JIT = {}


def _jit(fn):
    global tl
    if fn.__name__ not in _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT[fn.__name__] = triton.jit(fn)
    return _JIT[fn.__name__]


def norm_fwd_triton(x2, weight, bias, eps, rms):
    """Launch the Triton forward over a CUDA (rows, hidden) tensor whose
    last dim is contiguous.  Returns (y, mean, rstd) like
    `norm_fwd_reference`; `norm_fwd_triton.launches` counts launches."""
    rows, hidden = x2.shape
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"LayerNorm kernel holds a row in registers: "
                         f"hidden {hidden} > {_MAX_HIDDEN}")
    if x2.stride(1) != 1:
        raise ValueError("LayerNorm kernel needs the hidden dim contiguous")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (hidden,)
                              or not t.is_contiguous()):
            raise ValueError(f"LayerNorm {name} must be contiguous "
                             f"({hidden},), got {tuple(t.shape)}")
    y = torch.empty_like(x2)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    if rows == 0:
        return y, mean, rstd
    block = 1 << (hidden - 1).bit_length()
    num_warps = 4 if block <= 1024 else (8 if block <= 4096 else 16)
    _jit(_fwd_kernel)[(rows,)](
        x2, x2 if weight is None else weight, x2 if bias is None else bias,
        y, mean, rstd, x2.stride(0), y.stride(0), hidden, eps,
        BLOCK=block, RMS=rms, HAS_WEIGHT=weight is not None,
        HAS_BIAS=bias is not None, num_warps=num_warps)
    norm_fwd_triton.launches += 1
    return y, mean, rstd


norm_fwd_triton.launches = 0

# ------------------------------ CUDA backward -------------------------------

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
    wpr = 1
    while hidden > wpr * 32 * BWD_COLS:
        wpr *= 2
    if wpr > BWD_WARPS:
        wpr = BWD_WIDE_WARPS
    warps = max(wpr, BWD_WARPS)
    groups = warps // wpr
    row_bytes = hidden * itemsize
    if align % 16 == 0 and row_bytes % 16 == 0:
        width = 16
    elif align % 4 == 0 and row_bytes % 4 == 0:
        width = 4
    else:
        width = itemsize
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


def _bind(lib):
    """`lib` (a build of csrc/layer_norm.cu) with its C entry's types."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_layer_norm_bwd.restype = i32
    lib.apex_layer_norm_bwd.argtypes = [
        i32, vp, i64, vp, i64, vp, vp, vp, i32, vp, i64, vp, vp, vp, vp, i32,
        i32, i32, i32, i32, i32, i32, i32, i32, i32, vp]
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
    if weight is not None and (tuple(weight.shape) != (hidden,)
                               or not weight.is_contiguous()
                               or weight.dtype not in _DTYPE_CODES):
        raise ValueError(f"LayerNorm weight must be contiguous "
                         f"({hidden},) fp32/bf16/fp16, got "
                         f"{tuple(weight.shape)} {weight.dtype}")
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
        y, mean, rstd = norm_fwd_triton(x2, weight, bias, eps, rms)
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
        y2, _, _ = norm_fwd_triton(x2, weight, bias, eps, rms)
    return y2.reshape(x.shape)


def fused_layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Affine/plain LayerNorm over the last dim ≡ the JAX package's
    `fused_layer_norm`.  CPU tensors run the plain version; CUDA
    tensors run the kernels (the Triton forward, and the CUDA backward
    when a gradient is needed) or raise."""
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
