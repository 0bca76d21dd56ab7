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
  * `_fwd_kernel` and `_bwd_kernel` (+ `_bwd_finish_kernel`), Triton
    kernels launched by `norm_fwd_triton` / `norm_bwd_triton` for CUDA
    tensors.  A CUDA call that needs a gradient goes through `_NormFn`
    (a `torch.autograd.Function`: the forward kernel saves x, mean and
    rstd, the backward kernel computes dx, dw, db); one that does not
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
written once, ~12 flops per element.  The TPU kernel accumulates dw and
db across its sequential grid; blocks on the card run in any order, so
each program of `_bwd_kernel` walks a fixed run of rows, keeps its dw/db
partial rows in fp32 registers and writes them out, and
`_bwd_finish_kernel` sums the partials in a fixed order.  No atomics:
the result is deterministic.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops._common import check_kernel_device

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


# ------------------------------- Triton kernel ------------------------------

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


def _bwd_kernel(G, X, Mean, Rstd, W, DX, DWP, DBP, g_stride, x_stride,
                dx_stride, n_rows, n_cols, rows_per_prog,
                BLOCK: tl.constexpr, RMS: tl.constexpr,
                HAS_WEIGHT: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK)
    mask = cols < n_cols
    if HAS_WEIGHT:
        w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    dw_acc = tl.zeros([BLOCK], dtype=tl.float32)
    db_acc = tl.zeros([BLOCK], dtype=tl.float32)
    row0 = pid * rows_per_prog
    for row in range(row0, tl.minimum(row0 + rows_per_prog, n_rows)):
        r = row.to(tl.int64)
        g = tl.load(G + r * g_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        x = tl.load(X + r * x_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        mean = tl.load(Mean + r)
        rstd = tl.load(Rstd + r)
        xhat = tl.where(mask, (x - mean) * rstd, 0.0)
        wg = g
        if HAS_WEIGHT:
            wg = g * w
        c2 = tl.sum(wg * xhat, axis=0) / n_cols
        if RMS:
            dx = rstd * (wg - xhat * c2)
        else:
            c1 = tl.sum(wg, axis=0) / n_cols
            dx = rstd * (wg - c1 - xhat * c2)
        tl.store(DX + r * dx_stride + cols, dx.to(DX.dtype.element_ty),
                 mask=mask)
        if HAS_WEIGHT:
            dw_acc += g * xhat
            db_acc += g
    if HAS_WEIGHT:
        tl.store(DWP + pid * n_cols + cols, dw_acc, mask=mask)
        tl.store(DBP + pid * n_cols + cols, db_acc, mask=mask)


def _bwd_finish_kernel(DWP, DBP, DW, DB, n_parts, n_cols,
                       PARTS: tl.constexpr, BLOCK_N: tl.constexpr):
    """dw, db = the column sums of the (n_parts, n_cols) partials, in a
    fixed order (PARTS rows at a time)."""
    cols = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
    cmask = cols < n_cols
    parts = tl.arange(0, PARTS)
    dw = tl.zeros([BLOCK_N], dtype=tl.float32)
    db = tl.zeros([BLOCK_N], dtype=tl.float32)
    for p0 in range(0, n_parts, PARTS):
        rows = p0 + parts
        m = (rows[:, None] < n_parts) & cmask[None, :]
        off = rows[:, None] * n_cols + cols[None, :]
        dw += tl.sum(tl.load(DWP + off, mask=m, other=0.0), axis=0)
        db += tl.sum(tl.load(DBP + off, mask=m, other=0.0), axis=0)
    tl.store(DW + cols, dw, mask=cmask)
    tl.store(DB + cols, db, mask=cmask)


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

# the backward splits the rows into at most this many runs, one program
# each, whose dw/db partial rows the finishing pass sums
_BWD_PARTS = 512


def norm_bwd_triton(g2, x2, mean, rstd, weight, rms):
    """Launch the Triton backward over CUDA (rows, hidden) tensors whose
    last dim is contiguous: returns (dx in x's dtype, fp32 dw, fp32 db),
    dw/db None without a weight.  One call launches `_bwd_kernel` and,
    with a weight, `_bwd_finish_kernel`; `norm_bwd_triton.launches`
    counts calls."""
    rows, hidden = x2.shape
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"LayerNorm kernel holds a row in registers: "
                         f"hidden {hidden} > {_MAX_HIDDEN}")
    if g2.shape != x2.shape or g2.stride(1) != 1 or x2.stride(1) != 1:
        raise ValueError("LayerNorm backward needs g and x of one shape "
                         "with the hidden dim contiguous")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or t.numel() != rows
                or not t.is_contiguous()):
            raise ValueError(f"LayerNorm backward {name} must be "
                             f"contiguous fp32 ({rows}, 1)")
    if weight is not None and (tuple(weight.shape) != (hidden,)
                               or not weight.is_contiguous()):
        raise ValueError(f"LayerNorm weight must be contiguous "
                         f"({hidden},), got {tuple(weight.shape)}")
    dx = torch.empty_like(x2)
    has_w = weight is not None
    dw = db = None
    if rows == 0:
        if has_w:
            dw = torch.zeros(hidden, dtype=torch.float32, device=x2.device)
            db = torch.zeros_like(dw)
        return dx, dw, db
    rows_per_prog = -(-rows // _BWD_PARTS)
    n_parts = -(-rows // rows_per_prog)
    if has_w:
        dwp = torch.empty((n_parts, hidden), dtype=torch.float32,
                          device=x2.device)
        dbp = torch.empty_like(dwp)
    else:
        dwp = dbp = dx
    block = 1 << (hidden - 1).bit_length()
    num_warps = 4 if block <= 1024 else (8 if block <= 4096 else 16)
    _jit(_bwd_kernel)[(n_parts,)](
        g2, x2, mean, rstd, x2 if weight is None else weight, dx, dwp, dbp,
        g2.stride(0), x2.stride(0), dx.stride(0), rows, hidden,
        rows_per_prog, BLOCK=block, RMS=rms, HAS_WEIGHT=has_w,
        num_warps=num_warps)
    if has_w:
        dw = torch.empty(hidden, dtype=torch.float32, device=x2.device)
        db = torch.empty_like(dw)
        block_n = 32
        _jit(_bwd_finish_kernel)[(-(-hidden // block_n),)](
            dwp, dbp, dw, db, n_parts, hidden, PARTS=32, BLOCK_N=block_n,
            num_warps=4)
    norm_bwd_triton.launches += 1
    return dx, dw, db


norm_bwd_triton.launches = 0


class _NormFn(torch.autograd.Function):
    """The Triton kernels as one differentiable op over (rows, hidden):
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
        dx, dw, db = norm_bwd_triton(g2, x2, mean, rstd, weight, ctx.rms)
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
    tensors run the Triton kernels (forward, and backward when a
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
