"""Fused LayerNorm / RMSNorm forward (counterpart of apex_tpu/ops/layer_norm.py).

Statistics are fp32 whatever the input dtype, the variance is centred
(mean of (x - mean)^2, not E[x^2] - mean^2), and the forward also yields
the fp32 mean and rstd per row that the backward will need.

Two implementations of the forward live here:

  * `norm_fwd_reference` — the plain PyTorch version (and the
    `layer_norm_reference` / `rms_norm_reference` spellings of the JAX
    package).  It runs for CPU tensors, and `chip_smoke.py` holds the
    kernel against it.
  * `_fwd_kernel`, a Triton kernel launched by `norm_fwd_triton` for
    CUDA tensors.

Kernel note.  Replaces apex_tpu/ops/layer_norm.py:_fwd_kernel (launched
by _fwd_pallas).  What bounds it on an H100: bytes — a row reduction
doing ~8 flops per element read.  Design: one program per row holds the
whole row (hidden masked up to the next power of two, at most 16384) in
registers, so x is read once and y written once, with the statistics
reduced in fp32 in between; no tensor cores and no pipeline to build.
Triton serves as well as CUDA C++ for this shape of work.

The backward kernel (`_bwd_kernel` in the JAX package) comes with the
training slice.  Until then a CUDA call that needs a gradient raises
NotImplementedError; the serving engine runs under
`torch.inference_mode()`.
"""

from __future__ import annotations

import torch
from torch import nn

from apex_tpu_torch.ops._common import check_kernel_device

# triton.language, bound by `_fwd_kernel_jit` at the first launch: the
# kernel below is compiled only on a machine with a card, and importing
# this module must not need triton
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


_JIT = None


def _fwd_kernel_jit():
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_fwd_kernel)
    return _JIT


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
    _fwd_kernel_jit()[(rows,)](
        x2, x2 if weight is None else weight, x2 if bias is None else bias,
        y, mean, rstd, x2.stride(0), y.stride(0), hidden, eps,
        BLOCK=block, RMS=rms, HAS_WEIGHT=weight is not None,
        HAS_BIAS=bias is not None, num_warps=num_warps)
    norm_fwd_triton.launches += 1
    return y, mean, rstd


norm_fwd_triton.launches = 0


# --------------------------------- public API -------------------------------

def _norm(x, weight, bias, eps, rms):
    tensors = [t for t in (x, weight, bias) if t is not None]
    if not check_kernel_device(*tensors):
        if rms:
            return rms_norm_reference(x, weight, eps)
        return layer_norm_reference(x, weight, bias, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "LayerNorm/RMSNorm backward on CUDA (the port of "
            "apex_tpu/ops/layer_norm.py:_bwd_kernel) comes with the "
            "training slice; call under torch.inference_mode() or "
            "torch.no_grad()")
    x2 = x.reshape(-1, x.shape[-1])
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    y2, _, _ = norm_fwd_triton(x2, weight, bias, eps, rms)
    return y2.reshape(x.shape)


def fused_layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """Affine/plain LayerNorm over the last dim ≡ the JAX package's
    `fused_layer_norm`.  CPU tensors run the plain version; CUDA
    tensors run the Triton kernel or raise."""
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
