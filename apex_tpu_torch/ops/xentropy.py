"""Fused label-smoothed softmax cross entropy, forward and backward
(counterpart of apex_tpu/ops/xentropy.py).

Per row of (rows, V) logits: loss = lse(x) − (1−ε)·x[label] − ε·mean(x),
in fp32 whatever the logits' dtype; the forward keeps only the fp32
log-sum-exp for the backward, which rebuilds dx = g·(softmax(x) − q) with
q = (1−ε)·onehot + ε/V, in the logits' dtype.

Two implementations of each direction live here:

  * `xent_fwd_reference` / `xent_bwd_reference` — the plain PyTorch
    versions (and `softmax_cross_entropy_reference`, the JAX package's
    differentiable reference).  CPU tensors run them, and
    `chip_smoke.py` holds the kernels against them.
  * `_xent_fwd_kernel` and `_xent_bwd_kernel`, Triton kernels launched
    by `xent_fwd_triton` / `xent_bwd_triton` for CUDA tensors.

Both go through `_XentFn` (a `torch.autograd.Function`: the forward
saves the logits, labels and lse, the backward is the formula above),
as the JAX package's custom_vjp `_xent` does.

Kernel notes.  Replace apex_tpu/ops/xentropy.py `_fwd_kernel` and
`_bwd_kernel`.  What bounds them on an H100: bytes — the forward reads
the logits once (~6 flops an element), the backward reads them once and
writes dx once.  At the ResNet step's (256, 1000) fp32 logits that is
~1 MB, a fraction of a microsecond at 3.35 TB/s: the launch sets the
time.  The TPU kernels hold a block of whole rows; here the forward is
one program per row with a loop over the vocabulary in chunks of
`_FWD_BLOCK` (an online max and rescaled sum), so any V works, GPT's
50,304 as well as 1000; the label's logit is picked by a compare, as
the TPU kernel does.  The backward is one program per (row, chunk).
fp32 math, stores rounded to nearest-even.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops._common import check_kernel_device

# triton.language, bound by `_jit` at the first launch: the kernels are
# compiled only on a machine with a card, and importing this module must
# not need triton
tl = None

_FWD_BLOCK = 1024
_BWD_BLOCK = 1024


# --------------------------- plain PyTorch versions --------------------------

def softmax_cross_entropy_reference(logits, labels, smoothing=0.0):
    """Per-sample loss, fp32, differentiable by autograd (≡ the JAX
    package's reference); labels int, the logits' leading shape."""
    shape = logits.shape
    loss, _ = xent_fwd_reference(logits.reshape(-1, shape[-1]),
                                 labels.reshape(-1), smoothing)
    return loss.reshape(shape[:-1])


def xent_fwd_reference(x2, labels, smoothing):
    """The forward kernel's function in plain PyTorch over (rows, V):
    returns (fp32 loss (rows,), fp32 lse (rows,))."""
    x = x2.float()
    m = torch.amax(x, dim=1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(x - m), dim=1)) + m[:, 0]
    xl = torch.gather(x, 1, labels.long()[:, None])[:, 0]
    loss = lse - (1.0 - smoothing) * xl
    if smoothing:
        loss = loss - smoothing * torch.mean(x, dim=1)
    return loss, lse


def xent_bwd_reference(g, x2, labels, lse, smoothing):
    """The backward kernel's function in plain PyTorch: dx = g·(softmax −
    q) over (rows, V), in x2's dtype."""
    x = x2.float()
    p = torch.exp(x - lse[:, None])
    onehot = (torch.arange(x.shape[1], device=x.device)[None, :]
              == labels[:, None]).float()
    q = (1.0 - smoothing) * onehot
    if smoothing:
        q = q + smoothing / x.shape[1]
    return (g.float()[:, None] * (p - q)).to(x2.dtype)


# ------------------------------- Triton kernels ------------------------------

def _xent_fwd_kernel(X, LBL, LOSS, LSE, x_stride, n_cols, smoothing,
                     BLOCK: tl.constexpr, SMOOTH: tl.constexpr):
    # per-lane running max and rescaled sum, merged across lanes at the
    # end; a lane that has seen only masked (-inf) entries keeps s = 0
    row = tl.program_id(0).to(tl.int64)
    lbl = tl.load(LBL + row)
    base = X + row * x_stride
    m = tl.full([BLOCK], -float("inf"), tl.float32)
    s = tl.zeros([BLOCK], dtype=tl.float32)
    xl = tl.zeros([BLOCK], dtype=tl.float32)
    xsum = tl.zeros([BLOCK], dtype=tl.float32)
    for c0 in range(0, n_cols, BLOCK):
        cols = c0 + tl.arange(0, BLOCK)
        mask = cols < n_cols
        x = tl.load(base + cols, mask=mask,
                    other=-float("inf")).to(tl.float32)
        m_new = tl.maximum(m, x)
        m_ref = tl.where(m_new == -float("inf"), 0.0, m_new)
        s = s * tl.exp(m - m_ref) + tl.exp(x - m_ref)
        m = m_new
        xl += tl.where(cols == lbl, x, 0.0)
        if SMOOTH:
            xsum += tl.where(mask, x, 0.0)
    m_row = tl.max(m, axis=0)
    lse = tl.log(tl.sum(s * tl.exp(m - m_row), axis=0)) + m_row
    loss = lse - (1.0 - smoothing) * tl.sum(xl, axis=0)
    if SMOOTH:
        loss = loss - smoothing * (tl.sum(xsum, axis=0) / n_cols)
    tl.store(LOSS + row, loss)
    tl.store(LSE + row, lse)


def _xent_bwd_kernel(G, X, LBL, LSE, DX, x_stride, dx_stride, n_cols,
                     smoothing, BLOCK: tl.constexpr, SMOOTH: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = cols < n_cols
    g = tl.load(G + row)
    lse = tl.load(LSE + row)
    lbl = tl.load(LBL + row)
    x = tl.load(X + row * x_stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    p = tl.exp(x - lse)
    q = tl.where(cols == lbl, 1.0 - smoothing, 0.0)
    if SMOOTH:
        q = q + smoothing / n_cols
    dx = g * (p - q)
    tl.store(DX + row * dx_stride + cols,
             dx.to(DX.dtype.element_ty, fp_downcast_rounding="rtne"),
             mask=mask)


_JIT = {}


def _jit(fn):
    global tl
    if fn.__name__ not in _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT[fn.__name__] = triton.jit(fn)
    return _JIT[fn.__name__]


def _check(who, x2, labels, **rows):
    if x2.ndim != 2 or x2.stride(1) != 1 or not x2.dtype.is_floating_point:
        raise ValueError(f"{who} needs float (rows, V) logits with V "
                         f"contiguous, got {tuple(x2.shape)} {x2.dtype}")
    n = x2.shape[0]
    for name, t in dict(rows, labels=labels).items():
        if t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{who} needs a contiguous ({n},) {name}, got "
                             f"{tuple(t.shape)}")
    if labels.dtype != torch.int32:
        raise TypeError(f"{who} labels must be int32, got {labels.dtype}")


def xent_fwd_triton(x2, labels, smoothing):
    """Launch the forward kernel over CUDA (rows, V) logits and int32
    labels: returns (fp32 loss, fp32 lse), each (rows,).
    `xent_fwd_triton.launches` counts launches."""
    _check("cross-entropy forward", x2, labels)
    rows, v = x2.shape
    loss = torch.empty(rows, dtype=torch.float32, device=x2.device)
    lse = torch.empty_like(loss)
    if rows:
        _jit(_xent_fwd_kernel)[(rows,)](
            x2, labels, loss, lse, x2.stride(0), v, float(smoothing),
            BLOCK=_FWD_BLOCK, SMOOTH=bool(smoothing), num_warps=4)
    xent_fwd_triton.launches += 1
    return loss, lse


xent_fwd_triton.launches = 0


def xent_bwd_triton(g, x2, labels, lse, smoothing):
    """Launch the backward kernel: dx (rows, V) in the logits' dtype from
    fp32 g and lse (rows,).  `xent_bwd_triton.launches` counts
    launches."""
    _check("cross-entropy backward", x2, labels, g=g, lse=lse)
    if g.dtype != torch.float32 or lse.dtype != torch.float32:
        raise TypeError("cross-entropy backward needs fp32 g and lse")
    rows, v = x2.shape
    dx = torch.empty_like(x2, memory_format=torch.contiguous_format)
    if rows:
        _jit(_xent_bwd_kernel)[(rows, -(-v // _BWD_BLOCK))](
            g, x2, labels, lse, dx, x2.stride(0), dx.stride(0), v,
            float(smoothing), BLOCK=_BWD_BLOCK, SMOOTH=bool(smoothing),
            num_warps=4)
    xent_bwd_triton.launches += 1
    return dx


xent_bwd_triton.launches = 0


class _XentFn(torch.autograd.Function):
    """Per-row loss over (rows, V) logits: the forward saves (logits,
    labels, lse), the backward is g·(softmax − q) (≡ `_xent_fwd` /
    `_xent_bwd` of the JAX package).  CUDA tensors run the kernels, CPU
    tensors the plain versions."""

    @staticmethod
    def forward(ctx, x2, labels, smoothing):
        if check_kernel_device(x2, labels):
            loss, lse = xent_fwd_triton(x2, labels, smoothing)
        else:
            loss, lse = xent_fwd_reference(x2, labels, smoothing)
        ctx.save_for_backward(x2, labels, lse)
        ctx.smoothing = smoothing
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if check_kernel_device(x2, labels):
            dx = xent_bwd_triton(g, x2, labels, lse, ctx.smoothing)
        else:
            dx = xent_bwd_reference(g, x2, labels, lse, ctx.smoothing)
        return dx, None, None


# --------------------------------- public API -------------------------------

def softmax_cross_entropy_loss(logits, labels, smoothing: float = 0.0):
    """Per-sample label-smoothed cross entropy, fp32 (≡ the JAX package's
    `softmax_cross_entropy_loss`, itself ≡ apex.contrib.xentropy's
    `SoftmaxCrossEntropyLoss.apply`).  Leading dims are batch, the last
    is the vocabulary.  CPU tensors run the plain versions; CUDA tensors
    run the Triton kernels or raise."""
    shape = logits.shape
    x2 = logits.reshape(-1, shape[-1])
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    lbl = labels.reshape(-1).to(torch.int32).contiguous()
    return _XentFn.apply(x2, lbl, float(smoothing)).reshape(shape[:-1])


SoftmaxCrossEntropyLoss = softmax_cross_entropy_loss
