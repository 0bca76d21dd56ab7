"""Fused optimizer kernels over flat 1-D buffers (counterpart of
apex_tpu/ops/optimizer_kernels.py; only the uniform Adam/AdamW update
is ported so far).

`adam_flat` applies one Adam/AdamW step to flat param / exp_avg /
exp_avg_sq buffers IN PLACE (the port's answer to JAX's donation), from
a flat grad buffer of any float dtype.  The overflow skip and the bias
correction are folded into nine scalars by `_adam_fold_scalars`, the one
place they are defined; the scalars stay a small device tensor, so a
`found_inf` or `step` that lives on the card causes no host sync.

Two implementations of the update:

  * `_adam_reference` — the plain PyTorch version (pure: returns new
    tensors).  `adam_flat` runs it for CPU tensors and copies the result
    back into the buffers; `chip_smoke.py` holds the kernel against it.
  * `_adam_kernel`, a Triton kernel launched by `adam_flat_triton` for
    CUDA tensors.

Kernel note.  Replaces apex_tpu/ops/optimizer_kernels.py:_adam_kernel
(launched by adam_flat).  What bounds it on an H100: bytes — per
element it reads p, m, v and g and writes p, m, v (14 bytes with bf16
state and grads, 28 with fp32 state) for ~15 flops.  Design: one program
per 4096-element block, masked loads so any length works (a
`FLAT_TILE`-padded buffer has a zero tail that stays zero), the nine
scalars read once per program, fp32 math, and the stores rounded to
nearest-even (`rtne`, as `tensor.to(torch.bfloat16)` rounds).  The
square root and the divide are the IEEE ones (`sqrt_rn`, `div_rn`), not
the approximate defaults, so the kernel computes the plain version's
arithmetic.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops._common import check_kernel_device

# triton.language, bound by `_adam_kernel_jit` at the first launch: the
# kernel is compiled only on a machine with a card, and importing this
# module must not need triton
tl = None

_LANES = 128
_BLOCK_ROWS = 512
# flat buffers are padded to this length multiple at optimizer init
# (flat.flatten(pad_to=...)), as in the JAX package
FLAT_TILE = _BLOCK_ROWS * _LANES

_BLOCK = 4096


def device_scalar(x, dtype, device):
    """`x` as a 0-d `dtype` tensor on `device`: a tensor is converted
    where it lies, a Python number is filled in on the device.  Never a
    host-to-device copy of a Python number, which would make the host
    wait for the card."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _adam_fold_scalars(lr, step, beta1, beta2, bias_correction, inv_scale,
                       found_inf, device=None):
    """The nine folded scalars [lr_eff, inv_scale, b1e, c1, b2e, c2,
    rbc1, rbc2, found] as an fp32 device tensor (≡ the JAX package's
    `_adam_fold_scalars`).  found_inf sets lr_eff=0, b*e=1, c*=0 so the
    state is kept; the clamp (bc >= 1e-20) keeps 1/bc finite when
    found_inf skips the very first step (step 0)."""
    f32 = torch.float32

    def t(x):
        return device_scalar(x, f32, device)

    step = t(step)
    keep = device_scalar(found_inf, torch.bool, device)
    bc1 = torch.clamp_min(1.0 - torch.pow(t(beta1), step), 1e-20)
    bc2 = torch.clamp_min(1.0 - torch.pow(t(beta2), step), 1e-20)
    one, zero = t(1.0), t(0.0)
    return torch.stack([
        torch.where(keep, zero, t(lr)),              # lr_eff
        t(inv_scale),
        torch.where(keep, one, t(beta1)),            # b1e
        torch.where(keep, zero, 1.0 - t(beta1)),     # c1
        torch.where(keep, one, t(beta2)),            # b2e
        torch.where(keep, zero, 1.0 - t(beta2)),     # c2
        one / bc1 if bias_correction else one,       # rbc1
        one / bc2 if bias_correction else one,       # rbc2
        keep.to(f32),                                # found
    ])


# --------------------------- plain PyTorch version ---------------------------

def _adam_reference(p, m, v, g, scalars, eps, weight_decay, adam_w_mode):
    """The folded-scalar update of `_adam_kernel` in plain PyTorch;
    returns (p, m, v) new, in their own dtypes."""
    (lr_eff, inv_scale, b1e, c1, b2e, c2, rbc1, rbc2,
     found) = scalars.unbind(0)
    g = torch.where(found > 0.5, 0.0, g.float() * inv_scale)
    p32 = p.float()
    if not adam_w_mode and weight_decay:
        g = g + weight_decay * p32
    m_new = b1e * m.float() + c1 * g
    v_new = b2e * v.float() + c2 * (g * g)
    update = (m_new * rbc1) / (torch.sqrt(v_new * rbc2) + eps)
    if adam_w_mode and weight_decay:
        update = update + weight_decay * p32
    p_new = p32 - lr_eff * update
    return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


# ------------------------------- Triton kernel ------------------------------

def _adam_kernel(P, M, V, G, S, n, eps, weight_decay,
                 WD_MODE: tl.constexpr, BLOCK: tl.constexpr):
    # WD_MODE: 0 no weight decay, 1 L2 (Adam), 2 decoupled (AdamW)
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    lr_eff = tl.load(S + 0)
    inv_scale = tl.load(S + 1)
    b1e = tl.load(S + 2)
    c1 = tl.load(S + 3)
    b2e = tl.load(S + 4)
    c2 = tl.load(S + 5)
    rbc1 = tl.load(S + 6)
    rbc2 = tl.load(S + 7)
    found = tl.load(S + 8)
    g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    m = tl.load(M + offs, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(V + offs, mask=mask, other=0.0).to(tl.float32)
    # the one select: inf/nan grads would poison m/v through 0 * inf
    g = tl.where(found > 0.5, 0.0, g * inv_scale)
    if WD_MODE == 1:
        g = g + weight_decay * p
    m_new = b1e * m + c1 * g
    v_new = b2e * v + c2 * (g * g)
    update = tl.div_rn(m_new * rbc1, tl.sqrt_rn(v_new * rbc2) + eps)
    if WD_MODE == 2:
        update = update + weight_decay * p
    p_new = p - lr_eff * update
    tl.store(P + offs, p_new.to(P.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(M + offs, m_new.to(M.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(V + offs, v_new.to(V.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)


_JIT = None


def _adam_kernel_jit():
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_adam_kernel)
    return _JIT


_STATE_DTYPES = (torch.float32, torch.bfloat16)


def adam_flat_triton(p, m, v, g, scalars, eps, weight_decay, adam_w_mode):
    """Launch the Triton Adam kernel over CUDA flat buffers, updating p,
    m and v in place.  `adam_flat_triton.launches` counts launches."""
    n = p.numel()
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.ndim != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"adam kernel needs contiguous 1-D buffers of "
                             f"one length; {name} is {tuple(t.shape)}")
        if name != "g" and t.dtype not in _STATE_DTYPES:
            raise TypeError(f"adam kernel state is fp32 or bf16, {name} is "
                            f"{t.dtype}")
    if not g.dtype.is_floating_point:
        raise TypeError(f"adam kernel grads must be float, got {g.dtype}")
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (9,):
        raise ValueError("adam kernel scalars must be fp32 (9,)")
    if n == 0:
        return p, m, v
    grid = (-(-n // _BLOCK),)
    _adam_kernel_jit()[grid](
        p, m, v, g, scalars, n, float(eps), float(weight_decay),
        WD_MODE=0 if weight_decay == 0.0 else (2 if adam_w_mode else 1),
        BLOCK=_BLOCK, num_warps=8)
    adam_flat_triton.launches += 1
    return p, m, v


adam_flat_triton.launches = 0


# --------------------------------- public API -------------------------------

def adam_flat(p, m, v, g, lr, step, *, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.0, adam_w_mode=True, bias_correction=True,
              inv_scale=1.0, found_inf=False):
    """One fused Adam/AdamW step on flat buffers, IN PLACE (≡ the JAX
    package's `adam_flat`, which returns new buffers under donation).
    `step` and `found_inf` may be device tensors.  Returns (p, m, v) —
    the same tensors, updated.  CPU tensors run the plain version; CUDA
    tensors run the Triton kernel or raise."""
    scalars = _adam_fold_scalars(lr, step, beta1, beta2, bias_correction,
                                 inv_scale, found_inf, device=p.device)
    if not check_kernel_device(p, m, v, g):
        pn, mn, vn = _adam_reference(p, m, v, g, scalars, eps,
                                     weight_decay, adam_w_mode)
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return p, m, v
    return adam_flat_triton(p, m, v, g, scalars, eps, weight_decay,
                            adam_w_mode)
