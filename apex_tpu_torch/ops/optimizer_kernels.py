"""Fused optimizer kernels over flat 1-D buffers (counterpart of
apex_tpu/ops/optimizer_kernels.py; the uniform Adam/AdamW update, Adam
with per-tensor weight decay and lr scales, the two LAMB phases with
their per-tensor norms and SGD with momentum are ported so far — all but
the uniform Adam are described at their sections below).

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

import functools

import numpy as np
import torch

from apex_tpu_torch.ops._common import check_kernel_device

# triton.language, bound by `_jit` at the first launch: the
# kernels are compiled only on a machine with a card, and importing this
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


_JIT = {}


def _jit(fn):
    global tl
    if fn.__name__ not in _JIT:
        import triton
        import triton.language

        tl = triton.language
        _JIT[fn.__name__] = triton.jit(fn)
    return _JIT[fn.__name__]


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
    _jit(_adam_kernel)[grid](
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


# ------------------------- Adam with per-tensor groups -----------------------
#
# `adam_flat_seg` (≡ the JAX package's `adam_flat_seg`) is `adam_flat` with
# a weight decay and an lr multiplier per tensor: the param groups of
# apex's FusedAdam (Megatron's no-decay group for biases and norms, or
# per-layer lr scales) in one pass.  The buffers are laid out by a
# lane-aligned spec, so a tensor is a run of rows of 128 and the kernel
# finds a row's values through `segment_tables(spec, n_rows)["seg"]` and
# the per-tensor tables built by `_table`.  Padding rows get the dummy
# tensor id, whose weight decay AND lr scale are 0: the zero tail never
# moves.  L2 mode adds wd·p to the gradient, AdamW mode to the update;
# p -= (lr_eff · lr_scale) · update.
#
# Kernel note.  Replaces apex_tpu/ops/optimizer_kernels.py:_adam_seg_kernel
# (launched by adam_flat_seg).  What bounds it on an H100: bytes — per
# element it reads p, m, v, g and writes p, m, v (14 bytes with bf16 state
# and grads), plus 4 bytes of tensor id per row of 128, for ~17 flops.
# Design: `_adam_kernel`'s body over programs of 32 rows of 128, with the
# per-row wd and lr scale gathered from the two tables (the TPU kernel
# rebuilds them with a one-hot product on the MXU); the nine folded
# scalars are read once per program from a device tensor, so the step
# makes no host sync.  fp32 math with the IEEE square root and divide,
# stores rounded to nearest-even and fp-contraction off: the kernel
# evaluates the plain version's operations one by one, and the two agree
# bit for bit.

def _adam_seg_reference(p, m, v, g, scalars, eps, adam_w_mode, wd_rows,
                        lrs_rows):
    """The segmented update in plain PyTorch with the per-row (fp32, one
    value per row of 128) weight decay and lr scale (≡ the JAX package's
    `_adam_seg_reference`, which takes them per element); returns
    (p, m, v) new, in their own dtypes."""
    (lr_eff, inv_scale, b1e, c1, b2e, c2, rbc1, rbc2,
     found) = scalars.unbind(0)
    wd = wd_rows[:, None]
    g = torch.where(found > 0.5, 0.0,
                    g.float().view(-1, _LANES) * inv_scale)
    p32 = p.float().view(-1, _LANES)
    if not adam_w_mode:
        g = g + wd * p32
    m_new = b1e * m.float().view(-1, _LANES) + c1 * g
    v_new = b2e * v.float().view(-1, _LANES) + c2 * (g * g)
    update = (m_new * rbc1) / (torch.sqrt(v_new * rbc2) + eps)
    if adam_w_mode:
        update = update + wd * p32
    p_new = p32 - (lr_eff * lrs_rows)[:, None] * update
    return (p_new.view(-1).to(p.dtype), m_new.view(-1).to(m.dtype),
            v_new.view(-1).to(v.dtype))


def _adam_seg_kernel(P, M, V, G, S, SEG, WDT, LRT, n, eps,
                     ADAM_W: tl.constexpr, ROWS: tl.constexpr,
                     LANES: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    offs = rows.to(tl.int64)[:, None] * LANES + tl.arange(0, LANES)[None, :]
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
    seg = tl.load(SEG + rows, mask=rows * LANES < n, other=0)
    wd = tl.load(WDT + seg)[:, None]
    step = (lr_eff * tl.load(LRT + seg))[:, None]      # lr · scale, per row
    g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    m = tl.load(M + offs, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(V + offs, mask=mask, other=0.0).to(tl.float32)
    # the one select: inf/nan grads would poison m/v through 0 * inf
    g = tl.where(found > 0.5, 0.0, g * inv_scale)
    if not ADAM_W:
        g = g + wd * p
    m_new = b1e * m + c1 * g
    v_new = b2e * v + c2 * (g * g)
    update = tl.div_rn(m_new * rbc1, tl.sqrt_rn(v_new * rbc2) + eps)
    if ADAM_W:
        update = update + wd * p
    p_new = p - step * update
    tl.store(P + offs, p_new.to(P.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(M + offs, m_new.to(M.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(V + offs, v_new.to(V.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)


def adam_flat_seg_triton(p, m, v, g, scalars, eps, adam_w_mode, seg, wdt,
                         lrt):
    """Launch the segmented Adam kernel over CUDA flat buffers, updating
    p, m and v in place: `seg` the int32 tensor id per row, `wdt` and
    `lrt` the fp32 per-tensor weight decay and lr scale (dummy 0 last).
    `adam_flat_seg_triton.launches` counts launches."""
    n = _check_flat("adam seg kernel", _LANES, p=p, m=m, v=v, g=g)
    _check_scalars("adam seg kernel", scalars, 9)
    if seg.dtype != torch.int32 or seg.numel() != n // _LANES:
        raise ValueError("adam seg kernel needs an int32 tensor id per row")
    if wdt.numel() != lrt.numel():
        raise ValueError("adam seg kernel: wd and lr-scale tables differ in "
                         "length")
    if n:
        _jit(_adam_seg_kernel)[(-(-n // (_ROWS * _LANES)),)](
            p, m, v, g, scalars, seg, wdt, lrt, n, float(eps),
            ADAM_W=bool(adam_w_mode), ROWS=_ROWS, LANES=_LANES, num_warps=8,
            enable_fp_fusion=False)
    adam_flat_seg_triton.launches += 1
    return p, m, v


adam_flat_seg_triton.launches = 0


def adam_flat_seg(p, m, v, g, lr, step, *, wd_values, lr_scale_values, spec,
                  beta1=0.9, beta2=0.999, eps=1e-8, adam_w_mode=True,
                  bias_correction=True, inv_scale=1.0, found_inf=False):
    """`adam_flat` with per-tensor weight decay `wd_values` and lr scale
    `lr_scale_values` ((n_tensors,) each, device tensors or arrays),
    looked up per row from the lane-aligned `spec` (≡ the JAX package's
    `adam_flat_seg` on one device), IN PLACE.  Returns (p, m, v) — the
    same tensors, updated.  CPU tensors run the plain version; CUDA
    tensors run the Triton kernel or raise."""
    scalars = _adam_fold_scalars(lr, step, beta1, beta2, bias_correction,
                                 inv_scale, found_inf, device=p.device)
    wdt = _table(wd_values, p.device)
    lrt = _table(lr_scale_values, p.device)
    for what, t in (("wd values", wdt), ("lr scales", lrt)):
        if t.numel() != len(spec.sizes) + 1:
            raise ValueError(f"{t.numel() - 1} {what} for "
                             f"{len(spec.sizes)} tensors")
    seg = segment_tables(spec, p.numel() // _LANES, p.device)["seg"]
    if not check_kernel_device(p, m, v, g):
        rows = seg.long()
        pn, mn, vn = _adam_seg_reference(p, m, v, g, scalars, eps,
                                         adam_w_mode, wdt[rows], lrt[rows])
        p.copy_(pn)
        m.copy_(mn)
        v.copy_(vn)
        return p, m, v
    return adam_flat_seg_triton(p, m, v, g, scalars, eps, adam_w_mode, seg,
                                wdt, lrt)


# ------------------------------ LAMB (two-phase) -----------------------------
#
# FusedLAMB's step is five passes over the flat buffers (counterpart of
# the JAX package's `lamb_phase1_flat` / `lamb_phase1_seg`,
# `per_tensor_l2norm_aligned` and `lamb_phase2_seg`):
#
#   phase 1   m, v updated IN PLACE; u = m̂ / (√v̂ + eps) + wd · p written to
#             a new buffer in p's dtype.  Global-norm clipping, inv_scale,
#             the overflow skip and bias correction are folded into eight
#             scalars by `_lamb_fold_scalars` (a device tensor: no sync).
#   norms     ‖p‖ and ‖u‖ per tensor (`per_tensor_l2norm_aligned`).
#   phase 2   p -= lr · ratio[tensor] · u, IN PLACE, with the per-tensor
#             trust ratio.
#
# The buffers are laid out by a lane-aligned spec (`make_spec(align=128)`):
# every tensor owns whole rows of 128 elements, so a tensor is a run of
# rows.  `segment_tables(spec, n_rows)` turns the spec into the lookups
# the kernels read, built once per spec and kept on the card: an int32
# tensor id per row (tail-padding rows get the dummy id n_tensors, whose
# wd and ratio are 0), and the row ranges of the norm pass's work items.
#
# Kernel notes.  Replace apex_tpu/ops/optimizer_kernels.py
# `_lamb_phase1_kernel` and `_lamb_phase1_seg_kernel` (this module's
# `_lamb_phase1_kernel`, specialised by SEGMENTED), `_lamb_phase2_seg_kernel`
# and `_rows_sumsq_seg_kernel` (this module's `_sumsq_items_kernel` plus
# `_sumsq_segments_kernel`).  What bounds them on an H100: bytes.  Phase 1
# reads m, v, g, p and writes m, v, u (14 bytes an element with bf16 state
# and grads) for ~20 flops; phase 2 reads p, u and writes p; a norm reads
# its buffer once.  Design:
#   * The TPU kernels rebuild each block's segment membership with a
#     one-hot product on the MXU.  Here a program of 32 rows reads their 32
#     tensor ids (4 bytes per 128 elements) and gathers the per-tensor wd or
#     ratio from a table of n_tensors + 1 values, then broadcasts it along
#     the row: no per-element wd or ratio vector ever exists in memory.
#   * The scalars are read once per program.  fp32 math with the IEEE
#     square root and divide (`sqrt_rn`, `div_rn`), stores rounded to
#     nearest-even, and fp-contraction off: each kernel evaluates the plain
#     version's operations one by one, so the two agree bit for bit.
#   * The per-tensor sums of squares are deterministic: no atomics.  The
#     TPU kernel carries one accumulator across its sequential grid; blocks
#     on the card run in any order, so the rows are cut into work items, a
#     run of at most 256 rows inside one tensor each (the 31.3M-element word
#     embedding of BERT-Large is 954 items, a 1024-wide LayerNorm vector one
#     item of 8 rows).  `_sumsq_items_kernel` writes one fp32 partial per
#     item, and `_sumsq_segments_kernel` sums each tensor's partials in
#     item order.

_ROWS = 32                 # rows of 128 per program in the phase kernels
_ITEM_ROWS = 256           # rows per work item of the norm pass
_ITEM_TILE = 32            # rows per loop step inside a work item


def _lamb_fold_scalars(clip_ratio, step, beta1, beta2, bias_correction,
                       grad_averaging, inv_scale, found_inf, device=None):
    """The eight folded phase-1 scalars [g_scale, b1e, c1, b2e, c2, rbc1,
    rbc2, found] as an fp32 device tensor (≡ the JAX package's
    `_lamb_fold_scalars`): g_scale = clip_ratio · inv_scale; found_inf
    sets b*e = 1 and c* = 0 so the moments are kept, and the clamp keeps
    1/bc finite when found_inf skips the very first step."""
    f32 = torch.float32

    def t(x):
        return device_scalar(x, f32, device)

    beta3 = (1.0 - beta1) if grad_averaging else 1.0
    step = t(step)
    keep = device_scalar(found_inf, torch.bool, device)
    bc1 = torch.clamp_min(1.0 - torch.pow(t(beta1), step), 1e-20)
    bc2 = torch.clamp_min(1.0 - torch.pow(t(beta2), step), 1e-20)
    one, zero = t(1.0), t(0.0)
    return torch.stack([
        t(clip_ratio) * t(inv_scale),                # g_scale
        torch.where(keep, one, t(beta1)),            # b1e
        torch.where(keep, zero, t(beta3)),           # c1
        torch.where(keep, one, t(beta2)),            # b2e
        torch.where(keep, zero, 1.0 - t(beta2)),     # c2
        one / bc1 if bias_correction else one,       # rbc1
        one / bc2 if bias_correction else one,       # rbc2
        keep.to(f32),                                # found
    ])


def _row_segment_ids(spec):
    """Tensor id of every row of the spec's (lane-aligned) buffer."""
    if spec.align % _LANES:
        raise ValueError(f"the segmented kernels need a lane-aligned spec "
                         f"(align a multiple of {_LANES}), got "
                         f"align={spec.align}")
    bounds = list(spec.offsets) + [spec.total]
    rows = [(bounds[i + 1] - bounds[i]) // _LANES
            for i in range(len(spec.offsets))]
    return np.repeat(np.arange(len(rows), dtype=np.int32), rows)


def _seg_row_bounds(spec):
    """Per-tensor [start, end) row bounds, as numpy int32 arrays."""
    bounds = np.asarray(list(spec.offsets) + [spec.total], np.int64) // _LANES
    return bounds[:-1].astype(np.int32), bounds[1:].astype(np.int32)


@functools.lru_cache(maxsize=8)
def segment_tables(spec, n_rows: int, device):
    """The kernels' lookups for a buffer of `n_rows` rows laid out by
    `spec`, on `device` (built once per spec and buffer; the first call
    copies them to the card):

      seg         int32 (n_rows,)  tensor id per row; padding rows get
                                   the dummy id len(spec.sizes)
      item_lo/hi  int32 (n_items,) row range of each norm work item
      item_ptr    int32 (n_tensors + 1,) each tensor's first item
    """
    n_seg = len(spec.sizes)
    base = _row_segment_ids(spec)
    if n_rows < base.shape[0]:
        raise ValueError(f"buffer of {n_rows} rows is shorter than the "
                         f"spec's {base.shape[0]}")
    seg = np.concatenate([base, np.full((n_rows - base.shape[0],), n_seg,
                                        np.int32)])
    lo, hi = _seg_row_bounds(spec)
    counts = -(-(hi - lo) // _ITEM_ROWS)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    first = np.repeat(lo, counts)
    k = np.arange(int(ptr[-1])) - np.repeat(ptr[:-1], counts)
    item_lo = (first + k * _ITEM_ROWS).astype(np.int32)
    item_hi = np.minimum(item_lo + _ITEM_ROWS,
                         np.repeat(hi, counts)).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"seg": dev(seg), "item_lo": dev(item_lo),
            "item_hi": dev(item_hi), "item_ptr": dev(ptr)}


def _table(values, device):
    """Per-tensor fp32 values plus the dummy 0 of the padding rows."""
    vals = (values.to(device=device, dtype=torch.float32)
            if isinstance(values, torch.Tensor)
            else torch.as_tensor(np.asarray(values, np.float32),
                                 device=device))
    return torch.cat([vals.reshape(-1), vals.new_zeros(1)])


# --------------------------- plain PyTorch versions --------------------------

def _lamb_phase1_reference(m, v, g, p, scalars, eps, wd_rows=None,
                           weight_decay=0.0):
    """Phase 1 in plain PyTorch; returns (m, v, u) new, in m's, v's and
    p's dtypes.  `wd_rows` (fp32, one value per row of 128) is the
    segmented variant's weight decay, else the uniform `weight_decay`."""
    g_scale, b1e, c1, b2e, c2, rbc1, rbc2, found = scalars.unbind(0)
    g32 = torch.where(found > 0.5, 0.0, g.float() * g_scale)
    p32 = p.float()
    m_new = b1e * m.float() + c1 * g32
    v_new = b2e * v.float() + c2 * (g32 * g32)
    u = (m_new * rbc1) / (torch.sqrt(v_new * rbc2) + eps)
    if wd_rows is not None:
        u = (u.view(-1, _LANES) + wd_rows[:, None] * p32.view(-1, _LANES)
             ).view(-1)
    elif weight_decay:
        u = u + weight_decay * p32
    return m_new.to(m.dtype), v_new.to(v.dtype), u.to(p.dtype)


def _lamb_phase2_reference(p, u, ratio_rows, lr):
    """Phase 2 in plain PyTorch: p - (lr · ratio[row]) · u, new."""
    r = (lr * ratio_rows)[:, None]
    return (p.float().view(-1, _LANES) - r * u.float().view(-1, _LANES)
            ).view(-1).to(p.dtype)


def _rows_sumsq_reference(x, spec):
    """Per-tensor sums of squares in plain PyTorch: fp32 sums of each row
    of 128, then a scatter-add by tensor id in fp64, rounded once to
    fp32.  (An fp32 scatter-add sums a tensor's rows one after another:
    over the 244,224 rows of BERT-Large's word embedding that drifts by
    ~1e-5 relative, more than the kernel's tree of partial sums.)"""
    rows = spec.total // _LANES
    x2 = x[:spec.total].view(rows, _LANES).float()
    seg = torch.from_numpy(_row_segment_ids(spec)).to(x.device).long()
    out = torch.zeros(len(spec.sizes), dtype=torch.float64, device=x.device)
    return out.index_add_(0, seg, torch.sum(x2 * x2, dim=1).double()).float()


# ------------------------------- Triton kernels ------------------------------

def _lamb_phase1_kernel(M, V, G, P, U, S, SEG, WDT, n, eps, weight_decay,
                        SEGMENTED: tl.constexpr, WD: tl.constexpr,
                        ROWS: tl.constexpr, LANES: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    offs = rows.to(tl.int64)[:, None] * LANES + tl.arange(0, LANES)[None, :]
    mask = offs < n
    g_scale = tl.load(S + 0)
    b1e = tl.load(S + 1)
    c1 = tl.load(S + 2)
    b2e = tl.load(S + 3)
    c2 = tl.load(S + 4)
    rbc1 = tl.load(S + 5)
    rbc2 = tl.load(S + 6)
    found = tl.load(S + 7)
    g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    m = tl.load(M + offs, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(V + offs, mask=mask, other=0.0).to(tl.float32)
    # the one select: inf/nan grads would poison m/v through 0 * inf
    g = tl.where(found > 0.5, 0.0, g * g_scale)
    m_new = b1e * m + c1 * g
    v_new = b2e * v + c2 * (g * g)
    u = tl.div_rn(m_new * rbc1, tl.sqrt_rn(v_new * rbc2) + eps)
    if SEGMENTED:
        seg = tl.load(SEG + rows, mask=rows * LANES < n, other=0)
        u = u + tl.load(WDT + seg)[:, None] * p
    elif WD:
        u = u + weight_decay * p
    tl.store(M + offs, m_new.to(M.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(V + offs, v_new.to(V.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(U + offs, u.to(U.dtype.element_ty,
                            fp_downcast_rounding="rtne"), mask=mask)


def _lamb_phase2_seg_kernel(P, U, SEG, RT, LR, n, ROWS: tl.constexpr,
                            LANES: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    offs = rows.to(tl.int64)[:, None] * LANES + tl.arange(0, LANES)[None, :]
    mask = offs < n
    seg = tl.load(SEG + rows, mask=rows * LANES < n, other=0)
    step = tl.load(LR) * tl.load(RT + seg)             # lr · ratio, per row
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(U + offs, mask=mask, other=0.0).to(tl.float32)
    p_new = p - step[:, None] * u
    tl.store(P + offs, p_new.to(P.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)


def _sumsq_items_kernel(X, LO, HI, OUT, TR: tl.constexpr,
                        LANES: tl.constexpr):
    i = tl.program_id(0)
    lo = tl.load(LO + i)
    hi = tl.load(HI + i)
    acc = tl.zeros((TR, LANES), dtype=tl.float32)
    for r0 in range(lo, hi, TR):
        rows = r0 + tl.arange(0, TR)
        offs = (rows.to(tl.int64)[:, None] * LANES
                + tl.arange(0, LANES)[None, :])
        x = tl.load(X + offs, mask=(rows < hi)[:, None],
                    other=0.0).to(tl.float32)
        acc += x * x
    tl.store(OUT + i, tl.sum(tl.sum(acc, axis=1), axis=0))


def _sumsq_segments_kernel(PART, PTR, OUT, BLOCK: tl.constexpr):
    s = tl.program_id(0)
    lo = tl.load(PTR + s)
    hi = tl.load(PTR + s + 1)
    acc = tl.zeros((BLOCK,), dtype=tl.float32)
    for i0 in range(lo, hi, BLOCK):
        idx = i0 + tl.arange(0, BLOCK)
        acc += tl.load(PART + idx, mask=idx < hi, other=0.0)
    tl.store(OUT + s, tl.sum(acc, axis=0))


def _check_flat(who, n_mult, **bufs):
    n = next(iter(bufs.values())).numel()
    for name, t in bufs.items():
        if t.ndim != 1 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{who} needs contiguous 1-D buffers of one "
                             f"length; {name} is {tuple(t.shape)}")
        if name != "g" and t.dtype not in _STATE_DTYPES:
            raise TypeError(f"{who} state is fp32 or bf16, {name} is "
                            f"{t.dtype}")
    if "g" in bufs and not bufs["g"].dtype.is_floating_point:
        raise TypeError(f"{who} grads must be float, got {bufs['g'].dtype}")
    if n % n_mult:
        raise ValueError(f"{who} needs a length that is a multiple of "
                         f"{n_mult}, got {n}")
    return n


def _check_scalars(who, scalars, n):
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (n,):
        raise ValueError(f"{who} scalars must be fp32 ({n},)")


def _launch_phase1(m, v, g, p, scalars, eps, weight_decay, seg=None,
                   wdt=None):
    n = p.numel()
    u = torch.empty_like(p)
    segmented = seg is not None
    if not segmented:
        seg = wdt = p                  # pointers the kernel never reads
    if n:
        grid = (-(-n // (_ROWS * _LANES)),)
        _jit(_lamb_phase1_kernel)[grid](
            m, v, g, p, u, scalars, seg, wdt, n, float(eps),
            float(weight_decay), SEGMENTED=segmented,
            WD=weight_decay != 0.0, ROWS=_ROWS, LANES=_LANES, num_warps=8,
            enable_fp_fusion=False)
    return m, v, u


def lamb_phase1_triton(m, v, g, p, scalars, eps, weight_decay):
    """Launch phase 1 with one uniform weight decay over CUDA flat
    buffers: m, v in place, u returned new in p's dtype.
    `lamb_phase1_triton.launches` counts launches."""
    _check_flat("lamb phase 1", 1, m=m, v=v, g=g, p=p)
    _check_scalars("lamb phase 1", scalars, 8)
    out = _launch_phase1(m, v, g, p, scalars, eps, weight_decay)
    lamb_phase1_triton.launches += 1
    return out


lamb_phase1_triton.launches = 0


def lamb_phase1_seg_triton(m, v, g, p, scalars, eps, seg, wdt):
    """Launch phase 1 with per-tensor weight decay: `seg` the int32 tensor
    id per row, `wdt` the fp32 wd table (dummy 0 last).
    `lamb_phase1_seg_triton.launches` counts launches."""
    n = _check_flat("lamb phase 1", _LANES, m=m, v=v, g=g, p=p)
    _check_scalars("lamb phase 1", scalars, 8)
    if seg.dtype != torch.int32 or seg.numel() != n // _LANES:
        raise ValueError("lamb phase 1 needs an int32 tensor id per row")
    out = _launch_phase1(m, v, g, p, scalars, eps, 0.0, seg, wdt)
    lamb_phase1_seg_triton.launches += 1
    return out


lamb_phase1_seg_triton.launches = 0


def lamb_phase2_seg_triton(p, u, seg, ratio_table, lr):
    """Launch phase 2 over CUDA flat buffers, p in place: `seg` the int32
    tensor id per row, `ratio_table` the fp32 trust ratios (dummy 0
    last), `lr` a 0-d fp32 device tensor.
    `lamb_phase2_seg_triton.launches` counts launches."""
    n = _check_flat("lamb phase 2", _LANES, p=p, u=u)
    if seg.dtype != torch.int32 or seg.numel() != n // _LANES:
        raise ValueError("lamb phase 2 needs an int32 tensor id per row")
    if n:
        grid = (-(-n // (_ROWS * _LANES)),)
        _jit(_lamb_phase2_seg_kernel)[grid](
            p, u, seg, ratio_table, lr, n, ROWS=_ROWS, LANES=_LANES,
            num_warps=4, enable_fp_fusion=False)
    lamb_phase2_seg_triton.launches += 1
    return p


lamb_phase2_seg_triton.launches = 0


def rows_sumsq_seg_triton(x, spec):
    """Per-tensor fp32 sums of squares over a CUDA flat buffer laid out
    by a lane-aligned `spec`: the item pass and the per-tensor pass, two
    launches; `rows_sumsq_seg_triton.launches` counts calls."""
    n = _check_flat("per-tensor norms", _LANES, x=x)
    tabs = segment_tables(spec, n // _LANES, x.device)
    n_items = tabs["item_lo"].numel()
    n_seg = len(spec.sizes)
    part = torch.empty(n_items, dtype=torch.float32, device=x.device)
    out = torch.empty(n_seg, dtype=torch.float32, device=x.device)
    if n_items:
        _jit(_sumsq_items_kernel)[(n_items,)](
            x, tabs["item_lo"], tabs["item_hi"], part, TR=_ITEM_TILE,
            LANES=_LANES, num_warps=4)
    if n_seg:
        _jit(_sumsq_segments_kernel)[(n_seg,)](
            part, tabs["item_ptr"], out, BLOCK=1024, num_warps=4)
    rows_sumsq_seg_triton.launches += 1
    return out


rows_sumsq_seg_triton.launches = 0


# --------------------------------- public API -------------------------------

def lamb_phase1_flat(m, v, g, p, clip_ratio, step, *, beta1, beta2, eps,
                     weight_decay, bias_correction=True, grad_averaging=True,
                     inv_scale=1.0, found_inf=False):
    """LAMB phase 1 with one uniform weight decay (≡ the JAX package's
    `lamb_phase1_flat`): m and v updated IN PLACE, u returned new in p's
    dtype.  `g` may ride in its own (bf16) dtype; `clip_ratio`, `step`,
    `inv_scale` and `found_inf` may be device tensors.  Returns (m, v, u).
    CPU tensors run the plain version; CUDA tensors run the kernel or
    raise."""
    scalars = _lamb_fold_scalars(clip_ratio, step, beta1, beta2,
                                 bias_correction, grad_averaging, inv_scale,
                                 found_inf, device=p.device)
    if not check_kernel_device(m, v, g, p):
        mn, vn, u = _lamb_phase1_reference(m, v, g, p, scalars, eps,
                                           weight_decay=weight_decay)
        m.copy_(mn)
        v.copy_(vn)
        return m, v, u
    return lamb_phase1_triton(m, v, g, p, scalars, eps, weight_decay)


def lamb_phase1_seg(m, v, g, p, clip_ratio, step, *, wd_values, spec, beta1,
                    beta2, eps, bias_correction=True, grad_averaging=True,
                    inv_scale=1.0, found_inf=False):
    """`lamb_phase1_flat` with per-tensor weight decay `wd_values`
    ((n_tensors,), a device tensor or an array), looked up per row from
    the lane-aligned `spec` (≡ the JAX package's `lamb_phase1_seg`)."""
    scalars = _lamb_fold_scalars(clip_ratio, step, beta1, beta2,
                                 bias_correction, grad_averaging, inv_scale,
                                 found_inf, device=p.device)
    wdt = _table(wd_values, p.device)
    if wdt.numel() != len(spec.sizes) + 1:
        raise ValueError(f"{wdt.numel() - 1} wd values for "
                         f"{len(spec.sizes)} tensors")
    seg = segment_tables(spec, p.numel() // _LANES, p.device)["seg"]
    if not check_kernel_device(m, v, g, p):
        mn, vn, u = _lamb_phase1_reference(m, v, g, p, scalars, eps,
                                           wd_rows=wdt[seg.long()])
        m.copy_(mn)
        v.copy_(vn)
        return m, v, u
    return lamb_phase1_seg_triton(m, v, g, p, scalars, eps, seg, wdt)


def lamb_phase2_seg(p, u, ratio_values, spec, lr):
    """p -= lr · trust_ratio[tensor] · u, IN PLACE, with the per-tensor
    `ratio_values` ((n_tensors,)) looked up per row from the lane-aligned
    `spec`; tail-padding rows get ratio 0 and stay untouched (≡ the JAX
    package's `lamb_phase2_seg`).  `lr` may be a device tensor.  Returns
    p."""
    rt = _table(ratio_values, p.device)
    if rt.numel() != len(spec.sizes) + 1:
        raise ValueError(f"{rt.numel() - 1} ratios for "
                         f"{len(spec.sizes)} tensors")
    seg = segment_tables(spec, p.numel() // _LANES, p.device)["seg"]
    lr_t = device_scalar(lr, torch.float32, p.device)
    if not check_kernel_device(p, u):
        return p.copy_(_lamb_phase2_reference(p, u, rt[seg.long()], lr_t))
    return lamb_phase2_seg_triton(p, u, seg, rt, lr_t)


def l2norm_flat(flat):
    """Global L2 norm in fp32 (≡ the JAX package's `l2norm_flat`, a plain
    reduction there too): the reduction upcasts as it reads, no fp32 copy
    of the buffer is made."""
    return torch.linalg.vector_norm(flat, dtype=torch.float32)


def per_tensor_l2norm_aligned(flat, spec):
    """Per-tensor L2 norms over a flat buffer laid out by a lane-aligned
    `spec` (≡ the JAX package's `per_tensor_l2norm_aligned`).  CPU tensors
    run the plain version; CUDA tensors the kernels or raise."""
    if not check_kernel_device(flat):
        return torch.sqrt(_rows_sumsq_reference(flat, spec))
    return torch.sqrt(rows_sumsq_seg_triton(flat, spec))


# ------------------------------------ SGD -----------------------------------
#
# `sgd_flat` (≡ the JAX package's `sgd_flat`, itself ≡
# amp_C.multi_tensor_sgd) updates flat params and momentum buffer IN
# PLACE from a flat grad buffer of any float dtype.  Four scalars ride as
# an fp32 device tensor [lr, inv_scale, found_inf, first], so a loss
# scale, an overflow flag or a step count that lives on the card causes
# no host sync.  `first` selects torch's buf-is-None branch (buf := g)
# inside the kernel, so one pass covers step 0 and the steady state;
# `first_run` is its static form.  A found_inf step keeps p and buf bit
# for bit.
#
# Kernel note.  Replaces apex_tpu/ops/optimizer_kernels.py:_sgd_kernel
# (launched by sgd_flat).  What bounds it on an H100: bytes — per element
# it reads p, buf and g and writes p and buf (18 bytes with fp32 state
# and bf16 grads) for ~8 flops.  Design: one program per 4096-element
# block, masked loads so any length works, the four scalars read once per
# program, fp32 math; momentum, dampening, nesterov, weight decay (and
# whether it comes before or after momentum) and first_run are
# compile-time constants, so each configuration compiles only the
# operations it does.  Stores round to nearest-even and fp-contraction is
# off, so the kernel evaluates the plain version's operations one by one
# and the two agree bit for bit.


def _sgd_scalars(lr, inv_scale, found_inf, first, device=None):
    """[lr, inv_scale, found_inf, first] as an fp32 (4,) device tensor."""
    return torch.stack([device_scalar(x, torch.float32, device)
                        for x in (lr, inv_scale, found_inf, first)])


def _sgd_reference(p, buf, g, scalars, momentum, dampening, nesterov,
                   weight_decay, wd_after_momentum, first_run):
    """The SGD update in plain PyTorch (the JAX package's jnp branch of
    `sgd_flat`); returns (p, buf) new, in their own dtypes."""
    lr, inv_scale, found, first = scalars.unbind(0)
    g32 = g.float() * inv_scale
    p32 = p.float()
    if weight_decay and not wd_after_momentum:
        g32 = g32 + weight_decay * p32
    if momentum != 0.0:
        if first_run:
            b_new = g32
        else:
            b_new = torch.where(first > 0.5, g32,
                                momentum * buf.float()
                                + (1 - dampening) * g32)
        upd = g32 + momentum * b_new if nesterov else b_new
    else:
        b_new, upd = buf.float(), g32
    if weight_decay and wd_after_momentum:
        upd = upd + weight_decay * p32
    p_new = p32 - lr * upd
    keep = found > 0.5
    return (torch.where(keep, p32, p_new).to(p.dtype),
            torch.where(keep, buf.float(), b_new).to(buf.dtype))


def _sgd_kernel(P, B, G, S, n, MOMENTUM: tl.constexpr,
                DAMPENING: tl.constexpr, NESTEROV: tl.constexpr,
                WEIGHT_DECAY: tl.constexpr, WD_AFTER: tl.constexpr,
                FIRST_RUN: tl.constexpr, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    lr = tl.load(S + 0)
    inv_scale = tl.load(S + 1)
    keep = tl.load(S + 2) > 0.5
    first = tl.load(S + 3) > 0.5
    g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32) * inv_scale
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    if WEIGHT_DECAY != 0.0:
        if not WD_AFTER:
            g = g + WEIGHT_DECAY * p
    if MOMENTUM != 0.0:
        b = tl.load(B + offs, mask=mask, other=0.0).to(tl.float32)
        if FIRST_RUN:
            b_new = g
        else:
            b_new = tl.where(first, g, MOMENTUM * b + (1 - DAMPENING) * g)
        if NESTEROV:
            upd = g + MOMENTUM * b_new
        else:
            upd = b_new
    else:
        upd = g
    if WEIGHT_DECAY != 0.0:
        if WD_AFTER:
            upd = upd + WEIGHT_DECAY * p
    p_new = tl.where(keep, p, p - lr * upd)
    tl.store(P + offs, p_new.to(P.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    if MOMENTUM != 0.0:
        b_new = tl.where(keep, b, b_new)
        tl.store(B + offs, b_new.to(B.dtype.element_ty,
                                    fp_downcast_rounding="rtne"), mask=mask)


def sgd_flat_triton(p, buf, g, scalars, momentum, dampening, nesterov,
                    weight_decay, wd_after_momentum, first_run):
    """Launch the Triton SGD kernel over CUDA flat buffers, updating p
    and buf in place.  `sgd_flat_triton.launches` counts launches."""
    n = _check_flat("sgd kernel", 1, p=p, buf=buf, g=g)
    _check_scalars("sgd kernel", scalars, 4)
    if n:
        _jit(_sgd_kernel)[(-(-n // _BLOCK),)](
            p, buf, g, scalars, n, MOMENTUM=float(momentum),
            DAMPENING=float(dampening), NESTEROV=bool(nesterov),
            WEIGHT_DECAY=float(weight_decay),
            WD_AFTER=bool(wd_after_momentum), FIRST_RUN=bool(first_run),
            BLOCK=_BLOCK, num_warps=8, enable_fp_fusion=False)
    sgd_flat_triton.launches += 1
    return p, buf


sgd_flat_triton.launches = 0


def sgd_flat(p, buf, g, lr, *, momentum=0.0, dampening=0.0, nesterov=False,
             weight_decay=0.0, wd_after_momentum=False, first_run=False,
             first=False, inv_scale=1.0, found_inf=False):
    """One SGD step on flat buffers, IN PLACE (≡ the JAX package's
    `sgd_flat`, which returns new buffers under donation).  `lr`, `first`,
    `inv_scale` and `found_inf` may be device tensors.  Returns (p, buf)
    — the same tensors, updated.  CPU tensors run the plain version;
    CUDA tensors run the Triton kernel or raise."""
    scalars = _sgd_scalars(lr, inv_scale, found_inf, first, device=p.device)
    args = (momentum, dampening, nesterov, weight_decay, wd_after_momentum,
            first_run)
    if not check_kernel_device(p, buf, g):
        pn, bn = _sgd_reference(p, buf, g, scalars, *args)
        p.copy_(pn)
        buf.copy_(bn)
        return p, buf
    return sgd_flat_triton(p, buf, g, scalars, *args)


# ---------------------------------- Adagrad ---------------------------------
#
# `adagrad_flat` (≡ the JAX package's `adagrad_flat`, itself ≡
# amp_C.multi_tensor_adagrad) updates flat params p and the sum of
# squared grads h IN PLACE from a flat grad buffer of any float dtype:
#
#   g += wd · p            (L2 mode, adagrad_w_mode=False)
#   h += g · g
#   upd = g / (√h + eps)
#   upd += wd · p          (decoupled mode, adagrad_w_mode=True)
#   p -= lr · upd
#
# `lr` rides as a 0-d fp32 device tensor, so a learning rate that lives on
# the card causes no host sync.
#
# Kernel note.  Replaces apex_tpu/ops/optimizer_kernels.py:_adagrad_kernel
# (launched by adagrad_flat).  What bounds it on an H100: bytes — per
# element it reads p, h and g and writes p and h (18 bytes with fp32 state
# and bf16 grads) for ~7 flops.  Design: `_sgd_kernel`'s shape, one program
# per 4096-element block with masked loads so any length works; eps, the
# weight decay and its mode are compile-time constants; fp32 math in the
# JAX kernel's order with the IEEE square root and divide (`sqrt_rn`,
# `div_rn`), stores rounded to nearest-even and fp-contraction off, so the
# kernel evaluates the plain version's operations one by one and the two
# agree bit for bit.

def _adagrad_reference(p, h, g, lr, eps, weight_decay, adagrad_w_mode):
    """The Adagrad update in plain PyTorch (the JAX package's jnp branch
    of `adagrad_flat`); returns (p, h) new, p in its own dtype, h fp32."""
    g32 = g.float()
    p32 = p.float()
    if not adagrad_w_mode and weight_decay:
        g32 = g32 + weight_decay * p32
    h_new = h + g32 * g32
    upd = g32 / (torch.sqrt(h_new) + eps)
    if adagrad_w_mode and weight_decay:
        upd = upd + weight_decay * p32
    return (p32 - lr * upd).to(p.dtype), h_new


def _adagrad_kernel(P, H, G, LR, n, EPS: tl.constexpr,
                    WEIGHT_DECAY: tl.constexpr, W_MODE: tl.constexpr,
                    BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    lr = tl.load(LR)
    g = tl.load(G + offs, mask=mask, other=0.0).to(tl.float32)
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    h = tl.load(H + offs, mask=mask, other=0.0)
    if WEIGHT_DECAY != 0.0:
        if not W_MODE:
            g = g + WEIGHT_DECAY * p
    h_new = h + g * g
    upd = tl.div_rn(g, tl.sqrt_rn(h_new) + EPS)
    if WEIGHT_DECAY != 0.0:
        if W_MODE:
            upd = upd + WEIGHT_DECAY * p
    p_new = p - lr * upd
    tl.store(P + offs, p_new.to(P.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)
    tl.store(H + offs, h_new, mask=mask)


def adagrad_flat_triton(p, h, g, lr, eps, weight_decay, adagrad_w_mode):
    """Launch the Triton Adagrad kernel over CUDA flat buffers, updating p
    and h (fp32) in place; `lr` a 0-d fp32 device tensor.
    `adagrad_flat_triton.launches` counts launches."""
    n = _check_flat("adagrad kernel", 1, p=p, h=h, g=g)
    if h.dtype != torch.float32:
        raise TypeError(f"adagrad kernel keeps h in fp32, got {h.dtype}")
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError("adagrad kernel lr must be a 0-d fp32 tensor")
    if n:
        _jit(_adagrad_kernel)[(-(-n // _BLOCK),)](
            p, h, g, lr, n, EPS=float(eps), WEIGHT_DECAY=float(weight_decay),
            W_MODE=bool(adagrad_w_mode), BLOCK=_BLOCK, num_warps=8,
            enable_fp_fusion=False)
    adagrad_flat_triton.launches += 1
    return p, h


adagrad_flat_triton.launches = 0


def adagrad_flat(p, h, g, lr, *, eps=1e-10, weight_decay=0.0,
                 adagrad_w_mode=False):
    """One Adagrad step on flat buffers, IN PLACE (≡ the JAX package's
    `adagrad_flat`, which returns new buffers under donation): p in its
    dtype, h fp32, g any float dtype; `lr` may be a device tensor.
    Returns (p, h) — the same tensors, updated.  CPU tensors run the
    plain version; CUDA tensors run the Triton kernel or raise."""
    lr_t = device_scalar(lr, torch.float32, p.device)
    if not check_kernel_device(p, h, g):
        pn, hn = _adagrad_reference(p, h, g, lr_t, eps, weight_decay,
                                    adagrad_w_mode)
        p.copy_(pn)
        h.copy_(hn)
        return p, h
    return adagrad_flat_triton(p, h, g, lr_t, eps, weight_decay,
                               adagrad_w_mode)


# ------------------------- LAMB phase 2, per element ------------------------
#
# `lamb_phase2_flat` (≡ the JAX package's `lamb_phase2_flat`, itself ≡
# multi_tensor_lamb_stage2) is phase 2 with the trust ratio given per
# ELEMENT: p -= lr · r · u, IN PLACE.  FusedLAMB does not call it: its
# segmented phase 2 (`lamb_phase2_seg`) reads a tensor id per row and has
# no cap on the number of tensors, so the JAX package's fallback to this
# function past 2047 tensors (a limit of the TPU's one-hot product) has no
# counterpart here.  It stays a public function of its own.
#
# Kernel note.  Replaces apex_tpu/ops/optimizer_kernels.py:_lamb_phase2_kernel
# (launched by lamb_phase2_flat).  What bounds it on an H100: bytes — per
# element it reads p, u and r and writes p (10 bytes with bf16 p and u and
# an fp32 r) for 3 flops; the ratio vector it reads is what makes it slower
# than the segmented phase 2, which reads 4 bytes of tensor id per row of
# 128.  Design: one program per 4096-element block, masked loads, `lr`
# read once from a device tensor, fp32 math in the plain version's order,
# stores rounded to nearest-even, fp-contraction off: bit for bit with the
# plain version, and with `lamb_phase2_seg` fed the same ratios.

def _lamb_phase2_flat_reference(p, u, r, lr):
    """Phase 2 with a per-element ratio in plain PyTorch: p - lr · r · u,
    new, in p's dtype."""
    return (p.float() - lr * r * u.float()).to(p.dtype)


def _lamb_phase2_kernel(P, U, R, LR, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    lr = tl.load(LR)
    p = tl.load(P + offs, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(U + offs, mask=mask, other=0.0).to(tl.float32)
    r = tl.load(R + offs, mask=mask, other=0.0)
    p_new = p - lr * r * u
    tl.store(P + offs, p_new.to(P.dtype.element_ty,
                                fp_downcast_rounding="rtne"), mask=mask)


def lamb_phase2_flat_triton(p, u, r, lr):
    """Launch phase 2 with a per-element fp32 ratio `r` over CUDA flat
    buffers, p in place; `lr` a 0-d fp32 device tensor.
    `lamb_phase2_flat_triton.launches` counts launches."""
    n = _check_flat("lamb phase 2 (flat)", 1, p=p, u=u, r=r)
    if r.dtype != torch.float32:
        raise TypeError(f"lamb phase 2 ratios are fp32, got {r.dtype}")
    if lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError("lamb phase 2 lr must be a 0-d fp32 tensor")
    if n:
        _jit(_lamb_phase2_kernel)[(-(-n // _BLOCK),)](
            p, u, r, lr, n, BLOCK=_BLOCK, num_warps=8,
            enable_fp_fusion=False)
    lamb_phase2_flat_triton.launches += 1
    return p


lamb_phase2_flat_triton.launches = 0


def lamb_phase2_flat(p, u, ratio_elem, lr):
    """p -= lr · ratio_elem · u, IN PLACE, with a per-element fp32 trust
    ratio (≡ the JAX package's `lamb_phase2_flat`); `lr` may be a device
    tensor.  Returns p.  CPU tensors run the plain version; CUDA tensors
    run the Triton kernel or raise."""
    lr_t = device_scalar(lr, torch.float32, p.device)
    if not check_kernel_device(p, u, ratio_elem):
        return p.copy_(_lamb_phase2_flat_reference(p, u, ratio_elem, lr_t))
    return lamb_phase2_flat_triton(p, u, ratio_elem, lr_t)


# --------------------------- reductions / utilities -------------------------
#
# Plain PyTorch, as the JAX package leaves them to XLA.

def per_tensor_l2norm(flat, sizes):
    """Per-tensor fp32 L2 norms over a flat buffer of back-to-back
    segments of `sizes` elements (≡ the JAX package's `per_tensor_l2norm`,
    multi_tensor_l2norm's per_tensor mode)."""
    segs = torch.split(flat[:sum(sizes)], list(sizes))
    return torch.stack([torch.linalg.vector_norm(s, dtype=torch.float32)
                        for s in segs])


@functools.lru_cache(maxsize=8)
def _repeats(sizes, device):
    """`sizes` as an int64 tensor on `device`, copied there once."""
    return torch.as_tensor(sizes, dtype=torch.int64, device=device)


def expand_per_tensor(values, sizes, total):
    """Per-tensor values repeated over their segments of `sizes` elements,
    `total` long; past sum(sizes) the last value repeats (≡ the JAX
    package's `expand_per_tensor`, `jnp.repeat` with a total length).
    No host sync: the output size is known."""
    n = sum(sizes)
    elem = torch.repeat_interleave(
        values, _repeats(tuple(sizes), values.device), output_size=n)
    if total > n:
        elem = torch.cat([elem, values[-1:].expand(total - n)])
    return elem


def expand_per_tensor_aligned(values, spec, total):
    """Per-tensor values broadcast to a per-element vector of `total`
    (>= spec.total) elements over a lane-aligned `spec`: each tensor's
    rows, its zero tail included, get its value, and past spec.total the
    last value repeats (≡ the JAX package's `expand_per_tensor_aligned`)."""
    rows = segment_tables(spec, spec.total // _LANES, values.device)["seg"]
    elem = values[rows.long()][:, None].expand(-1, _LANES).reshape(-1)
    if total > elem.numel():
        elem = torch.cat([elem, values[-1:].expand(total - elem.numel())])
    return elem


def scale_flat(flat, scale):
    """fp32 scaled copy (≡ amp_C.multi_tensor_scale)."""
    return flat.float() * scale


def axpby_flat(a, x, b, y):
    """a·x + b·y in fp32 (≡ amp_C.multi_tensor_axpby)."""
    return a * x.float() + b * y.float()
