"""Fused scaled-(masked)-softmax, forward and backward (counterpart of
apex_tpu/ops/softmax.py).

y = softmax(where(mask, -10000, scale · x)) over the last dim, in fp32
whatever x's dtype, rounded once to x's dtype.  Masked positions get
-10000 (not -inf), as apex's Megatron kernels do, so a fully masked row
comes out uniform, not NaN.  Three forms: plain, masked (a bool mask,
True = masked out, that broadcasts to x) and causal (the upper triangle
of the last two dims masked, sq == sk).  The gradient is
dx = scale · y · (g - Σ g·y) per row, from y alone: the forward saves
only its output, as the JAX package's `custom_vjp` does.

Two implementations of each direction live here:

  * the plain PyTorch versions — `scaled_softmax_reference`,
    `scaled_masked_softmax_reference`,
    `scaled_upper_triang_masked_softmax_reference` and
    `softmax_bwd_reference`.  CPU tensors run them, and `chip_smoke.py`
    holds the kernels against them.
  * `_softmax_fwd_kernel` and `_softmax_bwd_kernel`, Triton kernels
    launched by `softmax_fwd_triton` / `softmax_bwd_triton` for CUDA
    tensors.  A call that needs a gradient goes through `_SoftmaxFn`
    (a `torch.autograd.Function`); one that does not runs the forward
    alone.

Forward kernel note.  Replaces apex_tpu/ops/softmax.py:_fwd_kernel
(launched by _fwd_pallas).  What bounds it on an H100: bytes — x read
once where the mask leaves it (a masked element's output does not
depend on x: the lower triangle of the causal form, the unmasked
columns of the masked form), the mask, and y written once; ~6 flops per
element.  Design:
  * A masked element's score is -10000 whatever x holds, so it enters
    the max, the sum and its own output, exp(-10000 - m)/s, as that
    constant: the plain version's function, a fully masked row
    (uniform) and rows whose scores sit near -10000 (where the masked
    elements' term of s matters) included.  The causal form loads x
    only up to each row's diagonal, rounded up to whole groups of
    `_GROUP` (8) columns: a load mask that is one value a group keeps
    the loads 16 bytes wide.  The masked form loads every in-bounds x:
    skipping its padded groups made the unpadded batches the models
    send slower (PERF.md).
  * A row up to `_MAX_BLOCK` (8192) columns sits in registers, so x is
    read once; short rows are packed several to a program (about 4096
    elements each), so a program never idles on a 64-wide row.  Longer
    rows take two passes in chunks: an online max and rescaled sum (the
    causal form visits the chunks up to the row's diagonal and adds the
    rest as n·exp(-10000 - m)), then the writes (x is read twice where
    visible).  Every sequence length runs.
  * The mask is read through its broadcast strides: BERT's (B, 1, 1, S)
    padding mask is S bytes a sequence, and the (B, nh, S, S) mask the
    TPU wrapper builds with `broadcast_to` never exists.  A program maps
    its row index back to the mask's leading (at most three) dims.
  * The causal form computes its mask from the row index (query
    position = row % sq), reading no mask at all.
  * fp32 math; the exponential is the hardware one (`ex2.approx`, within
    ~1e-6 relative of the plain version's `expf`), each row's 1/s is the
    IEEE one (`div_rn`) and multiplies every numerator (within an fp32
    ulp of the quotient), and the store rounds to nearest-even.

Backward kernel note.  Replaces apex_tpu/ops/softmax.py:_bwd_kernel
(launched by _bwd_pallas).  What bounds it on an H100: bytes — g and y
read once, dx written once, ~4 flops per element.  Design: the same row
packing and chunking as the forward; Σ g·y reduced in fp32 in registers
(chunked rows read g and y twice), then dx = (scale · y) · (g - Σ), the
plain version's order, into a fresh tensor in g's dtype.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops._common import check_kernel_device, row_block

# triton.language, bound by `_jit` at the first launch: the kernels
# below are compiled only on a machine with a card, and importing this
# module must not need triton
tl = None

_MASK_VALUE = -10000.0
# the longest row a program holds in registers; longer rows are chunked
_MAX_BLOCK = 8192
# the chunk of a row longer than _MAX_BLOCK
_CHUNK = 4096
# elements a program covers when it packs several short rows
_PROGRAM_ELEMS = 4096
# the forward reads x in groups of this many columns, whole groups at a
# time (16 bytes of bf16)
_GROUP = 8


# --------------------------- plain PyTorch versions --------------------------

def scaled_softmax_reference(x, scale=1.0):
    x32 = x.float() * scale
    return torch.softmax(x32, dim=-1).to(x.dtype)


def scaled_masked_softmax_reference(x, mask, scale=1.0):
    """mask: bool, True = masked out, broadcasting to x."""
    x32 = torch.where(mask, _MASK_VALUE, x.float() * scale)
    return torch.softmax(x32, dim=-1).to(x.dtype)


def _causal_mask(sq, sk, device):
    return torch.triu(torch.ones((sq, sk), dtype=torch.bool,
                                 device=device), diagonal=1)


def scaled_upper_triang_masked_softmax_reference(x, scale=1.0):
    """Causal mask over the last two dims (sq, sk), sq == sk."""
    return scaled_masked_softmax_reference(
        x, _causal_mask(x.shape[-2], x.shape[-1], x.device), scale)


def softmax_fwd_reference(x, mask, scale, causal):
    """The forward kernel's function in plain PyTorch (x of any shape;
    `mask` None or broadcasting to x)."""
    if causal:
        return scaled_upper_triang_masked_softmax_reference(x, scale)
    if mask is None:
        return scaled_softmax_reference(x, scale)
    return scaled_masked_softmax_reference(x, mask, scale)


def softmax_bwd_reference(g, y, scale):
    """dx = scale · y · (g - Σ g·y) over the last dim, fp32 math, in g's
    dtype (≡ the JAX package's `_bwd_kernel`)."""
    g32, y32 = g.float(), y.float()
    dot = torch.sum(g32 * y32, dim=-1, keepdim=True)
    return (scale * y32 * (g32 - dot)).to(g.dtype)


# ------------------------------- Triton kernels ------------------------------

def _softmax_fwd_kernel(X, M, Y, n_rows, n_cols, x_stride, y_stride, sq,
                        n1, n2, ms0, ms1, ms2, msc, scale,
                        ROWS: tl.constexpr, BLOCK: tl.constexpr,
                        GROUP: tl.constexpr, ONE_BLOCK: tl.constexpr,
                        HAS_MASK: tl.constexpr, CAUSAL: tl.constexpr):
    # a block of ROWS rows x BLOCK columns as (row, group of GROUP
    # columns, column in the group): a load mask that is one value a
    # group keeps its loads 16 bytes wide
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    rmask = (rows < n_rows)[:, None, None]
    r64 = rows.to(tl.int64)
    x_row = X + r64[:, None, None] * x_stride
    y_row = Y + r64[:, None, None] * y_stride
    m_row = M
    if HAS_MASK:
        # the mask's offset of each row: row = (i0 * n1 + i1) * n2 + i2
        i2 = r64 % n2
        i1 = (r64 // n2) % n1
        i0 = r64 // n2 // n1
        m_row = M + (i0 * ms0 + i1 * ms1 + i2 * ms2)[:, None, None]
    pos = (rows % sq)[:, None, None]                 # query position
    grp = tl.arange(0, BLOCK // GROUP)[None, :, None] * GROUP
    lane = tl.arange(0, GROUP)[None, None, :]
    if ONE_BLOCK:
        cols = grp + lane
        inb = rmask & (cols < n_cols)
        vis, live = _fwd_visible(m_row, cols, grp, inb, pos, msc,
                                 HAS_MASK, CAUSAL)
        x = tl.load(x_row + cols, mask=live, other=0.0).to(tl.float32)
        # a masked score is -10000 whatever x holds there; out of bounds,
        # no weight
        z = tl.where(vis, x * scale, -10000.0)
        z = tl.where(inb, z, float("-inf"))
        m = tl.max(tl.max(z, axis=2), axis=1)
        e = tl.exp(z - m[:, None, None])
        inv = tl.div_rn(tl.full([ROWS], 1.0, tl.float32),
                        tl.sum(tl.sum(e, axis=2), axis=1))
        tl.store(y_row + cols, (e * inv[:, None, None]).to(
            Y.dtype.element_ty, fp_downcast_rounding="rtne"), mask=inb)
    else:
        # one row a program (ROWS == 1): an online max and rescaled sum,
        # then the writes; the causal form's chunks past the row's
        # diagonal, every score -10000, are counted, not visited
        m_i = tl.full([ROWS], float("-inf"), tl.float32)
        s_i = tl.zeros([ROWS], dtype=tl.float32)
        end = n_cols
        if CAUSAL:
            end = tl.minimum(
                n_cols, ((tl.program_id(0) * ROWS) % sq) // BLOCK * BLOCK
                + BLOCK)
        for c0 in range(0, end, BLOCK):
            cols = c0 + grp + lane
            inb = rmask & (cols < n_cols)
            vis, live = _fwd_visible(m_row, cols, c0 + grp, inb, pos, msc,
                                     HAS_MASK, CAUSAL)
            x = tl.load(x_row + cols, mask=live, other=0.0).to(tl.float32)
            z = tl.where(vis, x * scale, -10000.0)
            z = tl.where(inb, z, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(tl.max(z, axis=2), axis=1))
            s_i = (s_i * tl.exp(m_i - m_new)
                   + tl.sum(tl.sum(tl.exp(z - m_new[:, None, None]),
                                   axis=2), axis=1))
            m_i = m_new
        if CAUSAL:
            n_skip = (n_cols - end).to(tl.float32)
            m_new = tl.where(n_skip > 0, tl.maximum(m_i, -10000.0), m_i)
            s_i = (s_i * tl.exp(m_i - m_new)
                   + n_skip * tl.exp(-10000.0 - m_new))
            m_i = m_new
        inv = tl.div_rn(tl.full([ROWS], 1.0, tl.float32), s_i)
        for c0 in range(0, n_cols, BLOCK):
            cols = c0 + grp + lane
            inb = rmask & (cols < n_cols)
            vis, live = _fwd_visible(m_row, cols, c0 + grp, inb, pos, msc,
                                     HAS_MASK, CAUSAL)
            x = tl.load(x_row + cols, mask=live, other=0.0).to(tl.float32)
            # the scaled score rounded before the exponent, as in the plain
            # version (through the select: no FMA takes the product whole)
            z = tl.where(vis, x * scale, -10000.0)
            e = tl.exp(z - m_i[:, None, None])
            tl.store(y_row + cols, (e * inv[:, None, None]).to(
                Y.dtype.element_ty, fp_downcast_rounding="rtne"), mask=inb)


def _fwd_visible(m_row, cols, grp, inb, pos, msc, HAS_MASK: tl.constexpr,
                 CAUSAL: tl.constexpr):
    """(vis, live) over a (rows, groups, GROUP) block of columns `cols`
    whose groups start at `grp`: vis, the in-bounds elements the mask
    leaves (their scores count); live, where x is loaded — in the causal
    form the in-bounds elements of every group that starts at or before
    the row's diagonal, else every in-bounds element."""
    vis = inb
    live = inb
    if CAUSAL:
        vis = inb & (cols <= pos)
        live = inb & (grp <= pos)
    elif HAS_MASK:
        mk = tl.load(m_row + cols.to(tl.int64) * msc, mask=inb, other=1)
        vis = inb & (mk == 0)
    return vis, live


def _softmax_bwd_kernel(G, Y, DX, n_rows, n_cols, g_stride, y_stride,
                        dx_stride, scale, ROWS: tl.constexpr,
                        BLOCK: tl.constexpr, ONE_BLOCK: tl.constexpr):
    rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
    rmask = rows < n_rows
    r64 = rows.to(tl.int64)
    g_row = G + r64[:, None] * g_stride
    y_row = Y + r64[:, None] * y_stride
    dx_row = DX + r64[:, None] * dx_stride
    if ONE_BLOCK:
        cols = tl.arange(0, BLOCK)[None, :]
        inb = rmask[:, None] & (cols < n_cols)
        g = tl.load(g_row + cols, mask=inb, other=0.0).to(tl.float32)
        y = tl.load(y_row + cols, mask=inb, other=0.0).to(tl.float32)
        dot = tl.sum(g * y, axis=1)
        dx = scale * y * (g - dot[:, None])
        tl.store(dx_row + cols, dx.to(DX.dtype.element_ty,
                                      fp_downcast_rounding="rtne"), mask=inb)
    else:
        dot = tl.zeros([ROWS], dtype=tl.float32)
        for c0 in range(0, n_cols, BLOCK):
            cols = c0 + tl.arange(0, BLOCK)[None, :]
            inb = rmask[:, None] & (cols < n_cols)
            g = tl.load(g_row + cols, mask=inb, other=0.0).to(tl.float32)
            y = tl.load(y_row + cols, mask=inb, other=0.0).to(tl.float32)
            dot += tl.sum(g * y, axis=1)
        for c0 in range(0, n_cols, BLOCK):
            cols = c0 + tl.arange(0, BLOCK)[None, :]
            inb = rmask[:, None] & (cols < n_cols)
            g = tl.load(g_row + cols, mask=inb, other=0.0).to(tl.float32)
            y = tl.load(y_row + cols, mask=inb, other=0.0).to(tl.float32)
            dx = scale * y * (g - dot[:, None])
            tl.store(dx_row + cols, dx.to(DX.dtype.element_ty,
                                          fp_downcast_rounding="rtne"),
                     mask=inb)


_JIT = {}


def _jit(fn):
    global tl, _fwd_visible
    if fn.__name__ not in _JIT:
        import triton
        import triton.language

        tl = triton.language
        if not isinstance(_fwd_visible, triton.JITFunction):
            # the forward kernel's helper, jitted before its first compile
            _fwd_visible = triton.jit(_fwd_visible)
        _JIT[fn.__name__] = triton.jit(fn)
    return _JIT[fn.__name__]


def _launch_shape(n_rows, n_cols):
    """(BLOCK, ROWS, ONE_BLOCK, num_warps, grid) for rows of n_cols."""
    if n_cols <= _MAX_BLOCK:
        block = max(16, 1 << (n_cols - 1).bit_length())
        one = True
    else:
        block, one = _CHUNK, False
    rows = max(1, _PROGRAM_ELEMS // block)
    elems = rows * block
    num_warps = 4 if elems <= 1024 else (8 if elems <= 4096 else 16)
    return block, rows, one, num_warps, (-(-n_rows // rows),)


def _as_rows(t):
    """`t` as a (rows, last dim) view whose last dim is contiguous (a
    copy only where no such view exists)."""
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(1) == 1 else t2.contiguous()


def _mask_layout(mask, shape):
    """The mask as uint8 broadcast to `shape`, with the numbers the
    kernel needs to find a row's mask entries: (mask, n1, n2, s0, s1, s2,
    sc) for rows indexed (i0 * n1 + i1) * n2 + i2.  Broadcast dims keep
    stride 0 (nothing is materialised); leading dims are merged where
    their strides allow, and only a mask whose leading dims do not fold
    into three is copied out to `shape`."""
    try:
        fits = torch.broadcast_shapes(mask.shape, shape) == tuple(shape)
    except RuntimeError:
        fits = False
    if not fits:
        raise ValueError(f"softmax mask {tuple(mask.shape)} does not "
                         f"broadcast to the scores {tuple(shape)}")
    m = (mask if mask.dtype == torch.bool else mask != 0).view(torch.uint8)
    m = m.expand(shape)
    dims = []
    for n, s in zip(shape[:-1], m.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == s * n:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    if len(dims) > 3:
        m = m.contiguous()
        rows = 1
        for n in shape[:-1]:
            rows *= n
        dims = [(rows, shape[-1])]
    dims = [(1, 0)] * (3 - len(dims)) + dims
    return (m, dims[1][0], dims[2][0], dims[0][1], dims[1][1], dims[2][1],
            m.stride(-1))


def softmax_fwd_triton(x, mask, scale, causal):
    """Launch the forward kernel over a CUDA tensor of any shape (the
    softmax over its last dim); `mask` None or a tensor that broadcasts
    to x.  Returns y, new, of x's shape and dtype.
    `softmax_fwd_triton.launches` counts launches."""
    y, _ = _launch_fwd(x, mask, scale, causal)
    softmax_fwd_triton.launches += 1
    return y


def _launch_fwd(x, mask, scale, causal):
    """`softmax_fwd_triton`'s launch, uncounted: (y, the compiled kernel,
    whose `asm["ptx"]` shows its loads; None for an empty x)."""
    if not x.dtype.is_floating_point:
        raise TypeError(f"softmax kernel needs a float tensor, got {x.dtype}")
    shape = tuple(x.shape)
    n_cols = shape[-1]
    sq = shape[-2] if len(shape) >= 2 else 1
    x2 = _as_rows(x)
    n_rows = x2.shape[0]
    y = torch.empty((n_rows, n_cols), dtype=x.dtype, device=x.device)
    if mask is not None:
        if mask.device != x.device:
            raise ValueError(f"softmax mask on {mask.device}, scores on "
                             f"{x.device}")
        m, n1, n2, s0, s1, s2, sc = _mask_layout(mask, shape)
    else:
        m, n1, n2, s0, s1, s2, sc = x2, 1, 1, 0, 0, 0, 0
    compiled = None
    if n_rows and n_cols:
        block, rows, one, num_warps, grid = _launch_shape(n_rows, n_cols)
        compiled = _jit(_softmax_fwd_kernel)[grid](
            x2, m, y, n_rows, n_cols, x2.stride(0), y.stride(0), sq, n1, n2,
            s0, s1, s2, sc, float(scale), ROWS=rows, BLOCK=block,
            GROUP=_GROUP, ONE_BLOCK=one, HAS_MASK=mask is not None,
            CAUSAL=bool(causal), num_warps=num_warps)
    return y.reshape(shape), compiled


softmax_fwd_triton.launches = 0


def softmax_bwd_triton(g, y, scale):
    """Launch the backward kernel over CUDA g and y of one shape:
    returns dx = scale · y · (g - Σ g·y), new, in g's dtype.
    `softmax_bwd_triton.launches` counts launches."""
    if g.shape != y.shape:
        raise ValueError(f"softmax backward: g {tuple(g.shape)} and y "
                         f"{tuple(y.shape)} differ")
    shape = tuple(y.shape)
    n_cols = shape[-1]
    g2, y2 = _as_rows(g), _as_rows(y)
    n_rows = g2.shape[0]
    dx = torch.empty((n_rows, n_cols), dtype=g.dtype, device=g.device)
    if n_rows and n_cols:
        block, rows, one, num_warps, grid = _launch_shape(n_rows, n_cols)
        _jit(_softmax_bwd_kernel)[grid](
            g2, y2, dx, n_rows, n_cols, g2.stride(0), y2.stride(0),
            dx.stride(0), float(scale), ROWS=rows, BLOCK=block,
            ONE_BLOCK=one, num_warps=num_warps)
    softmax_bwd_triton.launches += 1
    return dx.reshape(shape)


softmax_bwd_triton.launches = 0


def softmax_fwd(x, mask, scale, causal):
    """The forward on x's device: the plain version on the CPU, the
    kernel on the card (or a raise)."""
    tensors = (x,) if mask is None else (x, mask)
    if not check_kernel_device(*tensors):
        return softmax_fwd_reference(x, mask, scale, causal)
    return softmax_fwd_triton(x, mask, scale, causal)


def softmax_bwd(g, y, scale):
    """The backward on the tensors' device, as `softmax_fwd`."""
    if not check_kernel_device(g, y):
        return softmax_bwd_reference(g, y, scale)
    return softmax_bwd_triton(g, y, scale)


class _SoftmaxFn(torch.autograd.Function):
    """The softmax as one differentiable op that saves only its output
    (≡ the JAX package's `custom_vjp` of `_softmax`)."""

    @staticmethod
    def forward(ctx, x, mask, scale, causal):
        y = softmax_fwd(x, mask, scale, causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return softmax_bwd(g, y, ctx.scale), None, None, None


def _softmax(x, mask, scale, causal):
    if torch.is_grad_enabled() and x.requires_grad:
        return _SoftmaxFn.apply(x, mask, scale, causal)
    return softmax_fwd(x, mask, scale, causal)


# --------------------------------- public API -------------------------------

def scaled_softmax(x, scale: float = 1.0):
    """≡ the JAX package's `scaled_softmax` (apex's ScaledSoftmax)."""
    return _softmax(x, None, float(scale), False)


def scaled_masked_softmax(x, mask, scale: float = 1.0):
    """≡ the JAX package's `scaled_masked_softmax` (apex's
    ScaledMaskedSoftmax and GenericScaledMaskedSoftmax): `mask` bool,
    True = masked out, broadcasting to x; None is the plain form."""
    if mask is None:
        return scaled_softmax(x, scale)
    return _softmax(x, mask, float(scale), False)


def scaled_upper_triang_masked_softmax(x, scale: float = 1.0):
    """≡ the JAX package's `scaled_upper_triang_masked_softmax` (apex's
    ScaledUpperTriangMaskedSoftmax): causal over the last two dims."""
    if x.shape[-2] != x.shape[-1]:
        raise ValueError("causal softmax requires sq == sk")
    return _softmax(x, None, float(scale), True)


def get_batch_per_block(sq: int, sk: int, batches: int,
                        attn_heads: int) -> int:
    """Scheduling hint ≡ the JAX package's `get_batch_per_block` (itself
    ≡ scaled_masked_softmax_cuda.get_batch_per_block): how many (batch,
    head) rows one block covers under the JAX package's row-block
    heuristic, at least 1."""
    rows = batches * attn_heads * sq
    return max(1, row_block(rows, sk) // max(sq, 1))
