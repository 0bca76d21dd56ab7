"""Blockwise flash attention, forward and backward (counterpart of
apex_tpu/ops/flash_attention.py).

Layout (batch, heads, seq, head_dim), as in the JAX package.  Causal
attention is top-left aligned: query i sees key j iff j <= i.

Two implementations live here:

  * `attention_reference` — the plain PyTorch version: fp32 scores,
    masked scores set to `_NEG_INF` (-1e30), softmax, dropout by
    `_common.dropout` (a bernoulli draw from the key, as the JAX
    package's reference draws it), P.V in fp32.  It runs for CPU tensors
    (autograd gives its gradient), and `chip_smoke.py` holds the kernels
    against it.  Beside it, `flash_fwd_reference` is the plain version
    of the forward kernels with their in-kernel dropout (o and the lse),
    and `flash_bwd_dq_reference` / `flash_bwd_dkv_reference` are the
    plain versions of the backward's dq and dk/dv parts, from the
    forward's lse.
  * the CUDA C++ kernels in `apex_tpu_torch/csrc/flash_attention.cu`,
    the ports of `_fwd_kernel`, `_fwd_kernel_packed`,
    `_bwd_fused_kernel`, `_bwd_fused_kernel_packed`, `_bwd_dq_kernel`
    and `_bwd_dkv_kernel`, launched by `flash_fwd_cuda`,
    `flash_fwd_packed_cuda`, `flash_bwd_cuda`, `flash_bwd_packed_cuda`,
    `flash_bwd_dq_cuda` and `flash_bwd_dkv_cuda` inside `_FlashFn`, a
    `torch.autograd.Function` that saves o and the fp32 lse (b, h, sq).
    Its source note says what bounds them and how.

`heads_per_step` (hp) packs hp heads of one batch row into each block
of the packed kernels: the forward runs packed at any hp that divides
h; the backward takes the JAX package's route (`backward_route`, its
`_bwd_impl` rule): the packed fused kernel while hp > 1, sk * d <=
`_FUSED_BWD_CAP` and hp * sk * d <= `_FUSED_BWD_CAP_PACKED`; else the
fused kernel while sk * d <= `_FUSED_BWD_CAP`; else the split pair (the
dq pass, then the dk/dv pass), e.g. at 32k keys of 64 or GPT-350M at
seq 8192.  Nothing else chooses it.  Per head, the packed kernels give
the unpacked ones' o, lse, dk and dv bit for bit.

When the caller passes none of block_q, block_k and heads_per_step, a
CUDA call consults the tuner (`apex_tpu_torch.tune`, op "flash_sdpa")
for this shape, dtype and device kind, as the JAX package does; a miss
keeps hp = 1, so with an empty cache every call runs the kernels it ran
before the tuner existed.

Dropout (`dropout_rate` > 0 with a `dropout_key`) runs inside every
kernel, as on the TPU: a score (head i = batch * h + head, global query
row q, global key k) is kept where a murmur3-finalised hash of (seed, i,
q, k) clears the rate (`dropout_keep_dense`, the JAX package's
`_dropout_keep`), so the backward regenerates the forward's mask and
the mask is the same whatever the tiles, the packing or the route.  The
seed is one host draw from the key, a CPU `torch.Generator`, as the JAX
package draws an int32 from its key; q_off / k_off shift the hash's rows
and keys for a chunk of a longer sequence.

`_fwd_impl` and `_bwd_impl` are the JAX package's chunk entry points,
which ring attention (`parallel/context_parallel.py`) runs on each chunk
pair: the forward's o and fp32 lse, and the backward from a given lse,
with `grad_dtype=torch.float32` for fp32 dq, dk and dv (the backward
launchers' `out_dtype`, the F32 kernel instantiations; the fused
kernel's dq is its fp32 scratch, uncast), so that the ring's partials
add up in fp32 and are rounded once.

On CUDA the kernels take the surface the training steps use: causal or
not, segment ids or not (BERT's padding mask), dropout or not, bf16,
head_dim 64 or 128, no bias.  A bias raises NotImplementedError on CUDA;
on the CPU the plain version serves all of it.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import Optional

import torch

from apex_tpu_torch.ops import _common
from apex_tpu_torch.ops._common import add_kernel_flops, check_kernel_device

_NEG_INF = -1e30

_KERNEL_DTYPES = (torch.bfloat16,)
_KERNEL_HEAD_DIMS = (64, 128)
# the JAX package's fused-backward cap (apex_tpu/ops/flash_attention.py:41),
# applied as its _bwd_impl applies it (:979): the TPU kernel keeps the
# whole (sk, d) dk/dv scratch in VMEM, so past the cap it splits
_FUSED_BWD_CAP = 256 * 1024
# the packed fused backward's cap on hp * sk * d (the JAX package's
# _FUSED_BWD_CAP_PACKED, :45: two fp32 (hp, sk, d) VMEM scratches); the
# card keeps dk, dv in registers per head and has no such limit, but the
# route is the JAX package's
_FUSED_BWD_CAP_PACKED = 512 * 1024
# query rows per step of the split backward's plain versions: bounds
# their fp32 (rows, sk) temporaries (1 GiB each at 8 heads of 32k keys)
_REFERENCE_ROWS = 1024


def backward_route(sk: int, head_dim: int, heads_per_step: int = 1) -> str:
    """The backward `_FlashFn` runs for sk keys of `head_dim` with
    `heads_per_step` heads packed: "packed" while hp > 1, sk * head_dim
    <= `_FUSED_BWD_CAP` and hp * sk * head_dim <= `_FUSED_BWD_CAP_PACKED`;
    else "fused" while sk * head_dim <= `_FUSED_BWD_CAP`; else "split" —
    the JAX package's `_bwd_impl` rule (:947-979) for the surface CUDA
    takes (no bias, so no dbias unpacks or splits it)."""
    fits = sk * head_dim <= _FUSED_BWD_CAP
    if (heads_per_step > 1 and fits
            and heads_per_step * sk * head_dim <= _FUSED_BWD_CAP_PACKED):
        return "packed"
    return "fused" if fits else "split"


# ----------------------------- kernel-shape knobs -----------------------------
#
# The JAX package's block and packing knobs and its tuner lookup, with the
# same results and warnings.  The CUDA kernels keep their own tiles
# whatever the blocks say (the forward 192 query rows at d=64, 128 at
# d=128, x 128 keys; the fused backward and the dk/dv pass 128 keys x 64
# query rows; the dq pass 192 query rows at d=64, 128 at d=128, x 64
# keys): block_q / block_k are validated (a tuned or explicit block that
# does not divide the sequence warns once) and not otherwise read.

_BLOCK_FALLBACK_WARNED = set()
# the tuner's cap on hp * block_q * block_k (the JAX package's, :1135)
_TUNED_SCORE_ELEMS_CAP = 1024 * 1024


def _pick_block(seq, cap=512):
    for b in (1024, 512, 256, 128, 64, 32, 16, 8):
        if b <= cap and seq % b == 0:
            return b
    return None


def _fit_block(blk, seq, name):
    """Largest power-of-two block <= blk that divides seq (the JAX
    package's `_fit_block`): an explicit or tuned block that does not
    divide the sequence warns once per (name, blk, seq) and falls back;
    raises if no power-of-two block divides it."""
    if blk is None or seq % blk == 0:
        return blk
    fb = _pick_block(seq, cap=blk)
    if fb is None:
        raise ValueError(
            f"{name}={blk} does not divide seq={seq} and no smaller "
            f"power-of-two block divides it either")
    key = (name, blk, seq)
    if key not in _BLOCK_FALLBACK_WARNED:
        _BLOCK_FALLBACK_WARNED.add(key)
        warnings.warn(
            f"flash attention: {name}={blk} does not divide seq={seq}; "
            f"falling back to the largest dividing block {fb}",
            stacklevel=3)
    return fb


def _resolve_heads_per_step(heads_per_step, h, want_dbias=False):
    """Validated packing factor (the JAX package's, :774-791): it must
    divide the head count; dbias paths run unpacked.  An invalid value
    warns once and falls back to 1."""
    hp = int(heads_per_step or 1)
    if hp <= 1:
        return 1
    if want_dbias:
        return 1
    if h % hp:
        key = ("heads_per_step", hp, h)
        if key not in _BLOCK_FALLBACK_WARNED:
            _BLOCK_FALLBACK_WARNED.add(key)
            warnings.warn(
                f"flash attention: heads_per_step={hp} does not divide "
                f"num_heads={h}; running unpacked", stacklevel=3)
        return 1
    return hp


def _tuned_flash_config(b, h, sq, sk, d, dtype, causal, bias_kind,
                        has_seg):
    """The tuner's config for this call (the JAX package's lookup,
    :1139-1174): a host-side dict access, None on a miss, and None for
    sq != sk (entries are swept at self-attention shapes).  A hit whose
    blocks or packing are out of range warns once and is ignored."""
    from apex_tpu_torch import tune

    if sq != sk:
        return None
    cfg = tune.tuned("flash_sdpa",
                     tune.flash_attrs(b, h, sq, sk, d, dtype, causal,
                                      bias=bias_kind, seg=has_seg))
    if not cfg:
        return None
    bq = cfg.get("block_q")
    bk = cfg.get("block_k")
    hp = cfg.get("heads_per_step", 1)
    ok = (all(v is None or (isinstance(v, int) and 8 <= v <= 4096)
              for v in (bq, bk))
          and isinstance(hp, int) and 1 <= hp <= 16
          and hp * (bq or 1024) * (bk or 1024) <= _TUNED_SCORE_ELEMS_CAP)
    if not ok:
        key = ("tuned_cfg", sq, sk, d)
        if key not in _BLOCK_FALLBACK_WARNED:
            _BLOCK_FALLBACK_WARNED.add(key)
            warnings.warn(
                f"flash attention: ignoring out-of-range tuned config "
                f"{cfg} at (sq={sq}, sk={sk}, d={d}); using heuristics",
                stacklevel=3)
        return None
    return cfg


# --------------------------- plain PyTorch version ---------------------------

def attention_reference(q, k, v, *, causal=False, softmax_scale=None,
                        bias=None, q_segment_ids=None, kv_segment_ids=None,
                        dropout_rate=0.0, dropout_key=None):
    """Plain softmax attention with fp32 scores (the op sequence of the
    JAX package's `attention_reference`).  Dropout masks the
    post-softmax weights through `_common.dropout` with `dropout_key`, a
    `torch.Generator` (a bernoulli draw: another stream than the
    kernels' hash, the same distribution); with no key it applies none."""
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if q_segment_ids is not None:
        seg = (q_segment_ids[:, None, :, None]
               != kv_segment_ids[:, None, None, :])
        s = s.masked_fill(seg, _NEG_INF)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=s.device).triu(1)
        s = s.masked_fill(mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = _common.dropout(dropout_key, dropout_rate, p)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ------------------------------ in-kernel dropout ----------------------------
#
# The TPU kernels' keep mask (`_dropout_keep` over `_fmix32`,
# apex_tpu/ops/flash_attention.py:183-224): for head i (batch * h + head),
# global query row q and global key k,
#   v = fmix32(seed * 1000003 + i + k * 0x9e3779b1 + q * 0x85ebca77)
# in wrapping 32-bit arithmetic with logical shifts, and the score is kept
# where (v & 0x7fffffff) >= int(rate * 2^31).  Here the 32-bit words are
# held in int64 tensors in [0, 2^32), and products are taken by 16-bit
# halves so that no int64 product overflows.

_M32 = 0xFFFFFFFF


def _mul32(a, c):
    """(a * c) mod 2^32 for an int64 tensor `a` in [0, 2^32) and a
    constant 0 <= c < 2^32."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix32(h):
    """murmur3's finalizer on 32-bit words (int64 tensors in [0, 2^32),
    so >> is the logical shift of the JAX package's uint32 lanes)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _i32(x) -> int:
    """An integer (or a one-element tensor or array) as an int32 value,
    wrapped as the JAX package's int32 casts wrap it."""
    if hasattr(x, "reshape"):
        x = x.reshape(-1)[0]
    return ((int(x) + 2 ** 31) & _M32) - 2 ** 31


def _seed3(seed, q_off=0, k_off=0):
    """(seed, global q offset, global k offset) as int32 values (the JAX
    package's `_seed3`, there a (3, 1) int32 operand): None is seed 0; a
    tensor or array seed gives its first element."""
    return (_i32(0 if seed is None else seed), _i32(q_off), _i32(k_off))


def _threshold(rate: float) -> int:
    """The hash's keep threshold on its low 31 bits, as the JAX package
    computes it."""
    return int(rate * 2147483648.0)


def dropout_keep_dense(seed, b, h, sq, sk, rate, q_off=0, k_off=0,
                       device=None):
    """The dense (b, h, sq, sk) keep mask, bool: the bits of the kernels'
    in-kernel hash (head i = batch * h + head, query rows q_off .. q_off +
    sq - 1, keys k_off .. k_off + sk - 1), equal to the JAX package's
    `dropout_keep_dense` bit for bit."""
    seed, q_off, k_off = _seed3(seed, q_off, k_off)
    i64 = dict(dtype=torch.int64, device=device)
    head = (((seed & _M32) * 1000003) & _M32) + torch.arange(b * h, **i64)
    qt = _mul32((q_off + torch.arange(sq, **i64)) & _M32, 0x85EBCA77)
    kt = _mul32((k_off + torch.arange(sk, **i64)) & _M32, 0x9E3779B1)
    v = (head.reshape(b, h, 1, 1) + qt.reshape(1, 1, sq, 1)
         + kt.reshape(1, 1, 1, sk)) & _M32
    return (_fmix32(v) & 0x7FFFFFFF) >= _threshold(rate)


def _drop_mask(dropout_rate, seed, b, h, r0, r1, nk, device):
    """The keep mask of query rows [r0, r1) and keys [0, nk) under
    `seed` = (seed, q_off, k_off), or None without dropout."""
    if not dropout_rate:
        return None
    s, q_off, k_off = _seed3(*seed)
    return dropout_keep_dense(s, b, h, r1 - r0, nk, dropout_rate,
                              q_off + r0, k_off, device=device)


def flash_fwd_reference(q, k, v, scale, causal, q_seg=None, kv_seg=None,
                        dropout_rate=0.0, seed=(0, 0, 0)):
    """Plain version of the forward kernels, on any device: (o in q's
    dtype, lse (b, h, sq) fp32), `_REFERENCE_ROWS` query rows at a time.
    Scores in fp32 with masked ones at -1e30 (`attention_reference`'s
    masks), p = softmax, and with `dropout_rate` the kernels' dropout:
    p·v takes where(keep, p, 0) · 1/(1 - rate), keep =
    `dropout_keep_dense` under `seed` = (seed, q_off, k_off), while the
    lse stays the undropped softmax's.  Differentiable (autograd)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dev = q.device
    inv = 1.0 / (1.0 - dropout_rate)
    outs, lses = [], []
    for r0 in range(0, sq, _REFERENCE_ROWS):
        r1 = min(sq, r0 + _REFERENCE_ROWS)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                         k.float()) * scale
        keep = torch.ones((r1 - r0, sk), dtype=torch.bool, device=dev)
        if q_seg is not None:
            keep = keep & (q_seg[:, None, r0:r1, None]
                           == kv_seg[:, None, None, :])
        if causal:
            keep = keep & (torch.arange(r0, r1, device=dev)[:, None]
                           >= torch.arange(sk, device=dev)[None, :])
        s = s.masked_fill(~keep, _NEG_INF)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)    # a dead row: uniform, as the kernels
        drop = _drop_mask(dropout_rate, seed, b, h, r0, r1, sk, dev)
        if drop is not None:
            p = torch.where(drop, p, 0.0) * inv
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v.float()))
        lses.append(lse)
    return torch.cat(outs, dim=2).to(q.dtype), torch.cat(lses, dim=2)


def _split_bwd_blocks(q, k, v, do, lse, delta, scale, causal, q_seg,
                      kv_seg, all_keys, dropout_rate=0.0, seed=(0, 0, 0)):
    """The backward's score blocks, `_REFERENCE_ROWS` query rows at a
    time: (r0, r1, nk, p, ds) in fp32 over keys [0, nk).  p = exp(scale
    q kᵀ − lse) where a key is visible, and where it is masked 1/sk for a
    row whose keys are all masked (its lse is about -1e30: the uniform
    weights of `attention_reference`), else 0; ds = p (dp − delta), 0
    wherever masked, dp = do vᵀ.  With dropout (the kernels' mask under
    `seed`, as `flash_fwd_reference` applies it) dp is masked and scaled
    before ds, and the p returned (dv's) is the dropped, scaled one.
    Causal without `all_keys` stops at the block's last row (every p and
    ds past it is 0; not so for a dead row's p)."""
    b, h, sq = q.shape[:3]
    sk = k.shape[2]
    dev = q.device
    inv = 1.0 / (1.0 - dropout_rate)
    for r0 in range(0, sq, _REFERENCE_ROWS):
        r1 = min(sq, r0 + _REFERENCE_ROWS)
        nk = min(sk, r1) if causal and not all_keys else sk
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                         k[:, :, :nk].float()) * scale
        keep = torch.ones((r1 - r0, nk), dtype=torch.bool, device=dev)
        if causal:
            keep = (torch.arange(r0, r1, device=dev)[:, None]
                    >= torch.arange(nk, device=dev)[None, :])
        if q_seg is not None:
            keep = keep & (q_seg[:, None, r0:r1, None]
                           == kv_seg[:, None, None, :nk])
        row_lse = lse[:, :, r0:r1, None]
        masked_p = torch.where(row_lse < -1e29, 1.0 / sk, 0.0)
        p = torch.where(keep, torch.exp(s - row_lse), masked_p)
        del s
        dp = torch.einsum("bhqd,bhkd->bhqk", do[:, :, r0:r1].float(),
                          v[:, :, :nk].float())
        drop = _drop_mask(dropout_rate, seed, b, h, r0, r1, nk, dev)
        if drop is not None:
            dp = torch.where(drop, dp, 0.0) * inv
        ds = torch.where(keep, p * (dp - delta[:, :, r0:r1, None]), 0.0)
        del dp, keep
        if drop is not None:
            p = torch.where(drop, p, 0.0) * inv
        yield r0, r1, nk, p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, scale, causal,
                           q_seg=None, kv_seg=None, dropout_rate=0.0,
                           seed=(0, 0, 0), out_dtype=None):
    """Plain version of the backward's dq (the split route's dq pass,
    `_bwd_dq_kernel`, and the fused kernels' dq), on any device: dq =
    scale ds k from the forward's fp32 `lse` and `delta = sum(do * o,
    -1)` in fp32, ds rounded to the inputs' dtype before its product as
    the kernels round it; `dropout_rate` and `seed` (seed, q_off, k_off)
    as the forward had them.  Returns dq in q's dtype, or `out_dtype`
    (fp32: the F32 kernels' output, the same sums unrounded)."""
    out_dtype = out_dtype or q.dtype
    dq = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    for r0, r1, nk, _, ds in _split_bwd_blocks(
            q, k, v, do, lse, delta, scale, causal, q_seg, kv_seg, False,
            dropout_rate, seed):
        dq[:, :, r0:r1] = (scale * torch.einsum(
            "bhqk,bhkd->bhqd", ds.to(q.dtype).float(),
            k[:, :, :nk].float())).to(out_dtype)
    return dq


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, scale, causal,
                            q_seg=None, kv_seg=None, dropout_rate=0.0,
                            seed=(0, 0, 0), out_dtype=None):
    """Plain version of the backward's dk and dv (the split route's dk/dv
    pass, `_bwd_dkv_kernel`, and the fused kernels' dk, dv), on any
    device: dv = pᵀ do (p dropped and scaled with dropout) and dk = scale
    dsᵀ q, summed over the query blocks in fp32, p and ds rounded to the
    inputs' dtype before their products; `dropout_rate` and `seed` as
    the forward had them.  Returns (dk, dv) in k's and v's dtypes, or
    both in `out_dtype`."""
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for r0, r1, nk, p, ds in _split_bwd_blocks(
            q, k, v, do, lse, delta, scale, causal, q_seg, kv_seg,
            q_seg is not None, dropout_rate, seed):
        dv[:, :, :nk] += torch.einsum("bhqk,bhqd->bhkd",
                                      p.to(q.dtype).float(),
                                      do[:, :, r0:r1].float())
        dk[:, :, :nk] += scale * torch.einsum(
            "bhqk,bhqd->bhkd", ds.to(q.dtype).float(),
            q[:, :, r0:r1].float())
    return dk.to(out_dtype or k.dtype), dv.to(out_dtype or v.dtype)


# ------------------------------- CUDA kernels -------------------------------

_LIB = None


def _bind(lib):
    """Declare the C interface of a loaded flash_attention library."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64, i64p = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
    seg = [vp, vp, i64, i64]           # q_seg, kv_seg and their batch strides
    # dropout (a flag; 1/(1 - rate); the hash's threshold; seed, q_off,
    # k_off) before the segment ids (`_drop_args`)
    seg = [i32, f32, i32, i32, i32, i32] + seg
    lib.apex_flash_attn_fwd.restype = i32
    lib.apex_flash_attn_fwd.argtypes = [
        i32, vp, vp, vp, vp, vp, i64p, i32, i32, i32, i32, f32, i32,
        *seg, vp]
    # the backward kernels take a zeroed int32 work-item counter after dv,
    # and after `causal` a flag for fp32 gradients (the F32
    # instantiations)
    lib.apex_flash_attn_bwd.restype = i32
    lib.apex_flash_attn_bwd.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64p, i32, i32, i32,
        i32, f32, i32, i32, *seg, vp]
    # the dq pass: dq, then its zeroed int32 work-item counter
    lib.apex_flash_attn_bwd_dq.restype = i32
    lib.apex_flash_attn_bwd_dq.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, i64p, i32, i32, i32, i32, f32,
        i32, i32, *seg, vp]
    lib.apex_flash_attn_bwd_dkv.restype = i32
    lib.apex_flash_attn_bwd_dkv.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64p, i32, i32, i32, i32,
        f32, i32, i32, *seg, vp]
    # the packed pair: the unpacked arguments with hp after `causal`
    lib.apex_flash_attn_fwd_packed.restype = i32
    lib.apex_flash_attn_fwd_packed.argtypes = [
        i32, vp, vp, vp, vp, vp, i64p, i32, i32, i32, i32, f32, i32, i32,
        *seg, vp]
    lib.apex_flash_attn_bwd_packed.restype = i32
    lib.apex_flash_attn_bwd_packed.argtypes = [
        i32, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i64p, i32, i32, i32,
        i32, f32, i32, i32, *seg, vp]
    # the backward's dynamic shared memory: (head_dim, seg, dq) -> bytes
    lib.apex_flash_attn_bwd_smem.restype = i32
    lib.apex_flash_attn_bwd_smem.argtypes = [i32, i32, i32]
    # the dq pass's: (head_dim, seg) -> bytes
    lib.apex_flash_attn_bwd_dq_smem.restype = i32
    lib.apex_flash_attn_bwd_dq_smem.argtypes = [i32, i32]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        _LIB = _bind(csrc.load("flash_attention"))
    return _LIB


def _kernel_operand(t):
    """`t` as the kernels read it: bf16, last dim contiguous, every row
    16-byte aligned (base and strides), no stride of 0 across more than
    one row (a TMA tensor map, which the forward reads through, takes
    none).  A view that is not gets one contiguous copy (a fresh one:
    `contiguous()` would return a misaligned contiguous view as it is)."""
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % 8 or (s == 0 and n > 1)
                   for s, n in zip(t.stride()[:3], t.shape[:3]))):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _check_kernel_inputs(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes (batch, heads, seq, "
                         "head_dim) tensors")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not agree")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise NotImplementedError(
            f"flash attention kernel takes bfloat16 q/k/v, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"flash attention kernel takes head_dim "
                                  f"in {_KERNEL_HEAD_DIMS}, got {d}")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs at least one query and "
                         "one key")
    if b * h > 65535:
        raise ValueError(f"flash attention kernel grid holds at most "
                         f"65535 batch*heads, got {b * h}")


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _seg_args(q_seg, kv_seg, b, sq, sk):
    """The C interface's [q_seg, kv_seg, q_seg_sb, kv_seg_sb] (int32 ids
    contiguous along the sequence, a copy only where they are not; or
    nulls) and the id tensors they point into.  The ids are never read
    on the host."""
    if q_seg is None and kv_seg is None:
        return [None, None, 0, 0], ()
    if q_seg is None or kv_seg is None:
        raise ValueError("q_seg and kv_seg go together")
    out = []
    for name, t, s in (("q_seg", q_seg, sq), ("kv_seg", kv_seg, sk)):
        if tuple(t.shape) != (b, s):
            raise ValueError(f"{name} must be ({b}, {s}), got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32 or t.stride(1) != 1:
            t = t.to(torch.int32).contiguous()
        out.append(t)
    return [out[0].data_ptr(), out[1].data_ptr(), out[0].stride(0),
            out[1].stride(0)], out


def _fwd_flops(b, h, sq, sk, d):
    """The flops of the forward's two products, q·kᵀ and p·v, over the
    full sq x sk square (what the plain version computes and
    `monitor.flops` counts, causal or not).  The backward's four
    products (dp, dv, dq, dk) are twice this; the split backward's dq
    pass computes dp and dq, its dk/dv pass dv and dk (the recomputed
    scores are not the model's products and are not counted)."""
    return 4 * b * h * sq * sk * d


def _raise_launch_error(err, what):
    """Raise for a launcher's return code: 0 is a launch; a code at or
    above `TENSOR_MAP_ERROR` is a tensor map the CUDA driver refused (its
    CUresult added), anything else a CUDA error."""
    from apex_tpu_torch.csrc import TENSOR_MAP_ERROR

    if err >= TENSOR_MAP_ERROR:
        raise RuntimeError(f"flash attention {what}: cuTensorMapEncodeTiled "
                           f"refused a TMA tensor map, CUresult "
                           f"{err - TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash attention {what} launch failed: CUDA "
                           f"error {err}")


def _drop_args(dropout_rate, seed):
    """The C interface's dropout arguments: [flag, 1/(1 - rate) as fp32,
    the hash's threshold, seed, q_off, k_off] (`seed` = the (seed, q_off,
    k_off) triple).  Rate 0 launches the kernels without dropout."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if not dropout_rate:
        return [0, 1.0, 0, 0, 0, 0]
    return [1, 1.0 / (1.0 - dropout_rate), _threshold(dropout_rate),
            *_seed3(*seed)]


def flash_fwd_cuda(q, k, v, scale, causal, q_seg=None, kv_seg=None,
                   dropout_rate=0.0, seed=(0, 0, 0)):
    """Launch the forward kernel on the current stream; `q_seg` (b, sq)
    and `kv_seg` (b, sk) are optional integer segment ids (both or
    neither); `dropout_rate` > 0 drops p·v's weights by the in-kernel
    hash under `seed` = (seed, q_off, k_off) (`dropout_keep_dense`).
    Returns (o (b, h, sq, d) bf16, lse (b, h, sq) fp32).
    `flash_fwd_cuda.launches` counts launches, and `.dropout_launches`
    those with dropout (each launcher of this module has both)."""
    _check_kernel_inputs(q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    seg, keep = _seg_args(q_seg, kv_seg, b, sq, sk)
    drop = _drop_args(dropout_rate, seed)
    _require_cuda(q, k, v, *keep)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_fwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _strides(q, k, v), b, h, sq, sk, float(scale),
        int(bool(causal)), *drop, *seg, stream)
    _raise_launch_error(err, "forward")
    add_kernel_flops(_fwd_flops(b, h, sq, sk, d))
    flash_fwd_cuda.launches += 1
    flash_fwd_cuda.dropout_launches += int(dropout_rate > 0.0)
    return o, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.dropout_launches = 0


def _check_heads_per_step(hp, h):
    if not (isinstance(hp, int) and hp >= 1 and h % hp == 0):
        raise ValueError(f"the packed flash kernels take a heads_per_step "
                         f"that divides num_heads={h}, got {hp!r}")


def flash_fwd_packed_cuda(q, k, v, scale, causal, hp, q_seg=None,
                          kv_seg=None, dropout_rate=0.0, seed=(0, 0, 0)):
    """Launch the packed forward kernel on the current stream: the
    arguments of `flash_fwd_cuda` and `hp`, the heads of one batch row
    each block walks (it must divide h).  o and lse are
    `flash_fwd_cuda`'s bit for bit.  `flash_fwd_packed_cuda.launches`
    counts launches."""
    _check_kernel_inputs(q, k, v)
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    _check_heads_per_step(hp, h)
    seg, keep = _seg_args(q_seg, kv_seg, b, sq, sk)
    drop = _drop_args(dropout_rate, seed)
    _require_cuda(q, k, v, *keep)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_fwd_packed(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _strides(q, k, v), b, h, sq, sk, float(scale),
        int(bool(causal)), hp, *drop, *seg, stream)
    _raise_launch_error(err, "packed forward")
    add_kernel_flops(_fwd_flops(b, h, sq, sk, d))
    flash_fwd_packed_cuda.launches += 1
    flash_fwd_packed_cuda.dropout_launches += int(dropout_rate > 0.0)
    return o, lse


flash_fwd_packed_cuda.launches = 0
flash_fwd_packed_cuda.dropout_launches = 0


def _require_cuda(*ts):
    """The launchers take CUDA tensors only: the plain versions serve the
    CPU (`flash_attention` dispatches by device)."""
    if not check_kernel_device(*ts):
        raise ValueError("the flash attention kernels take CUDA tensors; "
                         "CPU tensors go to the plain versions")


def _bwd_operands(q, k, v, do, lse, delta, q_seg, kv_seg, dropout_rate,
                  seed):
    """The checks every backward launcher makes before it launches (the
    kernel surface, segment ids, dropout, do, lse, delta, the device),
    and the operands as the kernels read them: (q, k, v, do, dropout and
    seg args, the id tensors they point into)."""
    _check_kernel_inputs(q, k, v)
    q, k, v, do = (_kernel_operand(t) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    sk = k.shape[2]
    seg, keep = _seg_args(q_seg, kv_seg, b, sq, sk)
    seg = _drop_args(dropout_rate, seed) + seg
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 "
                             f"{(b, h, sq)}, got {tuple(t.shape)} {t.dtype}")
    _require_cuda(q, k, v, do, lse, delta, *keep)
    return q, k, v, do, seg, keep


def _dq_scratch(b, h, sq, d, device):
    """The fused kernels' zeroed scratch, from one allocation: dq_acc
    (b, h, sq, d) fp32, and after it the launch's int32 work-item
    counter (its address), which starts at 0 (the bits of 0.0)."""
    n = b * h * sq * d
    buf = torch.zeros(n + 4, dtype=torch.float32, device=device)
    return buf[:n].view(b, h, sq, d), buf.data_ptr() + 4 * n


def _grad_dtype(out_dtype, q):
    """The backward launchers' output dtype and the C flag for it: None
    or q's dtype (bf16) launches the kernels as they were; fp32 the F32
    instantiations."""
    if out_dtype is None or out_dtype == q.dtype:
        return q.dtype, 0
    if out_dtype == torch.float32:
        return torch.float32, 1
    raise ValueError(f"the flash backward kernels write bf16 or fp32 "
                     f"gradients, not {out_dtype}")


def flash_bwd_cuda(q, k, v, do, lse, delta, scale, causal, q_seg=None,
                   kv_seg=None, dropout_rate=0.0, seed=(0, 0, 0),
                   out_dtype=None):
    """Launch the fused backward kernel on the current stream: dq, dk, dv
    from q, k, v, the output gradient `do`, the forward's fp32 `lse` and
    `delta = sum(do * o, -1)` in fp32, with the forward's segment ids and
    dropout (`dropout_rate`, `seed`: the mask regenerated).  dq is summed
    across key tiles in an fp32 scratch buffer by bulk reduce-adds and
    cast once.  `out_dtype=torch.float32` returns that fp32 dq uncast and
    launches the F32 instantiation, which writes dk and dv in fp32 (their
    bf16 launch's values before the rounding).  `flash_bwd_cuda.launches`
    counts launches, `.f32_launches` those with fp32 outputs (each
    backward launcher has both)."""
    q, k, v, do, seg, _keep = _bwd_operands(q, k, v, do, lse, delta, q_seg,
                                            kv_seg, dropout_rate, seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    gdt, f32 = _grad_dtype(out_dtype, q)
    dq_acc, work = _dq_scratch(b, h, sq, d, q.device)
    dk = torch.empty((b, h, sk, d), dtype=gdt, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=gdt, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_bwd(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), work, _strides(q, k, v, do), b, h, sq, sk,
        float(scale), int(bool(causal)), f32, *seg, stream)
    _raise_launch_error(err, "backward")
    add_kernel_flops(2 * _fwd_flops(b, h, sq, sk, d))
    flash_bwd_cuda.launches += 1
    flash_bwd_cuda.dropout_launches += int(dropout_rate > 0.0)
    flash_bwd_cuda.f32_launches += f32
    return (dq_acc if f32 else dq_acc.to(q.dtype)), dk, dv


flash_bwd_cuda.launches = 0
flash_bwd_cuda.dropout_launches = 0
flash_bwd_cuda.f32_launches = 0


def flash_bwd_packed_cuda(q, k, v, do, lse, delta, scale, causal, hp,
                          q_seg=None, kv_seg=None, dropout_rate=0.0,
                          seed=(0, 0, 0)):
    """Launch the packed fused backward kernel on the current stream: the
    arguments of `flash_bwd_cuda` and `hp` (dividing h).  dk and dv are
    `flash_bwd_cuda`'s bit for bit; dq is summed by the same fp32
    reduce-adds, whose order changes from run to run.
    `flash_bwd_packed_cuda.launches` counts launches."""
    _check_heads_per_step(hp, q.shape[1])
    q, k, v, do, seg, _keep = _bwd_operands(q, k, v, do, lse, delta, q_seg,
                                            kv_seg, dropout_rate, seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dq_acc, work = _dq_scratch(b, h, sq, d, q.device)
    dk = torch.empty((b, h, sk, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_bwd_packed(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), work, _strides(q, k, v, do), b, h, sq, sk,
        float(scale), int(bool(causal)), hp, *seg, stream)
    _raise_launch_error(err, "packed backward")
    add_kernel_flops(2 * _fwd_flops(b, h, sq, sk, d))
    flash_bwd_packed_cuda.launches += 1
    flash_bwd_packed_cuda.dropout_launches += int(dropout_rate > 0.0)
    return dq_acc.to(q.dtype), dk, dv


flash_bwd_packed_cuda.launches = 0
flash_bwd_packed_cuda.dropout_launches = 0


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, q_seg=None,
                      kv_seg=None, dropout_rate=0.0, seed=(0, 0, 0),
                      out_dtype=None):
    """Launch the split backward's dq pass on the current stream (the
    arguments of `flash_bwd_cuda`).  Each dq row is summed over its key
    tiles in registers and written once, in bf16 (fp32 with
    `out_dtype=torch.float32`: the F32 instantiation): no atomics, the
    same bits on every run.  The kernel takes its work items from a
    zeroed int32 counter.  `flash_bwd_dq_cuda.launches` counts
    launches."""
    q, k, v, do, seg, _keep = _bwd_operands(q, k, v, do, lse, delta, q_seg,
                                            kv_seg, dropout_rate, seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    gdt, f32 = _grad_dtype(out_dtype, q)
    dq = torch.empty((b, h, sq, d), dtype=gdt, device=q.device)
    work = torch.zeros(1, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_bwd_dq(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), work.data_ptr(),
        _strides(q, k, v, do), b, h, sq, sk, float(scale),
        int(bool(causal)), f32, *seg, stream)
    _raise_launch_error(err, "dq pass")
    add_kernel_flops(_fwd_flops(b, h, sq, sk, d))
    flash_bwd_dq_cuda.launches += 1
    flash_bwd_dq_cuda.dropout_launches += int(dropout_rate > 0.0)
    flash_bwd_dq_cuda.f32_launches += f32
    return dq


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.dropout_launches = 0
flash_bwd_dq_cuda.f32_launches = 0


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal, q_seg=None,
                       kv_seg=None, dropout_rate=0.0, seed=(0, 0, 0),
                       out_dtype=None):
    """Launch the split backward's dk/dv pass on the current stream (the
    arguments of `flash_bwd_cuda`): the fused kernel without its dq
    part, so dk and dv are the fused kernel's bit for bit.  Returns (dk,
    dv) in bf16, or fp32 with `out_dtype=torch.float32`.
    `flash_bwd_dkv_cuda.launches` counts launches."""
    q, k, v, do, seg, _keep = _bwd_operands(q, k, v, do, lse, delta, q_seg,
                                            kv_seg, dropout_rate, seed)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    gdt, f32 = _grad_dtype(out_dtype, q)
    dk = torch.empty((b, h, sk, d), dtype=gdt, device=q.device)
    dv = torch.empty((b, h, sk, d), dtype=gdt, device=q.device)
    work = torch.zeros(4, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().apex_flash_attn_bwd_dkv(
        d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        work.data_ptr(), _strides(q, k, v, do), b, h, sq, sk, float(scale),
        int(bool(causal)), f32, *seg, stream)
    _raise_launch_error(err, "dk/dv pass")
    add_kernel_flops(_fwd_flops(b, h, sq, sk, d))
    flash_bwd_dkv_cuda.launches += 1
    flash_bwd_dkv_cuda.dropout_launches += int(dropout_rate > 0.0)
    flash_bwd_dkv_cuda.f32_launches += f32
    return dk, dv


flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.dropout_launches = 0
flash_bwd_dkv_cuda.f32_launches = 0


# ----------------------- the chunk entry points (ring) -----------------------
#
# The JAX package's internal `_fwd_impl` / `_bwd_impl` (ops/flash_attention
# .py:807, :884), which its ring attention runs on each (query chunk, key
# chunk) pair with the chunks' global offsets (parallel/context_parallel
# .py:180-207).  CUDA tensors run the kernels (or raise), CPU tensors the
# plain versions.

def _chunk_checks(bias, want_dbias=False):
    if bias is not None or want_dbias:
        raise NotImplementedError(
            "the flash chunk entry points take no bias and give no dbias "
            "yet (ROADMAP Queue 2 item 38)")


def _fwd_impl(q, k, v, scale, causal, dropout_rate=0.0, seed=None,
              block_q=None, block_k=None, bias=None, q_seg=None,
              kv_seg=None, q_off=0, k_off=0, heads_per_step=1):
    """The forward on one chunk pair (the JAX package's `_fwd_impl`):
    (o in q's dtype, lse (b, h, sq) fp32).  `seed` is the int32 dropout
    seed (None: 0); `q_off` / `k_off` are the chunk's global query row
    and key offsets, which only the dropout hash reads (`_seed3`), so the
    mask is the gathered sequence's.  `causal` is the chunk's own
    top-left diagonal.  block_q / block_k are validated as
    `flash_attention` validates them; heads_per_step > 1 runs the packed
    forward on CUDA."""
    _chunk_checks(bias)
    sq, sk = q.shape[2], k.shape[2]
    _fit_block(block_q, sq, "block_q")
    _fit_block(block_k, sk, "block_k")
    seed3 = _seed3(seed, q_off, k_off)
    extras = [t for t in (q_seg, kv_seg) if t is not None]
    if not check_kernel_device(q, k, v, *extras):
        return flash_fwd_reference(q, k, v, scale, causal, q_seg, kv_seg,
                                   dropout_rate, seed3)
    hp = _resolve_heads_per_step(heads_per_step, q.shape[1])
    if hp > 1:
        return flash_fwd_packed_cuda(q, k, v, scale, causal, hp, q_seg,
                                     kv_seg, dropout_rate, seed3)
    return flash_fwd_cuda(q, k, v, scale, causal, q_seg, kv_seg,
                          dropout_rate, seed3)


def _bwd_impl(q, k, v, o, lse, do, scale, causal, dropout_rate=0.0,
              seed=None, block_q=None, block_k=None, bias=None,
              q_seg=None, kv_seg=None, want_dbias=False, grad_dtype=None,
              q_off=0, k_off=0, heads_per_step=1):
    """The backward on one chunk pair (the JAX package's `_bwd_impl`):
    (dq, dk, dv, None), from the forward's o and fp32 lse (the ring
    passes the global ones) and the output gradient `do`; delta =
    sum(do * o) in fp32, as the JAX package forms it.  `grad_dtype`
    (None: the inputs' dtypes; fp32: the F32 kernels, so that the ring
    sums its partials in fp32 and rounds once).  On CUDA the route is
    `backward_route`'s: the packed fused kernel, the fused kernel or the
    split pair; fp32 gradients with heads packed raise.  On the CPU the
    plain versions (`flash_bwd_dq_reference`, `flash_bwd_dkv_reference`)
    give every dtype."""
    _chunk_checks(bias, want_dbias)
    sq, sk = q.shape[2], k.shape[2]
    _fit_block(block_q, sq, "block_q")
    _fit_block(block_k, sk, "block_k")
    seed3 = _seed3(seed, q_off, k_off)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, scale, causal, q_seg, kv_seg,
            dropout_rate, seed3)
    extras = [t for t in (q_seg, kv_seg) if t is not None]
    if not check_kernel_device(q, k, v, do, lse, *extras):
        dq = flash_bwd_dq_reference(*args, out_dtype=grad_dtype)
        dk, dv = flash_bwd_dkv_reference(*args, out_dtype=grad_dtype)
        return dq, dk, dv, None
    hp = _resolve_heads_per_step(heads_per_step, q.shape[1])
    route = backward_route(sk, q.shape[3], hp)
    if route == "packed":
        if grad_dtype is not None and grad_dtype != q.dtype:
            raise NotImplementedError(
                "fp32 flash gradients with heads packed (heads_per_step > "
                "1): the packed backward writes bf16 only (ROADMAP Queue 2 "
                "item 46)")
        dq, dk, dv = flash_bwd_packed_cuda(*args[:8], hp, *args[8:])
    elif route == "fused":
        dq, dk, dv = flash_bwd_cuda(*args, out_dtype=grad_dtype)
    else:
        dq = flash_bwd_dq_cuda(*args, out_dtype=grad_dtype)
        dk, dv = flash_bwd_dkv_cuda(*args, out_dtype=grad_dtype)
    return dq, dk, dv, None


class _FlashFn(torch.autograd.Function):
    """The kernels as one differentiable op: forward runs the packed
    kernel when `hp` > 1 and saves o and the fp32 lse; backward forms
    delta = sum(do * o) in fp32 (as `_bwd_impl` does) and runs the packed
    fused kernel, the fused kernel or the split pair, as `backward_route`
    says.  `hp` is already resolved (`_resolve_heads_per_step`).  With
    `dropout_rate` > 0 every launch, forward and backward, gets the rate
    and `seed` = (seed, q_off, k_off), so the backward regenerates the
    forward's mask; at rate 0 the launchers are called as they were
    before dropout existed."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_seg, kv_seg, hp,
                dropout_rate=0.0, seed=(0, 0, 0)):
        drop = ({} if not dropout_rate
                else {"dropout_rate": dropout_rate, "seed": seed})
        if hp > 1:
            o, lse = flash_fwd_packed_cuda(q, k, v, scale, causal, hp, q_seg,
                                           kv_seg, **drop)
        else:
            o, lse = flash_fwd_cuda(q, k, v, scale, causal, q_seg, kv_seg,
                                    **drop)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg)
        ctx.scale, ctx.causal, ctx.hp, ctx.drop = scale, causal, hp, drop
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_seg, kv_seg = ctx.saved_tensors
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, delta, ctx.scale, ctx.causal)
        route = backward_route(k.shape[2], q.shape[3], ctx.hp)
        if route == "packed":
            dq, dk, dv = flash_bwd_packed_cuda(*args, ctx.hp, q_seg, kv_seg,
                                               **ctx.drop)
        elif route == "fused":
            dq, dk, dv = flash_bwd_cuda(*args, q_seg, kv_seg, **ctx.drop)
        else:
            dq = flash_bwd_dq_cuda(*args, q_seg, kv_seg, **ctx.drop)
            dk, dv = flash_bwd_dkv_cuda(*args, q_seg, kv_seg, **ctx.drop)
        return (dq, dk, dv) + (None,) * (len(ctx.needs_input_grad) - 3)


# --------------------------------- public API -------------------------------

def flash_attention(q, k, v, *, causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    bias=None,
                    segment_ids=None,
                    q_segment_ids=None,
                    kv_segment_ids=None,
                    dropout_rate: float = 0.0,
                    dropout_key=None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    heads_per_step: Optional[int] = None,
                    bias_grad: bool = True):
    """Flash attention over (batch, heads, seq, head_dim) ≡ the JAX
    package's `flash_attention` (same arguments and checks).  CPU tensors
    run the plain version (`attention_reference`, which takes every
    argument; dropout there is `_common.dropout`'s bernoulli draw from
    `dropout_key`, as the JAX package's reference draws it); CUDA tensors
    run the kernels or raise: a bias raises NotImplementedError on CUDA.
    With `dropout_rate` > 0 the kernels drop in-kernel by the coordinate
    hash (`dropout_keep_dense`) under one int32 seed drawn on the host
    from `dropout_key`, a CPU `torch.Generator` (no device sync), as the
    JAX package draws `jax.random.randint(key, (1, 1), -2**31, 2**31 -
    1)` for its kernels.  Segment ids go
    to the segment-masked kernels as they are, never read on the host;
    a masked score is -1e30, so a query row with every key masked gets
    uniform weights over the keys, as the plain version gives it.

    block_q / block_k / heads_per_step: the kernel-shape knobs.  The
    CUDA kernels keep their own tiles (forward 192 or 128 query rows x
    128 keys, backward 128 keys x 64 rows): block_q and block_k are
    validated as the JAX package validates them (one that does not divide the
    sequence warns once) and not otherwise read.  heads_per_step > 1
    runs the packed kernels, hp heads of one batch row per block (one
    that does not divide h warns once and runs unpacked).  When all
    three are None, a CUDA call consults the tuner (`_tuned_flash_config`)
    for a config swept at this exact (shape, dtype, device kind); a miss
    or APEX_TPU_TUNE=0 keeps hp = 1, so an empty cache runs the kernels
    that explicit None runs.  The CPU's plain version serves every hp.
    """
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(d)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_key is None:
        raise ValueError("dropout_rate > 0 requires dropout_key")
    if segment_ids is not None:
        if q_segment_ids is not None or kv_segment_ids is not None:
            raise ValueError(
                "pass either segment_ids or q_/kv_segment_ids, not both")
        q_segment_ids = kv_segment_ids = segment_ids
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    b, h = q.shape[0], q.shape[1]
    sq, sk = q.shape[2], k.shape[2]
    if bias is not None:
        if (bias.ndim != 4 or bias.shape[0] not in (1, b)
                or bias.shape[1] not in (1, h)
                or bias.shape[2] not in (1, sq)
                or bias.shape[3] not in (1, sk)):
            raise ValueError(
                f"bias shape {tuple(bias.shape)} not broadcastable to "
                f"({b}|1, {h}|1, {sq}|1, {sk}|1)")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (b, sq)
            or tuple(kv_segment_ids.shape) != (b, sk)):
        raise ValueError(
            f"segment id shapes {tuple(q_segment_ids.shape)}/"
            f"{tuple(kv_segment_ids.shape)} != ({b}, {sq})/({b}, {sk})")
    extras = [t for t in (bias, q_segment_ids, kv_segment_ids)
              if t is not None]
    if not check_kernel_device(q, k, v, *extras):
        if bias is not None and not bias_grad:
            bias = bias.detach()
        return attention_reference(
            q, k, v, causal=causal, softmax_scale=scale, bias=bias,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            dropout_rate=dropout_rate, dropout_key=dropout_key)
    if bias is not None:
        raise NotImplementedError(
            "flash attention on CUDA does not take bias yet (the training "
            "steps' surface is causal or not, segment ids or not, dropout "
            "or not, no bias)")
    if _pick_block(sq) and _pick_block(sk):    # where JAX runs its kernels
        if block_q is None and block_k is None and heads_per_step is None:
            # the key's bias kind is "none": CUDA takes no bias
            cfg = _tuned_flash_config(b, h, sq, sk, d, q.dtype, causal,
                                      "none", q_segment_ids is not None)
            if cfg:
                block_q = cfg.get("block_q")
                block_k = cfg.get("block_k")
                heads_per_step = cfg.get("heads_per_step")
        _fit_block(block_q, sq, "block_q")
        _fit_block(block_k, sk, "block_k")
    hp = _resolve_heads_per_step(heads_per_step, h)
    if dropout_rate > 0.0:
        seed = _seed3(_common.host_seed(dropout_key))
        return _FlashFn.apply(q, k, v, float(scale), bool(causal),
                              q_segment_ids, kv_segment_ids, hp,
                              float(dropout_rate), seed)
    return _FlashFn.apply(q, k, v, float(scale), bool(causal),
                          q_segment_ids, kv_segment_ids, hp)
