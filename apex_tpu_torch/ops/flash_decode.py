"""Paged flash-decode attention (counterpart of apex_tpu/ops/flash_decode.py).

Layout contract (shared with serve/kv_cache.py), as in the JAX package:

  q              (n_slots, q_len, n_q_heads, head_dim)
  k/v_pages      (n_kv_heads, n_pages, page_size, head_dim)
  block_table    (n_slots, pages_per_slot_max) int32 page ids
  lengths        (n_slots,) int32 — total visible tokens per slot,
                 INCLUDING the q_len new tokens (already written into
                 the pages).  0 marks an inactive slot.

Query row i of slot s sees cache positions p < lengths[s] - q_len + 1
+ i; GQA rides as n_q_heads = G * n_kv_heads with query head h reading
kv head h // G.  Rows with no visible position return exact ZEROS.
Partial last pages and stale table entries are masked by position,
never by data.

Two implementations of that contract live here:

  * `paged_attention_reference` — the plain PyTorch version: gather the
    table's pages, mask by position, fp32 softmax attention.  It runs
    for CPU tensors, and `chip_smoke.py` holds the kernel against it.
  * the CUDA C++ kernel in `apex_tpu_torch/csrc/flash_decode.cu` (the
    port of `_decode_kernel`), launched by `flash_decode` for CUDA
    tensors under the host plan `decode_plan` (kv heads a block, a split
    of a slot's pages among the blocks of a cluster, ring slots, row
    tile).  Its source note says what bounds it and how.

Forward only: decode is inference.
"""

from __future__ import annotations

import ctypes
import math
import warnings
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops._common import (check_kernel_device,
                                        sm_count as _sm_count)

_NEG_INF = -1e30

_HP_FALLBACK_WARNED = set()

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (64, 128)


def _check_shapes(q, k_pages, v_pages, block_table, lengths):
    if q.ndim != 4:
        raise ValueError(f"q must be (n_slots, q_len, n_q_heads, "
                         f"head_dim), got {tuple(q.shape)}")
    n_slots, q_len, hq, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages/v_pages must be equal-(n_kv_heads, n_pages, "
            f"page_size, head_dim), got {tuple(k_pages.shape)}/"
            f"{tuple(v_pages.shape)}")
    hkv = k_pages.shape[0]
    if k_pages.shape[3] != d:
        raise ValueError(f"head_dim mismatch: q {d} vs pages "
                         f"{k_pages.shape[3]}")
    if hq % hkv:
        raise ValueError(
            f"n_q_heads={hq} must be a multiple of n_kv_heads={hkv} "
            "(GQA groups)")
    if block_table.ndim != 2 or block_table.shape[0] != n_slots:
        raise ValueError(
            f"block_table must be (n_slots={n_slots}, max_pages), got "
            f"{tuple(block_table.shape)}")
    if tuple(lengths.shape) != (n_slots,):
        raise ValueError(
            f"lengths must be ({n_slots},), got {tuple(lengths.shape)}")
    max_kv = block_table.shape[1] * k_pages.shape[2]
    if q_len > max_kv:
        raise ValueError(
            f"q_len={q_len} exceeds the table's capacity {max_kv}")


def _resolve_heads_per_step(heads_per_step, hkv, page_size):
    """Validated kv-head packing factor, as in the JAX package.  None →
    the largest power-of-two divisor of n_kv_heads with hp * page_size
    <= 1024 (the TPU's rule; on the card `decode_plan` states its own for
    None); an invalid explicit value warns once and degrades to 1."""
    if heads_per_step is None:
        hp = 1
        while (hkv % (hp * 2) == 0 and (hp * 2) * page_size <= 1024
               and hp * 2 <= 16):
            hp *= 2
        return hp
    hp = int(heads_per_step)
    if hp == 1:
        return 1
    if hp < 1 or hkv % hp:
        key = ("decode_hp", hp, hkv)
        if key not in _HP_FALLBACK_WARNED:
            _HP_FALLBACK_WARNED.add(key)
            reason = ("is not positive" if hp < 1 else
                      f"does not divide n_kv_heads={hkv}")
            warnings.warn(
                f"flash_decode: heads_per_step={hp} {reason}; running "
                "unpacked", stacklevel=4)
        return 1
    return hp


def _tuned_decode_config(n_slots, q_len, hq, hkv, d, page_size, dtype):
    """The tuner's `flash_decode` config for this call (the JAX package's
    lookup, apex_tpu/ops/flash_decode.py:133-158): a host-side dict
    access, None on a miss.  A hit whose heads_per_step is out of range
    or does not divide n_kv_heads warns once and is ignored."""
    from apex_tpu_torch import tune

    cfg = tune.tuned("flash_decode",
                     tune.decode_attrs(n_slots, q_len, hq, hkv, d,
                                       page_size, dtype))
    if not cfg:
        return None
    hp = cfg.get("heads_per_step", 1)
    if not (isinstance(hp, int) and 1 <= hp <= 16 and hkv % hp == 0):
        key = ("decode_cfg", hkv, d, page_size)
        if key not in _HP_FALLBACK_WARNED:
            _HP_FALLBACK_WARNED.add(key)
            warnings.warn(
                f"flash_decode: ignoring out-of-range tuned config "
                f"{cfg}; using heuristics", stacklevel=4)
        return None
    return cfg


# --------------------------- plain PyTorch version ---------------------------

def paged_attention_reference(q, k_pages, v_pages, block_table, lengths,
                              *, softmax_scale=None):
    """Dense paged-decode version: gather every table page, mask by
    position, plain softmax attention in fp32 (the op sequence of the
    JAX package's `paged_attention_reference`).  Rows with no visible
    position return exact zeros.  Runs on any device."""
    _check_shapes(q, k_pages, v_pages, block_table, lengths)
    n_slots, q_len, hq, d = q.shape
    hkv = k_pages.shape[0]
    G = hq // hkv
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(d))
    tbl = block_table.long()
    # (hkv, slots, maxp, page, d) → (slots, hkv, max_kv, d)
    k = k_pages[:, tbl].permute(1, 0, 2, 3, 4).reshape(n_slots, hkv, -1, d)
    v = v_pages[:, tbl].permute(1, 0, 2, 3, 4).reshape(n_slots, hkv, -1, d)
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    qb = q.permute(0, 2, 1, 3)  # (slots, hq, q_len, d)
    s = torch.einsum("bhqd,bhkd->bhqk", qb.float(), k.float()) * scale
    kvpos = torch.arange(k.shape[2], device=q.device,
                         dtype=torch.int32)[None, None, None, :]
    vis = (lengths.to(torch.int32)[:, None, None, None] - q_len + 1
           + torch.arange(q_len, device=q.device,
                          dtype=torch.int32)[None, None, :, None])
    s = torch.where(kvpos >= vis, _NEG_INF, s)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    # rows with zero visible positions are exact zeros, not the
    # softmax-of-all-masked uniform average
    o = torch.where(vis > 0, o, 0.0).to(q.dtype)
    return o.permute(0, 2, 1, 3)


# ------------------------------- CUDA kernel --------------------------------

# the plan's constants (csrc/flash_decode.cu): keys a ring slot holds, a
# block's shared memory when blocks share an SM (five of them) and when
# the grid leaves an SM to each, the cluster's most blocks, and the blocks
# the rule for heads_per_step keeps at least (per SM)
DECODE_CHUNK = 128
DECODE_SMEM_SHARED = 40 * 1024
DECODE_SMEM_ALONE = 200 * 1024
DECODE_MAX_SPLIT = 8
DECODE_BLOCKS_PER_SM = 4
_WARPS = 4
_LIB = None


class DecodePlan(NamedTuple):
    """What `csrc/flash_decode.cu` runs: `heads_per_block` kv heads of one
    slot a block, a slot's pages split among `split` blocks of a cluster,
    a ring of `stages` slots of `chunk` keys of K and V, and `row_tile`
    query rows a block."""
    heads_per_block: int
    split: int
    stages: int
    row_tile: int
    chunk: int


def decode_smem(d, itemsize, row_tile, hp, split, stages, chunk, max_pages):
    """The dynamic shared memory of a block: a copy of `Layout` in
    csrc/flash_decode.cu, which must match it (the C entry refuses a plan
    its own Layout cannot hold).  The ring, q's rows, the rank's table
    entries, the warps' merge, with a split the block's merged states,
    the mbarriers."""
    def r16(b):
        return -(-b // 16) * 16
    pps = -(-max_pages // split)
    q = stages * 2 * chunk * d * itemsize
    state = (q + r16(hp * row_tile * d * itemsize) + r16(pps * 4)
             + _WARPS * row_tile * (d + 2) * 4)
    extra = hp * row_tile * (d + 2) * 4 if split > 1 else 0
    return r16(state + extra) + stages * 8


def decode_plan(n_slots, hkv, G, q_len, max_pages, page, d, itemsize, sms,
                hp=None):
    """The decode kernel's plan.  `hp`, the kv heads a block, is the
    caller's or the tuner's heads_per_step (validated); without one, the
    largest power of two dividing hkv that still leaves
    `DECODE_BLOCKS_PER_SM` blocks an SM.  The row tile is 1 when G * q_len
    is 1, else 8.  When the blocks would leave SMs idle and a slot has
    more than one page, a slot's pages split among as many blocks of a
    cluster (at most 8) as the idle SMs take.  The ring holds as many
    chunks (at most all of a block's) as a block's share of shared memory
    does: `DECODE_SMEM_ALONE` when the grid leaves an SM to each block,
    else `DECODE_SMEM_SHARED`."""
    rows = G * q_len
    row_tile = 1 if rows == 1 else 8
    tiles = -(-rows // row_tile)
    if hp is None:
        hp = 1
        while (hkv % (2 * hp) == 0 and n_slots * (hkv // (2 * hp)) * tiles
               >= DECODE_BLOCKS_PER_SM * sms):
            hp *= 2
    if hp < 1 or hkv % hp:
        raise ValueError(f"flash_decode plan: heads_per_step {hp} does not "
                         f"divide n_kv_heads={hkv}")
    base = n_slots * (hkv // hp) * tiles
    split = 1
    if base < sms and max_pages > 1:
        split = max(1, min(DECODE_MAX_SPLIT, max_pages, sms // base))
    chunk = min(page, DECODE_CHUNK)
    items = hp * -(-max_pages // split) * -(-page // chunk)
    budget = DECODE_SMEM_ALONE if base * split <= sms else DECODE_SMEM_SHARED
    fixed = decode_smem(d, itemsize, row_tile, hp, split, 0, chunk,
                        max_pages)
    stages = max(1, min(items, (budget - fixed) // (2 * chunk * d * itemsize
                                                     + 8)))
    return DecodePlan(hp, split, stages, row_tile, chunk)


def _bind(lib):
    """`lib` (a build of csrc/flash_decode.cu) with its C entry's types."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.apex_flash_decode.restype = i32
    lib.apex_flash_decode.argtypes = [
        i32, i32, vp, i64, i64, i64, vp, vp, vp, vp, vp,
        i32, i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, i32,
        i32, i32, vp]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from apex_tpu_torch import csrc
        _LIB = _bind(csrc.load("flash_decode"))
    return _LIB


def _launch(plan, q, k_pages, v_pages, tbl, lens, out, scale):
    """Launch the kernel on the current stream under `plan` into the
    preallocated out; counts the launch in `flash_decode_cuda.launches`
    and keeps the plan in `flash_decode_cuda.last_plan`."""
    n_slots, q_len, hq, d = q.shape
    hkv, n_pages, page, _ = k_pages.shape
    err = _lib().apex_flash_decode(
        _KERNEL_DTYPES[q.dtype], d, q.data_ptr(), q.stride(0), q.stride(1),
        q.stride(2), k_pages.data_ptr(), v_pages.data_ptr(), tbl.data_ptr(),
        lens.data_ptr(), out.data_ptr(), n_slots, q_len, hq, hkv, n_pages,
        page, tbl.shape[1], float(scale), plan.heads_per_block, plan.split,
        plan.stages, plan.row_tile, plan.chunk,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed (plan "
                           f"{tuple(plan)}): CUDA error {err}")
    flash_decode_cuda.launches += 1
    flash_decode_cuda.last_plan = plan


def flash_decode_cuda(q, k_pages, v_pages, block_table, lengths, scale,
                      heads_per_step=None):
    """Launch the CUDA kernel on the current stream (shapes already
    checked) under `decode_plan`, heads_per_step (validated) giving its
    heads a block.  Raises on anything the kernel does not take and when
    the launch is refused.  `flash_decode_cuda.launches` counts
    launches."""
    n_slots, q_len, hq, d = q.shape
    hkv, n_pages, page, _ = k_pages.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_decode kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"flash_decode kernel needs one dtype, got q "
                        f"{q.dtype}, pages {k_pages.dtype}/{v_pages.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    if page % 8:
        raise ValueError(f"flash_decode kernel takes a page_size that is a "
                         f"multiple of 8, got {page}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("flash_decode kernel needs contiguous k/v pages "
                         "(one layer's view of the pool is)")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("flash_decode kernel needs 16-byte aligned pages")
    if q.stride(-1) != 1:
        raise ValueError("flash_decode kernel needs q's head_dim "
                         "contiguous")
    tbl = block_table.to(torch.int32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((n_slots, q_len, hq, d), dtype=q.dtype,
                      device=q.device)
    plan = decode_plan(n_slots, hkv, hq // hkv, q_len, tbl.shape[1], page, d,
                       q.element_size(), _sm_count(q.device), heads_per_step)
    _launch(plan, q, k_pages, v_pages, tbl, lens, out, scale)
    return out


flash_decode_cuda.launches = 0
flash_decode_cuda.last_plan = None


# --------------------------------- public API -------------------------------

def flash_decode(q, k_pages, v_pages, block_table, lengths, *,
                 softmax_scale: Optional[float] = None,
                 heads_per_step: Optional[int] = None):
    """Single/few-query attention against a paged KV cache (module
    docstring for the layout).  CPU tensors run the plain version; CUDA
    tensors run the CUDA kernel or raise.  heads_per_step None consults
    the tuner on a CUDA call (`_tuned_decode_config`, key
    `tune.decode_attrs`), as the JAX package does; a value from either is
    validated as in the JAX package (a bad value warns once and runs
    unpacked) and gives the kernel's kv heads a block; with neither,
    `decode_plan`'s rule does.  Inactive slots (lengths == 0) return
    exact zeros."""
    _check_shapes(q, k_pages, v_pages, block_table, lengths)
    n_slots, q_len, hq, d = q.shape
    hkv, _, page, _ = k_pages.shape
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(d))
    on_card = check_kernel_device(q, k_pages, v_pages, block_table, lengths)
    if on_card and heads_per_step is None:
        cfg = _tuned_decode_config(n_slots, q_len, hq, hkv, d, page,
                                   q.dtype)
        if cfg:
            heads_per_step = cfg.get("heads_per_step")
    hp = (None if heads_per_step is None else
          _resolve_heads_per_step(heads_per_step, hkv, page))
    if not on_card:
        return paged_attention_reference(
            q, k_pages, v_pages, block_table, lengths, softmax_scale=scale)
    return flash_decode_cuda(q, k_pages, v_pages, block_table, lengths,
                             scale, hp)
