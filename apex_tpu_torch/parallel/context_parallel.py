"""Context parallelism for long sequences: ring attention and Ulysses
(counterpart of apex_tpu/parallel/context_parallel.py).

* `ring_attention`: the sequence (and its keys and values) is sharded
  over a process group; each rank keeps its query shard and its running
  online-softmax state (o in fp32, lse), while the key/value chunks
  rotate around the group, one `collectives.ring_hop` (a
  `batch_isend_irecv` to rank r + 1, from rank r - 1; a copy at one rank)
  a step.  Each step runs the flash kernels' chunk entry point
  (`ops.flash_attention._fwd_impl`) on the resident (query shard, key
  chunk) pair and merges its (o, lse) into the state (`_merge`).  The
  hop that brings the next chunk is started before the step's kernels
  and waited for after them.
  - The backward (`torch.autograd.Function`) recomputes from the saved
    q, k, v, o and the fp32 lse: each step runs `_bwd_impl` against the
    GLOBAL o and lse (delta = sum(do * o) in fp32, the same bits each
    step) with `grad_dtype=float32`, so the
    partials add up in fp32 and are rounded once.  The dk/dv fp32
    accumulators travel with their chunk and are home after n hops.
  - Causal: a chunk strictly above the diagonal is SKIPPED (no kernel,
    no zero fill); the diagonal chunk runs the causal kernels, the
    others the full ones.
  - Segment ids rotate with their chunk (global semantics).
  - Dropout hashes each chunk's GLOBAL (query, key) offsets into the
    kernels' coordinate-hash mask (`dropout_keep_dense`), so the ring
    draws one mask, the one single-device flash attention draws over the
    gathered sequence with the same seed.
  - layout="zigzag" (causal only): rank r holds the global half-chunks
    (r, 2n-1-r) (`zigzag_shard` / `zigzag_unshard`), so every rank runs
    two half-chunk computes a step (three on its diagonal step).
* `ulysses_attention`: one all-to-all each way (`all_to_all_single`)
  turns sequence shards into head shards, flash attention runs over the
  full sequence of the local heads (segment ids all-gathered), and the
  output goes back to sequence shards.

One schedule, run two ways.  A ring step's work is a module function of
(rank, n, step) and the chunk the rank holds then (`contiguous_fwd_step`,
`contiguous_bwd_step`, `zigzag_fwd_step`, `zigzag_bwd_step`; the skip /
diagonal / full choice of the JAX package's :271, :468 and :472 is
`_kind_ac` / `_kind_bd`).  The ring runs them over a process group;
`emulate_ring` runs the same functions for n virtual ranks on one
device, in the same order of fp32 sums, so it gives the ring's bits.

The group: `axis_name` is one of the port's axis names ("tp", "dp", "pp",
resolved by `parallel.mesh.group_of`; the JAX tests ring over "tp") or a
`torch.distributed` ProcessGroup (the JAX example rings over a one-axis
"cp" mesh of its own: in the port, the world group).  None, or a name
whose group is None, is a world of one.

On CUDA tensors every chunk runs the flash kernels (bf16, head_dim 64 or
128) or raises; on CPU tensors the plain versions (`flash_fwd_reference`,
`flash_bwd_dq_reference`, `flash_bwd_dkv_reference`, the counterparts of
the JAX package's `_chunk_fwd_jnp` / `_chunk_bwd_jnp`).  The JAX
package's `use_pallas_override` has no counterpart: the device decides,
as for the port's `flash_attention`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from apex_tpu_torch.ops import _common
from apex_tpu_torch.ops.flash_attention import (
    _NEG_INF, _bwd_impl, _fwd_impl, attention_reference, flash_attention)
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import _all_gather, ring_hop

# a chunk's place against the causal diagonal
SKIP, DIAG, FULL = 0, 1, 2


# ------------------------- per-chunk blockwise attention ---------------------

def _chunk_fwd(q, k, v, scale, causal, q_seg, kv_seg, block_q, block_k,
               dropout_rate=0.0, seed=None, q_off=0, k_off=0):
    """(o, lse) of one chunk pair: the kernels on CUDA, the plain version
    on the CPU (`_fwd_impl` decides by device)."""
    return _fwd_impl(q, k, v, scale, causal, dropout_rate, seed, block_q,
                     block_k, None, q_seg, kv_seg, q_off=q_off, k_off=k_off)


def _chunk_bwd(q, k, v, o, lse, do, scale, causal, q_seg, kv_seg, block_q,
               block_k, dropout_rate=0.0, seed=None, q_off=0, k_off=0):
    """fp32 (dq, dk, dv) partials of one chunk pair against the global o
    and lse: the kernels on CUDA, the plain versions on the CPU
    (`_bwd_impl` decides by device and forms delta from do and o)."""
    dq, dk, dv, _ = _bwd_impl(q, k, v, o, lse, do, scale, causal,
                              dropout_rate, seed, block_q, block_k, None,
                              q_seg, kv_seg, grad_dtype=torch.float32,
                              q_off=q_off, k_off=k_off)
    return dq, dk, dv


# ------------------------------- ring core ----------------------------------

def _merge(o_acc, lse_acc, o_c, lse_c):
    """Merge a chunk's normalized (o, lse) into the running state: the
    cross-rank half of online softmax.  Into the empty state (lse -1e30)
    a chunk's o comes back exactly (w1 = 0, w2 = 1)."""
    m = torch.maximum(lse_acc, lse_c)
    w1 = torch.exp(lse_acc - m)
    w2 = torch.exp(lse_c - m)
    wsum = w1 + w2
    o = (o_acc * w1[..., None] + o_c.float() * w2[..., None]
         ) / wsum[..., None]
    return o, m + torch.log(wsum)


def _kind_ac(src, rank):
    """The contiguous causal ring's chunk, and zigzag's (a, c) pair: skip
    above the diagonal, the causal kernels on it, the full ones below."""
    return SKIP if src > rank else DIAG if src == rank else FULL


def _kind_bd(src, rank):
    """Zigzag's (b, d) pair: the late query half against the late key
    half, whose diagonal runs the other way."""
    return SKIP if src < rank else DIAG if src == rank else FULL


def _halves(x, half, axis=2):
    if x is None:
        return None, None
    return x.narrow(axis, 0, half), x.narrow(axis, half, x.shape[axis] - half)


def _empty_state(q, s):
    b, h, _, d = q.shape
    return (torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, s), _NEG_INF, dtype=torch.float32,
                       device=q.device))


def contiguous_fwd_step(rank, n, step, q, k_c, v_c, q_seg, kseg_c, o_acc,
                        lse_acc, *, causal, scale, dropout_rate=0.0,
                        seed=None, block_q=None, block_k=None):
    """Step `step` of rank `rank` of the contiguous ring of `n`: merge the
    chunk of rank (rank - step) mod n, which the rank holds then, into
    (o_acc, lse_acc) and return them (a skipped chunk runs nothing)."""
    s = q.shape[2]
    src = (rank - step) % n
    kind = _kind_ac(src, rank) if causal else FULL
    if kind == SKIP:
        return o_acc, lse_acc
    return _merge(o_acc, lse_acc, *_chunk_fwd(
        q, k_c, v_c, scale, kind == DIAG, q_seg, kseg_c, block_q, block_k,
        dropout_rate, seed, rank * s, src * s))


def contiguous_bwd_step(rank, n, step, q, k_c, v_c, q_seg, kseg_c, o, lse,
                        do, dq_acc, dk_c, dv_c, *, causal, scale,
                        dropout_rate=0.0, seed=None, block_q=None,
                        block_k=None):
    """The backward of `contiguous_fwd_step`: the chunk's fp32 partials
    added in place into dq_acc and into the chunk's travelling dk_c,
    dv_c (a skipped chunk runs nothing)."""
    s = q.shape[2]
    src = (rank - step) % n
    kind = _kind_ac(src, rank) if causal else FULL
    if kind == SKIP:
        return
    dq_p, dk_p, dv_p = _chunk_bwd(
        q, k_c, v_c, o, lse, do, scale, kind == DIAG, q_seg, kseg_c,
        block_q, block_k, dropout_rate, seed, rank * s, src * s)
    dq_acc += dq_p
    dk_c += dk_p
    dv_c += dv_p


def _zz_offsets(rank, n, step, half):
    src = (rank - step) % n
    return (src, rank * half, (2 * n - 1 - rank) * half, src * half,
            (2 * n - 1 - src) * half)


def zigzag_fwd_step(rank, n, step, q, k_c, v_c, q_seg, kseg_c, acc, *,
                    scale, dropout_rate=0.0, seed=None, block_q=None,
                    block_k=None):
    """Step `step` of rank `rank` of the zigzag ring of `n`: the rank's
    query halves a (global half-chunk rank) and b (2n-1-rank) against the
    held chunk's key halves c (src) and d (2n-1-src), in the JAX
    package's order: (b, c) always full, (a, c) by `_kind_ac`, (b, d) by
    `_kind_bd`; (a, d) always skipped.  `acc` = (o_a, l_a, o_b, l_b)."""
    o_a, l_a, o_b, l_b = acc
    half = q.shape[2] // 2
    src, qo_a, qo_b, ko_lo, ko_hi = _zz_offsets(rank, n, step, half)
    q_a, q_b = _halves(q, half)
    qs_a, qs_b = _halves(q_seg, half, axis=1)
    k_lo, k_hi = _halves(k_c, half)
    v_lo, v_hi = _halves(v_c, half)
    ks_lo, ks_hi = _halves(kseg_c, half, axis=1)

    def attend(qh, qsh, kh, vh, ksh, causal, q_off, k_off):
        return _chunk_fwd(qh, kh, vh, scale, causal, qsh, ksh, block_q,
                          block_k, dropout_rate, seed, q_off, k_off)

    o_b, l_b = _merge(o_b, l_b, *attend(q_b, qs_b, k_lo, v_lo, ks_lo, False,
                                        qo_b, ko_lo))
    kind = _kind_ac(src, rank)
    if kind != SKIP:
        o_a, l_a = _merge(o_a, l_a, *attend(q_a, qs_a, k_lo, v_lo, ks_lo,
                                            kind == DIAG, qo_a, ko_lo))
    kind = _kind_bd(src, rank)
    if kind != SKIP:
        o_b, l_b = _merge(o_b, l_b, *attend(q_b, qs_b, k_hi, v_hi, ks_hi,
                                            kind == DIAG, qo_b, ko_hi))
    return o_a, l_a, o_b, l_b


def zigzag_bwd_step(rank, n, step, q, k_c, v_c, q_seg, kseg_c, o, lse,
                    do, dq_acc, dk_c, dv_c, *, scale,
                    dropout_rate=0.0, seed=None, block_q=None,
                    block_k=None):
    """The backward of `zigzag_fwd_step`: each pair's fp32 partials added
    in place, in the forward's order, into the halves of dq_acc and of
    the chunk's travelling dk_c, dv_c."""
    half = q.shape[2] // 2
    src, qo_a, qo_b, ko_lo, ko_hi = _zz_offsets(rank, n, step, half)
    k_lo, k_hi = _halves(k_c, half)
    v_lo, v_hi = _halves(v_c, half)
    ks_lo, ks_hi = _halves(kseg_c, half, axis=1)
    # (query half, its segment ids, o, lse, do, dq), a then b; the
    # kernels take a contiguous lse
    qa, qb = (tuple(_halves(x, half, axis=ax)[i] for x, ax in (
        (q, 2), (q_seg, 1), (o, 2), (lse, 2), (do, 2), (dq_acc, 2)))
        for i in (0, 1))
    qa, qb = ((*h[:3], h[3].contiguous(), *h[4:]) for h in (qa, qb))
    dks, dvs = _halves(dk_c, half), _halves(dv_c, half)

    def partials(qh, kv, causal, q_off, k_off):
        (qq, qs, oh, lh, doh, dqh), (kh, vh, ksh, dkh, dvh) = qh, kv
        dq_p, dk_p, dv_p = _chunk_bwd(qq, kh, vh, oh, lh, doh, scale, causal,
                                      qs, ksh, block_q, block_k,
                                      dropout_rate, seed, q_off, k_off)
        dqh += dq_p
        dkh += dk_p
        dvh += dv_p

    lo = (k_lo, v_lo, ks_lo, dks[0], dvs[0])
    hi = (k_hi, v_hi, ks_hi, dks[1], dvs[1])
    partials(qb, lo, False, qo_b, ko_lo)
    kind = _kind_ac(src, rank)
    if kind != SKIP:
        partials(qa, lo, kind == DIAG, qo_a, ko_lo)
    kind = _kind_bd(src, rank)
    if kind != SKIP:
        partials(qb, hi, kind == DIAG, qo_b, ko_hi)


def _start_hops(group, *xs):
    """Every tensor of `xs` (None stays None) on its ring hop: (buffers,
    work handles)."""
    bufs, works = [], []
    for x in xs:
        if x is None:
            bufs.append(None)
            continue
        buf, w = ring_hop(x, group)
        bufs.append(buf)
        works += w
    return bufs, works


def _wait(works):
    for w in works:
        w.wait()


def _ring_forward(layout, group, q, k, v, q_seg, kv_seg, causal, kw):
    """One rank's forward over the group: o (q's dtype) and the fp32 lse.
    The hop that brings the next chunk runs while this step's kernels
    do."""
    n, rank = M.group_size(group), M.group_rank(group)
    s = q.shape[2]
    if layout == "zigzag":
        acc = _empty_state(q, s // 2) * 2
    else:
        acc = _empty_state(q, s)
    k_c, v_c, ks_c = k, v, kv_seg
    for i in range(n):
        nxt, works = (_start_hops(group, k_c, v_c, ks_c) if i + 1 < n
                      else ((None, None, None), []))
        if layout == "zigzag":
            acc = zigzag_fwd_step(rank, n, i, q, k_c, v_c, q_seg, ks_c, acc,
                                  **kw)
        else:
            acc = contiguous_fwd_step(rank, n, i, q, k_c, v_c, q_seg, ks_c,
                                      *acc, causal=causal, **kw)
        _wait(works)
        k_c, v_c, ks_c = nxt
    if layout == "zigzag":
        o_a, l_a, o_b, l_b = acc
        return (torch.cat([o_a, o_b], dim=2).to(q.dtype),
                torch.cat([l_a, l_b], dim=2))
    return acc[0].to(q.dtype), acc[1]


def _ring_backward(layout, group, q, k, v, q_seg, kv_seg, o, lse, do, causal,
                   kw):
    """One rank's backward over the group: (dq, dk, dv) in the inputs'
    dtypes, summed in fp32.  dk_c and dv_c hop with their chunk after
    each step's partials, n hops in all, so each is home at the end."""
    n, rank = M.group_size(group), M.group_rank(group)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_c = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_c = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_c, v_c, ks_c = k, v, kv_seg
    for i in range(n):
        nxt, works = (_start_hops(group, k_c, v_c, ks_c) if i + 1 < n
                      else ((None, None, None), []))
        args = (rank, n, i, q, k_c, v_c, q_seg, ks_c, o, lse, do, dq, dk_c,
                dv_c)
        if layout == "zigzag":
            zigzag_bwd_step(*args, **kw)
        else:
            contiguous_bwd_step(*args, causal=causal, **kw)
        (dk_c, dv_c), acc_works = _start_hops(group, dk_c, dv_c)
        _wait(works + acc_works)
        k_c, v_c, ks_c = nxt
    return dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype)


class _RingFn(torch.autograd.Function):
    """The ring (either layout) as one differentiable op: the forward
    saves q, k, v, the segment ids, o and the fp32 lse; the backward
    recomputes from them (`_ring_backward`)."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, seed, group, layout, causal,
                scale, block_q, block_k, dropout_rate):
        kw = dict(scale=scale, dropout_rate=dropout_rate, seed=seed,
                  block_q=block_q, block_k=block_k)
        o, lse = _ring_forward(layout, group, q, k, v, q_seg, kv_seg, causal,
                               kw)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, o, lse)
        ctx.group, ctx.layout, ctx.causal, ctx.kw = group, layout, causal, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(ctx.layout, ctx.group, q, k, v, q_seg,
                                    kv_seg, o, lse, do.contiguous(),
                                    ctx.causal, ctx.kw)
        return (dq, dk, dv) + (None,) * 10


def _ring(q, k, v, q_seg, kv_seg, seed, group, causal, scale, block_q=None,
          block_k=None, dropout_rate=0.0):
    """The contiguous ring (the JAX package's `_ring`): `seed` the int32
    dropout seed (None without dropout), `group` a ProcessGroup or None."""
    return _RingFn.apply(q, k, v, q_seg, kv_seg, seed, group, "contiguous",
                         bool(causal), float(scale), block_q, block_k,
                         float(dropout_rate))


def _ring_zz(q, k, v, q_seg, kv_seg, seed, group, scale, block_q=None,
             block_k=None, dropout_rate=0.0):
    """The zigzag ring (the JAX package's `_ring_zz`), causal."""
    return _RingFn.apply(q, k, v, q_seg, kv_seg, seed, group, "zigzag", True,
                         float(scale), block_q, block_k, float(dropout_rate))


def emulate_ring(qs, ks, vs, dos, *, layout="contiguous", causal=False,
                 scale=None, q_segs=None, kv_segs=None, dropout_rate=0.0,
                 seed=None, after=None):
    """`n = len(qs)` virtual ranks of the ring on one device, through the
    ring's own step functions: forward, then the backward from the output
    gradients `dos`.  Step by step, each rank runs its step with the
    chunk it would hold (that of rank (r - step) mod n), and each chunk's
    dk/dv accumulators take the ranks' partials in the ring's order, so
    the results are the ring's bit for bit.  `after(stage, step,
    rank)`, if given, is called after each rank's step ("fwd" or "bwd"),
    e.g. to read launch counters by rank.  Returns (o, dq, dk, dv), each
    a list by rank."""
    n = len(qs)
    s = qs[0].shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(qs[0].shape[-1])
    q_segs = q_segs or [None] * n
    kv_segs = kv_segs or [None] * n
    kw = dict(scale=scale, dropout_rate=dropout_rate, seed=seed)
    zz = layout == "zigzag"
    if zz:
        accs = [_empty_state(q, s // 2) * 2 for q in qs]
    else:
        accs = [_empty_state(q, s) for q in qs]
    for i in range(n):
        for r in range(n):
            c = (r - i) % n
            held = (ks[c], vs[c], q_segs[r], kv_segs[c])
            if zz:
                accs[r] = zigzag_fwd_step(r, n, i, qs[r], held[0], held[1],
                                          held[2], held[3], accs[r], **kw)
            else:
                accs[r] = contiguous_fwd_step(
                    r, n, i, qs[r], held[0], held[1], held[2], held[3],
                    *accs[r], causal=causal, **kw)
            if after is not None:
                after("fwd", i, r)
    if zz:
        os_ = [torch.cat([a[0], a[2]], dim=2).to(q.dtype)
               for a, q in zip(accs, qs)]
        lses = [torch.cat([a[1], a[3]], dim=2) for a in accs]
    else:
        os_ = [a[0].to(q.dtype) for a, q in zip(accs, qs)]
        lses = [a[1] for a in accs]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dks = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvs = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
           for v in vs]
    for i in range(n):
        for r in range(n):
            c = (r - i) % n
            args = (r, n, i, qs[r], ks[c], vs[c], q_segs[r], kv_segs[c],
                    os_[r], lses[r], dos[r], dqs[r], dks[c],
                    dvs[c])
            if zz:
                zigzag_bwd_step(*args, **kw)
            else:
                contiguous_bwd_step(*args, causal=causal, **kw)
            if after is not None:
                after("bwd", i, r)
    return (os_, [d.to(q.dtype) for d, q in zip(dqs, qs)],
            [d.to(k.dtype) for d, k in zip(dks, ks)],
            [d.to(v.dtype) for d, v in zip(dvs, vs)])


# ------------------- zigzag layout (load-balanced causal) -------------------

def _zigzag_perm(n, seq_len):
    """Global positions in zigzag order: rank r's contiguous shard is
    global half-chunks (r, 2n-1-r)."""
    if seq_len % (2 * n):
        raise ValueError(
            f"zigzag needs seq_len % (2*n) == 0, got {seq_len} % {2 * n}")
    c = seq_len // (2 * n)
    return np.concatenate([
        np.r_[r * c:(r + 1) * c, (2 * n - 1 - r) * c:(2 * n - r) * c]
        for r in range(n)])


def zigzag_shard(x, n, axis=2):
    """Reorder a GLOBAL sequence axis so that a contiguous n-way split
    gives rank r the zigzag pair (r, 2n-1-r).  seq % 2n == 0."""
    idx = torch.from_numpy(_zigzag_perm(n, x.shape[axis])).to(x.device)
    return torch.index_select(x, axis, idx)


def zigzag_unshard(x, n, axis=2):
    """Inverse of zigzag_shard."""
    perm = _zigzag_perm(n, x.shape[axis])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return torch.index_select(x, axis, torch.from_numpy(inv).to(x.device))


# -------------------------------- public API --------------------------------

def _group(axis_name):
    """The process group a ring or all-to-all runs over: an axis name (or
    names) through `mesh.group_of`, else the ProcessGroup itself (None:
    a world of one)."""
    if isinstance(axis_name, (str, tuple, list)):
        return M.group_of(axis_name)
    return axis_name


def ring_attention(q, k, v, axis_name, *, causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   segment_ids=None, q_segment_ids=None,
                   kv_segment_ids=None,
                   layout: str = "contiguous",
                   block_q: Optional[int] = None,
                   block_k: Optional[int] = None,
                   dropout_rate: float = 0.0,
                   dropout_key=None):
    """Blockwise ring attention over the group of `axis_name` (see the
    module docstring), ≡ the JAX package's `ring_attention`.

    q, k, v: (b, h, s_local, d), this rank's shard; the global sequence
    is the concatenation over the group in rank order.  Segment ids are
    (b, s_local) ints per shard with global semantics.  Returns this
    rank's output shard (b, h, s_local, d).

    layout="zigzag" (causal only): rank r holds the global half-chunk
    pair (r, 2n-1-r); shard with `zigzag_shard`, undo with
    `zigzag_unshard`.

    dropout_rate / dropout_key: the kernels' in-kernel dropout at each
    chunk's GLOBAL offsets; `dropout_key` is a CPU `torch.Generator`,
    from which one int32 seed is drawn on the host (the same key on
    every rank)."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    d = q.shape[-1]
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / math.sqrt(d))
    if segment_ids is not None:
        if q_segment_ids is not None or kv_segment_ids is not None:
            raise ValueError(
                "pass either segment_ids or q_/kv_segment_ids, not both")
        q_segment_ids = kv_segment_ids = segment_ids
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids go together")
    b, s = q.shape[0], q.shape[2]
    seed = None
    if dropout_rate > 0.0:
        if dropout_key is None:
            raise ValueError("dropout_rate > 0 needs a dropout_key")
        seed = _common.host_seed(dropout_key)
    if q_segment_ids is not None:
        q_segment_ids = torch.as_tensor(q_segment_ids, dtype=torch.int32,
                                        device=q.device)
        kv_segment_ids = torch.as_tensor(kv_segment_ids, dtype=torch.int32,
                                         device=q.device)
        if (tuple(q_segment_ids.shape) != (b, s)
                or tuple(kv_segment_ids.shape) != (b, s)):
            raise ValueError(
                f"segment id shapes {tuple(q_segment_ids.shape)}/"
                f"{tuple(kv_segment_ids.shape)} != ({b}, {s})")
    group = _group(axis_name)
    if layout == "zigzag":
        if not causal:
            raise ValueError(
                "layout='zigzag' is causal-only: non-causal attention "
                "has no positional imbalance to fix — use the default "
                "contiguous layout (results are identical)")
        if s % 2:
            raise ValueError("zigzag needs an even local sequence")
        return _ring_zz(q, k, v, q_segment_ids, kv_segment_ids, seed, group,
                        scale, block_q, block_k, float(dropout_rate))
    return _ring(q, k, v, q_segment_ids, kv_segment_ids, seed, group, causal,
                 scale, block_q, block_k, float(dropout_rate))


def _seq_to_heads(x, group, n):
    """(b, h, s_local, d) → (b, h/n, n·s_local, d): head group j goes to
    rank j, and rank j's sequence shard of this rank's head group comes
    back, in rank order (one all_to_all_single)."""
    b, h, s, d = x.shape
    send = x.reshape(b, n, h // n, s, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    M.all_to_all(recv, send, group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x, group, n):
    """The inverse of `_seq_to_heads`: (b, h/n, n·s_local, d) →
    (b, h, s_local, d)."""
    b, hl, big, d = x.shape
    s = big // n
    send = x.reshape(b, hl, n, s, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    M.all_to_all(recv, send, group)
    return recv.transpose(0, 1).reshape(b, n * hl, s, d)


class _AllToAll(torch.autograd.Function):
    """`_seq_to_heads` (forward=True) or `_heads_to_seq`, whose backward
    is the other one."""

    @staticmethod
    def forward(ctx, x, group, n, to_heads):
        ctx.group, ctx.n, ctx.to_heads = group, n, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, group, n)

    @staticmethod
    def backward(ctx, g):
        fn = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return fn(g.contiguous(), ctx.group, ctx.n), None, None, None


def ulysses_attention(q, k, v, axis_name, *, causal: bool = False,
                      softmax_scale: Optional[float] = None,
                      segment_ids=None,
                      use_flash: bool = True):
    """All-to-all (DeepSpeed-Ulysses-style) sequence parallelism, ≡ the
    JAX package's `ulysses_attention`: seq-sharded (b, h, s_local, d)
    inputs with h divisible by the group's size become head-sharded full
    sequences, `flash_attention` (or `attention_reference` with
    `use_flash=False`) runs on the local heads, and the output goes back
    to sequence shards.  segment_ids: (b, s_local) per shard, global
    semantics, all-gathered to the full sequence.  A world of one runs
    no collective."""
    group = _group(axis_name)
    n = M.group_size(group)
    b, h, s_local, d = q.shape
    assert h % n == 0, "ulysses needs heads divisible by the axis size"

    def seq_to_heads(x):
        return x if group is None else _AllToAll.apply(x, group, n, True)

    def heads_to_seq(x):
        return x if group is None else _AllToAll.apply(x, group, n, False)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    seg_g = None
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, dtype=torch.int32,
                              device=q.device)
        seg_g = seg if group is None else _all_gather(seg, group, 1)
    if use_flash:
        og = flash_attention(qg, kg, vg, causal=causal,
                             softmax_scale=softmax_scale, segment_ids=seg_g)
    else:
        og = attention_reference(qg, kg, vg, causal=causal,
                                 softmax_scale=softmax_scale,
                                 q_segment_ids=seg_g, kv_segment_ids=seg_g)
    return heads_to_seq(og)
