"""Chunked compute/collective overlap primitives (counterpart of
apex_tpu/parallel/overlap.py:1-350).

The TP hot path's tax is a handful of big collectives that serialize
against the GEMMs that produce or consume them: the column-parallel
layer's sequence all-gather must finish before its GEMM starts, and the
row-parallel reduce-scatter or all-reduce cannot start until its GEMM
ends.  Split the work along the sequence into `chunks` pieces and
pipeline it: the collective of one chunk is in flight while the GEMM of
the next runs.  The JAX package leaves the overlapping to XLA's async
collectives; here each hop's P2P, and each chunk's reduce-scatter,
all-gather or all-reduce, is issued with `async_op=True` before the next
chunk's GEMM and waited on only where its result is read, so that
NCCL's stream runs it under the GEMM.

Four fused matmul+collective spellings, one per TP layer shape, each a
`torch.autograd.Function` whose backward is chunked as the JAX
package's `custom_vjp` is:

  ring_gather_matmul    column-parallel + sequence_parallel: the
                        all-gather + GEMM as p - 1 ring steps of P2P
                        hops interleaved with partial GEMMs
  matmul_reduce_scatter row-parallel + sequence_parallel: the GEMM and
                        the reduce-scatter chunk by chunk along the
                        output's sequence rows
  matmul_all_reduce     row-parallel, no SP: the same with all-reduces
  copy_matmul           column-parallel, no SP: the plain local GEMM
                        forward; the backward chunks dx = all-reduce of
                        g · wᵀ

GEMMs are `torch.matmul` in the input dtype (fp32 accumulation, one
rounding); weight gradients built from several chunks or ring steps
accumulate their partials in fp32 and are cast to the weight's dtype
once.  `chunks == 1` never enters these functions: the layers keep
their monolithic spelling.

Chunk counts are tuner-owned: `tune.tuned("overlap_chunks",
tune.overlap_attrs(...))`, 1 on a miss or at one rank.  `resolve_chunks`
applies the flash-attention block rule to a count that does not divide
the chunked dimension: the largest count that does, with a warning once
per call site.
"""

from __future__ import annotations

import warnings

import torch

from apex_tpu_torch.ops._common import loop_iteration
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import ring_hop

# call sites that already warned about a non-dividing chunk request —
# warn once per (site, requested, dim)
_WARNED_SITES = set()


def resolve_chunks(requested: int, dim: int, site: str = "overlap") -> int:
    """Largest divisor of `dim` that is <= `requested` (>= 1), warning
    once per (site, requested, dim) when that is not `requested`."""
    requested = int(requested)
    dim = int(dim)
    if requested <= 1 or dim <= 1:
        return 1
    c = min(requested, dim)
    while dim % c:
        c -= 1
    if c != requested:
        key = (site, requested, dim)
        if key not in _WARNED_SITES:
            _WARNED_SITES.add(key)
            warnings.warn(
                f"overlap_chunks={requested} does not divide the "
                f"chunked dim ({dim}) at {site!r}; falling back to "
                f"{c} chunks", stacklevel=2)
    return c


def layer_chunks(requested, path: str, rows: int, width: int,
                 axis_name: str, dtype, divisor_of: int) -> int:
    """The chunk count of one TP layer call.  `requested` None is
    tuner-owned: the `overlap_chunks` entry keyed by
    `tune.overlap_attrs(path, rows, width, tp size, dtype)` on this
    device kind, 1 on a miss; with no group or one rank there is no
    collective to hide, so 1 without a lookup (where the JAX package
    asks the tuner at tp = 1 too).  An int is the A/B override.  Either
    goes through `resolve_chunks` against `divisor_of`."""
    if requested is None:
        p = M.group_size(M.group_of(axis_name))
        if p == 1:
            return 1
        from apex_tpu_torch import tune

        cfg = tune.tuned("overlap_chunks",
                         tune.overlap_attrs(path, rows, width, p, dtype))
        requested = int(cfg["chunks"]) if cfg else 1
    requested = int(requested)
    if requested <= 1:
        return 1
    return resolve_chunks(requested, divisor_of, site=path)


def _wait(works):
    for w in works:
        w.wait()
    works.clear()


def _flat_wgrad(x_rows, g_rows):
    """fp32 (H, O) weight-gradient partial x_rowsᵀ · g_rows: 16-bit
    operands on the card through a GEMM that writes fp32
    (`out_dtype`), elsewhere through fp32 copies (exact products, fp32
    sums: the JAX package's `preferred_element_type=float32`)."""
    xm = x_rows.reshape(-1, x_rows.shape[-1])
    gm = g_rows.reshape(-1, g_rows.shape[-1])
    if xm.dtype == torch.float32:
        return torch.mm(xm.t(), gm)
    if xm.is_cuda:
        return torch.mm(xm.t(), gm, out_dtype=torch.float32)
    return torch.mm(xm.t().float(), gm.float())


def _local_wgrad(x, g, w):
    """The weight gradient from one product: one GEMM in the weight's
    dtype (fp32 accumulation, one rounding)."""
    return torch.matmul(x.reshape(-1, x.shape[-1]).t(),
                        g.reshape(-1, g.shape[-1])).to(w.dtype)


def _out_shape(x, w, rows):
    return (rows,) + tuple(x.shape[1:-1]) + (w.shape[-1],)


# --------------------------------------------------------------------------
# column-parallel + sequence_parallel: P2P-ring gather + GEMM
# --------------------------------------------------------------------------

def _ring_fwd(x, w, group, chunks):
    p, r = M.group_size(group), M.group_rank(group)
    s = x.shape[0]
    sc = s // chunks
    out = x.new_empty(_out_shape(x, w, p * s))
    held = [x[j * sc:(j + 1) * sc] for j in range(chunks)]
    for k in range(p):
        src = (r + k) % p
        nxt, works = [], []
        with loop_iteration("ring", k):
            for j in range(chunks):
                if k + 1 < p:
                    # the hop feeding step k + 1, issued before this GEMM
                    buf, wk = _ring_hop(held[j], group)
                    nxt.append(buf)
                    works += wk
                lo = src * s + j * sc
                torch.matmul(held[j], w, out=out[lo:lo + sc])
            _wait(works)
        if nxt:
            held = nxt
    return out


def _ring_hop(x, group):
    # shift -1: rank r receives rank r + 1's shard, so step k holds
    # source shard (r + k) mod p
    return ring_hop(x, group, shift=-1)


class _RingGatherMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, group, chunks):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.group, ctx.chunks = group, chunks
        return _ring_fwd(x, w, group, chunks)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        group, chunks = ctx.group, ctx.chunks
        p, r = M.group_size(group), M.group_rank(group)
        s = x.shape[0]
        sc = s // chunks
        g = g.contiguous()
        # dx = reduce_scatter(g · wᵀ) (the gather's transpose), chunked:
        # rows regroup as (p, chunks, sc), and the scatter of chunk j
        # keeps rank-block r of it, this shard's rows [j·sc, (j+1)·sc)
        gv = g.reshape((p, chunks, sc) + tuple(g.shape[1:]))
        dx = x.new_empty(x.shape)
        works = []
        for j in range(chunks):
            with loop_iteration("chunk", j):
                z = torch.matmul(
                    gv[:, j].reshape((p * sc,) + tuple(g.shape[1:])), w.t())
                wk = M.reduce_scatter(dx[j * sc:(j + 1) * sc].view(-1),
                                      z.view(-1), group, async_op=True)
            if wk is not None:
                works.append(wk)
        # dw: the ring over x again; each rank's g is the full cotangent
        # of its output columns, so the fp32 sum is complete without a
        # trailing collective
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        held = [x[j * sc:(j + 1) * sc] for j in range(chunks)]
        for k in range(p):
            src = (r + k) % p
            nxt, hops = [], []
            with loop_iteration("ring", k):
                for j in range(chunks):
                    if k + 1 < p:
                        buf, wk = _ring_hop(held[j], group)
                        nxt.append(buf)
                        hops += wk
                    lo = src * s + j * sc
                    dw += _flat_wgrad(held[j], g[lo:lo + sc])
                _wait(hops)
            if nxt:
                held = nxt
        _wait(works)
        return dx, dw.to(w.dtype), None, None


def ring_gather_matmul(x, w, group, chunks: int):
    """all_gather(x, dim 0) · w over `group` as a chunked P2P ring.  x:
    (s_loc, ..., H) this rank's sequence shard; w: (H, O_loc).  Returns
    (p · s_loc, ..., O_loc), the same rows as the monolithic gather and
    GEMM."""
    return _RingGatherMatmul.apply(x, w, group, chunks)


# --------------------------------------------------------------------------
# row-parallel + sequence_parallel: GEMM + chunked reduce-scatter
# --------------------------------------------------------------------------

class _MatmulReduceScatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, group, chunks):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.group, ctx.chunks = group, chunks
        p = M.group_size(group)
        s = x.shape[0]
        so = s // p
        soc = so // chunks
        xv = x.reshape((p, so) + tuple(x.shape[1:]))
        out = x.new_empty(_out_shape(x, w, so))
        works = []
        for j in range(chunks):
            with loop_iteration("chunk", j):
                xj = xv[:, j * soc:(j + 1) * soc].reshape(
                    (p * soc,) + tuple(x.shape[1:]))
                z = torch.matmul(xj, w)
                wk = M.reduce_scatter(out[j * soc:(j + 1) * soc].view(-1),
                                      z.view(-1), group, async_op=True)
            if wk is not None:
                works.append(wk)
        _wait(works)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        group, chunks = ctx.group, ctx.chunks
        p = M.group_size(group)
        s = x.shape[0]
        so = s // p
        soc = so // chunks
        g = g.contiguous()
        xv = x.reshape((p, so) + tuple(x.shape[1:]))
        dxv = x.new_empty(xv.shape)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)

        def gather(j):
            # the scatter's transpose: all-gather chunk j's cotangent
            gj = g[j * soc:(j + 1) * soc]
            G = gj.new_empty((p,) + tuple(gj.shape))
            wk = M.all_gather(G.view(-1), gj.reshape(-1), group,
                              async_op=True)
            return G, [wk] if wk is not None else []

        with loop_iteration("chunk", 0):
            nxt = gather(0)
        for j in range(chunks):
            G, works = nxt
            if j + 1 < chunks:
                with loop_iteration("chunk", j + 1):
                    nxt = gather(j + 1)   # in flight under chunk j's GEMMs
            _wait(works)
            dxv[:, j * soc:(j + 1) * soc] = torch.matmul(G, w.t())
            dw += _flat_wgrad(xv[:, j * soc:(j + 1) * soc], G)
        return dxv.reshape(x.shape), dw.to(w.dtype), None, None


def matmul_reduce_scatter(x, w, group, chunks: int):
    """reduce_scatter(x · w, dim 0) over `group`, chunked along the
    output rows.  x: (S, ..., H_loc); w: (H_loc, O).  Returns (S/p, ...,
    O); each chunk GEMMs exactly the input rows that feed its output
    slice and scatters them while the next chunk's GEMM runs."""
    return _MatmulReduceScatter.apply(x, w, group, chunks)


# --------------------------------------------------------------------------
# row-parallel, no SP: GEMM + chunked all-reduce
# --------------------------------------------------------------------------

class _MatmulAllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, group, chunks):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        s = x.shape[0]
        sc = s // chunks
        out = x.new_empty(_out_shape(x, w, s))
        works = []
        for j in range(chunks):
            with loop_iteration("chunk", j):
                yj = out[j * sc:(j + 1) * sc]
                torch.matmul(x[j * sc:(j + 1) * sc], w, out=yj)
                wk = M.all_reduce(yj, "sum", group, async_op=True)
            if wk is not None:
                works.append(wk)
        _wait(works)
        return out

    @staticmethod
    def backward(ctx, g):
        # the all-reduce's transpose is the identity: dgrad and wgrad are
        # local, so the backward stays monolithic
        x, w = ctx.saved_tensors
        return (torch.matmul(g, w.t()), _local_wgrad(x, g, w), None, None)


def matmul_all_reduce(x, w, group, chunks: int):
    """all_reduce(x · w) over `group`, chunked along dim 0: chunk k's
    all-reduce runs while chunk k + 1's GEMM does.  x: (S, ..., H_loc);
    w: (H_loc, O); returns (S, ..., O) fully reduced."""
    return _MatmulAllReduce.apply(x, w, group, chunks)


# --------------------------------------------------------------------------
# column-parallel, no SP: plain GEMM forward, chunked all-reduce of dx
# --------------------------------------------------------------------------

class _CopyMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, group, chunks):
        ctx.save_for_backward(x, w)
        ctx.group, ctx.chunks = group, chunks
        return torch.matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        group, chunks = ctx.group, ctx.chunks
        s = x.shape[0]
        sc = s // chunks
        g = g.contiguous()
        dx = x.new_empty(x.shape)
        works = []
        for j in range(chunks):
            with loop_iteration("chunk", j):
                dxj = dx[j * sc:(j + 1) * sc]
                torch.matmul(g[j * sc:(j + 1) * sc], w.t(), out=dxj)
                wk = M.all_reduce(dxj, "sum", group, async_op=True)
            if wk is not None:
                works.append(wk)
        dw = _local_wgrad(x, g, w)        # under the last all-reduce
        _wait(works)
        return dx, dw, None, None


def copy_matmul(x, w, group, chunks: int):
    """copy_to(x) · w: the plain local GEMM forward (there is no forward
    collective to hide); the backward chunks dx = all_reduce(g · wᵀ) so
    each chunk's all-reduce runs under the next chunk's dgrad GEMM.  x:
    (S, ..., H) replicated; w: (H, O_loc)."""
    return _CopyMatmul.apply(x, w, group, chunks)
