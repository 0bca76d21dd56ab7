"""Dense dispatch/combine and the ep all-to-all exchange (counterpart of
apex_tpu/moe/dispatch.py).

Densify before the collective: tokens scatter into a fixed (n_experts ·
capacity + 1, H) buffer (dropped tokens go to a trash row that stays
local), so the exchanged payload's shape depends on nothing the router
decided, and the cross-expert exchange is one tiled all-to-all over the
ep group each way (`parallel.collectives.all_to_all`):

    dispatch:  (E, C, H) --all_to_all(split 0, concat 1)--> (E/ep, ep·C, H)
    combine:   (E/ep, ep·C, H) --all_to_all(split 1, concat 0)--> (E, C, H)

Every non-trash destination row is unique (positions within an expert
are distinct across all (token, slot) assignments), so the scatter is a
plain copy (`index_copy`, no accumulation): a kept token's row is its
activation bit for bit, and only the trash row, which nothing reads,
takes duplicates.  The combine's gather (`index_select`) has a backward
that copies each token's gradient onto its unique row the same way
(`_Gather`), where autograd's would add into zeros by atomics.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.parallel.collectives import all_to_all


class _Gather(torch.autograd.Function):
    """`y.index_select(0, rows)` whose backward writes each gradient row
    to its source row with `index_copy` (the rows are unique but for the
    trash row, whose gradient nothing reads)."""

    @staticmethod
    def forward(ctx, y, rows):
        ctx.save_for_backward(rows)
        ctx.n = y.shape[0]
        return y.index_select(0, rows)

    @staticmethod
    def backward(ctx, g):
        (rows,) = ctx.saved_tensors
        out = g.new_zeros((ctx.n,) + tuple(g.shape[1:]))
        return out.index_copy_(0, rows, g), None


def dispatch(x, dest, n_experts: int, capacity: int) -> torch.Tensor:
    """Scatter token rows x (T, H) to their destination slots (dest: (T,
    k) flat rows from `router.capacity_destinations`).  Returns the dense
    (E·C + 1, H) buffer in x's dtype; row E·C is the trash row.  Unfilled
    slots stay zero (through the expert MLP they give bias-only rows that
    combine never reads)."""
    buf = x.new_zeros((n_experts * capacity + 1, x.shape[1]))
    for j in range(dest.shape[1]):
        buf.index_copy_(0, dest[:, j], x)
    return buf


def combine(ybuf, dest, gate) -> torch.Tensor:
    """Gather the expert outputs back to token order, weighted by the
    gates: ybuf (E·C + 1, H) with a zero trash row (`exchange_combine`
    makes it so), dest (T, k), gate (T, k) fp32 raw probabilities.
    Dropped assignments read the trash row and add exactly 0.  The
    weight multiply casts the gate to the activation dtype, not the
    activations to fp32: at gate 1.0 the product is the expert output
    bit for bit."""
    k = dest.shape[1]
    out = _Gather.apply(ybuf, dest[:, 0]) * gate[:, 0, None].to(ybuf.dtype)
    for j in range(1, k):
        out = out + (_Gather.apply(ybuf, dest[:, j])
                     * gate[:, j, None].to(ybuf.dtype))
    return out


def exchange_dispatch(buf, ep_axis, ep_size: int, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """(E·C + 1, H) local dispatch buffer → (E/ep, ep·C, H) rows for this
    rank's experts, gathered from every ep peer.  The trash row is sliced
    off first (local only).  ep_size == 1 is the reshape alone, no
    collective."""
    h = buf.shape[1]
    ebuf = buf[:n_experts * capacity].reshape(n_experts, capacity, h)
    if ep_size == 1:
        return ebuf
    return all_to_all(ebuf, ep_axis, split_dim=0, concat_dim=1)


def exchange_combine(y, ep_axis, ep_size: int, n_experts: int,
                     capacity: int) -> torch.Tensor:
    """The inverse exchange and the trash-row rebuild: expert outputs
    (E/ep, ep·C, H) → the (E·C + 1, H) combine buffer in (expert, slot)
    order with a fresh zero trash row."""
    h = y.shape[-1]
    if ep_size > 1:
        y = all_to_all(y, ep_axis, split_dim=1, concat_dim=0)
    flat = y.reshape(n_experts * capacity, h)
    return torch.cat([flat, flat.new_zeros((1, h))], dim=0)


def chunked_expert_exchange(buf, ffn, ep_axis, ep_size: int,
                            n_experts: int, capacity: int,
                            chunks: int = 1) -> torch.Tensor:
    """dispatch exchange → expert FFN → combine exchange, cut into
    `chunks` along the capacity dim (the JAX package's micro-chunked
    overlap): slot chunk j of every expert travels together, so each
    chunk's exchange is the same tiled all-to-all at capacity/chunks
    rows.  `ffn(xe)` maps (E_loc, rows, H) → (E_loc, rows, H) and must be
    row-independent along the slot dim (`MoEMLP._expert_ffn` is), which
    makes the reassembly exact.  chunks == 1 is exactly the monolithic
    exchange_dispatch → ffn → exchange_combine sequence."""
    if chunks <= 1:
        xe = exchange_dispatch(buf, ep_axis, ep_size, n_experts, capacity)
        return exchange_combine(ffn(xe), ep_axis, ep_size, n_experts,
                                capacity)
    h = buf.shape[1]
    ebuf = buf[:n_experts * capacity].reshape(n_experts, capacity, h)
    cc = capacity // chunks
    outs = []
    for j in range(chunks):
        piece = ebuf[:, j * cc:(j + 1) * cc]
        if ep_size > 1:
            piece = all_to_all(piece, ep_axis, split_dim=0, concat_dim=1)
        ye = ffn(piece)                      # (E_loc, ep·cc, H)
        if ep_size > 1:
            ye = all_to_all(ye, ep_axis, split_dim=1, concat_dim=0)
        outs.append(ye)
    y = torch.cat(outs, dim=1)               # (E, capacity, H), slot order
    flat = y.reshape(n_experts * capacity, h)
    return torch.cat([flat, flat.new_zeros((1, h))], dim=0)
