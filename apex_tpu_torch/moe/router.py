"""Top-k expert router — fp32 gates, capacity-aware destinations
(counterpart of apex_tpu/moe/router.py).

The routing contract, as in the JAX package:

* **fp32 gate logits whatever the compute dtype.**  The gate product
  keeps the activations in their dtype and writes fp32 (on the card one
  `torch.mm(..., out_dtype=torch.float32)`, no bf16 rounding; on the CPU
  an fp32 product), and the softmax and the top-k selection run in fp32.
* **Ties pinned by index.**  `lax.top_k` resolves equal probabilities to
  the LOWER expert index.  `torch.topk` promises no order among ties on
  CUDA, so the selection here is a stable descending sort, which keeps
  equal values in index order: routing is a function of the logits
  alone, on either device.
* **Byte-identical blocked path.**  Softmax and top-k are row-
  independent, so running them over row blocks changes scheduling only.
  `topk_gates` consults the `moe_router` tuner op for `block_rows`; on a
  miss the dense single-shot reference runs.

`expert_capacity` and `capacity_destinations` make routing emit a
static-shaped destination map: tokens past an expert's capacity go to
the trash row (`n_experts * capacity`), so no shape depends on where
tokens went, and nothing here reads a value back to the host (no
`nonzero`, no boolean-mask indexing, no `.item()`): a routed step makes
no host sync on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.ops._common import fp32_class


def expert_capacity(tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert, per-source-shard slot count (static):
    ceil(tokens · top_k · capacity_factor / n_experts) rounded up to 8
    and clamped to `tokens` (top-k picks distinct experts, so an expert
    never receives a token twice).  capacity_factor=inf is the no-drop
    setting: exactly `tokens` slots.  Under expert parallelism each
    expert's total capacity is ep times this (one block per source
    shard), and the drop decision stays local to the source shard."""
    if tokens < 1:
        raise ValueError(f"tokens must be >= 1, got {tokens}")
    if math.isinf(capacity_factor):
        return tokens
    if capacity_factor <= 0:
        raise ValueError(
            f"capacity_factor must be > 0 (or inf), got {capacity_factor}")
    c = math.ceil(tokens * top_k * capacity_factor / n_experts)
    c = ((c + 7) // 8) * 8
    return min(c, tokens)


class _GateLogits(torch.autograd.Function):
    """x (T, H) · w (H, E) → fp32 (T, E) from one product: on the card
    16-bit operands through a GEMM that writes fp32, elsewhere (and for
    fp32 x) an fp32 product of exact upcasts.  The backward is the fp32
    product's, each gradient rounded once to its operand's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda and x.dtype != torch.float32:
            return torch.mm(x, w, out_dtype=torch.float32)
        with fp32_class("router_gate"):
            return torch.mm(x.float(), w.float())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # the router's fp32 contract: exact upcasts, fp32 products
        with fp32_class("router_gate"):
            dx = torch.mm(g, w.float().t()).to(x.dtype)
            dw = torch.mm(x.float().t(), g).to(w.dtype)
        return dx, dw


def gate_logits(x, wg) -> torch.Tensor:
    """fp32 gate logits (T, E) for activations x (T, H) in any compute
    dtype (≡ `jnp.dot(x, wg.astype(x.dtype), preferred_element_type=
    float32)`): the output is fp32 from the product, never a rounded
    16-bit result upcast."""
    return _GateLogits.apply(x, wg.to(x.dtype))


def _softmax_topk(logits, top_k: int):
    probs = torch.softmax(logits, dim=-1)                     # fp32
    # a stable descending sort: ties keep index order (lax.top_k's)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, gate[:, :top_k], idx[:, :top_k].to(torch.int32)


class RouterOutput(NamedTuple):
    """Everything dispatch, combine and the aux losses need.

    probs: (T, E) fp32 softmax; gate: (T, k) fp32 selected probabilities
    (raw, not renormalised: the router gets main-loss gradient at any k,
    and at k = 1, E = 1 the gate is exactly 1.0); idx: (T, k) int32
    expert ids; logits: (T, E) fp32 (the z-loss reads them)."""

    probs: torch.Tensor
    gate: torch.Tensor
    idx: torch.Tensor
    logits: torch.Tensor


def topk_gates_dense(x, wg, top_k: int) -> RouterOutput:
    """The dense reference: one softmax + top-k over all token rows."""
    logits = gate_logits(x, wg)
    probs, gate, idx = _softmax_topk(logits, top_k)
    return RouterOutput(probs=probs, gate=gate, idx=idx, logits=logits)


def topk_gates_blocked(x, wg, top_k: int, block_rows: int) -> RouterOutput:
    """The same softmax + top-k over `block_rows`-row blocks of the
    logits, one block after another (the JAX package's `lax.map` over the
    padded blocks).  Byte-identical to the dense reference: both ops are
    row-independent."""
    logits = gate_logits(x, wg)
    parts = [_softmax_topk(b, top_k) for b in logits.split(block_rows)]
    return RouterOutput(probs=torch.cat([p[0] for p in parts]),
                        gate=torch.cat([p[1] for p in parts]),
                        idx=torch.cat([p[2] for p in parts]),
                        logits=logits)


def topk_gates(x, wg, top_k: int,
               block_rows: Optional[int] = None) -> RouterOutput:
    """Route x (T, H) through the gate weight wg (H, E): the `moe_router`
    tuner op.  An explicit `block_rows` wins; otherwise the tune cache is
    consulted (a host-side dict lookup) and a miss runs the dense
    reference, the same bytes on every path."""
    if block_rows is None:
        from apex_tpu_torch import tune

        cfg = tune.tuned("moe_router", tune.moe_router_attrs(
            x.shape[0], wg.shape[1], top_k, x.dtype))
        blk = cfg.get("block_rows") if cfg else None
        if isinstance(blk, int) and 8 <= blk <= 1 << 16 and blk % 8 == 0:
            block_rows = blk
    if block_rows is None:
        return topk_gates_dense(x, wg, top_k)
    return topk_gates_blocked(x, wg, top_k, block_rows)


def _one_hot(ids, n: int, dtype):
    """(T,) ids → (T, n) one-hot rows, by comparison (no host check)."""
    return (ids[:, None] == torch.arange(n, device=ids.device)).to(dtype)


def capacity_destinations(idx, n_experts: int, capacity: int):
    """Flat destination rows for each (token, slot) assignment.

    idx: (T, k) int expert choices.  Returns (dest, n_dropped): dest (T,
    k) int64 rows of a flat (n_experts · capacity + 1)-row buffer —
    assignment j of token t lands at `expert · capacity + position`,
    position counting the earlier assignments of that expert (slot-major:
    every slot-0 choice outranks slot 1), or at the trash row
    (`n_experts · capacity`) once the expert's capacity is full.
    n_dropped: the (E,) fp32 dropped-assignment counts.  One cumulative
    sum along the (E, k·T) one-hot rows of the slot-major assignments
    (the scan runs along each expert's row: a scan down the (k·T, E)
    columns, E of them, is one slow thread a column on the card) and a
    `where`: static shapes, no host sync."""
    t, k = idx.shape
    flat = idx.t().reshape(-1).long()                     # slot-major (k·T,)
    experts = torch.arange(n_experts, device=idx.device)
    oh = (experts[:, None] == flat[None, :]).to(torch.int32)   # (E, k·T)
    pos = torch.gather(torch.cumsum(oh, dim=1, dtype=torch.int32), 0,
                       flat[None, :])[0] - 1
    keep = pos < capacity
    dest = torch.where(keep, flat * capacity + pos,
                       torch.full_like(pos, n_experts * capacity))
    dropped = torch.sum(oh * (~keep).to(torch.int32)[None, :], dim=1)
    return dest.view(k, t).t(), dropped.to(torch.float32)


def load_balancing_aux(probs, idx, n_experts: int):
    """The Switch/GShard load-balancing loss and its statistics: f_e the
    fraction of (token, slot) assignments routed to expert e (hard
    counts: gradient flows through P_e only), P_e the mean gate
    probability of e, aux = E · Σ f·P (1.0 at perfect balance).  Returns
    (aux, f, P), fp32."""
    t, k = idx.shape
    assign = torch.zeros(n_experts, dtype=torch.float32, device=idx.device)
    for j in range(k):
        assign = assign + torch.sum(
            _one_hot(idx[:, j], n_experts, torch.float32), dim=0)
    f = assign / float(t * k)
    p_mean = torch.mean(probs, dim=0)
    aux = float(n_experts) * torch.sum(f * p_mean)
    return aux, f, p_mean


def router_z_loss(logits):
    """mean(logsumexp(logits)²): keeps the gate logits from drifting to
    magnitudes where the fp32 softmax saturates (ST-MoE)."""
    return torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))


def gate_entropy(probs):
    """Per-token gate entropy (T,) fp32 (a mean near 0: the router
    collapsed onto single experts)."""
    plogp = torch.where(probs > 0,
                        probs * torch.log(torch.clamp(probs, min=1e-30)),
                        torch.zeros((), dtype=probs.dtype,
                                    device=probs.device))
    return -torch.sum(plogp, dim=-1)
