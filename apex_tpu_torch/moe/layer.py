"""`MoEMLP` — the expert-parallel drop-in for a transformer block's MLP
(counterpart of apex_tpu/moe/layer.py).

    route (fp32 gates) → dispatch into (E, C, H) → all-to-all over ep
    → per-expert FFN (two batched products) → all-to-all back
    → combine weighted by the raw gate probabilities

Parameter layout: every rank holds the full (E, ...) expert tensors (the
ZeRO-2 posture: replicated at compute time, the master state sharded
over the combined (dp, ep) group by `DistributedFusedAdam(num_shards=
dp·ep, axis_name=("dp", "ep"), ep_shards=ep)`) and computes its own E/ep
experts, sliced by its host ep rank.  The gradient needs no expert-
specific sync: the combine all-to-all's backward routes each rank's
token gradients back to the rank that computed the expert, so after the
backward every rank holds d(its ep group's loss)/d(its expert slice) and
zeros elsewhere, and the train step's one mean over (dp, ep) is exact
for expert and non-expert parameters alike.

The expert products are cuBLAS (`torch.matmul` / `bmm`): the JAX package
leaves them to XLA's einsums, so no TPU kernel sits on this path.

With `tap_prefix` and an active tap context (`ops._common.tap`),
`apply` taps the per-expert load, the per-expert drop fraction and the
per-token gate entropy into the flight recorder, as the JAX package
does; without a context it runs the ops it always ran.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.moe import dispatch as D
from apex_tpu_torch.moe import router as R
from apex_tpu_torch.ops._common import active_tap_context, resolve_device
from apex_tpu_torch.ops._common import tap as _tap
from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel.collectives import (
    copy_to_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
)
from apex_tpu_torch.parallel.mesh import EP_AXIS


class MoEAux(NamedTuple):
    """Per-layer fp32 scalars the model folds into its loss and stats."""

    aux_loss: torch.Tensor        # load-balancing loss (1.0 = balanced)
    z_loss: torch.Tensor          # router z-loss
    drop_fraction: torch.Tensor   # dropped assignments / (T · k)
    gate_entropy: torch.Tensor    # mean per-token gate entropy


class MoEMLP:
    """Expert MLP bank: E experts of (H → ffn_hidden → H), tanh-gelu.

    Drop-in for the GPT block's fc1 → gelu → fc2: at n_experts=1 /
    top_k=1 / capacity_factor=inf (and ep 1) the output is the dense
    MLP's bit for bit (the same products row for row, the gate exactly
    1.0)."""

    def __init__(self, hidden: int, ffn_hidden: int, n_experts: int, *,
                 top_k: int = 1, capacity_factor: float = 1.25,
                 ep_size: int = 1, ep_axis: str = EP_AXIS,
                 init_std: float = 0.02,
                 proj_init_std: Optional[float] = None,
                 router_block_rows: Optional[int] = None,
                 tp_axis: Optional[str] = None,
                 overlap_chunks=None):
        if n_experts % max(1, ep_size):
            raise ValueError(
                f"n_experts={n_experts} must divide by ep_size={ep_size}")
        if top_k > n_experts:
            raise ValueError(f"top_k={top_k} > n_experts={n_experts}")
        self.hidden = hidden
        self.ffn_hidden = ffn_hidden
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = float(capacity_factor)
        self.ep_size = ep_size
        self.ep_axis = ep_axis
        self.init_std = init_std
        self.proj_init_std = proj_init_std or init_std
        self.router_block_rows = router_block_rows
        # the dense block's tp region markers (copy_to on entry,
        # reduce_from before the output bias), kept so the drop-in has
        # the same op sequence; experts replicate over tp, so only tp = 1
        # runs (apply raises at tp > 1)
        self.tp_axis = tp_axis
        # the exchange's chunk count: None asks the tuner
        # (`overlap_chunks`, 1 on a miss: the monolithic exchange), an
        # int forces it
        self.overlap_chunks = overlap_chunks

    # ------------------------------ params --------------------------------

    def init(self, seed: int = 0, dtype=torch.float32, device=None) -> dict:
        """Random weights from a `torch.Generator` seeded with `seed`, with
        the JAX package's distributions: wg and w1 N(0, init_std²), w2
        N(0, proj_init_std²), zero biases."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        e, h, f = self.n_experts, self.hidden, self.ffn_hidden

        def normal(shape, std):
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return (w * std).to(dtype)

        return {"wg": normal((h, e), self.init_std),
                "w1": normal((e, h, f), self.init_std),
                "b1": torch.zeros((e, f), dtype=dtype, device=dev),
                "w2": normal((e, f, h), self.proj_init_std),
                "b2": torch.zeros((e, h), dtype=dtype, device=dev)}

    def partition_specs(self) -> dict:
        """Every leaf replicated (None): each rank holds the full expert
        tensors and `_local_experts` slices its own."""
        return {"wg": None, "w1": None, "b1": None, "w2": None, "b2": None}

    # ------------------------------ forward -------------------------------

    def _local_experts(self, params):
        """This rank's E/ep slice of each expert tensor, at its host ep
        rank (the whole tensors at ep_size 1)."""
        keys = ("w1", "b1", "w2", "b2")
        if self.ep_size == 1:
            return tuple(params[k] for k in keys)
        group = M.group_of(self.ep_axis)
        if M.group_size(group) != self.ep_size:
            raise ValueError(
                f"the layer computes at ep_size={self.ep_size}, the "
                f"{self.ep_axis!r} group has {M.group_size(group)} ranks")
        e_loc = self.n_experts // self.ep_size
        start = M.group_rank(group) * e_loc
        return tuple(params[k].narrow(0, start, e_loc) for k in keys)

    def _expert_ffn(self, params, xe, cn=None):
        """The FFN of this rank's experts on the exchanged buffer (E_loc,
        rows, H): the dense fc1 → bias → gelu → fc2 → bias sequence as
        two batched products (fp32 accumulation, one rounding each).
        `cn(x, name)` tags the two points the dense block tags ("ffn1",
        "ffn_out"; the model passes `GPT._cn`)."""
        w1, b1, w2, b2 = self._local_experts(params)
        h = torch.matmul(xe, w1.to(xe.dtype))
        h = h + b1[:, None, :].to(h.dtype)
        if cn:
            h = cn(h, "ffn1")
        h = F.gelu(h, approximate="tanh")
        y = torch.matmul(h, w2.to(h.dtype))
        if self.tp_axis is not None:
            y = reduce_from_tensor_model_parallel_region(y, self.tp_axis)
        y = y + b2[:, None, :].to(y.dtype)
        if cn:
            y = cn(y, "ffn_out")
        return y

    def _exchange_chunks(self, capacity: int, dtype) -> int:
        """The exchange's chunk count: the explicit override, else the
        `overlap_chunks` tuner op (1 on a miss); a count that does not
        divide the capacity falls back to its largest divisor below, with
        one warning (`overlap.resolve_chunks`)."""
        from apex_tpu_torch.parallel import overlap as OV

        req = self.overlap_chunks
        if req is None:
            from apex_tpu_torch import tune

            cfg = tune.tuned("overlap_chunks", tune.overlap_attrs(
                "moe", capacity, self.hidden, self.ep_size, dtype))
            req = int(cfg["chunks"]) if cfg else 1
        req = int(req)
        if req <= 1:
            return 1
        return OV.resolve_chunks(req, capacity, site="moe")

    def apply(self, params, x, tap_prefix: Optional[str] = None, cn=None):
        """x: (..., H) this rank's activations ((S, B, H) from a GPT
        block).  Returns (y, MoEAux), y in x's shape and dtype.
        `tap_prefix` (with a tap context active): tap `<prefix>/load`,
        `/drop` and `/gate_entropy`; `cn`: the tagger of
        `_expert_ffn`."""
        lead_shape = x.shape[:-1]
        if self.tp_axis is not None:
            tp = M.group_size(M.group_of(self.tp_axis))
            if tp > 1:
                # experts replicate over tp: the row-parallel reduction
                # below would multiply every output by tp
                raise NotImplementedError(
                    f"MoEMLP does not support tensor parallelism yet "
                    f"(tp axis {self.tp_axis!r} has size {tp}): experts "
                    "replicate over tp and the RowParallel-style "
                    "reduction would multiply outputs by tp — build "
                    "the MoE mesh with tensor_model_parallel_size=1")
            x = copy_to_tensor_model_parallel_region(x, self.tp_axis)
        xt = x.reshape(-1, self.hidden)
        t = xt.shape[0]
        e, k = self.n_experts, self.top_k
        cap = R.expert_capacity(t, e, k, self.capacity_factor)

        out = R.topk_gates(xt, params["wg"], k,
                           block_rows=self.router_block_rows)
        if e == 1 and k == 1 and cap >= t and self.ep_size == 1:
            # every token to expert 0 with gate exactly 1.0 (a softmax
            # over one logit): the dispatch is the identity, so the FFN
            # runs on the original shape, the dense MLP's op sequence,
            # and the gate multiply (the identity function) is skipped
            dropped = torch.zeros(1, dtype=torch.float32, device=x.device)
            y1 = torch.matmul(x, params["w1"][0].to(x.dtype))
            y1 = y1 + params["b1"][0].to(y1.dtype)
            if cn:
                y1 = cn(y1, "ffn1")
            y1 = F.gelu(y1, approximate="tanh")
            y2 = torch.matmul(y1, params["w2"][0].to(y1.dtype))
            if self.tp_axis is not None:
                y2 = reduce_from_tensor_model_parallel_region(
                    y2, self.tp_axis)
            y2 = y2 + params["b2"][0].to(y2.dtype)
            if cn:
                y2 = cn(y2, "ffn_out")
            y = y2.reshape(-1, self.hidden)
        else:
            dest, dropped = R.capacity_destinations(out.idx, e, cap)
            buf = D.dispatch(xt, dest, e, cap)
            chunks = self._exchange_chunks(cap, xt.dtype)
            ybuf = D.chunked_expert_exchange(
                buf, lambda xe: self._expert_ffn(params, xe, cn=cn),
                self.ep_axis, self.ep_size, e, cap, chunks)
            y = D.combine(ybuf, dest, out.gate)

        aux_loss, load, _ = R.load_balancing_aux(out.probs, out.idx, e)
        drop_per_expert = dropped / float(t * k)
        ent = R.gate_entropy(out.probs)
        aux = MoEAux(aux_loss=aux_loss,
                     z_loss=R.router_z_loss(out.logits),
                     drop_fraction=torch.sum(drop_per_expert),
                     gate_entropy=torch.mean(ent))

        if tap_prefix is not None and active_tap_context() is not None:
            # the tapped stat tensors ride into the output through a
            # 0.0 * sum so the backward reaches their probe rows (a zero
            # gradient still carries the forward plane), as in the JAX
            # package; without a context this block is skipped
            s = (_tap(load, f"{tap_prefix}/load").sum()
                 + _tap(drop_per_expert, f"{tap_prefix}/drop").sum()
                 + _tap(ent, f"{tap_prefix}/gate_entropy").sum())
            y = y + (0.0 * s).to(y.dtype)

        return y.reshape(*lead_shape, self.hidden), aux


def mean_aux(auxes) -> MoEAux:
    """The mean of a list of per-layer MoEAux (fp32 scalars)."""
    n = float(len(auxes))
    return MoEAux(*[sum(getattr(a, f) for a in auxes) / n
                    for f in MoEAux._fields])

