"""MoE-GPT — the expert-parallel flagship (counterpart of
apex_tpu/models/moe_gpt.py).

GPT with every block's dense MLP swapped for `moe.MoEMLP`: fp32 top-k
routing, capacity-factor dropping into a static (E, C, H) dispatch
buffer, one all-to-all over the ep group each way, and the raw-gate-
weighted combine.  Everything else (embedding, attention, LayerNorms,
the tied vocab-parallel head) is the port's GPT code; this class
overrides init, partition_specs and the block's MLP half, which is what
makes the dense anchor hold: at n_experts=1 / top_k=1 /
capacity_factor=inf / aux_coef=z_coef=0 the train step is the dense GPT
step's bit for bit.

Parameters are GPT's nested dict with each block's fc1 / fc2 replaced by
`moe`: {wg (H, E), w1 (E, H, F), b1 (E, F), w2 (E, F, H), b2 (E, H)},
the JAX package's layout and names (`params_from_jax` converts its tree).

`build_moe_train_step` meshes over the torch.distributed world (ep = 2
when the world is even, else 1): the batch shards over the combined
(dp, ep) group, and the ZeRO-2 `DistributedFusedAdam` shards its master
state over the same group (`num_shards = dp·ep`, `axis_name=("dp",
"ep")`, `ep_shards = ep`).  The gradients need no expert-specific
handling: the combine all-to-all's backward already routes each
expert's partial gradients to the rank that computed it, so the step's
one mean over (dp, ep) is exact.

Refused (loud errors, as in the JAX package): sequence_parallel (a
sequence-sharded activation is not whole tokens), remat (the per-block
aux stats cross the checkpoint), and tensor parallelism (experts
replicate over tp; `MoEMLP.apply` raises at tp > 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import torch

from apex_tpu_torch.models import gpt as gpt_mod
from apex_tpu_torch.models.gpt import GPT, GPTConfig
from apex_tpu_torch.moe.layer import MoEMLP, mean_aux
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.random import (
    fold_in,
    model_parallel_fold_in,
    split,
)


@dataclasses.dataclass(frozen=True)
class MoEGPTConfig(GPTConfig):
    n_experts: int = 8
    top_k: int = 2
    # slots per expert per source shard = ceil(T·k·cf/E) (router.
    # expert_capacity); inf = never drop
    capacity_factor: float = 1.25
    # the ep size the model computes at; must divide n_experts and be the
    # mesh's ep group's size
    expert_parallel: int = 1
    aux_coef: float = 1e-2           # load-balancing loss weight
    z_coef: float = 1e-3             # router z-loss weight
    router_block_rows: int = 0       # 0 = the tuner's (moe_router op)

    def __post_init__(self):
        if self.sequence_parallel:
            raise ValueError(
                "MoEGPT does not support sequence_parallel: dispatch "
                "assumes every local token row is a whole token, and a "
                "seq-sharded activation is not (route-then-gather is "
                "future work)")
        if self.remat:
            raise ValueError(
                "MoEGPT does not support remat yet: the per-block MoE "
                "aux stats cross the jax.checkpoint boundary; run the "
                "smoke/bench shapes without it")
        if self.n_experts % max(1, self.expert_parallel):
            raise ValueError(
                f"n_experts={self.n_experts} must divide by "
                f"expert_parallel={self.expert_parallel}")


class MoEGPT(GPT):
    """GPT with an `MoEMLP` in each block (module docstring)."""

    def __init__(self, config: MoEGPTConfig):
        super().__init__(config)
        c = config
        self.moe = [
            MoEMLP(c.hidden, c.ffn_mult * c.hidden, c.n_experts,
                   top_k=c.top_k, capacity_factor=c.capacity_factor,
                   ep_size=c.expert_parallel, init_std=0.02,
                   proj_init_std=0.02 / math.sqrt(2.0 * c.num_layers),
                   router_block_rows=c.router_block_rows or None,
                   tp_axis=c.axis_name,
                   overlap_chunks=c.overlap_chunks)
            for _ in range(c.num_layers)]

    # ------------------------------ params --------------------------------

    def init(self, seed: int = 0, device=None) -> dict:
        """GPT's seeded weights with each block's fc1 / fc2 replaced by
        its experts, drawn from generators seeded from `seed` and the
        layer (the two frameworks draw different numbers; tests convert
        the JAX tree with `params_from_jax`)."""
        params = super().init(seed, device)
        c = self.c
        for i in range(c.num_layers):
            bp = params[f"block{i}"]
            bp.pop("fc1")
            bp.pop("fc2")
            bp["moe"] = self.moe[i].init(1_000_003 * (seed + 1) + i,
                                         c.dtype, device)
        return params

    def partition_specs(self) -> dict:
        specs = super().partition_specs()
        for i in range(self.c.num_layers):
            bs = specs[f"block{i}"]
            bs.pop("fc1")
            bs.pop("fc2")
            bs["moe"] = self.moe[i].partition_specs()
        return specs

    # ------------------------------ forward -------------------------------

    def _block(self, i, params, x, key=None):
        """GPT's block with the MLP half replaced; returns (x, MoEAux)."""
        qkv_mod, proj_mod, _, _ = self.blocks[i]
        k1 = k2 = k3 = None
        if key is not None:
            k1, k2, k3 = split(key, 3)
        ln = params["ln1"]
        h = fused_layer_norm(x, ln["weight"], ln["bias"])
        attn = self._attention(params, qkv_mod, proj_mod, h, k1)
        attn = self._cn(attn, "attn_out")
        x = x + self._dropout(k2, attn)
        ln = params["ln2"]
        h = fused_layer_norm(x, ln["weight"], ln["bias"])
        m, aux = self.moe[i].apply(params["moe"], h,
                                   tap_prefix=f"block{i}/moe", cn=self._cn)
        return x + self._dropout(k3, m), aux

    def apply_with_stats(self, params, tokens, key=None):
        """GPT.apply collecting each block's MoE aux: (final hidden (S, B,
        H), the MoEAux averaged over blocks)."""
        c = self.c
        h = self.embed.apply(params["embed"], tokens.T)
        pos = params["pos_embed"][:tokens.shape[1]][:, None, :]
        h = h + pos.to(h.dtype)
        if key is not None:
            key = model_parallel_fold_in(key, c.axis_name)
        auxes = []
        for i in range(c.num_layers):
            bk = None if key is None else fold_in(key, i)
            h, aux = self._block(i, params[f"block{i}"], h, bk)
            auxes.append(aux)
        ln = params["final_ln"]
        return fused_layer_norm(h, ln["weight"], ln["bias"]), mean_aux(auxes)

    def apply(self, params, tokens, key=None):
        return self.apply_with_stats(params, tokens, key)[0]

    def loss_with_stats(self, params, tokens, labels, key=None):
        """(total loss, flat fp32 stats dict).  total = CE + aux_coef ·
        load-balance + z_coef · z-loss; a coefficient of exactly 0.0 adds
        nothing (the dense anchor needs total == CE to the bit).  The
        stats are this rank's values."""
        c = self.c
        h, aux = self.apply_with_stats(params, tokens, key)
        logits = self.logits_local(params, h)
        ce = torch.mean(vocab_parallel_cross_entropy(
            logits, labels.T, axis_name=c.axis_name, fused=c.fused_xent))
        total = ce
        if c.aux_coef:
            total = total + c.aux_coef * aux.aux_loss.to(ce.dtype)
        if c.z_coef:
            total = total + c.z_coef * aux.z_loss.to(ce.dtype)
        stats = {"ce_loss": ce.float(),
                 "moe_aux_loss": aux.aux_loss,
                 "moe_z_loss": aux.z_loss,
                 "moe_drop_fraction": aux.drop_fraction,
                 "moe_gate_entropy": aux.gate_entropy}
        return total, stats

    def loss(self, params, tokens, labels, key=None):
        return self.loss_with_stats(params, tokens, labels, key)[0]


# ≡ the GPT-350M bench point with 8 experts
MOE_GPT_350M_8E = dict(hidden=1024, num_layers=24, num_heads=16,
                       n_experts=8, top_k=2)


def moe_smoke_config(ep: int = 1, **overrides) -> MoEGPTConfig:
    """The CPU smoke shape (the JAX package's): tiny GPT dims, 4
    experts."""
    cfg = dict(vocab_size=512, seq_len=64, hidden=64, num_layers=2,
               num_heads=4, dropout=0.0, n_experts=4, top_k=2,
               capacity_factor=2.0, expert_parallel=ep)
    cfg.update(overrides)
    return MoEGPTConfig(**cfg)


def bench_config(ep: int = 1) -> MoEGPTConfig:
    """The JAX bench's on-chip configuration (`build_moe_train_step(
    on_tpu=True)`): MOE_GPT_350M_8E cut to 12 layers, vocab 50304, seq
    1024, bf16 with bf16 logits, flash attention, capacity factor 1.25."""
    return MoEGPTConfig(
        vocab_size=50304, seq_len=1024, dropout=0.0, dtype=torch.bfloat16,
        logits_dtype=torch.bfloat16, use_flash_attention=True,
        expert_parallel=ep, capacity_factor=1.25,
        **{k: v for k, v in MOE_GPT_350M_8E.items() if k != "num_layers"},
        num_layers=12)


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's MoE-GPT parameter pytree (nested dicts of numpy
    arrays, `block{i}.moe.{wg, w1, b1, w2, b2}` in place of fc1 / fc2) as
    the port's parameters on `device`, same keys and layouts; `dtype`
    casts every leaf.  Every leaf is whole: MoE runs at tp = 1."""
    return gpt_mod.params_from_jax(tree, device, dtype)


def build_moe_train_step(device=None, *, batch=None, n_buckets: int = 2,
                         metrics=None, trace=None):
    """The MoE-GPT training step (≡ the JAX package's
    `build_moe_train_step`).

    Meshes over the torch.distributed world (a world of one without it):
    ep = 2 when the world is even, else 1, dp = world / ep.  On the card
    (`device` None or CUDA) the model is `bench_config` (the JAX bench's
    on-chip configuration), batch 8 and a bf16 master state; on the CPU
    `moe_smoke_config`, batch 4, fp32.  The global batch is rounded up to
    a dp·ep multiple.  ZeRO-2 `DistributedFusedAdam(lr=1e-4, n_buckets)`
    shards over the combined (dp, ep) group.

    Returns (model, step, (state, None, (tokens_shape, labels_shape)),
    info): `step(state, None, (tokens, labels)) -> (state, None, loss,
    stats)` on this rank's rows of the global (batch, seq) int32 batch
    (info["local_batch"] of them, rank r's the r-th run of the (dp, ep)
    group); info holds batch, local_batch, seq, dp, ep, vocab_size,
    config."""
    import torch.distributed as dist

    from apex_tpu_torch.ops._common import resolve_device
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        DistributedFusedAdam,
    )
    from apex_tpu_torch.parallel import ddp
    from apex_tpu_torch.parallel import mesh as M

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    world = dist.get_world_size() if dist.is_initialized() else 1
    ep = 2 if world % 2 == 0 else 1
    M.destroy_model_parallel()
    M.initialize_model_parallel(expert_model_parallel_size=ep)
    dp = M.get_data_parallel_world_size()
    data_axes = M.get_data_parallel_axis_names()
    axis_name = data_axes if len(data_axes) > 1 else data_axes[0]
    if on_card:
        batch = batch or 8
        cfg = bench_config(ep)
    else:
        batch = batch or 4
        cfg = moe_smoke_config(ep=ep)
    shards = dp * ep
    batch = -(-batch // shards) * shards

    model = MoEGPT(cfg)
    params = model.init(seed=0, device=dev)
    opt = DistributedFusedAdam(
        num_shards=shards, lr=1e-4, n_buckets=n_buckets,
        axis_name=axis_name, ep_shards=ep,
        master_dtype=torch.bfloat16 if on_card else torch.float32)
    state = opt.init(params)
    del params

    def loss_fn(p, b):
        return model.loss_with_stats(p, b[0], b[1])

    step = ddp.make_train_step(loss_fn, opt, has_aux=True, device=dev,
                               axis_name=axis_name, metrics=metrics,
                               trace=trace)
    shape = torch.Size((batch, cfg.seq_len))
    info = {"batch": batch, "local_batch": batch // shards,
            "seq": cfg.seq_len, "dp": dp, "ep": ep,
            "vocab_size": cfg.vocab_size, "config": cfg, "optimizer": opt}
    return model, step, (state, None, (shape, shape)), info
