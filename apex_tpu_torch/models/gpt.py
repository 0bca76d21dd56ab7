"""GPT — configuration, seeded init, the JAX-params converter and the
training forward at tp=1 (counterpart of apex_tpu/models/gpt.py).

Parameters are a plain nested dict of tensors in the JAX package's
layout and key names, so a checkpoint of either package maps onto the
other one name for one name:

  embed.weight            (V, H)          tied LM head
  pos_embed               (seq_len, H)
  block{i}.ln1/ln2        weight, bias    (H,)
  block{i}.qkv            weight (H, 3H), bias (3H,)   packed (3, nh, d)
  block{i}.proj           weight (H, H),  bias (H,)
  block{i}.fc1            weight (H, 4H), bias (4H,)
  block{i}.fc2            weight (4H, H), bias (H,)
  final_ln                weight, bias    (H,)

Linear weights stay (in, out), so every product reads `x @ w` exactly
as the JAX package's `_dot` does.

`GPT` is the training forward of the JAX package's `GPT` on one device
(tp=1): activations are (S, B, H), attention is causal (the flash kernel
with `use_flash_attention=True`, else the dense path: the S² scores,
the fused causal softmax kernel, the probabilities times v), the MLP is
fc1 → tanh-gelu → fc2, the LM head is the tied embedding and the loss is
the mean vocab-parallel cross entropy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.fused_dense import qkv_split_heads
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.softmax import scaled_upper_triang_masked_softmax
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    seq_len: int = 1024
    hidden: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_mult: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.float32
    # LM-head logits dtype: None keeps fp32 logits; bf16 halves the
    # (S, B, V) traffic (the cross entropy upcasts inside either way)
    logits_dtype: Optional[torch.dtype] = None
    use_flash_attention: bool = False
    # flash attention's kernel-shape knobs (the JAX package's fields).
    # All None: the flash kernel consults the tuner (apex_tpu_torch.tune)
    # for this shape, dtype and device kind, and a miss keeps the
    # unpacked kernels, so an untuned machine runs the kernels it ran
    # before.  attn_heads_per_step > 1 packs that many heads into each
    # block of the packed kernels; the CUDA tile is 64 x 64 whatever
    # attn_block_q / attn_block_k say (they are validated only).
    attn_block_q: Any = None
    attn_block_k: Any = None
    attn_heads_per_step: Any = None
    remat: bool = False            # activation checkpointing: not yet

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


# preset sizes ≡ apex_tpu.models.gpt
GPT2_350M = dict(hidden=1024, num_layers=24, num_heads=16)
GPT2_1p3B = dict(hidden=2048, num_layers=24, num_heads=32)


def init_gpt_params(cfg: GPTConfig, seed: int = 0, device=None) -> dict:
    """Random GPT weights from a `torch.Generator` seeded with `seed`,
    with the distributions of the JAX package's `GPT.init`: embeddings
    N(0, 0.02²), qkv/fc1 N(0, 0.02²), proj/fc2 N(0, (0.02/√(2L))²),
    zero biases, LayerNorm weight 1 and bias 0.  The two frameworks draw
    different numbers from one seed; tests that need both packages on
    one set of weights convert the JAX tree with `params_from_jax`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = cfg
    h, f = c.hidden, c.ffn_mult * c.hidden
    out_std = 0.02 / math.sqrt(2.0 * c.num_layers)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * std).to(c.dtype)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=c.dtype)

    def ln():
        return {"weight": torch.ones(h, device=dev, dtype=c.dtype),
                "bias": zeros(h)}

    params = {
        "embed": {"weight": normal((c.vocab_size, h), 0.02)},
        "pos_embed": normal((c.seq_len, h), 0.02),
        "final_ln": ln(),
    }
    for i in range(c.num_layers):
        params[f"block{i}"] = {
            "ln1": ln(),
            "qkv": {"weight": normal((h, 3 * h), 0.02), "bias": zeros(3 * h)},
            "proj": {"weight": normal((h, h), out_std), "bias": zeros(h)},
            "ln2": ln(),
            "fc1": {"weight": normal((h, f), 0.02), "bias": zeros(f)},
            "fc2": {"weight": normal((f, h), out_std), "bias": zeros(h)},
        }
    return params


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's GPT parameter pytree, given as nested dicts of
    numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray, params)`),
    as the port's parameters on `device`: same keys, same layouts
    (Linear weights (in, out), embedding (V, H)).  `dtype` casts every
    leaf; None keeps each array's own float type."""
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, Mapping):
            return {k: convert(v) for k, v in x.items()}
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":   # ml_dtypes: no torch mapping
            t = torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(arr)           # a copy, never a view
        if dtype is not None:
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree)


class GPT:
    """The GPT LM's training forward on one device ≡ the JAX package's
    `GPT` at tp=1, over the nested parameter dict of `init_gpt_params` /
    `params_from_jax`.

    Attention follows `use_flash_attention`: the flash kernel, or (the
    default, as in the JAX package) the dense path through the causal
    scaled softmax kernel.  Dropout is not applied: the JAX package's
    `loss` applies it only when given a key, and its train step passes
    none.  `remat=True` (activation checkpointing) is not ported yet and
    raises."""

    def __init__(self, config: GPTConfig):
        c = config
        if c.hidden % c.num_heads:
            raise ValueError(f"num_heads={c.num_heads} must divide "
                             f"hidden={c.hidden}")
        if c.remat:
            raise NotImplementedError(
                "GPTConfig.remat (activation checkpointing and the "
                "remat_policy dials) is not ported yet")
        self.c = c
        h, f = c.hidden, c.ffn_mult * c.hidden
        self.embed = VocabParallelEmbedding(c.vocab_size, h)
        self.blocks = [(ColumnParallelLinear(h, 3 * h),
                        RowParallelLinear(h, h),
                        ColumnParallelLinear(h, f),
                        RowParallelLinear(f, h))
                       for _ in range(c.num_layers)]

    def init(self, seed: int = 0, device=None) -> dict:
        return init_gpt_params(self.c, seed, device)

    def _ln(self, p, x):
        return fused_layer_norm(x, p["weight"], p["bias"])

    def _attention(self, bp, qkv_mod, proj_mod, x):
        """x: (S, B, H) → attention output (S, B, H)."""
        c = self.c
        s, b, _ = x.shape
        qkv = qkv_mod.apply(bp["qkv"], x)                  # (S, B, 3H)
        q, k, v = qkv_split_heads(qkv, c.num_heads, c.head_dim)
        scale = 1.0 / math.sqrt(c.head_dim)
        if c.use_flash_attention:
            ctx = flash_attention(q, k, v, causal=True, softmax_scale=scale,
                                  block_q=c.attn_block_q,
                                  block_k=c.attn_block_k,
                                  heads_per_step=c.attn_heads_per_step)
        else:
            # the two products stay GEMMs (XLA's einsums in the JAX
            # package), each rounded once to the compute dtype
            scores = torch.matmul(q, k.transpose(-2, -1))  # (B, nh, S, S)
            probs = scaled_upper_triang_masked_softmax(
                scores.reshape(-1, s, s), scale).reshape(scores.shape)
            ctx = torch.matmul(probs, v)                   # (B, nh, S, d)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)    # (S, B, H)
        return proj_mod.apply(bp["proj"], ctx)

    def _block(self, i, params, x):
        """ln1 → qkv → split heads → attention → proj → residual, then
        ln2 → fc1 → tanh-gelu → fc2 → residual."""
        qkv_mod, proj_mod, fc1, fc2 = self.blocks[i]
        h = self._ln(params["ln1"], x)
        x = x + self._attention(params, qkv_mod, proj_mod, h)
        h = self._ln(params["ln2"], x)
        m = fc1.apply(params["fc1"], h)
        m = F.gelu(m, approximate="tanh")
        m = fc2.apply(params["fc2"], m)
        return x + m

    def apply(self, params, tokens):
        """tokens: (B, S) int ids → final hidden states (S, B, H)."""
        h = self.embed.apply(params["embed"], tokens.T)    # (S, B, H)
        pos = params["pos_embed"][:tokens.shape[1]][:, None, :]
        h = h + pos.to(h.dtype)
        for i in range(self.c.num_layers):
            h = self._block(i, params[f"block{i}"], h)
        return self._ln(params["final_ln"], h)

    def logits_local(self, params, h):
        """Tied-embedding LM head: (S, B, V) logits, the fp32-accumulated
        product rounded once to `logits_dtype` (fp32 when None)."""
        w = params["embed"]["weight"]
        out_dtype = self.c.logits_dtype or torch.float32
        if out_dtype == h.dtype:
            return torch.matmul(h, w.t())
        return torch.matmul(h.float(), w.float().t()).to(out_dtype)

    def loss(self, params, tokens, labels):
        """Mean LM loss; tokens/labels (B, S)."""
        h = self.apply(params, tokens)
        logits = self.logits_local(params, h)              # (S, B, V)
        loss = vocab_parallel_cross_entropy(logits, labels.T)
        return torch.mean(loss)


def gpt_350m(**overrides) -> GPT:
    """GPT-350M (`GPT2_350M`), with `overrides` of any `GPTConfig` field."""
    return GPT(GPTConfig(**{**GPT2_350M, **overrides}))


def gpt_1p3b(**overrides) -> GPT:
    """GPT-1.3B (`GPT2_1p3B`), with `overrides` of any `GPTConfig` field."""
    return GPT(GPTConfig(**{**GPT2_1p3B, **overrides}))
