"""BERT — the bidirectional encoder with its MLM and NSP heads, at tp=1
(counterpart of apex_tpu/models/bert.py).

Parameters are a plain nested dict of tensors in the JAX package's
layout and key names (`params_from_jax` carries a JAX tree over):

  embed.weight                 (V, H)   tied MLM head
  pos_embed                    (seq_len, H)
  tokentype_embed              (num_tokentypes, H)
  embed_ln, lm_head_ln         weight, bias (H,)
  pooler_w, pooler_b           (H, H), (H,)
  lm_head_dense_w, _b          (H, H), (H,)
  nsp_w, nsp_b                 (H, 2), (2,)
  block{i}.ln1/ln2             weight, bias (H,)
  block{i}.qkv                 weight (H, 3H), bias (3H,)   packed (3, nh, d)
  block{i}.proj                weight (H, H),  bias (H,)
  block{i}.fc1 / fc2           (H, 4H) / (4H, H) with biases

Activations are (S, B, H).  Attention is non-causal.  With
`use_flash_attention=True` it is the flash kernel, with the padding mask
passed as segment ids (real tokens 1, pads 0), so padded keys are masked
without an S² score matrix.  Otherwise (the default, as in the JAX
package) it is dense: the S² scores, the masked scaled softmax kernel
with the (B, 1, 1, S) padding mask, the probabilities times v.  The MLP
is fc1 → tanh-gelu → fc2; the MLM head is dense → tanh-gelu → LayerNorm
→ the tied embedding, the pooler a tanh, and the NSP term an fp32
log-softmax.

The MLM logits are, as in the JAX package, a product of bf16 operands
with an fp32 result: `torch.mm(..., out_dtype=torch.float32)` on the
card keeps both operands bf16 on the tensor cores (cuBLAS accumulates in
fp32), where upcasting them first would make the (tokens × H) · (H × V)
product and its two gradients fp32 GEMMs.  The gradients round the fp32
cotangent to bf16 once and run as bf16 GEMMs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.models.gpt import params_from_jax  # noqa: F401
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.fused_dense import qkv_split_heads
from apex_tpu_torch.ops.layer_norm import fused_layer_norm
from apex_tpu_torch.ops.softmax import scaled_masked_softmax
from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528
    seq_len: int = 512
    hidden: int = 1024          # BERT-Large defaults
    num_layers: int = 24
    num_heads: int = 16
    ffn_mult: int = 4
    num_tokentypes: int = 2
    dtype: torch.dtype = torch.float32
    # MLM logits dtype: None keeps fp32 (S, B, V) logits
    logits_dtype: Optional[torch.dtype] = None
    use_flash_attention: bool = False
    # the TPU kernel's tile knobs: accepted, not read (the CUDA kernels
    # tile by 64 x 64)
    attn_block_q: Any = None
    attn_block_k: Any = None
    attn_heads_per_step: Any = None
    axis_name: str = "tp"       # the tensor-parallel axis: tp=1 here

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


def init_bert_params(cfg: BertConfig, seed: int = 0, device=None) -> dict:
    """Random BERT weights from a `torch.Generator` seeded with `seed`,
    with the distributions of the JAX package's `Bert.init`: embeddings,
    pooler, MLM dense, NSP, qkv and fc1 N(0, 0.02²), proj and fc2
    N(0, (0.02/√(2L))²), zero biases, LayerNorm weight 1 and bias 0."""
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
        "tokentype_embed": normal((c.num_tokentypes, h), 0.02),
        "embed_ln": ln(),
        "pooler_w": normal((h, h), 0.02), "pooler_b": zeros(h),
        "lm_head_ln": ln(),
        "lm_head_dense_w": normal((h, h), 0.02), "lm_head_dense_b": zeros(h),
        "nsp_w": normal((h, 2), 0.02), "nsp_b": zeros(2),
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


class _MlmLogits(torch.autograd.Function):
    """(N, H) · (V, H)ᵀ with bf16 operands and an fp32 product on the
    card; the gradients are bf16 GEMMs of the cotangent rounded once."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w, g.t() @ x


def mlm_logits(x, w, out_dtype):
    """(S, B, H) hidden · the (V, H) embedding → (S, B, V) logits: the
    fp32-accumulated product rounded once to `out_dtype`."""
    s, b, h = x.shape
    if x.dtype == torch.float32 or x.device.type != "cuda":
        y = torch.matmul(x.float(), w.float().t())
    else:
        y = _MlmLogits.apply(x.reshape(s * b, h), w).view(s, b, -1)
    return y.to(out_dtype)


class Bert:
    """The BERT encoder and its pretraining loss on one device ≡ the JAX
    package's `Bert` at tp=1, over the nested parameter dict of
    `init_bert_params` / `params_from_jax`.  Attention follows
    `use_flash_attention`: the flash kernel with segment ids, or (the
    default) the dense path through the masked scaled softmax kernel."""

    def __init__(self, config: BertConfig):
        c = config
        if c.hidden % c.num_heads:
            raise ValueError(f"num_heads={c.num_heads} must divide "
                             f"hidden={c.hidden}")
        self.c = c
        h, f = c.hidden, c.ffn_mult * c.hidden
        self.embed = VocabParallelEmbedding(c.vocab_size, h)
        self.blocks = [(ColumnParallelLinear(h, 3 * h),
                        RowParallelLinear(h, h),
                        ColumnParallelLinear(h, f),
                        RowParallelLinear(f, h))
                       for _ in range(c.num_layers)]

    def init(self, seed: int = 0, device=None) -> dict:
        return init_bert_params(self.c, seed, device)

    def _ln(self, p, x):
        return fused_layer_norm(x, p["weight"], p["bias"])

    def _attention(self, bp, qkv_mod, proj_mod, x, attn_mask):
        """x: (S, B, H) → (S, B, H).  attn_mask: the flash path's (B, S)
        int32 segment ids, or the dense path's (B, 1, 1, S) bool padding
        mask (True = padded)."""
        c = self.c
        s, b, _ = x.shape
        qkv = qkv_mod.apply(bp["qkv"], x)                  # (S, B, 3H)
        q, k, v = qkv_split_heads(qkv, c.num_heads, c.head_dim)
        scale = 1.0 / math.sqrt(c.head_dim)
        if c.use_flash_attention:
            ctx = flash_attention(q, k, v, softmax_scale=scale,
                                  segment_ids=attn_mask)
        else:
            scores = torch.matmul(q, k.transpose(-2, -1))  # (B, nh, S, S)
            probs = scaled_masked_softmax(scores, attn_mask, scale)
            ctx = torch.matmul(probs, v)                   # (B, nh, S, d)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)    # (S, B, H)
        return proj_mod.apply(bp["proj"], ctx)

    def encode(self, params, tokens, tokentype_ids=None, pad_mask=None):
        """tokens (B, S) → hidden (S, B, H).  pad_mask (B, S): True where
        padded; padded keys are masked out of every query's attention."""
        ids = tokens.T
        h = self.embed.apply(params["embed"], ids)         # (S, B, H)
        h = h + params["pos_embed"][:ids.shape[0]][:, None, :].to(h.dtype)
        if tokentype_ids is not None:
            tt = F.embedding(tokentype_ids.T, params["tokentype_embed"])
            h = h + tt.to(h.dtype)
        h = self._ln(params["embed_ln"], h)
        if pad_mask is None:
            pad_mask = torch.zeros_like(tokens, dtype=torch.bool)
        if self.c.use_flash_attention:
            # real tokens share one segment id, pads another: cross
            # attention is masked without an S² score matrix
            attn_mask = torch.logical_not(pad_mask).to(torch.int32)
        else:
            # (B, 1, 1, S): the softmax kernel reads it through its
            # broadcast strides
            attn_mask = pad_mask.to(torch.bool)[:, None, None, :]
        for i, (qkv_mod, proj_mod, fc1, fc2) in enumerate(self.blocks):
            bp = params[f"block{i}"]
            hn = self._ln(bp["ln1"], h)
            h = h + self._attention(bp, qkv_mod, proj_mod, hn, attn_mask)
            hn = self._ln(bp["ln2"], h)
            m = F.gelu(fc1.apply(bp["fc1"], hn), approximate="tanh")
            h = h + fc2.apply(bp["fc2"], m)
        return h

    def loss(self, params, tokens, mlm_labels, loss_mask, nsp_labels=None,
             tokentype_ids=None, pad_mask=None):
        """Masked-LM loss over the `loss_mask` positions (+ the NSP loss
        when `nsp_labels` are given); tokens, labels and masks (B, S)."""
        c = self.c
        h = self.encode(params, tokens, tokentype_ids, pad_mask)
        lm = (h @ params["lm_head_dense_w"].to(h.dtype)
              + params["lm_head_dense_b"].to(h.dtype))
        lm = self._ln(params["lm_head_ln"],
                      F.gelu(lm, approximate="tanh"))
        logits = mlm_logits(lm, params["embed"]["weight"],
                            c.logits_dtype or torch.float32)
        per_tok = vocab_parallel_cross_entropy(logits, mlm_labels.T)
        lm_mask = loss_mask.T.to(torch.float32)
        mlm_loss = (torch.sum(per_tok * lm_mask)
                    / torch.clamp_min(torch.sum(lm_mask), 1.0))
        if nsp_labels is None:
            return mlm_loss
        pooled = torch.tanh(h[0] @ params["pooler_w"].to(h.dtype)
                            + params["pooler_b"].to(h.dtype))   # (B, H)
        nsp_logits = (pooled @ params["nsp_w"].to(h.dtype)
                      + params["nsp_b"].to(h.dtype))
        logp = torch.log_softmax(nsp_logits.float(), dim=-1)
        nsp = -torch.mean(torch.gather(logp, 1,
                                       nsp_labels.long()[:, None]))
        return mlm_loss + nsp


def bert_large(**overrides) -> Bert:
    return Bert(BertConfig(**overrides))
