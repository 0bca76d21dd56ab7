"""Fused multihead attention modules, self and encdec (counterpart of
apex_tpu/contrib/multihead_attn.py, itself ≡ apex.contrib.multihead_attn's
SelfMultiheadAttn and EncdecMultiheadAttn).

One parametrised module over `ops.flash_attention.flash_attention`: the
reference's variants ({self, encdec} × {bias} × {include_norm_add} ×
{mask}) are plain composition.  Layout seq-first, (S, B, E), as the
reference and the JAX package take it; the projections are (E, 3E) /
(E, E) weights applied as `x @ W`.  `include_norm_add` runs a LayerNorm
first (`ops.layer_norm.fused_layer_norm`: the LayerNorm kernels on the
card) and adds the residual to the output.

The mask routes are the JAX package's (`_core`):

  * no mask: flash attention as it is;
  * a (B, Sk) key-padding mask (True = padded): segment ids, queries 0
    and keys `mask.int()`, so the padded keys cost no score tensor (on
    the card the segment-id kernels);
  * any other mask broadcastable to (b, n, sq, sk): an fp32 additive bias
    of -10000 where masked, passed with `bias_grad=False` (on the card
    the BIAS kernels, reading the (sq, sk) bias with stride 0 over batch
    and heads).

Dropout runs inside the flash kernels, drawn from `dropout_key`, a CPU
`torch.Generator`, as `flash_attention` draws it.  The module looks up
`flash_attention` in this module's namespace at each call, so a caller
can put the plain version in its place (chip_smoke.py and the example
do, to hold the kernels against it).

The JAX module stores `impl` and `separate_qkv_params` and reads
neither (its docstring says `impl="default"` runs the reference math;
its code runs flash attention either way); the port mirrors the code.

Modules with weights are `nn.Module`s that also keep the JAX package's
functional form: `init(seed, device, dtype)` gives the parameter tree
(the JAX keys), `apply(params, query, ...)` runs it, `forward` runs
`apply` on the module's own parameters, `load_params(tree)` copies a tree
in; `params_from_jax` turns the JAX package's tree into the port's.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn

from apex_tpu_torch.models.gpt import tree_from_jax
from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.flash_attention import flash_attention
from apex_tpu_torch.ops.layer_norm import fused_layer_norm


def params_from_jax(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The JAX package's SelfMultiheadAttn / EncdecMultiheadAttn params
    (nested dicts of arrays) as the port's tree on `device` (the card
    unless it says otherwise): the same keys and layouts; `dtype` casts
    every leaf (None keeps each one's own float type)."""
    return tree_from_jax(tree, device, dtype)


def _uniform(gen, shape, bound, device, dtype):
    """Uniform in ±bound from the CPU generator `gen`, on `device`."""
    return ((torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1)
            * bound).to(device=device, dtype=dtype)


class SelfMultiheadAttn(nn.Module):
    """≡ SelfMultiheadAttn (the JAX package's, and apex's
    self_multihead_attn.py:21-207): q, k and v from one (E, 3E)
    projection of the query; `bias` adds the projections' biases;
    `include_norm_add` a pre-LayerNorm and the residual."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 bias: bool = False, include_norm_add: bool = False,
                 impl: str = "fast", separate_qkv_params: bool = False, *,
                 seed: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.use_bias = bias
        self.include_norm_add = include_norm_add
        self.impl = impl
        self.separate_qkv_params = separate_qkv_params
        self.scaling = self.head_dim ** -0.5
        self._register(self.init(seed, resolve_device(device), dtype))

    def _register(self, params):
        for key, val in params.items():
            if isinstance(val, Mapping):
                setattr(self, key, nn.ParameterDict(
                    {k: nn.Parameter(v) for k, v in val.items()}))
            else:
                setattr(self, key, nn.Parameter(val))

    def _projections(self, gen, device, dtype):
        std = 1.0 / math.sqrt(self.embed_dim)
        e = self.embed_dim
        return {"qkv_weight": _uniform(gen, (e, 3 * e), std, device, dtype),
                "out_weight": _uniform(gen, (e, e), std, device, dtype)}

    def _biases(self, device, dtype):
        e = self.embed_dim
        return {"qkv_bias": torch.zeros(3 * e, device=device, dtype=dtype),
                "out_bias": torch.zeros(e, device=device, dtype=dtype)}

    def init(self, seed: int = 0, device=None, dtype=torch.float32) -> dict:
        """The parameter tree (the JAX package's keys): weights uniform in
        ±1/√E from `seed`, biases 0, LayerNorm weight 1 and bias 0."""
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        p = self._projections(gen, device, dtype)
        if self.use_bias:
            p.update(self._biases(device, dtype))
        if self.include_norm_add:
            e = self.embed_dim
            p["ln"] = {"weight": torch.ones(e, device=device, dtype=dtype),
                       "bias": torch.zeros(e, device=device, dtype=dtype)}
        return p

    def params(self) -> dict:
        """The module's parameters as the functional tree."""
        out = {}
        for key, val in self.named_children():
            out[key] = dict(val.items())
        for key, val in self.named_parameters(recurse=False):
            out[key] = val
        return out

    @torch.no_grad()
    def load_params(self, tree: Mapping[str, Any]):
        """Copy a parameter tree (e.g. `params_from_jax`'s) into the
        module's parameters."""
        mine = self.params()
        for key, val in tree.items():
            if isinstance(val, Mapping):
                for k, v in val.items():
                    mine[key][k].copy_(v)
            else:
                mine[key].copy_(val)
        return self

    def forward(self, query, key=None, value=None, *, mask=None,
                is_training: Optional[bool] = None, dropout_key=None):
        return self.apply(self.params(), query, key, value, mask=mask,
                          is_training=(self.training if is_training is None
                                       else is_training),
                          dropout_key=dropout_key)

    def _norm(self, params, x):
        if not self.include_norm_add:
            return x
        return fused_layer_norm(x, params["ln"]["weight"],
                                params["ln"]["bias"])

    def _out(self, params, ctx, residual):
        sq, b = ctx.shape[2], ctx.shape[0]
        ctx = ctx.permute(2, 0, 1, 3).reshape(sq, b, self.embed_dim)
        out = ctx @ params["out_weight"].to(ctx.dtype)
        if self.use_bias:
            out = out + params["out_bias"].to(ctx.dtype)
        if self.include_norm_add:
            out = out + residual
        return out

    def apply(self, params, query, key=None, value=None, *, mask=None,
              is_training: bool = True, dropout_key=None):
        """The JAX package's `apply`: query (S, B, E) → (S, B, E)."""
        x = self._norm(params, query)
        s, b, _ = x.shape
        qkv = x @ params["qkv_weight"].to(x.dtype)
        if self.use_bias:
            qkv = qkv + params["qkv_bias"].to(x.dtype)
        qkv = qkv.reshape(s, b, 3, self.num_heads, self.head_dim)
        q, k, v = (qkv[:, :, i].permute(1, 2, 0, 3) for i in range(3))
        ctx = self._core(q, k, v, mask, is_training, dropout_key)
        return self._out(params, ctx, query)

    def _core(self, q, k, v, mask, is_training, dropout_key):
        """Attention over (b, n, s, hd) q, k, v by the mask routes of the
        module docstring."""
        rate = self.dropout if (is_training and dropout_key is not None) \
            else 0.0
        common = dict(causal=False, softmax_scale=self.scaling,
                      dropout_rate=rate,
                      dropout_key=dropout_key if rate > 0 else None)
        if mask is None:
            return flash_attention(q, k, v, **common)
        b, sq, sk = q.shape[0], q.shape[2], k.shape[2]
        if mask.ndim == 2 and tuple(mask.shape) == (b, sk):
            # (B, Sk), True = padded: segment ids (key padding wins where
            # (B, Sk) and (Sq, Sk) coincide, as in the JAX package)
            return flash_attention(
                q, k, v,
                q_segment_ids=torch.zeros((b, sq), dtype=torch.int32,
                                          device=q.device),
                kv_segment_ids=mask.to(torch.int32), **common)
        while mask.ndim < 4:
            mask = mask[None]
        # fp32 (scalars, not device tensors: those would be a host copy
        # that waits for the card each call)
        bias = torch.where(mask.to(torch.bool), -10000.0, 0.0).float()
        # a mask-derived bias is a constant: no dbias work
        return flash_attention(q, k, v, bias=bias, bias_grad=False, **common)


class EncdecMultiheadAttn(SelfMultiheadAttn):
    """≡ EncdecMultiheadAttn (the JAX package's; apex's
    encdec_multihead_attn.py): the query from the decoder through a
    (E, E) projection, key and value from the encoder (`key`, (Sk, B,
    E)) through one (E, 2E) projection."""

    def _projections(self, gen, device, dtype):
        std = 1.0 / math.sqrt(self.embed_dim)
        e = self.embed_dim
        return {"q_weight": _uniform(gen, (e, e), std, device, dtype),
                "kv_weight": _uniform(gen, (e, 2 * e), std, device, dtype),
                "out_weight": _uniform(gen, (e, e), std, device, dtype)}

    def _biases(self, device, dtype):
        e = self.embed_dim
        return {"q_bias": torch.zeros(e, device=device, dtype=dtype),
                "kv_bias": torch.zeros(2 * e, device=device, dtype=dtype),
                "out_bias": torch.zeros(e, device=device, dtype=dtype)}

    def apply(self, params, query, key=None, value=None, *, mask=None,
              is_training: bool = True, dropout_key=None):
        enc = key if key is not None else query
        x = self._norm(params, query)
        sq, b, _ = x.shape
        sk = enc.shape[0]
        q = x @ params["q_weight"].to(x.dtype)
        kv = enc @ params["kv_weight"].to(enc.dtype)
        if self.use_bias:
            q = q + params["q_bias"].to(x.dtype)
            kv = kv + params["kv_bias"].to(x.dtype)
        q = q.reshape(sq, b, self.num_heads, self.head_dim).permute(
            1, 2, 0, 3)
        kv = kv.reshape(sk, b, 2, self.num_heads, self.head_dim)
        k_, v_ = (kv[:, :, i].permute(1, 2, 0, 3) for i in range(2))
        ctx = self._core(q, k_, v_, mask, is_training, dropout_key)
        return self._out(params, ctx, query)
