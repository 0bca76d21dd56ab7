"""GPT configuration, seeded init and the JAX-params converter
(counterpart of the config and `GPT.init` half of apex_tpu/models/gpt.py).

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
as the JAX package's `_dot` does.  The training forward (`GPT.apply`,
flash attention, cross entropy) waits for the training slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch

from apex_tpu_torch.ops._common import resolve_device


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

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


# preset sizes ≡ apex_tpu.models.gpt
GPT2_350M = dict(hidden=1024, num_layers=24, num_heads=16)


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
