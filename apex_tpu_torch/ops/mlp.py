"""Fused MLP — a chain of linear + bias + activation layers
(counterpart of apex_tpu/ops/mlp.py, itself ≡ apex's mlp_cuda extension
and apex.mlp.MLP): each layer is one launch of the fused dense kernel
(`ops.fused_dense.linear_bias`), the activation between layers and none
after the last."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.ops.fused_dense import _uniform, linear_bias


def mlp_forward(x, weights, biases, activation: str = "relu"):
    """The chain (≡ the JAX package's `mlp_forward`): `weights` (in, out)
    each, `biases` (out,) or None each; the activation on every layer but
    the last."""
    n = len(weights)
    for i, (w, b) in enumerate(zip(weights, biases)):
        x = linear_bias(x, w, b, activation if i < n - 1 else None)
    return x


class MLP(nn.Module):
    """≡ apex.mlp.MLP (the JAX package's `MLP`): mlp_sizes = [in, h1, ...,
    out]; activation 'none', 'relu', 'sigmoid' or 'gelu'.  Weights (in,
    out) and biases uniform in ±1/√in from `seed`, on the card unless
    `device` says otherwise; `ops.fused_dense.params_from_jax` gives the
    JAX package's params as this module's state dict."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", *, seed=0, device=None,
                 dtype=torch.float32):
        super().__init__()
        if activation not in ("none", "relu", "sigmoid", "gelu"):
            raise TypeError(f"activation '{activation}' not supported")
        self.mlp_sizes = tuple(mlp_sizes)
        self.use_bias = bias
        self.activation = activation
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        weights, biases = [], []
        for fan_in, fan_out in zip(self.mlp_sizes[:-1], self.mlp_sizes[1:]):
            bound = 1.0 / math.sqrt(fan_in)
            weights.append(nn.Parameter(_uniform(
                gen, (fan_in, fan_out), bound, device, dtype)))
            if bias:
                biases.append(nn.Parameter(_uniform(gen, (fan_out,), bound,
                                                    device, dtype)))
        self.weights = nn.ParameterList(weights)
        self.biases = nn.ParameterList(biases)

    def forward(self, x):
        biases = list(self.biases) if self.use_bias else [None] * len(
            self.weights)
        return mlp_forward(x, list(self.weights), biases, self.activation)
