"""Test-support modules and helpers (counterpart of
apex_tpu/transformer/testing/commons.py): the toy models (MyLayer,
MyModel, ToyParallelMLP), IdentityLayer and deterministic seeding.

The port's functional idiom: `init(key, dtype, device)` draws the
parameters from the CPU generator `key` (so the draws do not depend on
the device) onto `device`, the card unless the caller asks for
another; `apply(params, x)` runs them.  ToyParallelMLP is the
port's ColumnParallelLinear -> gelu -> RowParallelLinear over the tp
group of `parallel.mesh` (the identity without one), its gelu the tanh
form that the JAX package's `jax.nn.gelu` default computes.
"""

from __future__ import annotations

import random

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.ops._common import resolve_device
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
)


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators with `seed`
    and return a CPU generator seeded with it (the JAX package returns
    its PRNG key)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def _randn(key, shape, dtype, device):
    return torch.randn(shape, generator=key).to(
        dtype=dtype, device=resolve_device(device))


class IdentityLayer:
    """A learnable tensor: `apply(params)` returns it."""

    def __init__(self, size, scale=1.0):
        self.size = size
        self.scale = scale

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        return {"weight": self.scale * _randn(key, self.size, dtype,
                                              device)}

    def apply(self, params):
        return params["weight"]


class MyLayer:
    """One shape-preserving linear layer."""

    def __init__(self, hidden_size):
        self.hidden_size = hidden_size

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        h = self.hidden_size
        device = resolve_device(device)
        return {"w": _randn(key, (h, h), dtype, device) * 0.1,
                "b": torch.zeros((h,), dtype=dtype, device=device)}

    def apply(self, params, x):
        return x @ params["w"] + params["b"]


class MyModel:
    """Stacked MyLayers (pipeline test fodder)."""

    def __init__(self, hidden_size, num_layers=1):
        self.layers = [MyLayer(hidden_size) for _ in range(num_layers)]

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        return [layer.init(key, dtype, device) for layer in self.layers]

    def apply(self, params, x):
        for layer, p in zip(self.layers, params):
            x = layer.apply(p, x)
        return x


class ToyParallelMLP:
    """hidden -> 4 hidden (column-parallel) -> gelu -> hidden
    (row-parallel)."""

    def __init__(self, hidden_size, sequence_parallel=False):
        self.col = ColumnParallelLinear(hidden_size, 4 * hidden_size,
                                        gather_output=False,
                                        sequence_parallel=sequence_parallel)
        self.row = RowParallelLinear(4 * hidden_size, hidden_size,
                                     input_is_parallel=True,
                                     sequence_parallel=sequence_parallel)

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        device = resolve_device(device)
        return {"col": self.col.init(key, dtype, device),
                "row": self.row.init(key, dtype, device)}

    def partition_spec(self):
        return {"col": self.col.partition_spec(),
                "row": self.row.partition_spec()}

    def apply(self, params, x):
        h = F.gelu(self.col.apply(params["col"], x), approximate="tanh")
        return self.row.apply(params["row"], h)
