"""Tensor-parallel layers at tp=1 (counterpart of
apex_tpu/transformer/tensor_parallel/layers.py).

The layers keep the JAX package's parameter layout and names: Linear
weights are (in, out) so every product reads `x @ w`, and the embedding
is (V, H).  Products are `torch.matmul`, which reduces bf16 products in
fp32 and rounds once to the input dtype under `strict_matmul_numerics`
(≡ `preferred_element_type=float32` then `.astype(x.dtype)`).

At tp=1 there are no collectives: the copy/reduce/gather regions of the
JAX package are identities.  tp>1, sequence parallelism and the chunked
compute/collective overlap come with ROADMAP slice 4 (Queue 1 item 13).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class ColumnParallelLinear:
    """Y = XA + b, A (input_size, output_size); tp=1."""

    def __init__(self, input_size: int, output_size: int, *,
                 bias: bool = True):
        self.input_size = input_size
        self.output_size = output_size
        self.use_bias = bias

    def apply(self, params, x):
        y = torch.matmul(x, params["weight"])
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        return y


class RowParallelLinear(ColumnParallelLinear):
    """Y = XA + b with the bias added after the (tp=1: absent)
    reduction; tp=1."""


class VocabParallelEmbedding:
    """Embedding lookup, weight (V, H); tp=1 (every id is local)."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim

    def apply(self, params, ids):
        return F.embedding(ids, params["weight"])
