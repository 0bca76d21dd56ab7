"""Tensor-parallel layers — column- and row-parallel linear, the
vocab-parallel embedding (counterpart of
apex_tpu/transformer/tensor_parallel/layers.py:38-252).

The layers keep the JAX package's parameter layout and names: Linear
weights are (in, out) so every product reads `x @ w`, and the embedding
is (V, H).  Products are `torch.matmul`, which reduces bf16 products in
fp32 and rounds once to the input dtype under `strict_matmul_numerics`
(≡ `preferred_element_type=float32` then `.astype(x.dtype)`).

`init` returns the whole (global) parameters; `partition_spec()` names,
for each leaf, the dimension it is cut along over the tp ranks (the JAX
package's `PartitionSpec`, which is JAX-only: here a dim index, or None
for a replicated leaf), and `shard_tree` cuts a rank's shard.  `apply`
takes this rank's shard and runs the Megatron region collectives of
`parallel.collectives` over the tp group of `parallel.mesh` (the
identity without one).  A shard that does not match the layer's size
over the tp group raises: a tp > 1 shard with no process group, or a
size the tp group does not divide.

`overlap_chunks` (None: the tuner's, 1 on a miss; an int: forced) above
1 routes a layer through the chunked primitives of `parallel.overlap`;
at 1 the layers keep the monolithic spelling below.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.parallel import mesh as M
from apex_tpu_torch.parallel import overlap as OV
from apex_tpu_torch.parallel.collectives import (
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
)
from apex_tpu_torch.parallel.mesh import TP_AXIS


def axis_dims(spec) -> dict:
    """{axis name: dim} of one leaf's partition spec: None (replicated),
    an int (the dim cut over tp), or a tuple naming each dim's axis ("pp",
    "tp" or None), the JAX package's `PartitionSpec` order."""
    if spec is None:
        return {}
    if isinstance(spec, int):
        return {TP_AXIS: spec}
    return {name: d for d, name in enumerate(spec) if name is not None}


def _shard_leaf(x, spec, coords):
    """The shard of the global `x` that `coords` ({axis: (rank, size)})
    names: each dim of `spec` cut over its axis (axes absent from
    `coords` are left whole)."""
    for axis, dim in axis_dims(spec).items():
        rank, size = coords.get(axis, (0, 1))
        if size == 1:
            continue
        if x.shape[dim] % size:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} is "
                             f"not divisible by {size} {axis} ranks")
        n = x.shape[dim] // size
        x = x.narrow(dim, rank * n, n).contiguous()
    return x


def shard_tree_axes(tree, specs, coords):
    """A nested dict of global leaves cut to the shards that `coords`
    ({axis name: (rank, size)}) names, by the matching tree of partition
    specs (`axis_dims`)."""
    if isinstance(tree, dict):
        return {k: shard_tree_axes(v, specs[k], coords)
                for k, v in tree.items()}
    return _shard_leaf(tree, specs, coords)


def shard_tree(tree, specs, rank: int, size: int):
    """A nested dict of global leaves cut to tp rank `rank`'s shards by
    the matching tree of `partition_spec()` entries."""
    return shard_tree_axes(tree, specs, {TP_AXIS: (rank, size)})


def _check_shard(who, leaf, full_shape, dim, p):
    """`leaf` must be a rank's shard of `full_shape` cut along `dim` over
    `p` tp ranks."""
    if dim is not None and full_shape[dim] % p:
        raise ValueError(f"{who}: size {full_shape[dim]} is not divisible "
                         f"by the {p} tensor-parallel ranks")
    want = list(full_shape)
    if dim is not None:
        want[dim] //= p
    if tuple(leaf.shape) != tuple(want):
        raise ValueError(
            f"{who}: a shard of shape {tuple(leaf.shape)} is not this "
            f"rank's {tuple(want)} of {tuple(full_shape)} over {p} "
            f"tensor-parallel ranks (a tp > 1 shard needs the tp group of "
            f"parallel.mesh.initialize_model_parallel)")


def _normal(key, shape, std, dtype, device):
    w = torch.randn(shape, generator=key, dtype=torch.float32)
    return (w * std).to(dtype=dtype, device=device)


class ColumnParallelLinear:
    """Y = XA + b with A column-sharded over tp: A = [A_1 .. A_p].

    gather_output re-gathers Y along the last dim; sequence_parallel
    all-gathers the sequence-sharded input first (its backward is the
    reduce-scatter of the input gradient)."""

    def __init__(self, input_size: int, output_size: int, *,
                 bias: bool = True, gather_output: bool = False,
                 sequence_parallel: bool = False,
                 init_std: Optional[float] = None,
                 axis_name: str = TP_AXIS, overlap_chunks=None):
        self.input_size = input_size
        self.output_size = output_size
        self.use_bias = bias
        self.gather_output = gather_output
        self.sequence_parallel = sequence_parallel
        self.init_std = init_std
        self.axis_name = axis_name
        self.overlap_chunks = overlap_chunks

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        """Global parameters: weight N(0, init_std²) (1/√input_size by
        default) drawn from the CPU generator `key`, zero bias."""
        std = self.init_std or 1.0 / math.sqrt(self.input_size)
        p = {"weight": _normal(key, (self.input_size, self.output_size), std,
                               dtype, device)}
        if self.use_bias:
            p["bias"] = torch.zeros(self.output_size, dtype=dtype,
                                    device=device)
        return p

    def partition_spec(self):
        spec = {"weight": 1}
        if self.use_bias:
            spec["bias"] = 0
        return spec

    def apply(self, params, x):
        """`params` are this rank's shards (output dim / tp)."""
        ax = self.axis_name
        group = M.group_of(ax)
        p = M.group_size(group)
        w = params["weight"]
        _check_shard("ColumnParallelLinear weight", w,
                     (self.input_size, self.output_size), 1, p)
        path = "tp_col" if self.sequence_parallel else "tp_col_copy"
        chunks = OV.layer_chunks(self.overlap_chunks, path, x.shape[0],
                                 w.shape[-1], ax, x.dtype,
                                 divisor_of=x.shape[0])
        if chunks > 1:
            if self.sequence_parallel:
                # the gather and GEMM as a chunked ring: each hop under
                # the previous chunk's partial GEMM
                y = OV.ring_gather_matmul(x, w, group, chunks)
            else:
                # no forward collective: the backward's dx all-reduce is
                # chunked against the dgrad GEMM
                y = OV.copy_matmul(x, w, group, chunks)
        else:
            if self.sequence_parallel:
                x = gather_from_sequence_parallel_region(x, ax)
            else:
                x = copy_to_tensor_model_parallel_region(x, ax)
            y = torch.matmul(x, w)
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        if self.gather_output:
            y = gather_from_tensor_model_parallel_region(y, ax)
        return y


class RowParallelLinear:
    """Y = XA + b with A row-sharded over tp and the partial products
    summed.  input_is_parallel skips the input scatter;
    sequence_parallel reduce-scatters the output along the sequence
    instead of all-reducing it.  The bias is added after the reduction,
    once; under sequence_parallel it passes through copy_to, so that its
    gradient (a partial sum on each rank) is summed over tp."""

    def __init__(self, input_size: int, output_size: int, *,
                 bias: bool = True, input_is_parallel: bool = True,
                 sequence_parallel: bool = False,
                 init_std: Optional[float] = None,
                 axis_name: str = TP_AXIS, overlap_chunks=None):
        if sequence_parallel and not input_is_parallel:
            raise RuntimeError(
                "To enable sequence_parallel, input_is_parallel must be True")
        self.input_size = input_size
        self.output_size = output_size
        self.use_bias = bias
        self.input_is_parallel = input_is_parallel
        self.sequence_parallel = sequence_parallel
        self.init_std = init_std
        self.axis_name = axis_name
        self.overlap_chunks = overlap_chunks

    init = ColumnParallelLinear.init

    def partition_spec(self):
        spec = {"weight": 0}
        if self.use_bias:
            spec["bias"] = None
        return spec

    def apply(self, params, x):
        ax = self.axis_name
        group = M.group_of(ax)
        p = M.group_size(group)
        w = params["weight"]
        _check_shard("RowParallelLinear weight", w,
                     (self.input_size, self.output_size), 0, p)
        if not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x, ax)
        if self.sequence_parallel:
            # the chunked dim is the output rows (S / p): each chunk
            # GEMMs the input rows feeding its scatter slice
            div, path = x.shape[0] // p, "tp_row"
        else:
            div, path = x.shape[0], "tp_row_ar"
        chunks = OV.layer_chunks(self.overlap_chunks, path, x.shape[0],
                                 w.shape[-1], ax, x.dtype, divisor_of=div)
        if chunks > 1:
            if self.sequence_parallel:
                y = OV.matmul_reduce_scatter(x, w, group, chunks)
            else:
                y = OV.matmul_all_reduce(x, w, group, chunks)
        else:
            y = torch.matmul(x, w)
            if self.sequence_parallel:
                y = reduce_scatter_to_sequence_parallel_region(y, ax)
            else:
                y = reduce_from_tensor_model_parallel_region(y, ax)
        if self.use_bias:
            bias = params["bias"]
            if self.sequence_parallel:
                bias = copy_to_tensor_model_parallel_region(bias, ax)
            y = y + bias.to(y.dtype)
        return y


class VocabParallelEmbedding:
    """Embedding with the vocab dim sharded over tp: each rank owns rows
    [rank·V/p, (rank+1)·V/p); ids outside them are looked up as row 0,
    their outputs zeroed, and the ranks' outputs summed.  Under
    sequence_parallel the sum is then scattered along the sequence."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 init_std: float = 0.02, axis_name: str = TP_AXIS,
                 sequence_parallel: bool = False):
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.init_std = init_std
        self.axis_name = axis_name
        self.sequence_parallel = sequence_parallel

    def init(self, key: torch.Generator, dtype=torch.float32, device=None):
        return {"weight": _normal(key, (self.num_embeddings,
                                        self.embedding_dim), self.init_std,
                                  dtype, device)}

    def partition_spec(self):
        return {"weight": 0}

    def apply(self, params, ids):
        """`params["weight"]` is this rank's (V/p, D) shard; `ids` the
        global ids (replicated over tp)."""
        ax = self.axis_name
        group = M.group_of(ax)
        p = M.group_size(group)
        w = params["weight"]
        _check_shard("VocabParallelEmbedding weight", w,
                     (self.num_embeddings, self.embedding_dim), 0, p)
        if p == 1:
            out = F.embedding(ids, w)
        else:
            start = M.group_rank(group) * w.shape[0]
            local = ids - start
            valid = (local >= 0) & (local < w.shape[0])
            out = F.embedding(torch.where(valid, local, 0), w)
            out = torch.where(valid[..., None], out, 0.0)
        out = reduce_from_tensor_model_parallel_region(out, ax)
        if self.sequence_parallel:
            # the embedding's output scattered along the sequence (the
            # Megatron SP entry point)
            out = scatter_to_sequence_parallel_region(out, ax)
        return out
