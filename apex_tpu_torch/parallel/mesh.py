"""Process-group bookkeeping, its data-parallel part (counterpart of
apex_tpu/parallel/mesh.py, itself ≡ apex.transformer.parallel_state).

The JAX package names the axes of one device mesh; the port keeps the
axis names and holds, in their place, the `torch.distributed` process
group that each parallel dimension runs its collectives over.  So far
that is the data-parallel group: `initialize_model_parallel` takes the
whole `torch.distributed` world as the dp group (tp = pp = cp = ep = 1),
and tensor, pipeline, context and expert parallelism raise, naming the
ROADMAP items that bring them.

A world of one needs no `init_process_group`: with torch.distributed
not initialized the dp group is None, its size 1 and its rank 0, and
the collectives below are the identity.  With a process group, even
one of a single rank (NCCL on one card), every collective is issued.

The collectives are thin wrappers over `torch.distributed` that take
the group (None: the identity) and use the names that do not warn on
torch builds that have them (`all_gather_single`,
`reduce_scatter_single`; older builds call the same operation
`all_gather_into_tensor` / `reduce_scatter_tensor`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

# Canonical axis names, the JAX package's.
DP_AXIS = "dp"
PP_AXIS = "pp"
TP_AXIS = "tp"
EP_AXIS = "ep"

_GLOBAL_STATE = None


@dataclasses.dataclass
class _MeshState:
    dp_group: Optional[object]      # a ProcessGroup, or None (world of one)
    data_parallel_size: int
    data_parallel_rank: int


class MeshNotInitializedError(RuntimeError):
    pass


def _world_group():
    """The torch.distributed world, or None when it is not initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        pipeline_model_parallel_split_rank: Optional[int] = None,
        expert_model_parallel_size: int = 1,
        context_parallel_size: int = 1):
    """Set up the data-parallel group (≡ the JAX package's
    `initialize_model_parallel` at tp = pp = ep = 1, where dp is the
    whole world).  The dp group is the torch.distributed world when it
    is initialized, else None (a world of one).  Returns the dp group."""
    global _GLOBAL_STATE
    for what, n, item in (
            ("tensor_model_parallel_size", tensor_model_parallel_size, 13),
            ("pipeline_model_parallel_size", pipeline_model_parallel_size,
             14),
            ("context_parallel_size", context_parallel_size, 15),
            ("expert_model_parallel_size", expert_model_parallel_size, 16)):
        if n < 1:
            raise ValueError(f"{what} must be >= 1, got {n}")
        if n != 1:
            raise NotImplementedError(
                f"{what}={n}: only data parallelism is ported; this comes "
                f"with ROADMAP Queue 1 item {item}")
    if (virtual_pipeline_model_parallel_size is not None
            or pipeline_model_parallel_split_rank is not None):
        raise NotImplementedError(
            "virtual pipelines and the encoder/decoder split come with "
            "pipeline parallelism, ROADMAP Queue 1 item 14")
    group = _world_group()
    _GLOBAL_STATE = _MeshState(dp_group=group,
                               data_parallel_size=group_size(group),
                               data_parallel_rank=group_rank(group))
    return group


def model_parallel_is_initialized() -> bool:
    """≡ parallel_state.model_parallel_is_initialized."""
    return _GLOBAL_STATE is not None


def destroy_model_parallel() -> None:
    """≡ parallel_state.destroy_model_parallel: forgets the groups (the
    torch.distributed world itself stays up; tear it down with
    `torch.distributed.destroy_process_group`)."""
    global _GLOBAL_STATE
    _GLOBAL_STATE = None


def _state() -> _MeshState:
    if _GLOBAL_STATE is None:
        raise MeshNotInitializedError(
            "the process groups are not initialized; call "
            "apex_tpu_torch.parallel.mesh.initialize_model_parallel first")
    return _GLOBAL_STATE


def get_data_parallel_group():
    """The dp ProcessGroup (None for a world of one)."""
    return _state().dp_group


def get_data_parallel_world_size() -> int:
    return _state().data_parallel_size


def get_data_parallel_rank() -> int:
    """This process's dp rank, a host int (the JAX package's is the
    traced `axis_index`)."""
    return _state().data_parallel_rank


def get_data_parallel_axis_names() -> tuple:
    """The axes a data batch (and its grad sync) spans: ("dp",) without
    expert parallelism, which is all the port has."""
    _state()
    return (DP_AXIS,)


# --- the group a data-parallel collective runs over ------------------------

def data_parallel_group():
    """The dp group of `initialize_model_parallel`; else the
    torch.distributed world when it is initialized; else None (a world
    of one: every collective is the identity)."""
    if _GLOBAL_STATE is not None:
        return _GLOBAL_STATE.dp_group
    return _world_group()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# --- collectives ------------------------------------------------------------

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x, op: str = "sum", group=None):
    """`x` reduced over `group` in place (op "sum", "max" or "min") and
    returned; the identity without a group."""
    if group is not None:
        dist.all_reduce(x, op=getattr(dist.ReduceOp, _OPS[op]), group=group)
    return x


def reduce_scatter(out, inp, group=None, async_op: bool = False):
    """`out` (1-D, len(inp) / world) := this rank's chunk of the sum of
    every rank's `inp` (≡ `lax.psum_scatter(tiled=True)`); a copy
    without a group."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    work = fn(out, inp, group=group, async_op=async_op)
    return work if async_op else out


def all_gather(out, inp, group=None, async_op: bool = False):
    """`out` (1-D, len(inp) x world) := every rank's `inp` in rank order
    (≡ `lax.all_gather(tiled=True)`); a copy without a group."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    work = fn(out, inp, group=group, async_op=async_op)
    return work if async_op else out
