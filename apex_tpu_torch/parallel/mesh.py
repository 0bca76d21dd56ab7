"""Process-group bookkeeping (counterpart of apex_tpu/parallel/mesh.py,
itself ≡ apex.transformer.parallel_state).

The JAX package names the axes of one device mesh, shape (pp, dp, tp)
over the devices in row-major order (apex_tpu/parallel/mesh.py:61-123);
the port keeps the axis names and holds, in their place, the
`torch.distributed` process groups that each parallel dimension runs
its collectives over.  `initialize_model_parallel` splits the world as
that reshape does, tensor parallelism innermost: the tp groups are runs
of contiguous ranks, [k·tp, (k+1)·tp), and the dp groups are strided,
{i + j·tp}.  Every rank creates every group, in the same order (the tp
groups, then the dp groups); a group that spans the whole world is the
world itself.  Pipeline, context and expert parallelism raise, naming
the ROADMAP items that bring them (14, 15, 16).

A world of one needs no `init_process_group`: with torch.distributed
not initialized every group is None, its size 1 and its rank 0, and the
collectives below are the identity.  With a process group, even one of
a single rank (NCCL on one card), every collective is issued.

Ranks are host ints here: the JAX package's `get_tensor_model_parallel_
rank` / `get_data_parallel_rank` are traced `lax.axis_index`es inside
`shard_map`.  `named_sharding` and `data_parallel_sharding` are JAX
shardings (`NamedSharding` over the mesh) and have no counterpart: a
rank holds its shard as an ordinary tensor (`partition_spec()` of the
tensor-parallel layers names the dimension it is cut along).

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
    tp_group: Optional[object]
    tensor_model_parallel_size: int
    tensor_model_parallel_rank: int
    world_size: int
    rank: int
    use_fp8: bool = False


class MeshNotInitializedError(RuntimeError):
    pass


def _world_group():
    """The torch.distributed world, or None when it is not initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _new_groups(runs, rank, world):
    """Create one process group per rank list in `runs` (every rank makes
    every group, in order) and return the one holding `rank`; a run that
    is the whole world is the world group."""
    mine = None
    for ranks in runs:
        g = (dist.group.WORLD if len(ranks) == world
             else dist.new_group(ranks))
        if rank in ranks:
            mine = g
    return mine


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        pipeline_model_parallel_split_rank: Optional[int] = None,
        expert_model_parallel_size: int = 1,
        context_parallel_size: int = 1,
        use_fp8: bool = False):
    """Split the torch.distributed world into tp groups and dp groups
    (≡ the JAX package's `initialize_model_parallel` at pp = ep = 1:
    dp = world // tp).  A tp size that does not divide the world raises.
    Without torch.distributed the world is one rank and both groups are
    None.  Returns the dp group."""
    global _GLOBAL_STATE
    tp = tensor_model_parallel_size
    if tp < 1:
        raise ValueError(f"tensor_model_parallel_size must be >= 1, got {tp}")
    for what, n, item in (
            ("pipeline_model_parallel_size", pipeline_model_parallel_size,
             14),
            ("context_parallel_size", context_parallel_size, 15),
            ("expert_model_parallel_size", expert_model_parallel_size, 16)):
        if n < 1:
            raise ValueError(f"{what} must be >= 1, got {n}")
        if n != 1:
            raise NotImplementedError(
                f"{what}={n}: only data and tensor parallelism are ported; "
                f"this comes with ROADMAP Queue 1 item {item}")
    if (virtual_pipeline_model_parallel_size is not None
            or pipeline_model_parallel_split_rank is not None):
        raise NotImplementedError(
            "virtual pipelines and the encoder/decoder split come with "
            "pipeline parallelism, ROADMAP Queue 1 item 14")
    world_group = _world_group()
    world, rank = group_size(world_group), group_rank(world_group)
    if world % tp:
        raise ValueError(f"world size {world} is not divisible by tp({tp}) "
                         f"x pp(1) x ep(1)")
    dp = world // tp
    if world_group is None:
        tp_group = dp_group = None
    else:
        tp_group = _new_groups(
            [list(range(k * tp, (k + 1) * tp)) for k in range(dp)],
            rank, world)
        dp_group = _new_groups(
            [[i + j * tp for j in range(dp)] for i in range(tp)], rank,
            world)
    _GLOBAL_STATE = _MeshState(
        dp_group=dp_group, data_parallel_size=dp,
        data_parallel_rank=rank // tp, tp_group=tp_group,
        tensor_model_parallel_size=tp, tensor_model_parallel_rank=rank % tp,
        world_size=world, rank=rank, use_fp8=use_fp8)
    return dp_group


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


def get_tensor_model_parallel_group():
    """The tp ProcessGroup (None for a world of one)."""
    return _state().tp_group


def get_tensor_model_parallel_world_size() -> int:
    return _state().tensor_model_parallel_size


def get_tensor_model_parallel_rank() -> int:
    """This process's tp rank, a host int."""
    return _state().tensor_model_parallel_rank


def get_tensor_model_parallel_src_rank(device_rank: Optional[int] = None
                                       ) -> int:
    """First global rank of `device_rank`'s tp group (this process's by
    default) ≡ parallel_state.get_tensor_model_parallel_src_rank."""
    s = _state()
    r = s.rank if device_rank is None else device_rank
    return (r // s.tensor_model_parallel_size) * s.tensor_model_parallel_size


def get_data_parallel_src_rank(device_rank: Optional[int] = None) -> int:
    """First global rank of `device_rank`'s dp group (this process's by
    default): the same tp index at dp index 0 (the JAX package's
    coordinate form; pp = 1, so one stage holds the world)."""
    s = _state()
    r = s.rank if device_rank is None else device_rank
    return r % s.tensor_model_parallel_size


def get_rank_info() -> str:
    """(dp, tp, pp) info string for log prefixes ≡
    parallel_state.get_rank_info: this process's rank and the group
    sizes."""
    if _GLOBAL_STATE is None:
        return f"proc{group_rank(_world_group())}"
    s = _GLOBAL_STATE
    return (f"proc{s.rank} dp{s.data_parallel_size}"
            f"/tp{s.tensor_model_parallel_size}/pp1")


def get_model_parallel_axes() -> tuple:
    """Axes of the model-parallel group (pp × tp plane), the JAX
    package's names; `new_process_group` turns them into a group."""
    return (PP_AXIS, TP_AXIS)


def get_amax_reduction_axes() -> tuple:
    """Axes spanning one fp8 amax-reduction group (one pipeline stage's
    (dp, tp) plane); needs `use_fp8=True` at initialization."""
    if not _state().use_fp8:
        raise MeshNotInitializedError(
            "AMAX reduction group is not initialized; pass use_fp8=True to "
            "initialize_model_parallel")
    return (DP_AXIS, TP_AXIS)


def reduce_amax(x):
    """The max of each rank's `x` over the amax-reduction group, as a new
    tensor (≡ `lax.pmax` over `get_amax_reduction_axes()`)."""
    return all_reduce(x.clone(), "max",
                      new_process_group(get_amax_reduction_axes()))


def new_process_group(axes):
    """The process group whose collectives run over the named mesh axes
    (one name or an iterable of them) ≡ parallel_state.new_process_group,
    which the JAX package reduces to a validated tuple of axis names:
    ("tp",) the tp group, ("dp",) the dp group, ("dp", "tp") the world;
    "pp" adds nothing (pp = 1).  A group of one rank is None.  Unknown
    axes raise."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = set(axes)
    valid = {PP_AXIS, DP_AXIS, TP_AXIS}
    unknown = sorted(axes - valid)
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; have {sorted(valid)}")
    s = _state()
    if {DP_AXIS, TP_AXIS} <= axes:
        return _world_group()
    if TP_AXIS in axes:
        return s.tp_group
    if DP_AXIS in axes:
        return s.dp_group
    return None


# --- the group a collective runs over ---------------------------------------

def data_parallel_group():
    """The dp group of `initialize_model_parallel`; else the
    torch.distributed world when it is initialized; else None (a world
    of one: every collective is the identity)."""
    if _GLOBAL_STATE is not None:
        return _GLOBAL_STATE.dp_group
    return _world_group()


def group_of(axis_name: str):
    """The group a collective over `axis_name` ("tp" or "dp", the JAX
    package's axis names) runs over: the mesh's; without a mesh the tp
    group is None (every rank holds the whole model: tp = 1) and the dp
    group `data_parallel_group()`."""
    if axis_name == TP_AXIS:
        return None if _GLOBAL_STATE is None else _GLOBAL_STATE.tp_group
    if axis_name == DP_AXIS:
        return data_parallel_group()
    raise ValueError(f"no process group for axis {axis_name!r}; the port "
                     f"has {TP_AXIS!r} and {DP_AXIS!r}")


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# --- collectives ------------------------------------------------------------

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def all_reduce(x, op: str = "sum", group=None, async_op: bool = False):
    """`x` reduced over `group` in place (op "sum", "max" or "min") and
    returned (with `async_op`, the work handle: wait on it before reading
    `x`, which must then be contiguous); the identity without a group.
    A strided `x` is reduced through a contiguous copy."""
    if group is None:
        return None if async_op else x
    op = getattr(dist.ReduceOp, _OPS[op])
    if not x.is_contiguous() and not async_op:
        y = x.contiguous()
        dist.all_reduce(y, op=op, group=group)
        return x.copy_(y)
    work = dist.all_reduce(x, op=op, group=group, async_op=async_op)
    return work if async_op else x


def reduce_scatter(out, inp, group=None, async_op: bool = False):
    """`out` (len(inp) / world elements) := this rank's chunk of the sum
    of every rank's `inp` (≡ `lax.psum_scatter(tiled=True)`); a copy
    without a group.  Both contiguous."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    work = fn(out, inp, group=group, async_op=async_op)
    return work if async_op else out


def all_gather(out, inp, group=None, async_op: bool = False):
    """`out` (len(inp) x world elements) := every rank's `inp` in rank
    order (≡ `lax.all_gather(tiled=True)`); a copy without a group.  Both
    contiguous."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    work = fn(out, inp, group=group, async_op=async_op)
    return work if async_op else out


def exchange(sends, group):
    """Point-to-point over `group`: `sends` is a list of (tensor, dst,
    recv buffer, src) with group ranks; every send and receive is issued
    in one batch (`batch_isend_irecv`).  Returns the work handles: wait
    on them before reading a receive buffer or writing a sent tensor."""
    ops = []
    for t, dst, buf, src in sends:
        ops.append(dist.P2POp(dist.isend, t,
                              dist.get_global_rank(group, dst), group))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
    return dist.batch_isend_irecv(ops)
