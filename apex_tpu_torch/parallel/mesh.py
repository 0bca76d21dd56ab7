"""Process-group bookkeeping (counterpart of apex_tpu/parallel/mesh.py,
itself ≡ apex.transformer.parallel_state).

The JAX package names the axes of one device mesh, shape (pp, dp, tp)
over the devices in row-major order, or (pp, dp, ep, tp) with expert
parallelism (apex_tpu/parallel/mesh.py:61-123); the port keeps the axis
names and holds, in their place, the `torch.distributed` process groups
that each parallel dimension runs its collectives over.
`initialize_model_parallel` splits the world as that reshape does: rank
= pp_i·dp·ep·tp + dp_i·ep·tp + ep_i·tp + tp_i, tensor parallelism
innermost, ep between dp and tp.  The tp groups are runs of contiguous
ranks, the ep groups are strided by tp, the dp groups by ep·tp within a
stage, and the pp groups by dp·ep·tp.  Besides the axes' groups it makes
one group for every other set of axes (("pp", "tp"), the model-parallel
plane of the grad scaler; ("dp", "tp"), one stage's plane; ("dp", "ep"),
the data-parallel world of an expert-parallel model; ...).  Every rank
creates every group, in one fixed order (the tp groups, the dp groups,
then the pp groups and the planes; with ep > 1 the sets holding "ep"
after them); a group that spans the whole world is the world itself.  At
ep = 1 no group holds "ep": those sets name the groups without it (the
ep group is None), so the groups are the ones the port made before
expert parallelism, member for member.  Context parallelism needs no
axis of its own: as in the JAX package, `parallel.context_parallel`
rings over whatever group it is given.

With ep > 1 a data batch (and its grad sync) spans ("dp", "ep")
(`get_data_parallel_axis_names`), and `data_parallel_group()`, the group
that DDP, the ZeRO optimizers and the grad scaler's sums run over, is
that combined group.

A world of one needs no `init_process_group`: with torch.distributed
not initialized every group is None, its size 1 and its rank 0, and the
collectives below are the identity.  With a process group, even one of
a single rank (NCCL on one card), every collective is issued; a
point-to-point hop over a group of one rank is a copy
(`collectives.ring_hop`).

Ranks are host ints here: the JAX package's `get_tensor_model_parallel_
rank`, `get_data_parallel_rank`, `get_expert_model_parallel_rank` and
`get_pipeline_model_parallel_rank` are traced `lax.axis_index`es inside
`shard_map`.  The stage helpers
(`is_pipeline_first_stage`, the embedding groups' membership, the split)
take a stage as the JAX package's do, and default to this rank's.
`named_sharding` and `data_parallel_sharding` are JAX shardings
(`NamedSharding` over the mesh) and have no counterpart: a rank holds
its shard as an ordinary tensor (`partition_spec()` of the
tensor-parallel layers names the dimension it is cut along).

The collectives are thin wrappers over `torch.distributed` that take
the group (None: the identity) and use the names that do not warn on
torch builds that have them (`all_gather_single`,
`reduce_scatter_single`; older builds call the same operation
`all_gather_into_tensor` / `reduce_scatter_tensor`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import torch.distributed as dist

# Canonical axis names, the JAX package's.
DP_AXIS = "dp"
PP_AXIS = "pp"
TP_AXIS = "tp"
EP_AXIS = "ep"

# the mesh's order, outermost first
_AXES = (PP_AXIS, DP_AXIS, EP_AXIS, TP_AXIS)

# the order in which every rank creates the groups: the tp and dp groups
# first (the only ones before pipeline parallelism), then the rest; the
# sets holding "ep" only at ep > 1
_GROUP_ORDER = tuple(frozenset(s) for s in (
    (TP_AXIS,), (DP_AXIS,), (PP_AXIS,), (PP_AXIS, TP_AXIS),
    (DP_AXIS, TP_AXIS), (PP_AXIS, DP_AXIS), (PP_AXIS, DP_AXIS, TP_AXIS)))
_EP_GROUP_ORDER = tuple(frozenset(s) for s in (
    (EP_AXIS,), (DP_AXIS, EP_AXIS), (EP_AXIS, TP_AXIS), (PP_AXIS, EP_AXIS),
    (DP_AXIS, EP_AXIS, TP_AXIS), (PP_AXIS, DP_AXIS, EP_AXIS),
    (PP_AXIS, EP_AXIS, TP_AXIS), (PP_AXIS, DP_AXIS, EP_AXIS, TP_AXIS)))

_GLOBAL_STATE = None


@dataclasses.dataclass
class _MeshState:
    sizes: dict        # axis name -> size
    coords: dict       # axis name -> this rank's index along it
    groups: dict       # frozenset of axis names -> ProcessGroup or None
    world_size: int
    rank: int
    virtual_pipeline_model_parallel_size: Optional[int] = None
    # the "current chunk" cursor of host-driven pipeline code
    # (parallel_state.py:700-712)
    virtual_pipeline_model_parallel_rank: int = 0
    pipeline_model_parallel_split_rank: Optional[int] = None
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


def _runs(sizes, axes):
    """The rank lists of the groups spanning `axes`: one for each
    coordinate of the other axes, in the mesh's row-major order, its
    members in row-major order over `axes`."""
    strides = {TP_AXIS: 1, EP_AXIS: sizes[TP_AXIS],
               DP_AXIS: sizes[EP_AXIS] * sizes[TP_AXIS],
               PP_AXIS: sizes[DP_AXIS] * sizes[EP_AXIS] * sizes[TP_AXIS]}
    fixed = [a for a in _AXES if a not in axes]
    spans = [a for a in _AXES if a in axes]

    def offsets(names):
        return [sum(i * strides[a] for i, a in zip(idx, names))
                for idx in itertools.product(*(range(sizes[a])
                                               for a in names))]

    return [[b + o for o in offsets(spans)] for b in offsets(fixed)]


def initialize_model_parallel(
        tensor_model_parallel_size: int = 1,
        pipeline_model_parallel_size: int = 1,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        pipeline_model_parallel_split_rank: Optional[int] = None,
        expert_model_parallel_size: int = 1,
        use_fp8: bool = False):
    """Split the torch.distributed world into the (pp, dp[, ep], tp)
    groups (≡ the JAX package's `initialize_model_parallel`: dp = world
    // (tp·pp·ep)).  Sizes that do not divide the world raise, and so
    does a virtual pipeline below pp = 2, with the JAX package's
    messages.  Without torch.distributed the world is one rank and every
    group is None.  Returns the data-parallel group (`data_parallel_
    group()`: the dp group, or the combined (dp, ep) group at ep > 1)."""
    global _GLOBAL_STATE
    tp, pp = tensor_model_parallel_size, pipeline_model_parallel_size
    for what, n in (("tensor_model_parallel_size", tp),
                    ("pipeline_model_parallel_size", pp)):
        if n < 1:
            raise ValueError(f"{what} must be >= 1, got {n}")
    ep = expert_model_parallel_size
    if ep < 1:
        raise ValueError(f"expert_model_parallel_size must be >= 1, got {ep}")
    world_group = _world_group()
    world, rank = group_size(world_group), group_rank(world_group)
    if world % (tp * pp * ep):
        raise ValueError(f"world size {world} is not divisible by tp({tp}) "
                         f"x pp({pp}) x ep({ep})")
    if virtual_pipeline_model_parallel_size is not None and pp < 2:
        raise ValueError("virtual pipeline parallelism requires "
                         "pipeline_model_parallel_size >= 2")
    dp = world // (tp * pp * ep)
    sizes = {PP_AXIS: pp, DP_AXIS: dp, EP_AXIS: ep, TP_AXIS: tp}
    coords = {PP_AXIS: rank // (dp * ep * tp),
              DP_AXIS: (rank // (ep * tp)) % dp,
              EP_AXIS: (rank // tp) % ep, TP_AXIS: rank % tp}
    order = _GROUP_ORDER + (_EP_GROUP_ORDER if ep > 1 else ())
    groups = {axes: (None if world_group is None else
                     _new_groups(_runs(sizes, axes), rank, world))
              for axes in order}
    _GLOBAL_STATE = _MeshState(
        sizes=sizes, coords=coords, groups=groups, world_size=world,
        rank=rank,
        virtual_pipeline_model_parallel_size=(
            virtual_pipeline_model_parallel_size),
        pipeline_model_parallel_split_rank=pipeline_model_parallel_split_rank,
        use_fp8=use_fp8)
    return data_parallel_group()


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


def _size(axis):
    return _state().sizes[axis]


def _coord(axis):
    return _state().coords[axis]


def get_data_parallel_group():
    """The dp ProcessGroup (None for a world of one)."""
    return new_process_group(DP_AXIS)


def get_data_parallel_world_size() -> int:
    return _size(DP_AXIS)


def get_data_parallel_rank() -> int:
    """This process's dp rank, a host int (the JAX package's is the
    traced `axis_index`)."""
    return _coord(DP_AXIS)


def get_data_parallel_axis_names() -> tuple:
    """The axes a data batch (and its grad sync) spans: ("dp",), or
    ("dp", "ep") with expert parallelism, which rides inside the
    data-parallel world (each ep rank routes its own tokens; for every
    non-expert parameter ep is more data parallelism).  `group_of` takes
    the tuple."""
    if _size(EP_AXIS) > 1:
        return (DP_AXIS, EP_AXIS)
    return (DP_AXIS,)


def get_expert_model_parallel_world_size() -> int:
    return _size(EP_AXIS)


def get_expert_model_parallel_rank() -> int:
    """This process's ep rank, a host int (the JAX package's is the
    traced `axis_index`, valid only when the mesh has an ep axis)."""
    return _coord(EP_AXIS)


def get_tensor_model_parallel_group():
    """The tp ProcessGroup (None for a world of one)."""
    return new_process_group(TP_AXIS)


def get_tensor_model_parallel_world_size() -> int:
    return _size(TP_AXIS)


def get_tensor_model_parallel_rank() -> int:
    """This process's tp rank, a host int."""
    return _coord(TP_AXIS)


def get_pipeline_model_parallel_group():
    """The pp ProcessGroup (None for a world of one)."""
    return new_process_group(PP_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _size(PP_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    """This process's pipeline stage, a host int (the JAX package's is
    the traced `axis_index`)."""
    return _coord(PP_AXIS)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _state().virtual_pipeline_model_parallel_size


def get_virtual_pipeline_model_parallel_rank() -> int:
    return _state().virtual_pipeline_model_parallel_rank


def set_virtual_pipeline_model_parallel_rank(rank: int) -> None:
    _state().virtual_pipeline_model_parallel_rank = rank


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _state().pipeline_model_parallel_split_rank


def set_pipeline_model_parallel_split_rank(rank: Optional[int]) -> None:
    _state().pipeline_model_parallel_split_rank = rank


def _stage_of(stage: Optional[int]) -> int:
    return _coord(PP_AXIS) if stage is None else stage


def is_pipeline_first_stage(stage: Optional[int] = None) -> bool:
    """Whether `stage` (this rank's by default) is the first pipeline
    stage ≡ parallel_state.is_pipeline_first_stage (parallel_state.py:590)
    for the non-virtual case; virtual chunks are the schedule's."""
    return _stage_of(stage) == 0


def is_pipeline_last_stage(stage: Optional[int] = None) -> bool:
    return _stage_of(stage) == _size(PP_AXIS) - 1


def get_tensor_model_parallel_src_rank(device_rank: Optional[int] = None
                                       ) -> int:
    """First global rank of `device_rank`'s tp group (this process's by
    default) ≡ parallel_state.get_tensor_model_parallel_src_rank."""
    r = _state().rank if device_rank is None else device_rank
    tp = _size(TP_AXIS)
    return (r // tp) * tp


def get_data_parallel_src_rank(device_rank: Optional[int] = None) -> int:
    """First global rank of `device_rank`'s dp group (this process's by
    default): the same stage, ep and tp index at dp index 0 (the JAX
    package's coordinate form, right for any pipeline depth)."""
    r = _state().rank if device_rank is None else device_rank
    inner = _size(EP_AXIS) * _size(TP_AXIS)
    stage_size = _size(DP_AXIS) * inner
    return (r // stage_size) * stage_size + r % inner


def get_rank_info() -> str:
    """(dp, tp, pp[, ep]) info string for log prefixes ≡
    parallel_state.get_rank_info: this process's rank and the group
    sizes (ep only when above 1, as the JAX package writes it)."""
    if _GLOBAL_STATE is None:
        return f"proc{group_rank(_world_group())}"
    s = _GLOBAL_STATE
    ep = f"/ep{s.sizes[EP_AXIS]}" if s.sizes[EP_AXIS] > 1 else ""
    return (f"proc{s.rank} dp{s.sizes[DP_AXIS]}/tp{s.sizes[TP_AXIS]}"
            f"/pp{s.sizes[PP_AXIS]}{ep}")


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


def _axis_set(axes) -> frozenset:
    """`axes` (one name or an iterable of them) as a frozenset; unknown
    names raise with the JAX package's message."""
    if isinstance(axes, str):
        axes = (axes,)
    axes = frozenset(axes)
    unknown = sorted(axes - set(_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; have {sorted(_AXES)}")
    return axes


def new_process_group(axes):
    """The process group whose collectives run over the named mesh axes
    (one name or an iterable of them) ≡ parallel_state.new_process_group,
    which the JAX package reduces to a validated tuple of axis names:
    ("tp",) the tp group, ("pp", "tp") the model-parallel plane, ("dp",
    "tp") a stage's plane, ("dp", "ep") the data-parallel world of an
    expert-parallel model, all of them the world.  At ep = 1 "ep" names
    no group of its own (("dp", "ep") is the dp group).  None for a world
    of one (or no axes).  Unknown axes raise."""
    axes = _axis_set(axes)
    s = _state()
    if s.sizes[EP_AXIS] == 1:
        axes = axes - {EP_AXIS}
    return s.groups[axes] if axes else None


# --- pipeline stages ---------------------------------------------------------
#
# The reference builds dedicated process groups for the tied-embedding /
# position-embedding exchange (parallel_state.py:321-407).  As in the JAX
# package (apex_tpu/parallel/mesh.py:260-351) they are sets of pipeline
# stages here (every (dp, tp) coordinate participates alike); the pp
# group is what a sum across them runs over.

def _split() -> Optional[int]:
    return _state().pipeline_model_parallel_split_rank


def get_embedding_group_stages() -> list:
    """Pipeline stages that hold tied input/output embeddings.

    ≡ embedding_ranks construction (parallel_state.py:352-370): [first,
    last], with the encoder/decoder split stage inserted when set.
    """
    pp = _size(PP_AXIS)
    if pp == 1:
        return [0]
    stages = [0, pp - 1]
    sp = _split()
    if sp is not None and sp not in stages:
        stages = [0, sp, pp - 1]
    return stages


def get_position_embedding_group_stages() -> list:
    """≡ position_embedding_ranks (parallel_state.py:355,367-370)."""
    if _size(PP_AXIS) == 1:
        return [0]
    sp = _split()
    return [0] if sp in (None, 0) else [0, sp]


def get_encoder_relative_position_embedding_group_stages() -> list:
    """≡ encoder_relative_position_embedding_ranks (parallel_state.py:356-363)."""
    if _size(PP_AXIS) == 1:
        return [0]
    sp = _split()
    return [0] if sp is None else list(range(sp))


def get_decoder_relative_position_embedding_group_stages() -> list:
    """≡ decoder_relative_position_embedding_ranks (parallel_state.py:356-365)."""
    pp = _size(PP_AXIS)
    if pp == 1:
        return [0]
    sp = _split()
    return [0] if sp is None else list(range(sp, pp))


def is_rank_in_embedding_group(stage: Optional[int] = None) -> bool:
    """≡ parallel_state.is_rank_in_embedding_group for `stage` (this
    rank's by default)."""
    return _stage_of(stage) in get_embedding_group_stages()


def is_rank_in_position_embedding_group(stage: Optional[int] = None) -> bool:
    return _stage_of(stage) in get_position_embedding_group_stages()


def is_pipeline_stage_before_split(stage: Optional[int] = None) -> bool:
    """≡ parallel_state.is_pipeline_stage_before_split: True when the
    stage (this rank's by default) runs encoder layers (always True
    without an encoder/decoder split)."""
    sp = _split()
    return True if sp is None else _stage_of(stage) < sp


def is_pipeline_stage_after_split(stage: Optional[int] = None) -> bool:
    sp = _split()
    return True if sp is None else _stage_of(stage) >= sp


def is_pipeline_stage_at_split(stage: Optional[int] = None) -> bool:
    """True when `stage` runs the last encoder block and `stage+1` the first
    decoder block (≡ parallel_state.is_pipeline_stage_at_split)."""
    stage = _stage_of(stage)
    return (is_pipeline_stage_before_split(stage)
            and is_pipeline_stage_after_split(stage + 1))


def get_pipeline_model_parallel_next_rank(stage: Optional[int] = None
                                          ) -> int:
    """The next stage (of this rank's by default), wrapping: where a
    forward hop sends (parallel_state.py:737-752)."""
    return (_stage_of(stage) + 1) % _size(PP_AXIS)


def get_pipeline_model_parallel_prev_rank(stage: Optional[int] = None
                                          ) -> int:
    return (_stage_of(stage) - 1) % _size(PP_AXIS)


def get_pipeline_model_parallel_first_rank() -> int:
    return 0


def get_pipeline_model_parallel_last_rank() -> int:
    return _size(PP_AXIS) - 1


def get_pipeline_global_device_ranks(dp_index: Optional[int] = None,
                                     tp_index: Optional[int] = None) -> list:
    """Global ranks of one pipeline group (this rank's by default):
    stage·dp·ep·tp + dp_index·ep·tp + ep_index·tp + tp_index for each
    stage, ep_index this rank's (parallel_state.py:345-348)."""
    dp_index = _coord(DP_AXIS) if dp_index is None else dp_index
    tp_index = _coord(TP_AXIS) if tp_index is None else tp_index
    inner = _size(EP_AXIS) * _size(TP_AXIS)
    stride = _size(DP_AXIS) * inner
    base = dp_index * inner + _coord(EP_AXIS) * _size(TP_AXIS) + tp_index
    return [base + stage * stride for stage in range(_size(PP_AXIS))]


# --- the group a collective runs over ---------------------------------------

def data_parallel_group():
    """The group a data batch spans under `initialize_model_parallel`
    (the dp group, or the combined (dp, ep) group at ep > 1); else the
    torch.distributed world when it is initialized; else None (a world
    of one: every collective is the identity)."""
    if _GLOBAL_STATE is not None:
        return new_process_group(get_data_parallel_axis_names())
    return _world_group()


def group_of(axis_name):
    """The group a collective over `axis_name` runs over: one of the JAX
    package's axis names ("tp", "dp", "pp", "ep") or an iterable of them
    (("pp", "tp"): the model-parallel plane; ("dp", "ep"): the data
    world of an expert-parallel model), the mesh's group.  Without a
    mesh the tp, pp and ep groups are None (every rank holds the whole
    model, ep is 1) and the dp group, with or without "ep", is
    `data_parallel_group()`.  An axis the port has no group for
    raises."""
    names = (axis_name,) if isinstance(axis_name, str) else axis_name
    unknown = [a for a in names if a not in _AXES]
    if unknown:
        raise ValueError(f"no process group for axis {unknown[0]!r}; the "
                         f"port has {TP_AXIS!r}, {DP_AXIS!r}, {PP_AXIS!r} "
                         f"and {EP_AXIS!r}")
    axes = frozenset(names)
    if _GLOBAL_STATE is not None:
        return new_process_group(axes)
    return data_parallel_group() if axes - {EP_AXIS} == {DP_AXIS} else None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


# --- collectives ------------------------------------------------------------
#
# Every collective of the port goes through the wrappers below.  While
# the monitor observes them (`monitor.comms`' inventory recorder, or a
# `monitor.ProfileCapture` window that names each collective's range in
# the trace, or a linter's program record) `_OBSERVER` is its
# `issue(kind, operands, outputs, group, async_op, run, **info)`, which
# numbers the collective, runs `run()` and returns what it returns;
# otherwise it is None and a wrapper pays that one check.

_OBSERVER = None

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def set_collective_observer(observer):
    """Install `observer` (None: none) and return the one it replaces."""
    global _OBSERVER
    prev, _OBSERVER = _OBSERVER, observer
    return prev


def _issue(kind, operands, outputs, group, async_op, run, **info):
    """`run()` the collective, through the observer when one is set;
    `info` tells it more (`op`: an all-reduce's reduction, `pairs`: an
    exchange's (destination, source) ranks)."""
    if _OBSERVER is None:
        return run()
    return _OBSERVER.issue(kind, operands, outputs, group, async_op, run,
                           **info)


def _all_reduce(x, op, group, async_op):
    op = getattr(dist.ReduceOp, _OPS[op])
    if not x.is_contiguous() and not async_op:
        y = x.contiguous()
        dist.all_reduce(y, op=op, group=group)
        return x.copy_(y)
    work = dist.all_reduce(x, op=op, group=group, async_op=async_op)
    return work if async_op else x


def all_reduce(x, op: str = "sum", group=None, async_op: bool = False):
    """`x` reduced over `group` in place (op "sum", "max" or "min") and
    returned (with `async_op`, the work handle: wait on it before reading
    `x`, which must then be contiguous); the identity without a group.
    A strided `x` is reduced through a contiguous copy."""
    if group is None:
        return None if async_op else x
    return _issue("all-reduce", (x,), (x,), group, async_op,
                  lambda: _all_reduce(x, op, group, async_op), op=op)


def reduce_scatter(out, inp, group=None, async_op: bool = False):
    """`out` (len(inp) / world elements) := this rank's chunk of the sum
    of every rank's `inp` (≡ `lax.psum_scatter(tiled=True)`); a copy
    without a group.  Both contiguous."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor

    def run():
        work = fn(out, inp, group=group, async_op=async_op)
        return work if async_op else out

    return _issue("reduce-scatter", (inp,), (out,), group, async_op, run)


def all_gather(out, inp, group=None, async_op: bool = False):
    """`out` (len(inp) x world elements) := every rank's `inp` in rank
    order (≡ `lax.all_gather(tiled=True)`); a copy without a group.  Both
    contiguous."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor

    def run():
        work = fn(out, inp, group=group, async_op=async_op)
        return work if async_op else out

    return _issue("all-gather", (inp,), (out,), group, async_op, run)


def all_to_all(out, inp, group=None, async_op: bool = False):
    """`out` := chunk r of every rank's `inp`, in rank order, where r is
    this rank (the leading dimension cut into world equal chunks; ≡
    `all_to_all_single`); a copy without a group.  Both contiguous."""
    if group is None:
        out.copy_(inp)
        return None if async_op else out

    def run():
        work = dist.all_to_all_single(out, inp, group=group,
                                      async_op=async_op)
        return work if async_op else out

    return _issue("all-to-all", (inp,), (out,), group, async_op, run)


def broadcast(x, src: int = 0, group=None, async_op: bool = False):
    """`x` := global rank `src`'s `x` on every rank of `group`, in place
    and returned (with `async_op`, the work handle); the identity without
    a group.  As the JAX package's `broadcast_one_to_all`: every rank but
    `src` zeroes its `x` and the group sums, so the comms inventory sees
    one all-reduce (the JAX package's collective kinds have no
    broadcast) and `src`'s values come back exactly."""
    if group is None:
        return None if async_op else x
    if dist.get_rank() != src:
        x.zero_()
    return all_reduce(x, "sum", group, async_op)


def exchange(sends, group):
    """Point-to-point over `group`: `sends` is a list of (tensor, dst,
    recv buffer, src) with group ranks; every send and receive is issued
    in one batch (`batch_isend_irecv`).  Returns the work handles: wait
    on them before reading a receive buffer or writing a sent tensor."""
    def run():
        ops = []
        for t, dst, buf, src in sends:
            ops.append(dist.P2POp(dist.isend, t,
                                  dist.get_global_rank(group, dst), group))
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, src), group))
        return dist.batch_isend_irecv(ops)

    return _issue("collective-permute", tuple(s[0] for s in sends),
                  tuple(s[2] for s in sends), group, True, run,
                  pairs=tuple((s[1], s[3]) for s in sends))


# --- the mesh as the monitor names it ----------------------------------------

def mesh_axes():
    """(axis names, sizes) of the mesh in the JAX package's order:
    ("pp", "dp", "tp"), or ("pp", "dp", "ep", "tp") with expert
    parallelism; without `initialize_model_parallel`, the world as one
    ("dp",) axis (size 1 without torch.distributed)."""
    if _GLOBAL_STATE is None:
        return (DP_AXIS,), (group_size(_world_group()),)
    s = _GLOBAL_STATE
    names = tuple(a for a in _AXES if a != EP_AXIS or s.sizes[EP_AXIS] > 1)
    return names, tuple(s.sizes[a] for a in names)


def group_axes(group) -> Optional[tuple]:
    """The mesh axes a process group spans, in `mesh_axes` order: the
    axes whose coordinate varies over its members (() for a group of
    one rank); None when the group is not one of the mesh's (or there
    is no mesh and it is not the world)."""
    if group is None:
        return ()
    if _GLOBAL_STATE is None:
        if group is _world_group():
            return (DP_AXIS,) if group_size(group) > 1 else ()
        return None
    names, sizes = mesh_axes()
    coords = []
    for r in dist.get_process_group_ranks(group):
        c, rest = {}, r
        for a, n in zip(reversed(names), reversed(sizes)):
            c[a], rest = rest % n, rest // n
        if rest:            # a rank outside the mesh
            return None
        coords.append(c)
    return tuple(a for a in names if len({c[a] for c in coords}) > 1)
