"""The program record behind the program-level lint passes (counterpart
of apex_tpu/lint/engine.py).

The JAX package traces the step to a closed jaxpr and walks it.  An
eager PyTorch step has no such program: `torch.fx` / `torch.export`
cannot trace through the port's kernels, which are launched through
ctypes on `data_ptr`s and through Triton inside `autograd.Function`s.
So the program the passes read is the one the step RUNS, recorded from
one run of the step on clones of its arguments (`monitor.compile.
report.audit_run`, the run `analyze_step` audits; the caller's tensors
are never touched).  The `Record` holds, in issue order:

  * every ATen op the run dispatches, forward and backward (a
    `TorchDispatchMode`): its name, the dtypes and shapes of its
    inputs and outputs, which ops last wrote the storages it reads,
    which storages it writes, and the enclosing `record_function`
    path;
  * every collective, from the comms inventory's hook on
    `parallel.mesh`'s wrappers (`all_reduce`, `reduce_scatter`,
    `all_gather`, `all_to_all`, `exchange`): its kind, its reduction,
    its group and the mesh axes that group can stand for, and for an
    `exchange` its (destination, source) pairs;
  * every launch of the port's own kernels, which no dispatch mode
    sees: each launcher reports its kernel's name and operands through
    `ops._common.note_launch`, beside the flops it reports through
    `add_kernel_flops`.

A location reads ``program:<range path>:<op>[i]``, as the JAX
`eqn_location` spells it: the `record_function` ranges around the op
joined by "/", the op's name, and its ordinal among the ops of that
name at that path (so an unrelated op inserted elsewhere does not shift
it).

Loops.  A loop iteration shows in the record as a `record_function`
range named ``<loop>#<i>`` (`ops._common.loop_iteration(loop, i)`, i
counted from 0 in each run of the loop; the range is opened only while
a program is recorded): the pipeline schedule's clock loops open one a
clock (forward and backward), and the chunked overlap one a ring step
or a chunk.  The path drops the ``#<i>`` and ordinals restart in each
iteration, so the same op in every iteration has one location; CL203
compares an op across the iterations of one run of its loop.

A ``fp32_class:<name>`` range (`ops._common.fp32_class`, also opened
only while recording) marks GEMMs that are deliberately fp32 inside a
low-precision program (the static form of an entry on Apex's FP32 cast
list): DP101 does not flag them.  The serving prefill's dense attention,
the engine's fp32 LM-head fallback and the MoE router's gate products
run inside one.

`lint_step` is the high-level entry: it reads the builder-attached
metadata (`step.arg_names`, `step.donate_argnums`, `step.mesh_axis_
names`; `ddp.make_train_step` and `make_tp_dp_train_step` attach all
three), records the step (the step underneath a `RecompileSentry`:
`wrapped`), and returns the combined findings of the dtype-policy,
collective and donation passes.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from apex_tpu_torch.lint.findings import Finding
from apex_tpu_torch.monitor.comms.inventory import InventoryRecorder
from apex_tpu_torch.ops import _common
from apex_tpu_torch.parallel import mesh as M

# the collectives, by the name of the mesh wrapper that issues them (the
# names their ops carry in the record)
COLLECTIVES = {"all-reduce": "all_reduce", "all-gather": "all_gather",
               "reduce-scatter": "reduce_scatter",
               "all-to-all": "all_to_all",
               "collective-permute": "exchange"}
COLLECTIVE_PRIMS = frozenset(COLLECTIVES.values())

# low-precision float dtypes (by torch's name without "torch.")
LOW_PRECISION = frozenset({"bfloat16", "float16", "float8_e4m3fn",
                           "float8_e5m2"})

# op namespaces the record leaves out: the collectives' own dispatcher
# ops (the inventory hook records them with their group) and the
# profiler's range ops (they make the path)
_SKIP_NAMESPACES = ("c10d", "_c10d_functional", "profiler")

# ops that overwrite their `self` without reading it
_PURE_WRITES = frozenset({"copy_", "fill_", "zero_", "normal_",
                          "uniform_", "random_", "bernoulli_",
                          "exponential_", "set_"})

_ITER_SEP = "#"
_FP32_CLASS = "fp32_class:"


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def is_low_precision(name: Optional[str]) -> bool:
    return name in LOW_PRECISION


def is_float(name: Optional[str]) -> bool:
    return name is not None and (name.startswith("float")
                                 or name in LOW_PRECISION)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _storage_key(t: torch.Tensor):
    """(device type, index, storage address) of a tensor's storage; None
    for one with no storage (empty, or a tensor subclass without one)."""
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None
    p = s.data_ptr()
    if p == 0:
        return None
    return (t.device.type, t.device.index or 0, p)


def _covers(t: torch.Tensor) -> bool:
    """Whether writing `t` overwrites its whole storage."""
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return True
    return (t.storage_offset() == 0
            and t.numel() * t.element_size() >= s.nbytes())


def _geometry(t: torch.Tensor):
    return (t.storage_offset(), tuple(t.shape), tuple(t.stride()))


@dataclasses.dataclass
class Op:
    """One recorded op.  `reads[j]` are the indices of the ops that last
    wrote the storage of input j when it was read; `geometry[j]` its
    (offset, shape, stride) there.  `loops` are the enclosing loop
    iterations, outermost first: (loop id, iteration)."""

    index: int
    kind: str                 # "aten" | "collective" | "kernel"
    name: str
    path: str
    ordinal: int
    loops: Tuple[Tuple[int, int], ...]
    in_dtypes: Tuple[str, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[str, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    reads: Tuple[FrozenSet[int], ...]
    geometry: Tuple[tuple, ...]
    in_keys: Tuple[Any, ...]
    out_keys: Tuple[Any, ...]
    backward: bool = False
    # collectives
    axes: Optional[Tuple[FrozenSet[str], ...]] = None   # None: unbound
    reduce_op: Optional[str] = None
    group_rank: int = 0
    group_size: int = 1
    pairs: Tuple[Tuple[int, int], ...] = ()
    # conversions (`_to_copy`, or `copy_` across dtypes): source dtype
    convert_from: Optional[str] = None
    # a conversion autograd runs to hand a leaf parameter its gradient
    # in the parameter's own dtype and shape (`_param_grad_cast`)
    param_grad_cast: bool = False

    def location(self, program: str) -> str:
        return f"{program}:{self.path}:{self.name}[{self.ordinal}]"

    @property
    def fp32_class(self) -> bool:
        return any(part.startswith(_FP32_CLASS)
                   for part in self.path.split("/"))


def group_axis_sets(group) -> Optional[Tuple[FrozenSet[str], ...]]:
    """The mesh axis sets a process group can stand for: every axis set
    whose mesh group it is (on a one-rank world every group is the world,
    so it stands for all of them).  Without a mesh the world is the dp
    group.  None: the group is not one of the mesh's (unbound)."""
    state = M._GLOBAL_STATE
    if state is None:
        if group is not None and group is M._world_group():
            return (frozenset({M.DP_AXIS}),)
        return None
    sets = tuple(axes for axes, g in state.groups.items()
                 if g is group and g is not None)
    return sets or None


class Record:
    """One recorded run (module docstring).  `ops` in issue order;
    `final`: the ops whose writes are live when the step returns (the
    last writers of the storages of its outputs and of its arguments,
    which the step updates in place); `readers[i]`: how many later op
    inputs read op i's writes."""

    def __init__(self):
        self.ops: List[Op] = []
        self.final: FrozenSet[int] = frozenset()
        self.readers: Dict[int, int] = {}
        self._pending: Dict[Any, set] = {}
        self._stack: List[Tuple[str, Optional[tuple]]] = []
        self._loops: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self._loop_ids = 0
        self._ordinals: Dict[tuple, Dict[str, int]] = {}
        self.loop_starts: Dict[int, int] = {}
        # > 0 while a collective's backend runs: its ops are not recorded
        self.quiet = 0

    # ---- the range stack -------------------------------------------------

    def _path_and_loops(self):
        parts, loops = [], []
        for name, loop in self._stack:
            parts.append(name)
            if loop is not None:
                loops.append(loop)
        return "/".join(parts), tuple(loops)

    def enter_range(self, name: str) -> None:
        loop = None
        base, sep, it = name.rpartition(_ITER_SEP)
        if sep and it.isdigit():
            i = int(it)
            key = (self._path_and_loops()[0], base)
            cur = self._loops.get(key)
            if cur is None or i <= cur[1]:      # a new run of the loop
                self._loop_ids += 1
                cur = (self._loop_ids, i)
                self.loop_starts[cur[0]] = len(self.ops)
            self._loops[key] = (cur[0], i)
            loop, name = (cur[0], i), base
        self._stack.append((name, loop))

    def exit_range(self) -> None:
        """Ranges are context managers, so they close innermost first
        (the handle a range's exit receives is a fresh Python object,
        which cannot name the range)."""
        if self._stack:
            self._stack.pop()

    # ---- ops --------------------------------------------------------------

    def add(self, kind: str, name: str, inputs: Sequence[torch.Tensor],
            written: Sequence[torch.Tensor], outputs: Sequence[torch.Tensor],
            read_mask: Optional[Sequence[bool]] = None, **extra) -> Op:
        path, loops = self._path_and_loops()
        counts = self._ordinals.setdefault((path, loops), {})
        ordinal = counts.get(name, 0)
        counts[name] = ordinal + 1
        idx = len(self.ops)
        reads, geom, in_keys = [], [], []
        read_mask = read_mask or [True] * len(inputs)
        for t, r in zip(inputs, read_mask):
            key = _storage_key(t)
            in_keys.append(key)
            geom.append(_geometry(t))
            w = frozenset(self._pending.get(key, ())) if r else frozenset()
            reads.append(w)
            for j in w:
                self.readers[j] = self.readers.get(j, 0) + 1
        out_keys = []
        for t in written:
            key = _storage_key(t)
            out_keys.append(key)
            if key is None:
                continue
            if _covers(t):
                self._pending[key] = {idx}
            else:
                self._pending.setdefault(key, set()).add(idx)
        op = Op(index=idx, kind=kind, name=name, path=path, ordinal=ordinal,
                loops=loops,
                in_dtypes=tuple(dtype_name(t.dtype) for t in inputs),
                in_shapes=tuple(tuple(t.shape) for t in inputs),
                out_dtypes=tuple(dtype_name(t.dtype) for t in outputs),
                out_shapes=tuple(tuple(t.shape) for t in outputs),
                reads=tuple(reads), geometry=tuple(geom),
                in_keys=tuple(in_keys), out_keys=tuple(out_keys),
                backward=_common._in_backward(), **extra)
        self.ops.append(op)
        return op

    def finish(self, outputs, args) -> None:
        """The ops live at the end: last writers of the storages the
        step's outputs and arguments hold."""
        live = set()
        leaves, _ = tree_flatten((outputs, args))
        for t in leaves:
            if isinstance(t, torch.Tensor):
                live |= self._pending.get(_storage_key(t), set())
        self.final = frozenset(live)

    # ---- queries the passes share ----------------------------------------

    def used(self, i: int) -> bool:
        return bool(self.readers.get(i)) or i in self.final

    def collectives(self):
        return [op for op in self.ops if op.kind == "collective"]

    def counts(self) -> Dict[str, int]:
        """{"ops", "collectives", "kernel_launches"} and the launches by
        kernel name (`kernels`)."""
        kernels: Dict[str, int] = {}
        for op in self.ops:
            if op.kind == "kernel":
                kernels[op.name] = kernels.get(op.name, 0) + 1
        return {"ops": sum(op.kind == "aten" for op in self.ops),
                "collectives": sum(op.kind == "collective"
                                   for op in self.ops),
                "kernel_launches": sum(kernels.values()),
                "kernels": kernels}


class _Mode(TorchDispatchMode):
    """Records every dispatched ATen op into `record`."""

    def __init__(self, record: Record):
        super().__init__()
        self.record = record

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "profiler":
            name = func.overloadpacket.__name__
            if name.startswith("_record_function_enter"):
                self.record.enter_range(str(args[0]))
            elif name.startswith("_record_function_exit"):
                self.record.exit_range()
        out = func(*args, **kwargs)
        if ns in _SKIP_NAMESPACES or self.record.quiet:
            return out
        name = (func.overloadpacket.__name__ if ns == "aten"
                else f"{ns}.{func.overloadpacket.__name__}")
        schema = func._schema
        flat_in, read_mask, written = [], [], []
        pure = name in _PURE_WRITES
        named = list(zip(schema.arguments, args)) + [
            (a, kwargs[a.name]) for a in schema.arguments
            if a.name in kwargs]
        for arg, val in named:
            tensors = [v for v in (val if isinstance(val, (list, tuple))
                                   else (val,))
                       if isinstance(v, torch.Tensor)]
            writes = bool(arg.alias_info is not None
                          and arg.alias_info.is_write)
            for t in tensors:
                if writes:
                    written.append(t)
                    if pure or (arg.kwarg_only and arg.name == "out"):
                        continue
                flat_in.append(t)
                read_mask.append(True)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        in_keys = {_storage_key(t) for t in flat_in} | {
            _storage_key(t) for t in written}
        fresh = [t for t in outs if _storage_key(t) not in in_keys]
        if outs and not written and not fresh:
            # a view: it moves no data, so it reads nothing
            read_mask = [False] * len(flat_in)
        extra = {}
        src = None
        if name == "_to_copy" and flat_in:
            src = flat_in[0]
        elif name == "copy_" and len(flat_in) >= 1 and written:
            src = flat_in[0]
        if src is not None:
            dst = outs[0] if outs else written[0]
            if src.dtype != dst.dtype:
                extra["convert_from"] = dtype_name(src.dtype)
                extra["param_grad_cast"] = _param_grad_cast(dst)
        self.record.add("aten", name, flat_in, written + fresh,
                        outs or written, read_mask, **extra)
        return out


def _param_grad_cast(out: torch.Tensor) -> bool:
    """True when the backward node running now hands its gradient to a
    leaf parameter (an `AccumulateGrad` edge) of `out`'s dtype and
    shape: the conversion is autograd returning that parameter's
    gradient in the parameter's dtype, which it does by contract."""
    node = torch._C._current_autograd_node()
    if node is None:
        return False
    for fn, _ in node.next_functions:
        leaf = getattr(fn, "variable", None)
        if (leaf is not None and leaf.dtype == out.dtype
                and leaf.shape == out.shape):
            return True
    return False


class _Quiet:
    """A collective's work handle whose `wait()` records nothing: what
    a backend runs to finish a collective is the collective's, not the
    program's."""

    def __init__(self, work, record):
        self._work, self._record = work, record

    def wait(self, *args, **kwargs):
        self._record.quiet += 1
        try:
            return self._work.wait(*args, **kwargs)
        finally:
            self._record.quiet -= 1

    def __getattr__(self, name):
        return getattr(self._work, name)


class _Collectives(InventoryRecorder):
    """The comms inventory's recorder, which also puts each collective
    into the record.  The ops a backend dispatches to carry a collective
    out (gloo's reduce-scatter is an all-reduce and a copy) are not
    recorded.  An `exchange` whose pairs are not one permutation of its
    group is not issued (a linter must not hang the step it reads): its
    receive buffers stay as they were."""

    def __init__(self, record: Record, **kw):
        super().__init__(**kw)
        self.record = record

    def end(self, entry, out):
        self.record.quiet -= 1
        out = super().end(entry, out)
        if not entry["async_op"]:
            return out
        if isinstance(out, (list, tuple)):
            return type(out)(_Quiet(w, self.record) for w in out)
        return _Quiet(out, self.record)

    def begin(self, name, kind, operands, outputs, group, async_op,
              **info):
        entry = super().begin(name, kind, operands, outputs, group,
                              async_op)
        pairs = tuple(info.get("pairs") or ())
        n, r = M.group_size(group), M.group_rank(group)
        self.record.add(
            "collective", COLLECTIVES.get(kind, kind), list(operands),
            list(outputs), list(outputs), axes=group_axis_sets(group),
            reduce_op=info.get("op"), group_rank=r, group_size=n,
            pairs=pairs)
        if pairs and not exchange_is_permutation(pairs, r, n):
            entry["not_issued"] = True
        self.record.quiet += 1          # until end(): the backend's ops
        return entry


def exchange_is_permutation(pairs, rank: int, n: int) -> bool:
    """Whether an exchange's (destination, source) pairs, seen from
    `rank` of an `n`-rank group, are one permutation of the group: both
    in range, and the send's shift the receive's (the cyclic shift every
    rank of a ring applies)."""
    for dst, src in pairs:
        if not (0 <= dst < n and 0 <= src < n):
            return False
        if (dst - rank) % n != (rank - src) % n:
            return False
    return True


class Recorder:
    """Records one run into `record` (`audit_run(..., record=)`): the
    dispatch mode, the kernel launch hook and the collective recorder."""

    def __init__(self):
        self.record = Record()

    def inventory(self, **kw) -> InventoryRecorder:
        """The comms inventory recorder this run uses (it also feeds the
        record)."""
        return _Collectives(self.record, **kw)

    @contextlib.contextmanager
    def recording(self):
        def launch(name, tensors):
            self.record.add("kernel", name, list(tensors), [], [])

        with _common.kernel_launch_log(launch), _Mode(self.record):
            yield self.record


# ------------------------------ config ------------------------------

@dataclasses.dataclass
class LintConfig:
    """Pass thresholds (the JAX package's).  Defaults are deliberately
    permissive: the linter gates on violations a reviewer would flag,
    not on style."""

    # declared policy compute dtype ("bfloat16"/"float16"/None = infer
    # from the GEMM population: >= 50% low-precision GEMMs => low region)
    compute_dtype: Optional[str] = None
    # mesh axes the program may legally reduce over (None = the step's
    # `mesh_axis_names`, or any mesh group)
    expected_axes: Optional[Sequence[str]] = None
    # DP103: reductions of at least this many summed elements must not
    # accumulate in a low-precision dtype
    reduction_threshold: int = 1 << 16
    # DP102: round trips on tensors below this size are exempt
    min_roundtrip_elems: int = 4096
    # DP104: outputs at least this large are treated as state buffers
    large_output_elems: int = 1 << 14
    # DN301: state args below this many bytes are too small to matter
    state_bytes_floor: int = 1 << 16


# ------------------------------ entry points ------------------------------

def record_program(fn, args) -> Record:
    """Run `fn(*args)` once on clones of `args` and return its record
    (the caller's tensors and RNG states are left as they were)."""
    from apex_tpu_torch.monitor.compile.report import audit_run

    return audit_run(fn, args, record=Recorder()).record


def trace_jaxpr(fn, args) -> Record:
    """The JAX package's entry for the program the passes read; here the
    record of one run of `fn(*args)` (`record_program`)."""
    return record_program(fn, args)


def collect_views(record: Record) -> Dict[str, List[Op]]:
    """The JAX package's per-sub-program views; here the record's ops by
    their range path, each list in issue order."""
    views: Dict[str, List[Op]] = {}
    for op in record.ops:
        views.setdefault(op.path, []).append(op)
    return views


def lint_program(fn=None, args=(), *, record: Optional[Record] = None,
                 program: str = "program",
                 config: Optional[LintConfig] = None) -> List[Finding]:
    """Run the program passes (dtype-policy + collectives) over one run
    of `fn(*args)` (or a recorded `record=`) and return the findings."""
    from apex_tpu_torch.lint import collectives as _cl
    from apex_tpu_torch.lint import dtype_policy as _dp

    cfg = config or LintConfig()
    if record is None:
        if fn is None:
            raise TypeError("lint_program needs fn+args or record=")
        record = record_program(fn, args)
    findings: List[Finding] = []
    findings += _dp.run(record, program=program, config=cfg)
    findings += _cl.run(record, program=program, config=cfg)
    return _dedupe(findings)


def lint_step(step, args, *, program: str = "step",
              config: Optional[LintConfig] = None,
              arg_names: Optional[Sequence[str]] = None,
              donate_argnums: Optional[Sequence[int]] = None,
              compile_report=None,
              record: Optional[Record] = None) -> List[Finding]:
    """Lint a built train step: the program passes over one recorded run
    of the step (underneath a `RecompileSentry`: its `wrapped`, so the
    lint run neither counts as a call nor registers a signature), plus
    the donation pass over the builder metadata (`step.arg_names` /
    `step.donate_argnums`) and, when a `CompileReport` (or its dict) is
    given, the static-vs-runtime donation cross-check.  `record`: a run
    already recorded (`analyze_step(lint=True)` passes its own)."""
    from apex_tpu_torch.lint import donation as _dn

    cfg = config or LintConfig()
    if cfg.expected_axes is None:
        mesh_axes = getattr(step, "mesh_axis_names", None)
        if mesh_axes:
            cfg = dataclasses.replace(
                cfg, expected_axes=tuple(str(a) for a in mesh_axes))
    if record is None:
        record = record_program(getattr(step, "wrapped", step), args)
    findings = lint_program(record=record, program=program, config=cfg)
    findings += _dn.run(
        step, args, program=program, config=cfg,
        arg_names=arg_names, donate_argnums=donate_argnums,
        compile_report=compile_report)
    return findings


def _dedupe(findings: List[Finding]) -> List[Finding]:
    """One finding a (rule, location): an op in a loop has one location
    in every iteration."""
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.location)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out
