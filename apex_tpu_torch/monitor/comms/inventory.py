"""The collective inventory recorder: what replaces the JAX package's
optimized-HLO parser (apex_tpu/monitor/comms/hlo.py) in the port.

An eager step compiles no program to read, so the inventory is taken
where the collectives are issued: every collective of the port goes
through `parallel.mesh`'s wrappers (`all_reduce`, `reduce_scatter`,
`all_gather`, `all_to_all`, `exchange`), and while anything observes
them those call `_Observer.issue`, which

  * names the collective "<kind>.<n>" (the JAX spelling of its kind,
    n in issue order from the start of the step);
  * runs it inside `record_function(name)` while a `ProfileCapture`
    window is open (`annotating`), so its range in the trace carries
    the inventory's name and `timeline.crosscheck_comms` matches by
    exact name;
  * hands it to the innermost `InventoryRecorder` (`recording`), which
    keeps its kind, dtype, operand and output bytes, group, mesh axes,
    `async_op` and caller, and, for an async collective, the flops the
    step issued between the collective's issue and the first `wait()`
    on its work handle (the window the JAX package prices with the dot
    flops scheduled between a start and its done).

With nothing observing, `parallel.mesh._OBSERVER` is None and the
wrappers pay that one check.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.monitor.comms.hlo import hlo_dtype
from apex_tpu_torch.parallel import mesh as M

_SKIP = (os.path.abspath(M.__file__), os.path.abspath(__file__))


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _caller() -> str:
    """"<dir>/<file>.py:<line> <function>" of the first frame outside
    the wrappers and this module: where the step issued the
    collective (the JAX inventory's op_name)."""
    f = sys._getframe(1)
    while f is not None and os.path.abspath(f.f_code.co_filename) in _SKIP:
        f = f.f_back
    if f is None:
        return ""
    path = f.f_code.co_filename
    short = os.path.join(os.path.basename(os.path.dirname(path)),
                         os.path.basename(path))
    return f"{short}:{f.f_lineno} {f.f_code.co_name}"[:160]


class _TimedWork:
    """A work handle whose `wait()` closes its collective's window in the
    recorder (the first wait of any of its handles); everything else is
    the handle's own."""

    def __init__(self, work, recorder, entry):
        self._work, self._recorder, self._entry = work, recorder, entry

    def wait(self, *args, **kwargs):
        out = self._work.wait(*args, **kwargs)
        if self._entry["end_flops"] is None:
            self._entry["end_flops"] = self._recorder.flops_now()
            self._entry["end_ops"] = self._recorder.ops_now()
        return out

    def __getattr__(self, name):
        return getattr(self._work, name)


class InventoryRecorder:
    """The collectives one run of a step issues, in order (`entries`:
    one dict each).  `flops_now` / `ops_now` read the run's running
    matmul-flop and op counts (zero when none is given)."""

    def __init__(self, flops_now: Optional[Callable[[], float]] = None,
                 ops_now: Optional[Callable[[], int]] = None):
        self.entries: List[dict] = []
        self.flops_now = flops_now or (lambda: 0.0)
        self.ops_now = ops_now or (lambda: 0)

    def begin(self, name, kind, operands, outputs, group, async_op,
              **info):
        """Record one collective as it is issued and return its entry.
        `info` is the wrapper's (`op`, `pairs`); a subclass that sets
        ``entry["not_issued"]`` holds the collective back (the linter's,
        for an exchange that would hang)."""
        ranks = dist.get_process_group_ranks(group)
        n = len(ranks)
        world = dist.get_world_size()
        if kind == "collective-permute":
            # one hop a pair of ranks: the JAX inventory's group of a
            # permute is its source/target pair
            group_size, n_groups = (2 if n > 1 else 1), n * len(operands)
        else:
            group_size, n_groups = n, max(1, world // n)
        entry = {
            "name": name, "kind": kind,
            "dtype": hlo_dtype(operands[0].dtype) if operands else "?",
            "operand_bytes": _nbytes(operands),
            "output_bytes": _nbytes(outputs),
            "group_size": group_size, "n_groups": n_groups,
            "axes": M.group_axes(group),
            "backend": str(dist.get_backend(group)),
            "async_op": bool(async_op), "op_name": _caller(),
            "issue_flops": self.flops_now(), "issue_ops": self.ops_now(),
            "end_flops": None, "end_ops": None}
        self.entries.append(entry)
        return entry

    def end(self, entry, out):
        """The wrapper's result, its work handles wrapped so that their
        wait() closes the window."""
        if not entry["async_op"]:
            return out
        if isinstance(out, (list, tuple)):
            return type(out)(_TimedWork(w, self, entry) for w in out)
        return _TimedWork(out, self, entry)

    def close(self) -> None:
        """Windows never waited on run to the end of the run."""
        for e in self.entries:
            if e["end_flops"] is None:
                e["end_flops"] = self.flops_now()
                e["end_ops"] = self.ops_now()


class _Observer:
    """What the mesh wrappers call while a recorder or a capture window
    is active."""

    def __init__(self):
        self.recorders: List[InventoryRecorder] = []
        self.annotate = 0
        self.seq = 0

    def issue(self, kind, operands, outputs, group, async_op, run,
              **info):
        name = f"{kind}.{self.seq}"
        self.seq += 1
        rec = self.recorders[-1] if self.recorders else None
        entry = (rec.begin(name, kind, operands, outputs, group, async_op,
                           **info)
                 if rec is not None else None)
        if entry is not None and entry.get("not_issued"):
            out = []            # held back: no work handles to wait on
        elif self.annotate:
            with torch.profiler.record_function(name):
                out = run()
        else:
            out = run()
        return rec.end(entry, out) if entry is not None else out


_OBSERVER = _Observer()


def _install() -> None:
    active = _OBSERVER.recorders or _OBSERVER.annotate
    M.set_collective_observer(_OBSERVER if active else None)


def restart_names() -> None:
    """Number the next collective 0 (each step's names start over)."""
    _OBSERVER.seq = 0


@contextlib.contextmanager
def recording(recorder: InventoryRecorder):
    """Record every collective issued inside the block into `recorder`,
    numbered from 0."""
    _OBSERVER.recorders.append(recorder)
    restart_names()
    _install()
    try:
        yield recorder
    finally:
        _OBSERVER.recorders.remove(recorder)
        recorder.close()
        _install()


@contextlib.contextmanager
def annotating():
    """Name each collective's range in the profiler's trace inside the
    block."""
    _OBSERVER.annotate += 1
    _install()
    try:
        yield
    finally:
        _OBSERVER.annotate -= 1
        _install()
