"""Profiler capture scoped to a step window (counterpart of
apex_tpu/monitor/profiler.py, over `torch.profiler`).

`profile_capture(range(10, 13))` arms a `torch.profiler.profile` that
starts when the first step of the window begins and stops after its
last step: the usual "skip the warm-up, grab 3 steady-state steps"
workflow, without start/stop calls in the training loop:

    cap = monitor.profile_capture(range(3, 6), device="cuda")
    for i in range(steps):
        with cap.step(i):
            state, ... = train_step(...)
    cap.close()   # safety net if the loop exits early
    report = monitor.analyze_trace(cap.trace_path())

The profiler records the host (CPU) and, on a GPU, the device (CUDA);
a card whose profiler cannot record CUDA activity raises, never a
capture that silently holds the host only.  On a card the recording
starts with `SETTLE_LAUNCHES` tiny launches ahead of the window, which
take the place of the device events a trace can lack at its start.  Each captured step runs
inside `record_function("<annotation>#<i>")`, so the trace carries its
step number (the parser reads Kineto's own "ProfilerStep#<i>" alike),
and ends with a device synchronize, so that its device work lies inside
its own window (the capture's cost: the steps it holds are not
overlapped with their successors).  While the window is open the
collective wrappers of `parallel.mesh` name each collective's range
"<kind>.<n>" (n from 0 each step), the comms inventory's names.  When
the window closes, the trace is written with `export_chrome_trace` to
`<logdir>/<host>.<stamp>.trace.json.gz`, which `trace_path()` returns.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import time
from typing import Iterable, Optional

import torch

from apex_tpu_torch.ops._common import resolve_device


# the tiny launches a card's recording starts with, ahead of the window
SETTLE_LAUNCHES = 512


def _default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "apex_tpu_torch_trace")


class ProfileStepReentryError(RuntimeError):
    """`ProfileCapture.step(i)` was entered while a previous `step()`
    context was still open.  Nested step scopes would nest the step
    annotations and make every "step" in the trace the hull of its
    children: the capture contract is one scope per training step,
    entered sequentially."""


class ProfileCapture:
    def __init__(self, step_range: Iterable[int], *,
                 logdir: Optional[str] = None,
                 annotation: str = "train-step",
                 device=None):
        steps = sorted(set(int(s) for s in step_range))
        # one capture = ONE contiguous trace window [first, last]; a
        # gapped range would silently capture its hull, so it is refused
        # (two windows = two ProfileCapture objects)
        if steps and steps[-1] - steps[0] != len(steps) - 1:
            raise ValueError(
                f"profile step_range must be contiguous, got {steps}; "
                "a capture arms a single [first, last] trace window — "
                "use one ProfileCapture per window")
        self._first = steps[0] if steps else None
        self._last = steps[-1] if steps else None
        self.logdir = logdir or _default_logdir()
        self.annotation = annotation
        self.device = resolve_device(device)
        self._active = False
        self._step_depth = 0    # open step() scopes (re-entry guard)
        self._fired = False     # did a trace window ever open?
        # the window's torch.profiler.profile (its key_averages() stay
        # readable after the window closed)
        self.profiler = None
        self._names = None      # the collective-naming scope
        self._path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._active

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError(
                    "ProfileCapture on a GPU: this torch build's profiler "
                    "cannot record CUDA activity")
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _start(self) -> None:
        from apex_tpu_torch.monitor.comms import inventory

        self.profiler = torch.profiler.profile(
            activities=self._activities())
        self.profiler.start()
        if self.device.type == "cuda":
            # late in a long process a card's trace lacked its first few
            # dozen device events (a pause did not help, launches did): a
            # burst of tiny launches takes their place, ahead of the window
            x = torch.zeros(1, device=self.device)
            for _ in range(SETTLE_LAUNCHES):
                x.add_(1)
            torch.cuda.synchronize(self.device)
        self._names = inventory.annotating()
        self._names.__enter__()
        self._active = True
        self._fired = True

    @contextlib.contextmanager
    def step(self, i: int):
        """Wrap one training step; starts / stops the trace at the window
        edges and annotates the step body."""
        if self._step_depth > 0 and self._active:
            # re-entering while the window is OPEN: a NAMED error, since
            # the alternative is a trace whose "steps" are hulls of their
            # children; outside a window the nesting is inert
            raise ProfileStepReentryError(
                f"ProfileCapture.step({i}) entered while a previous "
                "step scope's trace window is still open — one scope "
                "per training step, sequentially")
        # only a TOP-LEVEL step entry may arm the trace
        if (self._step_depth == 0
                and not self._active and not self._fired
                and self._first is not None
                and self._first <= i <= self._last):
            self._start()
        if self._active:
            from apex_tpu_torch.monitor.comms import inventory

            inventory.restart_names()
            ann = torch.profiler.record_function(f"{self.annotation}#{i}")
        else:
            ann = contextlib.nullcontext()
        self._step_depth += 1
        try:
            with ann:
                yield self
                if self._active and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        finally:
            self._step_depth -= 1
            if self._active and i >= self._last \
                    and self._step_depth == 0:
                self.close()

    def close(self) -> None:
        """Stop the trace if armed and write it (idempotent)."""
        if not self._active:
            return
        self._active = False
        self._names.__exit__(None, None, None)
        self.profiler.stop()
        os.makedirs(self.logdir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S") + f"_{os.getpid()}"
        path = os.path.join(self.logdir,
                            f"{socket.gethostname()}.{stamp}.trace.json.gz")
        self.profiler.export_chrome_trace(path)
        self._path = path

    def trace_path(self) -> Optional[str]:
        """Path of the trace the capture wrote (what
        `monitor.timeline.analyze_trace` consumes); None until a window
        fired and closed."""
        if not self._fired:
            return None
        return self._path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def profile_capture(step_range: Iterable[int], *,
                    logdir: Optional[str] = None,
                    annotation: str = "train-step",
                    device=None) -> ProfileCapture:
    """Build a `ProfileCapture` for the given step window (see the
    module docstring for the loop idiom)."""
    return ProfileCapture(step_range, logdir=logdir, annotation=annotation,
                          device=device)
