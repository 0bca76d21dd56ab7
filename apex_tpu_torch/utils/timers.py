"""Phase timers (counterpart of apex_tpu/utils/timers.py).

A timer reads the host's clock.  `start` / `stop` open and close a
`torch.profiler.record_function` range under the timer's name, so a
`monitor.ProfileCapture` trace and the timeline observatory see each
timed phase, as the JAX package's `TraceAnnotation` ranges are seen.
`stop(block=True)` waits for the card (`torch.cuda.synchronize()`)
before reading the clock: CUDA launches return before the device
finishes, so without it a timer measures the launches, not the work.
"""

from __future__ import annotations

import time

import torch


class _Timer:
    """start / stop / elapsed / reset of one named timer."""

    def __init__(self, name):
        self.name_ = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = time.perf_counter()
        self._range = None

    def start(self):
        assert not self.started_, "timer has already been started"
        self._range = torch.profiler.record_function(self.name_)
        self._range.__enter__()
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, block: bool = False):
        """block=True waits for every stream of the card before reading
        the clock (a no-op while this process has not touched CUDA)."""
        assert self.started_, "timer is not started"
        if block and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.elapsed_ += time.perf_counter() - self.start_time
        self.started_ = False
        self._range.__exit__(None, None, None)
        self._range = None

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset=True):
        started = self.started_
        if started:
            self.stop()
        e = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return e


class Timers:
    """A registry of named timers, with `write` and `log`."""

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def _get(self, name):
        try:
            return self.timers[name]
        except KeyError:
            raise KeyError(
                f"unknown timer {name!r}; registered timers: "
                f"{sorted(self.timers) or '(none)'}") from None

    def write(self, names, writer, iteration, normalizer=1.0, reset=False):
        """Emit `<name>-time` scalars to a SummaryWriter-compatible
        `writer` (anything with add_scalar: a TensorBoard writer, or
        `monitor.MetricsLogger.writer` to land timer scalars in the
        metrics JSONL stream)."""
        for name in names:
            value = self._get(name).elapsed(reset=reset) / normalizer
            writer.add_scalar(name + "-time", value, iteration)

    def log(self, names=None, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        names = names or list(self.timers)
        string = "time (ms)"
        for name in names:
            t = self._get(name).elapsed(reset=reset) * 1000.0 / normalizer
            string += f" | {name}: {t:.2f}"
        return string
