"""`RecompileSentry` (counterpart of apex_tpu/monitor/compile/sentry.py).

In the JAX package a steady-state retrace is a silent recompile; the
sentry counts them.  Eager PyTorch has no jit cache, so what the sentry
guards here is the fixed-shape contract itself: a wrapped step whose
argument signature (structure + per-tensor shape/dtype/device; python
scalars by type and value) changes after `mark_steady()` is a
steady-state "recompile" — exactly the change that would recompile the
JAX step, or re-capture a CUDA graph of this one.  This is the JAX
sentry's signature path (every call fingerprinted, a new signature is
an event); it flattens tuples, NamedTuples, lists, dicts, dataclasses,
tensors and numpy arrays itself.

Pure host-side bookkeeping: the wrapped call is forwarded untouched.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

_MAX_EVENTS = 64


def _sig(x):
    """Hashable shape/dtype signature of one argument tree."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, np.ndarray):
        return ("A", x.shape, x.dtype.str)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_sig(v) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _sig(x[k])) for k in sorted(x, key=str)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, _sig(getattr(x, f.name)))
                      for f in dataclasses.fields(x)))
    return (type(x).__name__, repr(x))


def _sig_of(args, kwargs):
    return _sig((tuple(args), dict(kwargs)))


class RecompileSentry:
    """Wrap a step: `sentry = RecompileSentry(step); sentry(*args)`.

    name: label in warnings/events.  recorder: an optional
    `trace.FlightRecorder` — every compile event is also pushed into its
    event list (`note_compile_event`) so a crash dump tells the
    recompile story too.  warn: emit the one-time steady-state warning
    (disable in benchmarks that assert instead).
    """

    def __init__(self, step_fn: Callable, *, name: str = "train_step",
                 recorder=None, warn: bool = True):
        self._fn = step_fn
        self.name = name
        self.recorder = recorder
        self.warn = warn
        self.calls = 0
        self.n_compiles = 0
        self.steady_recompiles = 0
        self.events = []          # [{call, kind, steady_state, signature}]
        self._signatures = {}     # sig -> first-seen call index
        self._steady = False
        self._warned = False

    @property
    def wrapped(self):
        """The step underneath, for tools that run the step without the
        sentry's bookkeeping (`lint.lint_step` records `wrapped`, so a
        lint run neither counts as a call nor registers a signature)."""
        return self._fn

    def __call__(self, *args, **kwargs):
        sig = _sig_of(args, kwargs)
        out = self._fn(*args, **kwargs)
        self.calls += 1
        if sig not in self._signatures:
            self._signatures[sig] = self.calls
            self.n_compiles += 1
            text = repr(sig)
            event = {"call": self.calls,
                     "kind": ("compile" if self.n_compiles == 1
                              else "retrace"),
                     "steady_state": self._steady,
                     "signature": text if len(text) <= 512 else
                     text[:509] + "..."}
            if len(self.events) < _MAX_EVENTS:
                self.events.append(event)
            # a recorder stand-in with only `dump` (a watchdog's) takes
            # no events
            note = getattr(self.recorder, "note_compile_event", None)
            if note is not None:
                note(dict(event, name=self.name))
            if self._steady:
                self.steady_recompiles += 1
                if self.warn and not self._warned:
                    self._warned = True
                    warnings.warn(
                        f"RecompileSentry({self.name}): steady-state "
                        f"signature change at call {self.calls} — "
                        f"{event['signature']}; the fixed-shape contract "
                        "is broken", RuntimeWarning, stacklevel=2)
        return out

    def mark_steady(self) -> None:
        """End of warmup: new signatures were expected until now; from
        here every one is a steady-state recompile (warned + counted)."""
        self._steady = True

    @property
    def n_signatures(self) -> int:
        return len(self._signatures)

    def summary(self) -> dict:
        """Flat JSON-able snapshot."""
        return {"calls": self.calls, "n_compiles": self.n_compiles,
                "n_signatures": self.n_signatures,
                "steady_recompiles": self.steady_recompiles}
