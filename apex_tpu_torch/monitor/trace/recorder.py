"""`FlightRecorder` — the bounded ring of recent steps and the crash
dump (counterpart of apex_tpu/monitor/trace/recorder.py).

The device planes (MetricsState, TapState, gathered rank timings) are
computed in the step; the recorder holds the last N steps of them ON
THE DEVICE (a few hundred scalars a step) and fetches them only when a
report is dumped — recording a step never waits for the step just
launched (the straggler fold fetches only the PREVIOUS step's timing
matrix; see record()).  On an exception inside `guard()`, or an
explicit `dump()` from a SIGTERM handler, the ring is fetched and
written as ONE self-contained JSON report that `trace.report` renders
into the last-good → first-bad timeline.

Report schema (the JAX package's; validated by `report.validate_report`;
FLIGHT_RECORDER_VERSION moves on any field add/rename/re-semantics):

    {"flight_recorder_version": 2,
     "monitor_schema_version":  <logger.SCHEMA_VERSION>,
     "reason": "exception: ..." | "explicit" | ...,
     "oom": bool,                        # allocator death?
     "capacity": N, "tap_names": [...], "timing_fields": [...],
     "straggler": {...} | null,          # StragglerDetector.summary()
     "compile_report": {...} | null,     # last attached compile report
     "compile_events": [{...}],          # RecompileSentry events
     "memory": {card index: stats} | null,  # memory stats at dump time
     "serve": {...} | null,              # attach_serve telemetry_report
     "records": [{"step": int,
                  "metrics": {...} | null,   # flat MetricsLogger record
                  "taps": {...} | null,      # taps.taps_to_dict shape
                  "timings": {"per_rank": [[...], ...]} | null}]}

`guard()` classifies an allocator death (`compile.watermarks.is_oom`)
and dumps with `oom: true` plus a fresh per-card memory snapshot.  The
serving plane rides an additive key: `attach_serve(engine)` keeps a
reference to a `serve.DecodeEngine` (anything with `telemetry_report()`,
or a dict), resolved at dump time.  `compile.RecompileSentry(step,
recorder=...)` pushes its compile events through `note_compile_event`.

Non-finite floats (an overflow step's absmax is ±inf by construction)
are serialized through `sinks.sanitize_json_floats` — the report is
always parseable JSON.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
from typing import Optional, Sequence

import numpy as np

from apex_tpu_torch.monitor.sinks import sanitize_json_floats
from apex_tpu_torch.monitor.trace import taps as taps_lib
from apex_tpu_torch.monitor.trace.report import (  # noqa: F401
    FLIGHT_RECORDER_VERSION,
)
from apex_tpu_torch.monitor.trace.straggler import StragglerDetector

# compile events are rare (a healthy run has a handful at warmup);
# bound the list anyway — a pathological retrace-every-step run must
# not grow the crash artifact without bound
_MAX_COMPILE_EVENTS = 64


def _numpy(x):
    """A timing matrix (device or host tensor, numpy, nested lists) as a
    host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FlightRecorder:
    """Ring buffer of the last `capacity` steps' telemetry planes.

    path: where `dump()` writes the JSON report.  tap_names: ordered
    tap labels (usually `step.tap_names()` after the first call — pass
    later via `record(tap_names=...)` if unknown at construction).
    straggler: an optional StragglerDetector fed each step's gathered
    timings (its summary lands in the report).
    """

    def __init__(self, path, capacity: int = 64,
                 tap_names: Optional[Sequence[str]] = None,
                 timing_fields: Sequence[str] = taps_lib.TIMING_FIELDS,
                 straggler: Optional[StragglerDetector] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.path = os.fspath(path)
        self.capacity = capacity
        self.tap_names = list(tap_names) if tap_names is not None else None
        self.timing_fields = list(timing_fields)
        self.straggler = straggler
        self._ring = collections.deque(maxlen=capacity)
        # timing matrices awaiting the straggler fold (at most one —
        # see record(): the newest step's output may still be in
        # flight, so its device_get is deferred one call)
        self._pending_timings = collections.deque()
        # the compile & memory plane
        self._compile_report = None
        self._compile_events = collections.deque(
            maxlen=_MAX_COMPILE_EVENTS)
        # the serving plane: a live source, resolved at
        # dump time so the crash artifact carries the ledger tail AS
        # OF the crash, not as of attachment
        self._serve_source = None

    def __len__(self) -> int:
        return len(self._ring)

    def attach_compile_report(self, report) -> None:
        """Keep the latest compile audit (anything with `to_dict()`, or
        a dict) so a crash — an OOM especially — dumps WITH the memory
        budget that explains it."""
        if hasattr(report, "to_dict"):
            report = report.to_dict()
        self._compile_report = report

    def attach_serve(self, source) -> None:
        """Attach the serving observatory: `source` is a
        `serve.DecodeEngine` — anything with `telemetry_report()` —
        or an already-materialized dict.  The report gains a `serve`
        key holding the request-lifecycle ledger tail, gauges/peaks,
        and engine stats, resolved AT DUMP TIME (a crash dumps the
        requests that were actually in flight).  Additive-optional:
        no recorder version bump, old reports still validate."""
        self._serve_source = source

    def _serve_report(self):
        src = self._serve_source
        if src is None:
            return None
        try:
            if hasattr(src, "telemetry_report"):
                return src.telemetry_report()
            return dict(src)
        except Exception as e:  # pragma: no cover — a poisoned engine
            return {"fetch_error": repr(e)}  # must not cost the report

    def note_compile_event(self, event: dict) -> None:
        """Record one sentry compile event (bounded list; the
        `compile.RecompileSentry(step, recorder=...)` hookup calls
        this so retraces land in the crash artifact)."""
        self._compile_events.append(dict(event))

    def record(self, step: int, *, metrics: Optional[dict] = None,
               taps=None, timings=None,
               tap_names: Optional[Sequence[str]] = None) -> None:
        """Append one step.  metrics: the flat host record
        `MetricsLogger.log_step` returned (already fetched).  taps: the
        step's TapState (kept as DEVICE tensors until dump).  timings:
        the gathered (n_ranks, k) matrix (device or host).

        An attached StragglerDetector needs EVERY step in order (its
        consecutive-outlier counts cannot be reconstructed from the
        bounded ring at dump time), but fetching the newest step's
        output here would block on the step that was just dispatched.
        So the fold is deferred one call: step N's matrix is
        fetched when step N+1 is recorded — by then it is
        materialized and the fetch is free — and `report()` drains the
        last one."""
        if tap_names is not None and self.tap_names is None:
            self.tap_names = list(tap_names)
        if timings is not None and self.straggler is not None:
            self._pending_timings.append(timings)
            while len(self._pending_timings) > 1:
                self.straggler.update(_numpy(self._pending_timings.popleft()))
        self._ring.append(
            {"step": int(step), "metrics": metrics, "taps": taps,
             "timings": timings})

    def report(self, reason: str = "explicit", oom: bool = False) -> dict:
        """Materialize the report dict (fetches the ring)."""
        while self._pending_timings:  # the deferred straggler fold
            try:
                self.straggler.update(_numpy(self._pending_timings.popleft()))
            except Exception:  # a poisoned buffer must not cost the
                pass           # whole report
        records = []
        for entry in self._ring:
            rec = {"step": entry["step"], "metrics": entry["metrics"],
                   "taps": None, "timings": None}
            try:
                if entry["taps"] is not None:
                    rec["taps"] = taps_lib.taps_to_dict(
                        entry["taps"], self.tap_names or [])
                if entry["timings"] is not None:
                    t = _numpy(entry["timings"])
                    rec["timings"] = {
                        "per_rank": [[float(v) for v in row]
                                     for row in t]}
            except Exception as e:  # a poisoned device buffer must not
                rec["fetch_error"] = repr(e)  # cost us the whole report
            records.append(rec)
        from apex_tpu_torch.monitor import logger as logger_lib
        import apex_tpu_torch.monitor.compile.watermarks as wm
        try:
            # a fresh allocator snapshot at dump time (None on CPU);
            # on an OOM this is the "how full was the card" answer
            memory = wm.all_device_memory_stats()
        except Exception:  # pragma: no cover — never cost the report
            memory = None
        return {
            "flight_recorder_version": FLIGHT_RECORDER_VERSION,
            "monitor_schema_version": logger_lib.SCHEMA_VERSION,
            "reason": reason,
            "oom": bool(oom),
            "capacity": self.capacity,
            "tap_names": list(self.tap_names or []),
            "timing_fields": list(self.timing_fields),
            "straggler": (self.straggler.summary()
                          if self.straggler is not None else None),
            "compile_report": self._compile_report,
            "compile_events": list(self._compile_events),
            "memory": memory,
            "serve": self._serve_report(),
            "records": records,
        }

    def dump(self, reason: str = "explicit", oom: bool = False) -> dict:
        """Write the report to `self.path` (atomic: tmp + rename — a
        crash artifact that is itself truncated is worse than none) and
        return it."""
        rep = sanitize_json_floats(self.report(reason, oom=oom))
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rep, f, indent=1, allow_nan=False)
            f.write("\n")
        os.replace(tmp, self.path)
        return rep

    @contextlib.contextmanager
    def guard(self):
        """Wrap the training loop: any exception dumps the report
        (reason = the exception repr) and re-raises.  An allocator
        death (`compile.watermarks.is_oom`: `torch.OutOfMemoryError`,
        RESOURCE_EXHAUSTED, "out of memory") dumps with `oom: true` —
        together with the per-card memory snapshot the report already
        carries, the run dies with its memory state instead of a bare
        stack trace."""
        import apex_tpu_torch.monitor.compile.watermarks as wm
        try:
            yield self
        except BaseException as e:
            self.dump(reason=f"exception: {e!r}", oom=wm.is_oom(e))
            raise
