"""Host-side metric sinks: where `MetricsLogger` records go (counterpart
of apex_tpu/monitor/sinks.py, whose code this module keeps as it is: it
touches no device).

  * JSONLSink   — one JSON object per step, append-only; the schema is
                  versioned (`logger.SCHEMA_VERSION`) and validated by
                  `logger.validate_records`
  * ConsoleSink — the reference's periodic "iteration … | loss … |
                  loss scale …" line (≡ Megatron/apex training_log)
  * SummaryWriterSink — wraps anything with the TensorBoard
                  `SummaryWriter.add_scalar(tag, value, step)` method

and `ScalarWriter` is a minimal `SummaryWriter`-compatible object
(implements `add_scalar`) that fans out to sinks — so `Timers.write`,
which expects a `SummaryWriter`, can target the monitor stack directly.
"""

from __future__ import annotations

import json
import math
import os
from typing import Callable, Optional


def sanitize_json_floats(obj):
    """Replace non-finite floats so the result serializes as VALID JSON
    (`json.dumps` defaults to allow_nan=True and emits bare `NaN` /
    `Infinity` tokens — not JSON; they break every schema-validating
    reader downstream, bench.py and the tests included).

    Dict values become `None` plus a `"<key>_nonfinite"` marker holding
    "nan" / "inf" / "-inf" (so the record stays self-describing);
    list/tuple elements become the marker string directly (a list slot
    cannot carry a sibling key).  Finite values pass through untouched;
    nested dicts/lists are handled recursively.
    """
    def marker(v):
        return "nan" if math.isnan(v) else ("inf" if v > 0 else "-inf")

    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(v, float) and not math.isfinite(v):
                out[k] = None
                out[f"{k}_nonfinite"] = marker(v)
            else:
                out[k] = sanitize_json_floats(v)
        return out
    if isinstance(obj, (list, tuple)):
        return [marker(v) if isinstance(v, float) and not math.isfinite(v)
                else sanitize_json_floats(v) for v in obj]
    return obj


class MetricSink:
    """One record per logged step.  `write(record)` with a flat
    str→scalar dict; `close()` flushes/releases resources."""

    def write(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class JSONLSink(MetricSink):
    """One JSON line per record; flushed per record so a killed run
    keeps every completed step.  Truncates by default — a fresh run's
    steps restart at 1, and appending onto an old trajectory would make
    the file fail the package's own monotonic-step validation.  Pass
    mode="a" when resuming a run whose step counter continues."""

    def __init__(self, path, mode: str = "w"):
        if mode not in ("w", "a"):
            raise ValueError(f"mode must be 'w' or 'a', got {mode!r}")
        self.path = os.fspath(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, mode)

    def write(self, record: dict) -> None:
        # allow_nan=False enforces the sanitizer's contract: a NaN/Inf
        # loss on an overflow step must serialize as null + a
        # "<key>_nonfinite" marker, never as a bare NaN token that
        # makes the whole line invalid JSON
        self._f.write(json.dumps(sanitize_json_floats(record),
                                 allow_nan=False) + "\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class ConsoleSink(MetricSink):
    """One human line per record ≡ the reference's training_log string.
    `print_fn` hooks a logger (e.g. `log_util` logger.info)."""

    _ORDER = ("step", "loss", "grad_norm", "loss_scale", "step_time_ms",
              "tokens_per_sec", "mfu")
    _FMT = {"loss": "{:.4f}", "grad_norm": "{:.3e}", "loss_scale": "{:g}",
            "step_time_ms": "{:.1f}", "tokens_per_sec": "{:,.0f}",
            "mfu": "{:.1%}"}

    def __init__(self, print_fn: Optional[Callable[[str], None]] = None):
        self.print_fn = print_fn or print

    def write(self, record: dict) -> None:
        parts = []
        for k in self._ORDER:
            if k in record and record[k] is not None:
                fmt = self._FMT.get(k, "{}")
                parts.append(f"{k} {fmt.format(record[k])}")
        if len(parts) <= 1:
            return  # step-only record (e.g. a ScalarWriter timer tag)
        self.print_fn(" | ".join(parts))


class SummaryWriterSink(MetricSink):
    """Forward every numeric field to a TensorBoard-style writer
    (anything with `add_scalar(tag, value, step)`); `prefix` namespaces
    the tags (`train/loss`, …)."""

    def __init__(self, writer, prefix: str = "train/"):
        if not hasattr(writer, "add_scalar"):
            raise TypeError(
                f"writer {type(writer).__name__} has no add_scalar; need "
                "a SummaryWriter-compatible object")
        self.writer = writer
        self.prefix = prefix
        self._auto_step = 0

    def write(self, record: dict) -> None:
        if "step" in record:
            step = int(record["step"])
            self._auto_step = step
        else:
            # no "step" field: tag with an internal monotonic step
            # instead of silently piling every record onto step 0
            self._auto_step += 1
            step = self._auto_step
        for k, v in record.items():
            # bool is an int subclass — without the explicit skip,
            # flag fields (overflowed_this_window, future overflow
            # markers) would land as 0/1 scalar curves
            if (k == "step" or isinstance(v, bool)
                    or not isinstance(v, (int, float))):
                continue
            self.writer.add_scalar(self.prefix + k, v, step)

    def close(self) -> None:
        if hasattr(self.writer, "flush"):
            self.writer.flush()


class ScalarWriter:
    """Minimal `SummaryWriter`-compatible adapter over sinks.

    Implements the one method this codebase's consumers use —
    `add_scalar(tag, value, step)` (`Timers.write` calls exactly this)
    — and emits each call as a one-field record `{"step": step, tag:
    value}` to every sink.  Lets timer traces land in the same JSONL
    stream as the step metrics.
    """

    def __init__(self, *sinks: MetricSink):
        self.sinks = list(sinks)

    def add_scalar(self, tag: str, value, step: int) -> None:
        rec = {"step": int(step), tag: float(value)}
        for s in self.sinks:
            s.write(rec)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        for s in self.sinks:
            s.close()
