"""Chrome trace-event parsing for the runtime timeline observatory
(counterpart of apex_tpu/monitor/timeline/events.py).

`torch.profiler` (and therefore `monitor.ProfileCapture`) writes a
Chrome trace-event JSON through Kineto (`export_chrome_trace`).  This
module parses it into typed events with the JAX package's contracts:
a truncated gzip, bad JSON or a JSON value that is not a trace raises
the named `TraceParseError`, and a malformed row costs only that row.

The format (one JSON object, `traceEvents` list), as a card writes it:

  * `"ph": "M"` metadata events name processes and threads.  Kineto
    names every process after the program ("python3") and labels it
    in a `process_labels` row: "CPU" for the host process, "GPU <n>"
    for device n, whose pid is n; a device's threads are its streams
    ("stream 7").  The JAX package's traces name device processes
    `/device:TPU:0` instead; both forms are read.
  * `"ph": "X"` complete events carry `ts`/`dur` in MICROSECONDS and a
    category `cat`:
      - `kernel`, `gpu_memcpy`, `gpu_memset`: the device's work, on the
        device pid and a stream tid (`DEVICE_CATEGORIES`);
      - `gpu_user_annotation`: mirrors of host ranges on the stream
        lanes (each kernel under its innermost host range); never work;
      - `cuda_runtime`, `cuda_driver`, `cpu_op`, `user_annotation`,
        `python_function`: host work.  A launch (`cuda_runtime` /
        `cuda_driver`) and the device event it launched share
        `args.correlation`.
    The JAX package's traces carry no category and mark device ops
    with `args.hlo_op` and step marks with `args.step_num`.

Two JAX fields are derived for the port's traces:

  * `hlo_op` (the JAX package's optimized-HLO instruction name) is the
    name of the collective a device event belongs to: the innermost
    host `user_annotation` named like an inventory entry
    ("<kind>.<n>", e.g. "all-gather.3", which the port's collective
    wrappers open while a capture is active) around the launch that
    shares the event's correlation id.  "" elsewhere.
  * `step_num` is read from a step mark's name, "<annotation>#<i>"
    (what `ProfileCapture` opens) or Kineto's own "ProfilerStep#<i>",
    so both give the same step number.

Anything else (flow events `s`/`f`, instants, counters) is ignored.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.monitor.comms.hlo import COLLECTIVE_KINDS

# the categories of the device's own work in a Kineto trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host ranges the annotations and step marks are read from
_RANGE_CATEGORIES = ("user_annotation", "gpu_user_annotation")
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

# "<annotation>#<i>" / "ProfilerStep#<i>"
_STEP_NAME = re.compile(r"^(.*)#(\d+)$")
# an inventory entry's name, "<kind>.<n>"
COLLECTIVE_NAME = re.compile(
    r"^(" + "|".join(re.escape(k) for k in COLLECTIVE_KINDS) + r")\.\d+$")


class TraceParseError(ValueError):
    """A profiler trace that cannot be parsed: a truncated or corrupt
    gzip, invalid JSON, or JSON that is not a Chrome trace-event object.
    The named error every malformed-trace path raises."""


@dataclasses.dataclass
class TraceEvent:
    """One complete ("X") trace event.  ts/dur in microseconds."""

    name: str
    pid: int
    tid: int
    ts: float
    dur: float
    hlo_op: str                 # the collective's name ("" elsewhere)
    step_num: Optional[int]     # step marks only
    cat: str = ""               # the Kineto category ("" in JAX traces)

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclasses.dataclass
class TraceEvents:
    """A parsed trace: complete events + the process/thread name maps
    the metadata events declared (`process_labels` rows, the Kineto
    device labels, fill in processes whose name is the program's)."""

    events: List[TraceEvent]
    process_names: Dict[int, str]
    thread_names: Dict[Tuple[int, int], str]
    path: Optional[str] = None
    process_labels: Dict[int, str] = dataclasses.field(default_factory=dict)


def load_trace(path: str) -> dict:
    """Read a `trace.json[.gz]` file into its JSON object.  Raises
    TraceParseError (never a bare gzip/json error) on a truncated or
    corrupt file."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                obj = json.load(f)
        else:
            with open(path, "r", encoding="utf-8") as f:
                obj = json.load(f)
    except FileNotFoundError:
        raise
    except (OSError, EOFError, ValueError, UnicodeDecodeError) as e:
        # gzip truncation raises EOFError/BadGzipFile(OSError); json
        # garbage raises JSONDecodeError(ValueError): one named error
        raise TraceParseError(
            f"cannot parse profiler trace {path!r}: {e}") from e
    if not isinstance(obj, dict):
        raise TraceParseError(
            f"profiler trace {path!r} is not a trace-event object "
            f"(got {type(obj).__name__})")
    return obj


def _step_num(name: str, args: dict, cat: str) -> Optional[int]:
    """args.step_num (JAX, serialized as a string), else the "#<i>" of a
    Kineto range's name."""
    step_num = args.get("step_num")
    if step_num is not None:
        try:
            return int(step_num)
        except (TypeError, ValueError):
            return None
    if cat in _RANGE_CATEGORIES:
        m = _STEP_NAME.match(name)
        if m:
            return int(m.group(2))
    return None


def _collective_names(events, correlation) -> None:
    """Set `hlo_op` on every device event launched inside a host range
    named like an inventory entry: the innermost such range, on the
    thread that made the launch, around the launch sharing the device
    event's correlation id."""
    by_thread: Dict[Tuple[int, int], list] = {}
    for ev in events:
        if (ev.cat == "user_annotation" and COLLECTIVE_NAME.match(ev.name)
                or ev.cat in _LAUNCH_CATEGORIES
                and id(ev) in correlation):
            by_thread.setdefault((ev.pid, ev.tid), []).append(ev)
    named: Dict[int, str] = {}
    for evs in by_thread.values():
        # one thread's ranges nest or are disjoint: a sweep in start
        # order keeps the open ones on a stack, the innermost on top
        # (a range sorts before a launch that starts with it)
        evs.sort(key=lambda e: (e.ts, e.cat in _LAUNCH_CATEGORIES,
                                -e.dur))
        stack: list = []
        for ev in evs:
            while stack and stack[-1].end < ev.ts:
                stack.pop()
            if ev.cat == "user_annotation":
                stack.append(ev)
            elif stack and ev.end <= stack[-1].end:
                named[correlation[id(ev)]] = stack[-1].name
    if not named:
        return
    for ev in events:
        if ev.cat in DEVICE_CATEGORIES:
            cid = correlation.get(id(ev))
            if cid in named:
                ev.hlo_op = named[cid]


def parse_trace(obj: dict, path: Optional[str] = None) -> TraceEvents:
    """Parse a Chrome trace-event JSON object (the `load_trace` result,
    or a hand-authored fixture dict) into typed events."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise TraceParseError(
            "trace object has no 'traceEvents' list — not a Chrome "
            "trace-event dump")
    raw = obj["traceEvents"]
    if not isinstance(raw, list):
        raise TraceParseError(
            f"'traceEvents' is {type(raw).__name__}, not a list")
    events: List[TraceEvent] = []
    correlation: Dict[int, int] = {}
    process_names: Dict[int, str] = {}
    process_labels: Dict[int, str] = {}
    thread_names: Dict[Tuple[int, int], str] = {}
    for e in raw:
        if not isinstance(e, dict):
            continue
        ph = e.get("ph")
        args = e.get("args") or {}
        if not isinstance(args, dict):
            args = {}
        if ph == "M":
            # a malformed metadata row (a non-numeric pid) costs the
            # ROW, never the trace
            try:
                if e.get("name") == "process_name":
                    process_names[int(e.get("pid", 0))] = str(
                        args.get("name", ""))
                elif e.get("name") == "process_labels":
                    process_labels[int(e.get("pid", 0))] = str(
                        args.get("labels", ""))
                elif e.get("name") == "thread_name":
                    thread_names[(int(e.get("pid", 0)),
                                  int(e.get("tid", 0)))] = str(
                        args.get("name", ""))
            except (TypeError, ValueError):
                pass
            continue
        if ph != "X":
            continue
        name = str(e.get("name", ""))
        cat = str(e.get("cat", "") or "")
        try:
            ev = TraceEvent(
                name=name,
                pid=int(e.get("pid", 0)),
                tid=int(e.get("tid", 0)),
                ts=float(e.get("ts", 0.0)),
                dur=float(e.get("dur", 0.0)),
                hlo_op=str(args.get("hlo_op", "")),
                step_num=_step_num(name, args, cat),
                cat=cat)
        except (TypeError, ValueError):
            continue  # a malformed row costs the EVENT, never the trace
        events.append(ev)
        cid = args.get("correlation")
        if isinstance(cid, int) and not isinstance(cid, bool):
            correlation[id(ev)] = cid
    _collective_names(events, correlation)
    return TraceEvents(events=events, process_names=process_names,
                       thread_names=thread_names, path=path,
                       process_labels=process_labels)


def read_trace(path: str) -> TraceEvents:
    """load_trace + parse_trace in one call."""
    return parse_trace(load_trace(path), path=path)


def newest_trace(logdir: str) -> Optional[str]:
    """The newest `*.trace.json[.gz]` under `logdir`, or None when no
    trace exists: what `ProfileCapture.trace_path()` resolves."""
    newest, newest_m = None, -1.0
    for root, _, files in os.walk(logdir):
        for f in files:
            if f.endswith(".trace.json.gz") or f.endswith(".trace.json"):
                p = os.path.join(root, f)
                try:
                    m = os.path.getmtime(p)
                except OSError:
                    continue
                if m > newest_m:
                    newest, newest_m = p, m
    return newest


def merged_length(intervals: List[Tuple[float, float]]) -> float:
    """Total covered length of a list of (start, end) intervals with
    overlaps merged: the device-busy union."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    total += cur_e - cur_s
    return total


def clipped(intervals: List[Tuple[float, float]], lo: float,
            hi: float) -> List[Tuple[float, float]]:
    """Intervals clipped to the [lo, hi] window (empties dropped)."""
    out = []
    for s, e in intervals:
        s2, e2 = max(s, lo), min(e, hi)
        if e2 > s2:
            out.append((s2, e2))
    return out
