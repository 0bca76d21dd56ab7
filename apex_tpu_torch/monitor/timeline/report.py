"""`analyze_trace(path) -> TimelineReport`: the measured step anatomy of
a real profiler trace (counterpart of apex_tpu/monitor/timeline/report.py,
with the same report, schema, renderer and crosscheck).

The comms observatory (`monitor.comms`) records what a step says over
the interconnect; this module measures what the device actually did,
from the `trace.json.gz` that `ProfileCapture` writes.  Per captured
step it derives

  * wall time, device-busy time (the union of the device's intervals
    over all its streams: concurrent streams never double-count) and
    the HOST GAP (wall minus busy: the time the device sat idle waiting
    on the host: input pipeline, dispatch, python),
  * wall-time attribution per op category, {gemm, collective,
    infeed_outfeed, other}, by op name (`classify_op`),
  * and per collective the MEASURED overlap fraction: the device's
    compute time concurrent with the collective's span, over the span,
    which `crosscheck_comms` holds against the comms report's.

The device lanes are the port's own.  In a Kineto trace (what
`torch.profiler` writes) the device's work is the `kernel`,
`gpu_memcpy` and `gpu_memset` events, on the device's pid and one tid
per stream; the `gpu_user_annotation` mirrors of host ranges on those
lanes are never work.  A trace without those categories is read by the
JAX package's rules (its `/device:` processes and "XLA Ops" lanes, or
`args.hlo_op`-tagged events), so its traces give the JAX package's
report here too.

Backend honesty, the JAX package's rule: a CPU trace (the gloo backend,
sync collectives, no device lanes) reports overlap UNMEASURABLE
(`overlap_measurable=False`, per-collective fraction None), never faked.
A GPU trace's streams are the schedule, so its overlap is measured.

A step's window is the hull of every mark of its step number: the host
range `ProfileCapture` opens ("<annotation>#<i>", or Kineto's
"ProfilerStep#<i>") and its mirror on the stream lanes.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

from apex_tpu_torch.monitor.comms.hlo import COLLECTIVE_KINDS
from apex_tpu_torch.monitor.timeline import events as events_lib
from apex_tpu_torch.monitor.timeline.events import (
    DEVICE_CATEGORIES,
    TraceEvents,
    TraceParseError,
    clipped,
    merged_length,
)

# Bump on any StepAnatomy/CollectiveSpan/TimelineReport field
# add/rename/re-semantics (the JAX package's version: both packages
# validate each other's reports)
TIMELINE_SCHEMA_VERSION = 1

# a step whose device-busy fraction is below this is host-bound: the
# renderer flags it DEVICE IDLE
IDLE_BUSY_FLOOR = 0.5

# a collective span shorter than this (total across the capture) is
# latency noise, not a hiding opportunity: never judged serialized
SERIALIZED_FLOOR_MS = 0.1

# the device-event categories the anatomy attributes wall time to;
# host events are counted separately (they are the gap, not the work)
CATEGORIES = ("gemm", "collective", "infeed_outfeed", "other")

_GEMM_PREFIXES = ("dot", "convolution", "conv", "gemm", "matmul",
                  "cublas", "loop_convolution")
_INFEED_PREFIXES = ("infeed", "outfeed", "host-transfer", "send",
                    "send-done", "recv", "recv-done", "copy-start",
                    "copy-done")
# CUDA names: NCCL's kernels by the collective they run ("SendRecv"
# before "Send"/"Recv"); the copies between host and device; the GEMMs
# of cuBLAS (nvjet, xmma), CUTLASS and the port's fused dense kernels
_NCCL_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
               ("reducescatter", "reduce-scatter"),
               ("alltoall", "all-to-all"),
               ("sendrecv", "collective-permute"),
               ("send", "collective-permute"),
               ("recv", "collective-permute"))
_HOST_COPIES = ("memcpy htod", "memcpy dtoh")
_CUDA_GEMMS = ("cublas", "cutlass", "nvjet", "xmma", "gemm")
_PORT_GEMM = re.compile(r"\bdense_\w*_kernel")


def collective_kind(name: str) -> Optional[str]:
    """The collective kind (the JAX package's spelling) a name belongs
    to: an inventory entry's "<kind>.<n>" (or an HLO instruction's), or
    an NCCL kernel's ("ncclDevKernel_AllGather_RING_LL" -> all-gather);
    None for anything else."""
    n = name.lower()
    for kind in COLLECTIVE_KINDS:
        if n.startswith(kind):
            return kind
    if n.startswith("nccl"):
        flat = n.replace("_", "")
        for key, kind in _NCCL_KINDS:
            if key in flat:
                return kind
    return None


def classify_op(name: str, hlo_op: str = "") -> str:
    """Category of one device op by NAME.  `hlo_op` (the collective an
    event belongs to, or a JAX trace's instruction name) wins over the
    display name when present.  The JAX package's name heuristics come
    first, so its traces classify alike; then the CUDA names: NCCL
    kernels are collectives, host<->device copies infeed_outfeed, the
    cuBLAS / CUTLASS / fused dense kernels gemm; the rest is "other",
    as the JAX package files its custom calls."""
    n = (hlo_op or name).lower()
    if collective_kind(n) is not None:
        return "collective"
    if n.startswith(_INFEED_PREFIXES) or n.startswith(_HOST_COPIES):
        return "infeed_outfeed"
    if n.startswith("convert"):
        return "other"  # dtype cast: the "conv" prefix below is for
        # convolutions and must not swallow it into gemm
    if n.startswith(_GEMM_PREFIXES):
        return "gemm"
    if n.startswith("fusion") and any(
            k in n for k in ("gemm", "matmul", "dot", "conv")):
        return "gemm"
    if any(k in n for k in _CUDA_GEMMS) or _PORT_GEMM.search(n):
        return "gemm"
    return "other"


@dataclasses.dataclass
class StepAnatomy:
    """One captured step's measured anatomy (times in ms)."""

    step: int
    t_start_us: float
    wall_ms: float
    device_busy_ms: float
    device_busy_fraction: float
    host_gap_ms: float
    category_ms: Dict[str, float]
    n_device_events: int

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["category_ms"] = {k: float(v)
                            for k, v in self.category_ms.items()}
        return d


@dataclasses.dataclass
class CollectiveSpan:
    """One collective (aggregated over its occurrences in the capture
    window: the same entry runs once per step) with its MEASURED
    overlap.  `overlap_fraction` is None when the backend's concurrency
    is not schedule truth (CPU)."""

    name: str
    kind: str
    n_events: int
    total_ms: float
    concurrent_compute_ms: float
    overlap_fraction: Optional[float]
    serialized: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TimelineReport:
    """The measured timeline anatomy (JSON-able via to_dict)."""

    device_type: str                 # "gpu" | "tpu" | "cpu" | "unknown"
    trace_path: Optional[str]
    annotation: str
    n_events: int
    n_device_events: int
    n_host_events: int
    steps: List[StepAnatomy]
    collectives: List[CollectiveSpan]
    # aggregates over the captured steps (whole trace if unannotated)
    device_busy_fraction: float
    host_gap_ms: float               # mean per step
    category_fractions: Dict[str, float]   # of device time; sum ~1
    collective_fraction: float
    overlap_measurable: bool
    measured_overlap_ok: Optional[bool]    # None when unmeasurable

    def to_dict(self) -> dict:
        return {
            "timeline_schema_version": TIMELINE_SCHEMA_VERSION,
            "device_type": self.device_type,
            "trace_path": self.trace_path,
            "annotation": self.annotation,
            "n_events": int(self.n_events),
            "n_device_events": int(self.n_device_events),
            "n_host_events": int(self.n_host_events),
            "steps": [s.to_dict() for s in self.steps],
            "collectives": [c.to_dict() for c in self.collectives],
            "device_busy_fraction": float(self.device_busy_fraction),
            "host_gap_ms": float(self.host_gap_ms),
            "category_fractions": {k: float(v) for k, v in
                                   self.category_fractions.items()},
            "collective_fraction": float(self.collective_fraction),
            "overlap_measurable": bool(self.overlap_measurable),
            "measured_overlap_ok": self.measured_overlap_ok,
        }

    def timeline_record(self) -> dict:
        """The `timeline_*` stamps for `MetricsLogger(timeline=report)`:
        optional-never-null, so the overlap verdict is simply absent
        where unmeasurable (CPU)."""
        rec = {
            "timeline_device_busy_fraction":
                float(self.device_busy_fraction),
            "timeline_host_gap_ms": float(self.host_gap_ms),
            "timeline_collective_fraction":
                float(self.collective_fraction),
        }
        if self.measured_overlap_ok is not None:
            rec["timeline_measured_overlap_ok"] = bool(
                self.measured_overlap_ok)
        return rec


# ------------------------------ analysis ------------------------------

def _kineto(trace: TraceEvents) -> bool:
    """A Kineto trace with device lanes: a process labelled "GPU <n>" or
    any device-category event."""
    return (any(lb.startswith("GPU") for lb in trace.process_labels.values())
            or any(ev.cat in DEVICE_CATEGORIES for ev in trace.events))


def _device_type(trace: TraceEvents) -> str:
    if _kineto(trace):
        return "gpu"
    names = " ".join(trace.process_names.values()).lower()
    if "/device:tpu" in names or " tpu" in names:
        return "tpu"
    if "/device:gpu" in names or "gpu" in names:
        return "gpu"
    if names:
        return "cpu"
    return "unknown"


def _device_op_tids(trace: TraceEvents, device_pids) -> Dict[int, set]:
    """A JAX trace's op lanes per device pid: its converters mirror the
    same wall time onto several lanes ("XLA Ops", "XLA Modules",
    "Steps"); threads named "XLA Ops*" are the ops, and a pid without
    such a thread counts every lane."""
    by_pid: Dict[int, list] = {}
    for (pid, tid), name in trace.thread_names.items():
        if pid in device_pids and "XLA Ops" in name:
            by_pid.setdefault(pid, []).append(tid)
    return {pid: set(tids) for pid, tids in by_pid.items()}


def _is_step_mark(ev, annotation: str) -> bool:
    n = ev.step_num
    return n is not None and ev.name in (annotation, f"{annotation}#{n}",
                                         f"ProfilerStep#{n}")


def _is_device_event(ev, kineto, device_pids, op_tids, annotation) -> bool:
    if kineto:
        return ev.cat in DEVICE_CATEGORIES
    if ev.pid in device_pids:
        # step markers are duplicated onto device pids by the JAX
        # converter (exclude by name); non-op lanes mirror wall time
        lanes = op_tids.get(ev.pid)
        if lanes is not None and ev.tid not in lanes:
            return False
        return ev.name != annotation and ev.step_num is None
    # an hlo_op-tagged event executed program code wherever it ran: on
    # a JAX CPU trace the "device" is XLA's thunk executor thread
    return bool(ev.hlo_op)


def analyze_events(trace: TraceEvents, *,
                   annotation: str = "train-step",
                   trace_path: Optional[str] = None) -> TimelineReport:
    """The analysis proper, over parsed events (hand-authored fixture
    dicts enter through `events.parse_trace` + this)."""
    kineto = _kineto(trace)
    device_pids = {pid for pid, name in trace.process_names.items()
                   if name.startswith("/device:")}
    device_type = _device_type(trace)
    # schedule concurrency is truth only where each lane IS a device
    # stream; a CPU trace's collectives are sync: unmeasurable
    overlap_measurable = device_type in ("tpu", "gpu")

    op_tids = _device_op_tids(trace, device_pids)
    dev_events, host_events, step_marks = [], [], []
    for ev in trace.events:
        if _is_step_mark(ev, annotation):
            step_marks.append(ev)
        elif _is_device_event(ev, kineto, device_pids, op_tids,
                              annotation):
            dev_events.append(ev)
        elif ev.cat != "gpu_user_annotation":
            # a Kineto annotation mirror is neither work nor host time
            host_events.append(ev)

    # step windows: one per step number, spanning every mark that
    # carries it (the host range and its mirror on the stream lanes)
    windows: Dict[int, Tuple[float, float]] = {}
    for m in step_marks:
        lo, hi = windows.get(m.step_num, (m.ts, m.end))
        windows[m.step_num] = (min(lo, m.ts), max(hi, m.end))
    if not windows and trace.events:
        # unannotated trace: the whole span is one pseudo-step so the
        # aggregates still mean something
        lo = min(ev.ts for ev in trace.events)
        hi = max(ev.end for ev in trace.events)
        windows = {-1: (lo, hi)}

    cat_of = {id(ev): classify_op(ev.name, ev.hlo_op)
              for ev in dev_events}
    # one pid per device: pooling them would let one busy device mask
    # another's idle and count device A's compute as "concurrent" with
    # device B's collective, so per-step numbers are per-device means
    # and the overlap window only sees compute from the collective's
    # own device
    dev_lane_pids = sorted({ev.pid for ev in dev_events})
    n_lanes = max(1, len(dev_lane_pids))
    by_pid: Dict[int, list] = {}
    for ev in dev_events:
        by_pid.setdefault(ev.pid, []).append(ev)

    steps: List[StepAnatomy] = []
    for step_num in sorted(windows):
        lo, hi = windows[step_num]
        wall_us = max(hi - lo, 1e-9)
        busy_us = sum(
            merged_length(clipped([(ev.ts, ev.end) for ev in evs],
                                  lo, hi))
            for evs in by_pid.values()) / n_lanes
        cat_ms = {c: 0.0 for c in CATEGORIES}
        n_dev = 0
        for ev in dev_events:
            s, e = max(ev.ts, lo), min(ev.end, hi)
            if e > s:
                cat_ms[cat_of[id(ev)]] += (e - s) / 1e3 / n_lanes
                n_dev += 1
        steps.append(StepAnatomy(
            step=int(step_num), t_start_us=float(lo),
            wall_ms=wall_us / 1e3,
            device_busy_ms=busy_us / 1e3,
            device_busy_fraction=min(1.0, busy_us / wall_us),
            host_gap_ms=max(0.0, wall_us - busy_us) / 1e3,
            category_ms=cat_ms, n_device_events=n_dev))

    # per-collective measured overlap: the SAME device's compute wall
    # time concurrent with each collective occurrence, aggregated by
    # name (total_ms sums across devices AND steps)
    compute_by_pid = {
        pid: [(ev.ts, ev.end) for ev in evs
              if cat_of[id(ev)] != "collective"]
        for pid, evs in by_pid.items()}
    spans: Dict[str, dict] = {}
    for ev in dev_events:
        if cat_of[id(ev)] != "collective":
            continue
        key = ev.hlo_op or ev.name
        d = spans.setdefault(key, {"n": 0, "total": 0.0, "conc": 0.0})
        d["n"] += 1
        d["total"] += ev.dur
        d["conc"] += merged_length(
            clipped(compute_by_pid.get(ev.pid, []), ev.ts, ev.end))
    collectives: List[CollectiveSpan] = []
    for key in sorted(spans):
        d = spans[key]
        frac = (min(1.0, d["conc"] / d["total"])
                if overlap_measurable and d["total"] > 0 else None)
        collectives.append(CollectiveSpan(
            # spans exist only for names classify_op called collective,
            # so the kind resolves
            name=key, kind=collective_kind(key), n_events=int(d["n"]),
            total_ms=d["total"] / 1e3,
            concurrent_compute_ms=d["conc"] / 1e3,
            overlap_fraction=frac,
            serialized=bool(frac == 0.0
                            and d["total"] / 1e3 >= SERIALIZED_FLOOR_MS)))

    total_wall = sum(s.wall_ms for s in steps)
    total_busy = sum(s.device_busy_ms for s in steps)
    total_cat = {c: sum(s.category_ms[c] for s in steps)
                 for c in CATEGORIES}
    cat_sum = sum(total_cat.values())
    cat_fracs = {c: (total_cat[c] / cat_sum if cat_sum > 0 else 0.0)
                 for c in CATEGORIES}
    measured_ok = None
    if overlap_measurable:
        measured_ok = not any(c.serialized for c in collectives)

    return TimelineReport(
        device_type=device_type,
        trace_path=trace_path if trace_path is not None else trace.path,
        annotation=annotation,
        n_events=len(trace.events),
        n_device_events=len(dev_events),
        n_host_events=len(host_events),
        steps=steps, collectives=collectives,
        device_busy_fraction=(total_busy / total_wall
                              if total_wall > 0 else 0.0),
        host_gap_ms=(sum(s.host_gap_ms for s in steps) / len(steps)
                     if steps else 0.0),
        category_fractions=cat_fracs,
        collective_fraction=cat_fracs["collective"],
        overlap_measurable=overlap_measurable,
        measured_overlap_ok=measured_ok)


def analyze_trace(path_or_obj, *,
                  annotation: str = "train-step") -> TimelineReport:
    """Parse + analyze one profiler trace.  Accepts a path to a
    `trace.json[.gz]` file (what `ProfileCapture.trace_path()`
    returns), a raw trace-event dict, or a parsed `TraceEvents`.
    Raises `TraceParseError` on a malformed or truncated file."""
    if isinstance(path_or_obj, TraceEvents):
        return analyze_events(path_or_obj, annotation=annotation)
    if isinstance(path_or_obj, dict):
        return analyze_events(events_lib.parse_trace(path_or_obj),
                              annotation=annotation)
    if path_or_obj is None:
        raise TraceParseError(
            "analyze_trace(None): no trace was captured — did the "
            "ProfileCapture window ever fire? (trace_path() is None "
            "until a window opened and closed)")
    return analyze_events(events_lib.read_trace(path_or_obj),
                          annotation=annotation)
# ---------------------------- schema + gate ----------------------------

_REPORT_FIELDS = {
    "timeline_schema_version": int,
    "device_type": str,
    "trace_path": (str, type(None)),
    "annotation": str,
    "n_events": int,
    "n_device_events": int,
    "n_host_events": int,
    "steps": list,
    "collectives": list,
    "device_busy_fraction": (int, float),
    "host_gap_ms": (int, float),
    "category_fractions": dict,
    "collective_fraction": (int, float),
    "overlap_measurable": bool,
    "measured_overlap_ok": (bool, type(None)),
}

_STEP_FIELDS = {
    "step": int, "t_start_us": (int, float), "wall_ms": (int, float),
    "device_busy_ms": (int, float),
    "device_busy_fraction": (int, float),
    "host_gap_ms": (int, float), "category_ms": dict,
    "n_device_events": int,
}

_COLLECTIVE_FIELDS = {
    "name": str, "kind": str, "n_events": int,
    "total_ms": (int, float), "concurrent_compute_ms": (int, float),
    "overlap_fraction": (int, float, type(None)), "serialized": bool,
}


def validate_timeline_report(report: dict) -> None:
    """Raise ValueError unless `report` (the to_dict form) matches the
    current schema (the JAX package's: each package's validator accepts
    the other's reports)."""
    if not isinstance(report, dict):
        raise ValueError(f"timeline report must be a dict, got "
                         f"{type(report).__name__}")
    if report.get("timeline_schema_version") != TIMELINE_SCHEMA_VERSION:
        raise ValueError(
            f"timeline_schema_version "
            f"{report.get('timeline_schema_version')!r} != "
            f"{TIMELINE_SCHEMA_VERSION}")
    for name, typ in _REPORT_FIELDS.items():
        if name not in report:
            raise ValueError(f"missing timeline report field {name!r}")
        v = report[name]
        if not isinstance(v, typ):
            raise ValueError(f"timeline report field {name!r} is "
                             f"{type(v).__name__}")
        if typ is int and isinstance(v, bool):
            raise ValueError(f"timeline report field {name!r} is bool")
    for i, s in enumerate(report["steps"]):
        for name, typ in _STEP_FIELDS.items():
            if name not in s:
                raise ValueError(f"steps[{i}] missing field {name!r}")
            if not isinstance(s[name], typ) or (
                    typ is int and isinstance(s[name], bool)):
                raise ValueError(f"steps[{i}].{name} is "
                                 f"{type(s[name]).__name__}")
        for c in CATEGORIES:
            if c not in s["category_ms"]:
                raise ValueError(f"steps[{i}].category_ms missing "
                                 f"category {c!r}")
    for i, c in enumerate(report["collectives"]):
        for name, typ in _COLLECTIVE_FIELDS.items():
            if name not in c:
                raise ValueError(
                    f"collectives[{i}] missing field {name!r}")
            if not isinstance(c[name], typ):
                raise ValueError(f"collectives[{i}].{name} is "
                                 f"{type(c[name]).__name__}")
        if c["kind"] not in COLLECTIVE_KINDS:
            raise ValueError(f"collectives[{i}] unknown kind "
                             f"{c['kind']!r}")
    for c, v in report["category_fractions"].items():
        if c not in CATEGORIES:
            raise ValueError(f"unknown category {c!r}")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"category_fractions[{c!r}] is "
                             f"{type(v).__name__}")
    frac_sum = sum(report["category_fractions"].values())
    if report["n_device_events"] > 0 and not math.isclose(
            frac_sum, 1.0, abs_tol=1e-6):
        raise ValueError(
            f"category fractions sum to {frac_sum}, not ~1 — the "
            "attribution dropped or double-counted device time")


# ---------------------------- rendering ----------------------------

def render_timeline_table(report, label: str = "trace") -> str:
    """The per-step anatomy table an operator reads next to the comms
    table.  Accepts a TimelineReport or its to_dict()."""
    r = report.to_dict() if hasattr(report, "to_dict") else dict(report)
    lines = [
        f"=== timeline: {label} ===",
        f"device: {r.get('device_type')} | events: "
        f"{r.get('n_device_events')} device / {r.get('n_host_events')} "
        f"host | steps: {len(r.get('steps') or [])}"
        + (f" | {r['trace_path']}" if r.get("trace_path") else ""),
        "| step | wall ms | busy % | host gap ms | gemm % | coll % | "
        "in/out % | other % |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for s in r.get("steps", []):
        cat = s.get("category_ms") or {}
        dev = sum(cat.values()) or 1.0

        def pct(c):
            return f"{100 * cat.get(c, 0.0) / dev:5.1f}"

        lines.append(
            f"| {s['step']:>4} | {s['wall_ms']:7.2f} | "
            f"{100 * s['device_busy_fraction']:5.1f} | "
            f"{s['host_gap_ms']:11.2f} | {pct('gemm')} | "
            f"{pct('collective')} | {pct('infeed_outfeed')} | "
            f"{pct('other')} |")
    lines.append(
        f"aggregate: device busy "
        f"{100 * r.get('device_busy_fraction', 0.0):.1f}% | host gap "
        f"{r.get('host_gap_ms', 0.0):.2f} ms/step | collectives "
        f"{100 * r.get('collective_fraction', 0.0):.1f}% of device "
        "time")
    # heaviest collectives first, capped — a dp=1 CPU smoke trace
    # carries dozens of sub-microsecond degenerate all-reduces that
    # would drown the table (serialized ones always shown)
    colls = sorted(r.get("collectives", []),
                   key=lambda c: (-bool(c.get("serialized")),
                                  -c.get("total_ms", 0.0)))
    shown = [c for i, c in enumerate(colls)
             if i < 8 or c.get("serialized")]
    for c in shown:
        frac = c.get("overlap_fraction")
        overlap = (f"{100 * frac:.0f}% overlapped" if frac is not None
                   else "overlap n/a")
        mark = " **SER**" if c.get("serialized") else ""
        lines.append(
            f"  collective {c['name']} ({c['kind']}): x{c['n_events']}, "
            f"{c['total_ms']:.2f} ms, {overlap}{mark}")
    if len(colls) > len(shown):
        lines.append(f"  … and {len(colls) - len(shown)} more "
                     "collective(s) (by total ms)")
    if not r.get("overlap_measurable"):
        lines.append(
            "overlap: UNMEASURABLE (sync collectives / no device lanes "
            "on this backend — run the capture on a GPU for the "
            "schedule truth)")
    elif r.get("measured_overlap_ok"):
        lines.append("overlap: measured ok (every collective's span "
                     "held concurrent compute)")
    else:
        ser = [c for c in r.get("collectives", [])
               if c.get("serialized")]
        lines.append(
            f"** {len(ser)} MEASURED-SERIALIZED collective(s): "
            + "; ".join(f"{c['name']} {c['total_ms']:.2f} ms"
                        for c in ser[:4]))
    if (r.get("steps") and r.get("n_device_events", 0) > 0
            and r.get("device_busy_fraction", 1.0) < IDLE_BUSY_FLOOR):
        lines.append(
            f"** DEVICE IDLE: busy fraction "
            f"{r['device_busy_fraction']:.2f} < {IDLE_BUSY_FLOOR} — "
            "the device waited on the host for most of each step "
            "(input pipeline / dispatch bound)")
    return "\n".join(lines)


# ------------------------- comms cross-check -------------------------

def _coll_name_prefix(name: str, strip_start: bool = False) -> str:
    """A collective's name with its uniquifying ".N" suffix stripped:
    the pool key the chunked same-kind entries of one logical
    collective share.  An async "-start" spelling is KEPT in the prefix;
    `strip_start=True` gives the fallback spelling for a trace that
    records the op under its base name."""
    head, dot, tail = name.rpartition(".")
    base = head if (dot and tail.isdigit()) else name
    if strip_start and base.endswith("-start"):
        base = base[:-len("-start")]
    return base


def crosscheck_comms(timeline, comms_report, *,
                     tolerance: float = 0.25) -> dict:
    """Close the loop between the comms report's PREDICTED overlap and
    the timeline's MEASURED one: one row per counted collective of the
    comms report (group_size > 1), matched to the trace's collective
    spans by name.  The port's wrappers name each collective's range in
    the trace after its inventory entry ("<kind>.<n>"), so an exact
    name match is the common case; unmatched collectives then pair
    within their NAME-PREFIX group (the ".N" suffix stripped, a
    "-start" kept, so that one logical collective spelled as several
    same-kind chunks keeps its own spans); only leftovers fall back to
    kind-ordinal pairing (k-th all-reduce with the k-th all-reduce
    span).  The JAX package's passes, in its order.

    Row verdicts: AGREE (|predicted - measured| <= tolerance),
    DIVERGES (the prediction and the schedule disagree: the thing this
    function exists to surface), UNMEASURED (no measured fraction: a
    CPU backend, or no span in the trace), MEASURED-ONLY (the trace
    measured a fraction the report called sync).  `ok` is False only
    on DIVERGES: an unmeasured plane is honest, not green-washed."""
    t = timeline.to_dict() if hasattr(timeline, "to_dict") \
        else dict(timeline)
    c = comms_report.to_dict() if hasattr(comms_report, "to_dict") \
        else dict(comms_report)
    spans_by_name = {s["name"]: s for s in t.get("collectives", [])}
    spans_by_kind: Dict[str, list] = {}
    for s in t.get("collectives", []):
        spans_by_kind.setdefault(s["kind"], []).append(s)
    counted = [coll for coll in c.get("collectives", [])
               if coll.get("group_size", 1) > 1]
    # pass 1: EXACT name matches claim their spans first (an async
    # spelling "<kind>-start.N" also matches its op "<kind>.N").  Only
    # then are the leftovers handed out: a fallback running first could
    # steal the very span a later collective matches BY NAME, judging
    # two rows against one measurement.
    claimed = set()
    span_for: Dict[int, Optional[dict]] = {}
    for i, coll in enumerate(counted):
        name = coll.get("name", "")
        span = spans_by_name.get(name)
        if span is None and "-start" in name:
            span = spans_by_name.get(name.replace("-start", "", 1))
        if span is not None and id(span) not in claimed:
            claimed.add(id(span))
            span_for[i] = span
    # pass 1.5: NAME-PREFIX groups.  A chunked program spells one
    # logical collective as N same-kind entries; if the trace numbered
    # them otherwise, raw kind-ordinal pairing could hand a chunk's span
    # to an UNRELATED same-kind collective (the dp grad all-reduce vs
    # the tp ring hop).  Pairing inside the ".N"-stripped prefix pool
    # first keeps chunk spans with their own logical collective.
    spans_by_prefix: Dict[str, list] = {}
    for s in t.get("collectives", []):
        spans_by_prefix.setdefault(
            _coll_name_prefix(s["name"]), []).append(s)
    prefix_cursor: Dict[str, int] = {}
    for i, coll in enumerate(counted):
        if i in span_for:
            continue
        name = coll.get("name", "")
        pref = _coll_name_prefix(name)
        if pref not in spans_by_prefix:
            # trace recorded the base-name spelling of an async op
            pref = _coll_name_prefix(name, strip_start=True)
        pool = spans_by_prefix.get(pref, [])
        j = prefix_cursor.get(pref, 0)
        while j < len(pool) and id(pool[j]) in claimed:
            j += 1
        if j < len(pool):
            claimed.add(id(pool[j]))
            span_for[i] = pool[j]
            prefix_cursor[pref] = j + 1
    kind_cursor: Dict[str, int] = {}
    for i, coll in enumerate(counted):
        if i in span_for:
            continue
        pool = spans_by_kind.get(coll.get("kind", ""), [])
        j = kind_cursor.get(coll.get("kind", ""), 0)
        while j < len(pool) and id(pool[j]) in claimed:
            j += 1
        if j < len(pool):
            claimed.add(id(pool[j]))
            span_for[i] = pool[j]
            kind_cursor[coll.get("kind", "")] = j + 1

    rows = []
    for i, coll in enumerate(counted):
        name, kind = coll.get("name", ""), coll.get("kind", "")
        span = span_for.get(i)
        predicted = coll.get("overlap_fraction")
        measured = span.get("overlap_fraction") if span else None
        if measured is None:
            verdict = "UNMEASURED"
        elif predicted is None:
            verdict = "MEASURED-ONLY"
        elif abs(predicted - measured) <= tolerance:
            verdict = "AGREE"
        else:
            verdict = "DIVERGES"
        rows.append({
            "name": name,
            "kind": kind,
            "expected_overlap": bool(coll.get("expected_overlap")),
            "predicted_overlap_fraction": predicted,
            "measured_overlap_fraction": measured,
            "measured_ms": span.get("total_ms") if span else None,
            "verdict": verdict,
        })
    n = {v: sum(1 for r in rows if r["verdict"] == v)
         for v in ("AGREE", "DIVERGES", "UNMEASURED", "MEASURED-ONLY")}
    return {
        "rows": rows,
        "n_expected_overlap": sum(1 for r in rows
                                  if r["expected_overlap"]),
        "n_agree": n["AGREE"],
        "n_diverge": n["DIVERGES"],
        "n_unmeasured": n["UNMEASURED"],
        "ok": n["DIVERGES"] == 0,
    }


def render_crosscheck(result: dict, label: str = "step") -> str:
    """The predicted-vs-measured table for one crosscheck_comms
    result."""
    lines = [
        f"=== overlap crosscheck: {label} ===",
        "| collective         | kind               | predicted | "
        "measured | verdict |",
        "|---|---|---|---|---|",
    ]

    def fm(v):
        return "n/a" if v is None else f"{100 * v:.0f}%"

    for r in result.get("rows", []):
        exp = "*" if r.get("expected_overlap") else " "
        lines.append(
            f"| {r['name'][:18]:<18} | {r['kind']:<18} | "
            f"{fm(r['predicted_overlap_fraction']):>9} | "
            f"{fm(r['measured_overlap_fraction']):>8} | "
            f"{r['verdict']}{exp} |")
    lines.append(
        f"verdict: {result.get('n_agree', 0)} agree, "
        f"{result.get('n_diverge', 0)} diverge, "
        f"{result.get('n_unmeasured', 0)} unmeasured "
        f"({result.get('n_expected_overlap', 0)} expected-overlap "
        "collective(s); * marks them)")
    return "\n".join(lines)
