"""Flight-report validation and rendering: the last-good → first-bad
timeline (counterpart of apex_tpu/monitor/trace/report.py; host code).

Input is the JSON report `FlightRecorder.dump` wrote (see recorder.py
for the schema); `render_report` turns it into the terminal story a
diverged run needs told: which steps were still healthy, where the
first non-finite value entered, WHICH tap (layer + plane) it entered
at, and whether a rank was straggling while it happened.  The schema
and its version are the JAX package's, so a report written by either
package validates and renders in both.  The port keeps its own copy of
`FLIGHT_RECORDER_VERSION` here.
"""

from __future__ import annotations

import math
from typing import List, Optional

# bump on any field add/rename/re-semantics (recorder.py docstring)
FLIGHT_RECORDER_VERSION = 2

_REQUIRED_TOP = ("flight_recorder_version", "monitor_schema_version",
                 "reason", "oom", "capacity", "tap_names",
                 "timing_fields", "straggler", "compile_report",
                 "compile_events", "memory", "records")
_REQUIRED_REC = ("step", "metrics", "taps", "timings")


def validate_report(report: dict) -> None:
    """Raise ValueError unless `report` matches the current
    flight-recorder schema (recorder.py docstring).  The version check
    is exact: a drifted fixture or a stale report from an older build
    must fail loudly, not render garbage."""
    from apex_tpu_torch.monitor import logger as logger_lib
    if not isinstance(report, dict):
        raise ValueError(f"report is {type(report).__name__}, want dict")
    for k in _REQUIRED_TOP:
        if k not in report:
            raise ValueError(f"missing report field {k!r}")
    if report["flight_recorder_version"] != FLIGHT_RECORDER_VERSION:
        raise ValueError(
            f"flight_recorder_version "
            f"{report['flight_recorder_version']!r} != "
            f"{FLIGHT_RECORDER_VERSION}")
    if report["monitor_schema_version"] != logger_lib.SCHEMA_VERSION:
        raise ValueError(
            f"monitor_schema_version "
            f"{report['monitor_schema_version']!r} != "
            f"{logger_lib.SCHEMA_VERSION}")
    if not isinstance(report["records"], list):
        raise ValueError("records is not a list")
    prev = None
    for i, rec in enumerate(report["records"]):
        for k in _REQUIRED_REC:
            if k not in rec:
                raise ValueError(f"record {i} missing field {k!r}")
        if not isinstance(rec["step"], int):
            raise ValueError(f"record {i} step is not an int")
        if prev is not None and rec["step"] <= prev:
            raise ValueError(
                f"non-monotonic record steps: {rec['step']} after {prev}")
        prev = rec["step"]


def _is_bad(rec: dict) -> bool:
    """A record is 'bad' when any tap tripped or the logged loss went
    non-finite (null + marker after JSON sanitization)."""
    taps = rec.get("taps") or {}
    if taps.get("first_bad_fwd") or taps.get("first_bad_grad"):
        return True
    m = rec.get("metrics") or {}
    if "loss_nonfinite" in m:
        return True
    loss = m.get("loss")
    return isinstance(loss, float) and not math.isfinite(loss)


def _fmt_metrics(m: Optional[dict]) -> str:
    if not m:
        return ""
    parts = []
    for k, fmt in (("loss", "{:.4f}"), ("grad_norm", "{:.3e}"),
                   ("loss_scale", "{:g}")):
        v = m.get(k)
        if v is None and f"{k}_nonfinite" in m:
            parts.append(f"{k} {m[f'{k}_nonfinite']}")
        elif isinstance(v, (int, float)):
            parts.append(f"{k} {fmt.format(v)}")
    return " | ".join(parts)


def render_report(report: dict, last: Optional[int] = None) -> str:
    """Render the timeline (newest-last).  `last` limits to the final N
    records.  Raises ValueError on schema drift (validate_report)."""
    validate_report(report)
    records = report["records"]
    if last is not None:
        records = records[-last:]
    lines: List[str] = []
    lines.append("=== numerics flight report ===")
    lines.append(f"reason: {report['reason']}")
    if records:
        lines.append(f"ring: {len(records)} of last {report['capacity']} "
                     f"steps (steps {records[0]['step']}.."
                     f"{records[-1]['step']})")
    else:
        lines.append("ring: empty")

    if report.get("oom"):
        lines.append("!! OOM: the run died RESOURCE_EXHAUSTED — HBM "
                     "budget below")

    strag = report.get("straggler")
    if strag and strag.get("last"):
        s = strag["last"]
        flagged = s.get("flagged") or []
        lines.append(
            f"rank timing ({strag.get('field')}): skew "
            f"{s['skew']:.2f}x (max rank {s['max_rank']}, "
            f"median {s['median_s'] * 1e3:.1f} ms)")
        for f in flagged:
            lines.append(
                f"  ** STRAGGLER rank {f['rank']}: {f['skew']:.2f}x "
                f"median for {f['consecutive']} consecutive steps")

    events = report.get("compile_events") or []
    if events:
        steady = [e for e in events if e.get("steady_state")]
        lines.append(f"compile: {len(events)} compile event(s), "
                     f"{len(steady)} steady-state")
        for e in events[-4:]:  # the tail tells the story
            sig = str(e.get("signature", ""))[:100]
            tag = ("** RECOMPILE" if e.get("steady_state")
                   else "   compile")
            lines.append(f"{tag} at call {e.get('call')} "
                         f"[{e.get('kind')}]: {sig}")

    mem = report.get("memory") or {}
    # device ids are stringified ints: numeric order, not lexicographic
    # (a 16-chip host must not render 0, 1, 10, 11, ..., 2, ...)
    def _dev_key(kv):
        return (0, int(kv[0])) if kv[0].isdigit() else (1, kv[0])

    for dev_id, stats in sorted(mem.items(), key=_dev_key):
        in_use = stats.get("bytes_in_use")
        peak = stats.get("peak_bytes_in_use")
        limit = stats.get("bytes_limit")
        if in_use is None and peak is None:
            continue
        line = f"hbm[{dev_id}]:"
        if in_use is not None:
            line += f" {in_use / 2**30:.2f} GiB in use"
        if peak is not None:
            line += f" / {peak / 2**30:.2f} GiB peak"
        if limit is not None:
            line += f" (limit {limit / 2**30:.2f} GiB)"
        lines.append(line)

    if report.get("compile_report") and (report.get("oom") or events):
        # the budget table IS the OOM forensics payload; on a healthy
        # explicit dump it stays out of the way unless compiles fired
        from apex_tpu_torch.monitor.compile import report as compile_report
        try:
            lines.append(compile_report.render_budget_table(
                report["compile_report"]))
        except Exception as e:  # a drifted attachment must not cost
            lines.append(f"(compile report unrenderable: {e!r})")

    last_good = None
    first_bad = None
    for rec in records:
        if _is_bad(rec):
            if first_bad is None:
                first_bad = rec
        elif first_bad is None:
            last_good = rec

    lines.append("--- timeline ---")
    for rec in records:
        bad = _is_bad(rec)
        tag = "  "
        if rec is last_good:
            tag = "OK"
        elif rec is first_bad:
            tag = "!!"
        elif bad:
            tag = " !"
        line = f"{tag} step {rec['step']:>8}"
        ms = _fmt_metrics(rec.get("metrics"))
        if ms:
            line += "  " + ms
        taps = rec.get("taps") or {}
        for plane in ("fwd", "grad"):  # forward origin wins (taps.provenance)
            nm = taps.get(f"first_bad_{plane}")
            if nm:
                stats = (taps.get(plane) or {}).get(nm) or {}
                n_bad = stats.get("nonfinite")
                line += (f"  <- first non-finite [{plane}] at {nm}"
                         + (f" ({n_bad:.0f} elements)"
                            if isinstance(n_bad, float) else ""))
                break
        lines.append(line)

    lines.append("--- verdict ---")
    if report.get("oom"):
        lines.append(
            "death by RESOURCE_EXHAUSTED: compare the HBM budget "
            "table above against the device limit (shrink the batch, "
            "enable remat, or shard the optimizer state)")
    if first_bad is None:
        lines.append("no non-finite step in the recorded window")
    else:
        if last_good is not None:
            lines.append(f"last good step: {last_good['step']}")
        taps = first_bad.get("taps") or {}
        culprit = (taps.get("first_bad_fwd")
                   or taps.get("first_bad_grad"))
        plane = ("fwd" if taps.get("first_bad_fwd") else "grad")
        if culprit:
            lines.append(
                f"first bad step: {first_bad['step']} — non-finite "
                f"values first observed at tap '{culprit}' "
                f"({plane} plane)")
        else:
            lines.append(
                f"first bad step: {first_bad['step']} — loss went "
                "non-finite (no tap attribution recorded; was the "
                "step built with trace taps enabled?)")
    return "\n".join(lines)
