"""`comms_report(step, args) -> CommsReport`: the collective inventory,
overlap analysis and link roofline of one train step (counterpart of
apex_tpu/monitor/comms/report.py, with its report, schema, gate and
table).

Three layers, as in the JAX package:

  * inventory: every all-reduce / all-gather / reduce-scatter /
    all-to-all / collective-permute the step issues: kind, dtype,
    operand and output bytes, its group mapped to the mesh's axis
    names, async or not.  The JAX package reads them from the optimized
    HLO; an eager step has none, so the port runs the step ONCE on
    clones of `args` (as `compile.analyze_step` does) while the
    collective wrappers of `parallel.mesh` report each one to an
    `inventory.InventoryRecorder`.
  * overlap: for each async collective, the matmul flops the step
    issued between its issue and its `wait()` (the JAX package's dot
    flops between a start and its done).  An expected-overlap
    collective (at least `OVERLAP_BYTES_FLOOR`) whose window holds none
    is SERIALIZED: the step waits on the wire.  On gloo, whose
    collectives are sync, `async_supported` is False and the plane is
    reported unmeasurable, as the JAX package reports a CPU program.
  * roofline: each collective priced against the link table
    (`roofline.collective_seconds`), totalled into predicted comm
    seconds, the comm fraction of the step (against the counted flops
    at the device's peak) and a comm-bound verdict.

`crosscheck_rank_timing` holds the roofline against the allreduce
durations the rank-timing plane measures, and
`timeline.crosscheck_comms` the predicted overlap against a trace's.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import List, Optional, Sequence, Tuple

from apex_tpu_torch.monitor.comms import roofline as roofline_lib
from apex_tpu_torch.monitor.comms.hlo import COLLECTIVE_KINDS
# one byte formatter for the observatory: the comms table prints next to
# the memory budget and both must agree what "16.00 MiB" is
from apex_tpu_torch.monitor.compile.report import _human_bytes

# Bump on any Collective/CommsReport field add/rename/re-semantics (the
# JAX package's version: both packages validate each other's reports)
COMMS_SCHEMA_VERSION = 1

# a collective smaller than this is never expected to overlap (scalar
# loss sums, found_inf ORs, the rank-timing all_gather): hiding a
# 4-byte flag behind a GEMM is noise, not a lever
OVERLAP_BYTES_FLOOR = 1 << 20  # 1 MiB

# the kinds the overlap gate holds to the expected-overlap rule (the JAX
# package's): a large async ring hop exists to hide behind the partial
# GEMM of the previous chunk; all-to-all overlap stays
# workload-specific
_EXPECTED_OVERLAP_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                           "collective-permute")


@dataclasses.dataclass
class Collective:
    """One collective the step issued (JSON-able via to_dict; the JAX
    package's fields).

    `name` is "<kind>.<n>", n in issue order.  `operand_bytes` is the
    total input bytes (for an all-gather: this rank's shard; see
    roofline.py for what each kind's formula does with it).  `axes` is
    the mesh-axis tuple the group spans (() for a group of one rank,
    None when the group is not one of the mesh's).  `async_pair` is an
    async collective on a backend whose collectives run asynchronously
    (NCCL); `n_between` and `overlapped_flops` are the ATen ops and the
    matmul flops the step issued between its issue and the first wait
    on its work.  `overlap_fraction` is None for a sync collective, else
    the fraction of the predicted comm time those flops cover at the
    device's peak, clamped to 1.  `op_name` is the caller's file, line
    and function."""

    name: str
    kind: str
    dtype: str
    operand_bytes: int
    output_bytes: int
    group_size: int
    n_groups: int
    axes: Optional[Tuple[str, ...]]
    async_pair: bool
    n_between: int
    overlapped_flops: float
    predicted_s: float
    overlap_fraction: Optional[float]
    expected_overlap: bool
    serialized: bool
    op_name: str

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["axes"] = None if self.axes is None else list(self.axes)
        return d


@dataclasses.dataclass
class CommsReport:
    """The step's communication anatomy (JSON-able via to_dict)."""

    backend: str
    device_kind: Optional[str]
    mesh_axis_names: Optional[Tuple[str, ...]]
    mesh_axis_sizes: Optional[Tuple[int, ...]]
    collectives: List[Collective]
    # aggregates over NON-degenerate collectives (group_size > 1)
    counts: dict                     # kind -> count
    bytes_by_kind: dict              # kind -> total operand bytes
    total_comm_bytes: int
    # roofline
    link_bandwidth: float
    bandwidth_source: str            # "override" | "table:<kind>" | "default"
    predicted_comm_s: float
    compute_s: Optional[float]       # counted flops / device peak (None:
    comm_fraction: Optional[float]   # no flop count given)
    comm_bound: Optional[bool]
    # overlap plane
    async_supported: bool            # the collectives run async (NCCL)
    serialized_comm_bytes: int
    overlap_ok: bool                 # vacuously True when not measurable

    def to_dict(self) -> dict:
        return {
            "comms_schema_version": COMMS_SCHEMA_VERSION,
            "backend": self.backend,
            "device_kind": self.device_kind,
            "mesh_axis_names": (None if self.mesh_axis_names is None
                                else list(self.mesh_axis_names)),
            "mesh_axis_sizes": (None if self.mesh_axis_sizes is None
                                else list(self.mesh_axis_sizes)),
            "collectives": [c.to_dict() for c in self.collectives],
            "counts": dict(self.counts),
            "bytes_by_kind": dict(self.bytes_by_kind),
            "total_comm_bytes": int(self.total_comm_bytes),
            "link_bandwidth": float(self.link_bandwidth),
            "bandwidth_source": self.bandwidth_source,
            "predicted_comm_s": float(self.predicted_comm_s),
            "compute_s": self.compute_s,
            "comm_fraction": self.comm_fraction,
            "comm_bound": self.comm_bound,
            "async_supported": bool(self.async_supported),
            "serialized_comm_bytes": int(self.serialized_comm_bytes),
            "overlap_ok": bool(self.overlap_ok),
        }



# ------------------------------ inventory ------------------------------

def _build(e, peak_flops, link_bandwidth, floor,
           async_supported) -> Collective:
    """One recorded collective (`inventory.InventoryRecorder` entry) as
    the report's Collective."""
    kind, group_size = e["kind"], e["group_size"]
    async_pair = bool(e["async_op"] and async_supported)
    overlapped = (float(e["end_flops"] - e["issue_flops"])
                  if async_pair else 0.0)
    predicted = roofline_lib.collective_seconds(
        kind, e["operand_bytes"], group_size, link_bandwidth)
    expected = (async_pair and kind in _EXPECTED_OVERLAP_KINDS
                and group_size > 1 and e["operand_bytes"] >= floor)
    if not async_pair:
        frac = None
    elif predicted > 0:
        frac = min(1.0, (overlapped / peak_flops) / predicted)
    else:
        frac = 1.0 if overlapped > 0 else 0.0
    axes = e["axes"]
    return Collective(
        name=e["name"], kind=kind, dtype=e["dtype"],
        operand_bytes=int(e["operand_bytes"]),
        output_bytes=int(e["output_bytes"]),
        group_size=int(group_size), n_groups=int(e["n_groups"]),
        axes=None if axes is None else tuple(axes),
        async_pair=async_pair,
        n_between=int(e["end_ops"] - e["issue_ops"]) if async_pair else 0,
        overlapped_flops=overlapped,
        predicted_s=float(predicted), overlap_fraction=frac,
        expected_overlap=bool(expected),
        serialized=bool(expected and overlapped == 0),
        op_name=e["op_name"][:160])


# ------------------------------ the report ------------------------------

def comms_report(step_fn=None, args: Sequence = (), *,
                 inventory: Optional[list] = None,
                 flops: Optional[float] = None,
                 device=None,
                 mesh_axis_names=None, mesh_axis_sizes=None,
                 device_kind: Optional[str] = None,
                 bandwidth_override: Optional[float] = None,
                 overlap_bytes_floor: int = OVERLAP_BYTES_FLOOR,
                 hlo_text: Optional[str] = None) -> CommsReport:
    """Run `step_fn(*args)` once on clones of `args` and inventory the
    collectives it issues.

    step_fn: any callable; a builder's step (`ddp.make_train_step`,
    `make_tp_dp_train_step`) carries `mesh_axis_names` /
    `mesh_axis_sizes`, which explicit arguments override (the default is
    `parallel.mesh.mesh_axes()`).  inventory / flops / device: a run
    already made (`compile.analyze_step(comms=True)` passes its own, so
    that the step runs once); the step is then not run again.
    hlo_text: the JAX package's saved-HLO entry; the port has no HLO
    parser (an eager step compiles no program), so it raises."""
    import torch

    if hlo_text is not None:
        raise NotImplementedError(
            "comms_report(hlo_text=): the port takes its inventory from "
            "the collective wrappers of parallel.mesh while the step "
            "runs; it has no HLO parser")
    if inventory is None:
        from apex_tpu_torch.monitor.compile.report import audit_run

        if step_fn is None:
            raise TypeError("comms_report needs a step to run (or the "
                            "inventory of a run)")
        run = audit_run(step_fn, args, inventory=True)
        inventory, flops, device = run.inventory, run.flops, run.device
        del run
    from apex_tpu_torch.monitor.compile.report import _device_info
    from apex_tpu_torch.parallel import mesh as M

    mesh_names, mesh_sizes = M.mesh_axes()
    if mesh_axis_names is None:
        mesh_axis_names = getattr(step_fn, "mesh_axis_names", mesh_names)
    if mesh_axis_sizes is None:
        mesh_axis_sizes = getattr(step_fn, "mesh_axis_sizes", mesh_sizes)
    mesh_axis_names = tuple(str(a) for a in mesh_axis_names)
    mesh_axis_sizes = tuple(int(s) for s in mesh_axis_sizes)

    backend, kind = _device_info(torch.device(device or "cpu"))
    if device_kind is None:
        device_kind = kind

    from apex_tpu_torch.monitor import flops as flops_lib
    peak = flops_lib.device_peak_flops(device_kind)
    bw, bw_src = roofline_lib.resolve_link_bandwidth(
        device_kind, override=bandwidth_override)
    # NCCL runs a collective on its own stream, so an async one can hide
    # behind compute; gloo's are sync, as XLA's are on the CPU
    async_supported = bool(inventory) and all(
        e["backend"] == "nccl" for e in inventory)
    collectives = [_build(e, peak, bw, overlap_bytes_floor,
                          async_supported) for e in inventory]

    counts: dict = {}
    bytes_by_kind: dict = {}
    total = 0
    predicted = 0.0
    serialized_bytes = 0
    for c in collectives:
        if c.group_size <= 1:
            continue  # degenerate (a one-rank group): listed, not counted
        counts[c.kind] = counts.get(c.kind, 0) + 1
        bytes_by_kind[c.kind] = bytes_by_kind.get(c.kind, 0) \
            + c.operand_bytes
        total += c.operand_bytes
        predicted += c.predicted_s
        if c.serialized:
            serialized_bytes += c.operand_bytes

    compute_s = comm_fraction = comm_bound = None
    # `is not None`: flops == 0.0 is a real answer (a collective-only
    # step is all comm), not a missing count
    if flops is not None:
        compute_s = float(flops) / peak
        denom = compute_s + predicted
        comm_fraction = predicted / denom if denom > 0 else 0.0
        comm_bound = predicted > compute_s

    return CommsReport(
        backend=backend, device_kind=device_kind,
        mesh_axis_names=mesh_axis_names, mesh_axis_sizes=mesh_axis_sizes,
        collectives=collectives, counts=counts,
        bytes_by_kind=bytes_by_kind, total_comm_bytes=total,
        link_bandwidth=bw, bandwidth_source=bw_src,
        predicted_comm_s=predicted, compute_s=compute_s,
        comm_fraction=comm_fraction, comm_bound=comm_bound,
        async_supported=async_supported,
        serialized_comm_bytes=serialized_bytes,
        overlap_ok=not any(c.serialized for c in collectives))


# ---------------------------- schema + gate ----------------------------

_REPORT_FIELDS = {
    "comms_schema_version": int, "backend": str,
    "device_kind": (str, type(None)),
    "mesh_axis_names": (list, type(None)),
    "mesh_axis_sizes": (list, type(None)),
    "collectives": list, "counts": dict, "bytes_by_kind": dict,
    "total_comm_bytes": int, "link_bandwidth": (int, float),
    "bandwidth_source": str, "predicted_comm_s": (int, float),
    "compute_s": (int, float, type(None)),
    "comm_fraction": (int, float, type(None)),
    "comm_bound": (bool, type(None)),
    "async_supported": bool, "serialized_comm_bytes": int,
    "overlap_ok": bool,
}

_COLLECTIVE_FIELDS = {
    "name": str, "kind": str, "dtype": str, "operand_bytes": int,
    "output_bytes": int, "group_size": int, "n_groups": int,
    "axes": (list, type(None)), "async_pair": bool, "n_between": int,
    "overlapped_flops": (int, float), "predicted_s": (int, float),
    "overlap_fraction": (int, float, type(None)),
    "expected_overlap": bool, "serialized": bool, "op_name": str,
}


def validate_comms_report(report: dict) -> None:
    """Raise ValueError unless `report` (the to_dict form) matches the
    current schema (the JAX package's: each package's validator accepts
    the other's reports)."""
    if not isinstance(report, dict):
        raise ValueError(f"comms report must be a dict, got "
                         f"{type(report).__name__}")
    if report.get("comms_schema_version") != COMMS_SCHEMA_VERSION:
        raise ValueError(
            f"comms_schema_version "
            f"{report.get('comms_schema_version')!r} != "
            f"{COMMS_SCHEMA_VERSION}")
    for name, typ in _REPORT_FIELDS.items():
        if name not in report:
            raise ValueError(f"missing comms report field {name!r}")
        v = report[name]
        if not isinstance(v, typ):
            raise ValueError(f"comms report field {name!r} is "
                             f"{type(v).__name__}")
        if not isinstance(typ, tuple) and typ in (int,) \
                and isinstance(v, bool):
            raise ValueError(f"comms report field {name!r} is bool")
    for i, c in enumerate(report["collectives"]):
        for name, typ in _COLLECTIVE_FIELDS.items():
            if name not in c:
                raise ValueError(
                    f"collective[{i}] missing field {name!r}")
            if not isinstance(c[name], typ):
                raise ValueError(
                    f"collective[{i}].{name} is "
                    f"{type(c[name]).__name__}")
        if c["kind"] not in COLLECTIVE_KINDS:
            raise ValueError(f"collective[{i}] unknown kind "
                             f"{c['kind']!r}")


def serialized_collectives(report) -> List[dict]:
    """The gate's findings: expected-overlap collectives whose async
    window held zero matmul flops.  Accepts a CommsReport or its dict."""
    d = report.to_dict() if hasattr(report, "to_dict") else report
    return [c for c in d["collectives"] if c.get("serialized")]


def parse_allowlist(text: str) -> List[Tuple[str, str]]:
    """`KIND location-glob` lines (fnmatch; `#` comments) accepting
    deliberately serialized collectives out of the gate (the JAX
    package's format: collective kinds as the rule column)."""
    entries = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        kind = parts[0]
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(
                f"comms allowlist line {ln}: unknown collective kind "
                f"{kind!r}")
        glob = parts[1].strip() if len(parts) > 1 else "*"
        entries.append((kind, glob))
    return entries


def apply_allowlist(findings: Sequence[dict], entries, target: str):
    """Split serialized-collective findings into (new, allowlisted);
    the glob matches `target:instruction-name`."""
    new, allowed = [], []
    for f in findings:
        loc = f"{target}:{f.get('name', '')}"
        if any(k == f.get("kind") and fnmatch.fnmatch(loc, g)
               for k, g in entries):
            allowed.append(f)
        else:
            new.append(f)
    return new, allowed


# ---------------------------- rendering ----------------------------


def _human_s(s) -> str:
    if s is None or not math.isfinite(s):
        return "n/a"
    if s >= 1.0:
        return f"{s:.2f} s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f} ms"
    return f"{s * 1e6:.0f} us"


def render_comms_table(report, label: str = "step") -> str:
    """The comms table an operator reads next to the memory budget.
    Accepts a CommsReport or its to_dict() (the crash-dump form).  Its
    labels are the JAX package's ("ICI" names the link table's
    bandwidth), so that both packages render one report dict to the
    same text (the lines for an unmeasurable plane name the port's
    reasons)."""
    r = report.to_dict() if hasattr(report, "to_dict") else dict(report)
    mesh = ""
    if r.get("mesh_axis_names") and r.get("mesh_axis_sizes"):
        mesh = " | mesh " + "x".join(
            f"{n}={s}" for n, s in zip(r["mesh_axis_names"],
                                       r["mesh_axis_sizes"]))
    lines = [
        f"=== comms: {label} ===",
        f"backend: {r.get('backend')}"
        + (f" ({r['device_kind']})" if r.get("device_kind") else "")
        + mesh
        + f" | ICI {r.get('link_bandwidth', 0) / 1e9:.0f} GB/s"
        + f" ({r.get('bandwidth_source')})",
        "| kind               | dtype |      bytes | axes   | n | "
        "async | overlap | predicted |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for c in r.get("collectives", []):
        if c.get("group_size", 1) <= 1:
            continue
        axes = ("?" if c.get("axes") is None
                else ",".join(c["axes"]) or "-")
        frac = c.get("overlap_fraction")
        overlap = ("sync" if not c.get("async_pair")
                   else f"{100 * frac:.0f}%" if frac is not None
                   else "?")
        mark = " **SER**" if c.get("serialized") else ""
        lines.append(
            f"| {c['kind']:<18} | {c['dtype']:<5} | "
            f"{_human_bytes(c['operand_bytes']):>10} | {axes:<6} | "
            f"{c['group_size']} | {str(c['async_pair']).lower():<5} | "
            f"{overlap:>7} | {_human_s(c['predicted_s']):>9} |{mark}")
    n_deg = sum(1 for c in r.get("collectives", [])
                if c.get("group_size", 1) <= 1)
    counts = r.get("counts") or {}
    by_kind = ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))
    lines.append(
        f"totals: {sum(counts.values())} collective(s) "
        f"({by_kind or 'none'}), "
        f"{_human_bytes(r.get('total_comm_bytes', 0))}"
        + (f"; {n_deg} degenerate single-device group(s) not counted"
           if n_deg else ""))
    comp = r.get("compute_s")
    if comp is not None and r.get("comm_fraction") is not None:
        verdict = "COMM-BOUND" if r.get("comm_bound") else "compute-bound"
        lines.append(
            f"roofline: predicted comm {_human_s(r['predicted_comm_s'])}"
            f" vs compute {_human_s(comp)} — "
            f"{100 * r['comm_fraction']:.0f}% of step, {verdict}")
    else:
        lines.append(
            f"roofline: predicted comm "
            f"{_human_s(r.get('predicted_comm_s'))} "
            "(no flop count — comm fraction n/a)")
    if not r.get("async_supported"):
        lines.append(
            "overlap: not measurable (no async collectives: this "
            "backend's are sync; run on NCCL for the schedule truth)")
    elif r.get("overlap_ok"):
        lines.append("overlap: ok (every expected-overlap collective's "
                     "window holds compute)")
    else:
        ser = serialized_collectives(r)
        lines.append(
            f"** {len(ser)} SERIALIZED collective(s) "
            f"({_human_bytes(r.get('serialized_comm_bytes', 0))}): "
            + "; ".join(f"{c['kind']} {c['name']} "
                        f"{_human_bytes(c['operand_bytes'])}"
                        for c in ser[:4]))
    return "\n".join(lines)


# ------------------------- runtime cross-check -------------------------

def crosscheck_rank_timing(report, timings, *,
                           field: Optional[int] = None) -> dict:
    """Close the loop between the roofline and what the step actually
    measured: `timings` is the gathered (n_ranks, k) matrix
    the rank-timing plane (`TraceConfig(rank_timing=True)`) returns.
    `field` defaults to the `allreduce_duration_s` column, resolved
    from `trace.TIMING_FIELDS` by NAME so a column reorder there can't
    silently repoint this at step time.  Returns the measured median
    across ranks,
    the report's predicted comm seconds, and their ratio — a measured/
    predicted ratio far above ~1.5 means the table bandwidth is
    optimistic for this topology (or the collective serialized behind
    something the roofline can't see); far below 1 means the table
    under-quotes the links and should be refreshed with an override."""
    import numpy as np

    if field is None:
        from apex_tpu_torch.monitor.trace import TIMING_FIELDS
        field = TIMING_FIELDS.index("allreduce_duration_s")
    r = report.to_dict() if hasattr(report, "to_dict") else dict(report)
    t = np.asarray(timings, np.float64)
    if t.ndim == 1:
        col = t  # a bare per-rank allreduce-duration vector
    elif field < t.shape[1]:
        col = t[:, field]
    else:
        # never silently repoint at another column (step time would
        # inflate the ratio and tell the operator the table is wrong)
        raise ValueError(
            f"timings has {t.shape[1]} column(s); column {field} "
            "(allreduce_duration_s) is missing — pass the full "
            "TIMING_FIELDS matrix or a 1-D allreduce vector")
    measured = float(np.median(col))
    predicted = float(r.get("predicted_comm_s") or 0.0)
    return {
        "measured_s": measured,
        "predicted_comm_s": predicted,
        "ratio": (measured / predicted) if predicted > 0 else None,
        "n_ranks": int(col.shape[0]),
    }
