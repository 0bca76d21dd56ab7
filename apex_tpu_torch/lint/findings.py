"""`Finding` records, the rule catalog, and the allowlist engine
(counterpart of apex_tpu/lint/findings.py, its schema: a report written
by either package validates under the other's `validate_findings`).

Every lint pass (dtype_policy / collectives / donation / hostsync)
emits `Finding`s through this module so the CLI, the CompileReport
attachment, and the flight-recorder crash dump all speak one schema.
A finding is (rule id, severity, location, message, fix hint); the
committed allowlist (`apex_tpu_torch/lint/allowlist.txt`) maps known,
accepted findings out of the gate — `apply_allowlist` splits a run's
findings into `new` (gate-failing) and `allowlisted`.

Schema stability is gated the same way the flight recorder's is:
`validate_findings` raises on drift, and `python -m apex_tpu_torch.lint
--selftest` renders the committed fixture
(`apex_tpu_torch/lint/fixture.json`) and exits nonzero when the schema
or the rendering's load-bearing markers are lost.  Bump
LINT_SCHEMA_VERSION on any field add/rename/re-semantics (and the JAX
package's with it: the two share the schema).
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Iterable, List, Optional, Sequence, Tuple

LINT_SCHEMA_VERSION = 1

SEVERITIES = ("error", "warning", "info")

# The rule catalog: id -> (default severity, one-line summary), the JAX
# package's ids and severities in the port's spellings.  Rule ids are
# namespaced by pass (DP1xx dtype-policy, CL2xx collectives, DN3xx
# donation, HS4xx host-sync) so an allowlist line reads at a glance
# which analysis it silences.
RULES = {
    # dtype-policy (the static form of Apex's cast lists)
    "DP101": ("warning", "fp32 GEMM inside a low-precision policy region"),
    "DP102": ("warning", "lossy dtype conversion round trip"),
    "DP103": ("warning", "low-precision accumulation in a large reduction"),
    "DP104": ("warning", "master-weight update math not in fp32"),
    "DP105": ("warning", "router top-k selection over low-precision gates"),
    # collectives
    "CL201": ("error", "collective over an unbound/mismatched mesh group"),
    "CL202": ("warning", "all-reduce of an all-reduced value"),
    "CL203": ("warning", "loop-invariant collective inside a loop"),
    "CL204": ("warning", "fp16 summing collective can overflow under "
                         "loss scaling"),
    "CL205": ("warning", "dead collective (result unused)"),
    "CL206": ("error", "all_to_all over an unbound/mismatched ep group"),
    "CL207": ("error", "exchange whose pairs are not one permutation"),
    # donation
    "DN301": ("warning", "state argument not covered by donate_argnums"),
    "DN302": ("error", "runtime donation failed (CompileReport.donation_ok)"),
    # host-sync hazards (AST pass)
    "HS401": ("error", ".item() on a tensor inside a device step"),
    "HS402": ("error", "float()/int()/bool() of a tensor in a device step"),
    "HS403": ("error", ".cpu()/.numpy()/.tolist()/np.asarray of a tensor "
                       "in a device step"),
    "HS404": ("warning", "branching on a tensor inside a device step"),
    "HS405": ("warning", "torch.compile constructed inside a loop"),
    "HS406": ("warning", "compiled closure over a loop-carried Python "
                         "scalar"),
}


@dataclasses.dataclass
class Finding:
    """One lint finding.  `location` is a program record path
    (`program:pipeline/clock:all_reduce[3]`) or a source location
    (`examples/foo.py:42`).  Allowlist entries match the rule id
    EXACTLY and the location by fnmatch glob (see apply_allowlist)."""

    rule: str
    severity: str
    location: str
    message: str
    hint: str = ""

    def __post_init__(self):
        if self.rule not in RULES:
            raise ValueError(f"unknown lint rule id {self.rule!r}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def make_finding(rule: str, location: str, message: str,
                 hint: str = "", severity: Optional[str] = None) -> Finding:
    """Construct a finding with the rule's default severity."""
    sev = severity or RULES[rule][0]
    return Finding(rule=rule, severity=sev, location=location,
                   message=message, hint=hint)


# ------------------------------ allowlist ------------------------------

def parse_allowlist(text: str) -> List[Tuple[str, str]]:
    """Parse allowlist lines into (rule, location-glob) pairs.

    Format, one entry per line:

        RULE location-glob   # optional comment

    Blank lines and full-line `#` comments are skipped.  The glob
    matches the finding's location with fnmatch (so `HS401
    examples/*.py:*` silences a rule across a tree).  A bare `RULE`
    with no glob matches every location — reserve that for rules that
    are wrong for this repo wholesale.
    """
    entries = []
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        rule = parts[0]
        if rule not in RULES:
            raise ValueError(
                f"allowlist line {ln}: unknown rule id {rule!r}")
        glob = parts[1].strip() if len(parts) > 1 else "*"
        entries.append((rule, glob))
    return entries


def load_allowlist(path) -> List[Tuple[str, str]]:
    with open(path) as f:
        return parse_allowlist(f.read())


def apply_allowlist(findings: Iterable[Finding],
                    allowlist: Sequence[Tuple[str, str]]):
    """Split findings into (new, allowlisted) against the entries."""
    new, allowed = [], []
    for f in findings:
        if any(f.rule == rule and fnmatch.fnmatch(f.location, glob)
               for rule, glob in allowlist):
            allowed.append(f)
        else:
            new.append(f)
    return new, allowed


# ------------------------------ report ------------------------------

@dataclasses.dataclass
class LintReport:
    """One lint run's outcome: the program/tree linted, the findings
    that gate (`new`), and the ones the committed allowlist accepted.
    `ok` is the CI bit — no new findings."""

    target: str
    new: List[Finding]
    allowlisted: List[Finding] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.new

    def to_dict(self) -> dict:
        return {
            "lint_schema_version": LINT_SCHEMA_VERSION,
            "target": self.target,
            "ok": self.ok,
            "new": [f.to_dict() for f in self.new],
            "allowlisted": [f.to_dict() for f in self.allowlisted],
        }


def validate_findings(obj: dict) -> None:
    """Raise ValueError unless `obj` is a LintReport.to_dict() of the
    current schema — the `--selftest` drift gate (mirrors
    `trace.report.validate_report`)."""
    if not isinstance(obj, dict):
        raise ValueError(f"lint report is {type(obj).__name__}, want dict")
    for k in ("lint_schema_version", "target", "ok", "new", "allowlisted"):
        if k not in obj:
            raise ValueError(f"missing lint report field {k!r}")
    if obj["lint_schema_version"] != LINT_SCHEMA_VERSION:
        raise ValueError(
            f"lint_schema_version {obj['lint_schema_version']!r} != "
            f"{LINT_SCHEMA_VERSION}")
    for group in ("new", "allowlisted"):
        if not isinstance(obj[group], list):
            raise ValueError(f"{group} is not a list")
        for i, f in enumerate(obj[group]):
            for k in ("rule", "severity", "location", "message", "hint"):
                if k not in f:
                    raise ValueError(f"{group}[{i}] missing field {k!r}")
            if f["rule"] not in RULES:
                raise ValueError(
                    f"{group}[{i}] unknown rule {f['rule']!r}")
            if f["severity"] not in SEVERITIES:
                raise ValueError(
                    f"{group}[{i}] unknown severity {f['severity']!r}")
    if bool(obj["ok"]) != (len(obj["new"]) == 0):
        raise ValueError("ok bit inconsistent with new findings")


_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}


def render_findings(report) -> str:
    """Human-readable rendering (the CLI output).  Accepts a LintReport
    or its to_dict() form (what the crash dump / fixture carries)."""
    r = report.to_dict() if hasattr(report, "to_dict") else dict(report)
    lines = [f"=== lint: {r.get('target')} ==="]
    new = sorted(r.get("new") or [],
                 key=lambda f: (_SEV_ORDER.get(f["severity"], 9),
                                f["rule"], f["location"]))
    for f in new:
        lines.append(f"{f['severity'].upper():<7} {f['rule']} "
                     f"{f['location']}")
        lines.append(f"        {f['message']}")
        if f.get("hint"):
            lines.append(f"        fix: {f['hint']}")
    allowed = r.get("allowlisted") or []
    if allowed:
        lines.append(f"({len(allowed)} allowlisted finding(s) accepted)")
    if not new:
        lines.append("clean: no new findings")
    else:
        n_err = sum(1 for f in new if f["severity"] == "error")
        lines.append(f"{len(new)} new finding(s), {n_err} error(s)")
    return "\n".join(lines)
