"""Donation lint — check that the step updates its state in place
(counterpart of apex_tpu/lint/donation.py).

An undonated state argument is a second full copy of the largest
buffers in the program.  In the port a donated argument is one the step
updates in place (its optimizer writes the flat buffers it was given),
and the builders carry what the check needs: `step.arg_names` labels
the arguments, `step.donate_argnums` says which the step updates in
place, and the call args give the bytes.  When the caller also has a
`CompileReport` (monitor.analyze_step, or its dict), DN302 cross-checks
the declaration against the audited run: `donation_ok=False` says the
donated arguments' storages did not come back as the step's outputs.

  DN301  an argument that names itself state (`opt_state`,
         `model_state`, ...) and is big enough to matter is not
         covered by donate_argnums.
  DN302  the runtime donation check failed: `CompileReport.donation_ok`
         is False — donated bytes did not come back as outputs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from apex_tpu_torch.lint.findings import Finding, make_finding


def _tree_bytes(tree) -> int:
    from apex_tpu_torch.monitor.compile.report import tree_bytes
    return tree_bytes(tree)


def _is_state_name(name: str) -> bool:
    n = name.lower()
    return n == "state" or n.endswith("_state") or n == "opt_state"


def run(step, args, *, program: str, config,
        arg_names: Optional[Sequence[str]] = None,
        donate_argnums: Optional[Sequence[int]] = None,
        compile_report=None) -> List[Finding]:
    findings: List[Finding] = []
    if donate_argnums is None:
        donate_argnums = getattr(step, "donate_argnums", None)
    if arg_names is None:
        arg_names = getattr(step, "arg_names", None)
    names = list(arg_names or [])
    names += [f"arg{i}" for i in range(len(names), len(args))]
    donated = set(donate_argnums or ())

    for i, (name, arg) in enumerate(zip(names, args)):
        if not _is_state_name(name) or i in donated:
            continue
        b = _tree_bytes(arg)
        if b < config.state_bytes_floor:
            continue  # a scaler/metrics pytree of scalars is noise
        findings.append(make_finding(
            "DN301", f"{program}:args[{i}]:{name}",
            f"state argument {name!r} ({b / 2**20:.1f} MiB) is not in "
            f"donate_argnums={sorted(donated)} — a second full copy of "
            "it stays alive across the step",
            hint="update the argument in place and name it in "
                 "donate_argnums (the builders' steps do), or shrink it "
                 "out of the state"))

    if compile_report is not None:
        rep = (compile_report.to_dict()
               if hasattr(compile_report, "to_dict")
               else dict(compile_report))
        if rep.get("donation_ok") is False:
            und = rep.get("undonated_bytes")
            don = rep.get("donated_bytes")
            findings.append(make_finding(
                "DN302", f"{program}:compile_report",
                f"runtime donation FAILED: {und} of {don} donated "
                "bytes did not come back as the step's outputs — the "
                "step keeps a second state copy alive despite the "
                "donation declaration",
                hint="update the donated buffers in place (a step that "
                     "returns new tensors allocates a second state; "
                     "analyze_step's budget table shows where the bytes "
                     "went)"))
    return findings
