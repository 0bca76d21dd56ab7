"""apex_tpu_torch.lint — the linter of the port's steps (counterpart of
apex_tpu/lint: the same rules, ids and severities, and the same report
schema).

The correctness gate in front of execution: where the monitor
*observes* the running program, this package *checks* it.  Four passes:

  dtype_policy — the static form of Apex's AMP cast lists: fp32 GEMMs
                 in low-precision programs, lossy conversion round
                 trips, low-precision accumulation, non-fp32 master
                 updates, low-precision router selection (DP1xx)
  collectives  — collectives over groups the mesh does not have or the
                 step does not declare, all-reduces of all-reduced
                 values, loop-invariant collectives, fp16 sums under
                 loss scaling, dead collectives, misrouted expert
                 exchanges, exchanges that are not one permutation
                 (CL2xx)
  donation     — donate_argnums coverage of the state arguments plus
                 the cross-check against `monitor.analyze_step`'s
                 donation_ok (DN3xx)
  hostsync     — the Python-AST pass: .item(), float(tensor), host
                 copies, branching on a tensor, torch.compile in a loop,
                 loop-carried scalar closures inside device steps (HS4xx,
                 the static complement of RecompileSentry)

The program passes read a record of one run of the step on clones of
its arguments (`engine`: the ATen ops forward and backward, the
collectives and the port's own kernel launches), not a traced graph:
the port's kernels are launched where no tracer can follow.

Entry points: `lint_step(step, args)` for built steps (reads the
builder-attached arg_names/donate_argnums/mesh_axis_names),
`lint_program(fn, args)` for any callable, `lint_paths([dirs])` for the
source pass.  `python -m apex_tpu_torch.lint` is the gate (nonzero exit
on findings outside the committed allowlist,
`apex_tpu_torch/lint/allowlist.txt`); findings also attach to
`monitor.analyze_step(..., lint=True)` reports.
"""

from apex_tpu_torch.lint.engine import (  # noqa: F401
    COLLECTIVE_PRIMS,
    LOW_PRECISION,
    LintConfig,
    Record,
    Recorder,
    collect_views,
    lint_program,
    lint_step,
    record_program,
    trace_jaxpr,
)
from apex_tpu_torch.lint.findings import (  # noqa: F401
    LINT_SCHEMA_VERSION,
    RULES,
    SEVERITIES,
    Finding,
    LintReport,
    apply_allowlist,
    load_allowlist,
    make_finding,
    parse_allowlist,
    render_findings,
    validate_findings,
)
from apex_tpu_torch.lint.hostsync import (  # noqa: F401
    lint_paths,
    lint_source,
    lint_source_text,
)
