"""Collective lint — group and placement analysis of the collectives a
step issues (counterpart of apex_tpu/lint/collectives.py, over the
program record of `lint.engine`).

Every collective of the port goes through `parallel.mesh`'s wrappers,
so the record holds each one with its group; a group stands for the
mesh axis sets whose group it is (`engine.group_axis_sets`).

  CL201  a collective over a group that is not one of the mesh's
         (unbound), or whose axes are not among the step's mesh axes
         (`LintConfig.expected_axes`, default the step's
         `mesh_axis_names`): the collective reduces the wrong ranks.
  CL202  an all-reduce (sum) of a value an all-reduce over the same
         axes already produced (through a scaling by a scalar, which is
         what an average is): the second multiplies by the group size
         or is redundant traffic.
  CL203  a loop-invariant collective inside a loop: its operand derives
         only from values written before the loop, read in the same
         place in every iteration (an iteration is a ``<loop>#<i>``
         range, `ops._common.loop_iteration`) — every iteration pays for
         bytes that never change.
  CL204  a float16 operand of a summing collective (an all-reduce sum
         or average, a reduce-scatter): under loss scaling the summands
         approach fp16's 65504 and the overflow happens inside the
         collective.  bf16 carries fp32's exponent and is exempt.
  CL205  a dead collective: no later op reads what it wrote and it is
         not part of the step's outputs or updated arguments.
  CL206  an `all_to_all` over an unbound or mismatched group (the CL201
         hazard with token-routing stakes), or over the dp group while
         the mesh carries an expert-parallel "ep" axis: the dp/ep
         transposition that scrambles tokens across data-parallel
         replicas instead of expert peers.
  CL207  an `exchange` (a `ring_hop`, a halo exchange, a pipeline
         shift) whose (destination, source) pairs are not one
         permutation of its group: a rank sends with one shift and
         receives with another, or names a rank outside the group, so
         some receive is never matched.  The linter does not issue such
         an exchange (the run would hang), and reports it.
"""

from __future__ import annotations

from typing import List

from apex_tpu_torch.lint import engine as E
from apex_tpu_torch.lint.findings import Finding, make_finding

_SUMS = ("sum", "avg")
_SCALINGS = ("div", "mul", "div_", "mul_")


def _axes_text(axes) -> list:
    return sorted("+".join(sorted(a)) for a in axes)


def _summing(op: E.Op) -> bool:
    return op.name == "reduce_scatter" or (
        op.name == "all_reduce" and (op.reduce_op or "sum") in _SUMS)


def _through_scaling(record, writers, hops: int = 2):
    """The ops that produced a value, walked back through scalings by a
    scalar (an average is a sum divided by the group size)."""
    out = []
    stack = [(w, hops) for w in writers]
    while stack:
        i, left = stack.pop()
        op = record.ops[i]
        if (op.kind == "aten" and op.name in _SCALINGS and left > 0
                and op.reads and (len(op.in_shapes) < 2
                                  or E._numel(op.in_shapes[1]) == 1)):
            stack += [(w, left - 1) for w in op.reads[0]]
            continue
        out.append(op)
    return out


def _invariant_ops(record) -> set:
    """Ops inside a loop iteration that derive only from values written
    before the loop's first iteration (or from such ops of their own
    iteration), read at the same place in every iteration."""
    ops = record.ops
    # the same op in every iteration: (loop id, path, name, ordinal)
    geometry = {}
    for op in ops:
        if not op.loops:
            continue
        loop, _ = op.loops[-1]
        start = record.loop_starts[loop]
        pre = tuple((k, g) for k, g, w in zip(op.in_keys, op.geometry,
                                               op.reads)
                    if all(j < start for j in w))
        key = (loop, op.path, op.name, op.ordinal)
        geometry.setdefault(key, set()).add(pre)
    inv = set()
    for op in ops:
        if not op.loops:
            continue
        loop, it = op.loops[-1]
        start = record.loop_starts[loop]
        if len(geometry[(loop, op.path, op.name, op.ordinal)]) != 1:
            continue
        ok = True
        for w in op.reads:
            for j in w:
                if j < start:
                    continue
                src = ops[j]
                if not (j in inv and src.loops and src.loops[-1]
                        == (loop, it)):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            inv.add(op.index)
    return inv


def run(record, *, program: str, config: E.LintConfig) -> List[Finding]:
    findings: List[Finding] = []
    expected = (frozenset(str(a) for a in config.expected_axes)
                if config.expected_axes is not None else None)
    mesh_axes, _ = E.M.mesh_axes()
    inv = _invariant_ops(record)

    for op in record.collectives():
        loc = op.location(program)
        axes = op.axes

        # ---- CL201: unbound / mismatched group ----
        bound_ok = axes is not None
        declared_ok = (not bound_ok or expected is None
                       or any(a <= expected for a in axes))
        if not bound_ok:
            findings.append(make_finding(
                "CL201", loc,
                f"{op.name} runs over a process group that is none of the "
                "mesh's groups — the program binds only the mesh's "
                f"{sorted(mesh_axes)} axes",
                hint="issue the collective over the mesh's group "
                     "(parallel.mesh.group_of(axis)); a collective over "
                     "another group reduces the wrong ranks"))
        elif not declared_ok:
            findings.append(make_finding(
                "CL201", loc,
                f"{op.name} runs over the {_axes_text(axes)} group but the "
                f"declared mesh carries only {sorted(expected)}",
                hint="issue the collective over a group of the declared "
                     "axes (or fix the axis name); a collective over the "
                     "wrong axis reduces the wrong ranks"))

        # ---- CL206: all_to_all off the expert-parallel group ----
        if op.name == "all_to_all":
            if not bound_ok or not declared_ok:
                have = (sorted(mesh_axes) if not bound_ok
                        else sorted(expected))
                findings.append(make_finding(
                    "CL206", loc,
                    "all_to_all exchanges over "
                    + ("a group that is none of the mesh's"
                       if not bound_ok else
                       f"the {_axes_text(axes)} group")
                    + f" but the mesh carries only {have} — the expert "
                    "dispatch/combine would trade tokens with the wrong "
                    "peers",
                    hint="set the ep size in the mesh "
                         "(initialize_model_parallel(expert_model_"
                         "parallel_size=...)) and exchange over "
                         "group_of('ep')"))
            elif ("ep" in mesh_axes and not any("ep" in a for a in axes)
                    and any("dp" in a for a in axes)):
                findings.append(make_finding(
                    "CL206", loc,
                    f"all_to_all rides the {_axes_text(axes)} group while "
                    "the mesh carries an expert-parallel 'ep' axis — "
                    "expert dispatch/combine must exchange over ep; a "
                    "dp/ep transposition scrambles tokens across "
                    "data-parallel replicas instead of expert peers",
                    hint="pass the ep axis (mesh.EP_AXIS) to the "
                         "exchange, or allowlist if this all_to_all is "
                         "deliberately non-expert traffic"))

        # ---- CL207: an exchange that is not one permutation ----
        if op.name == "exchange" and not E.exchange_is_permutation(
                op.pairs, op.group_rank, op.group_size):
            findings.append(make_finding(
                "CL207", loc,
                f"exchange pairs {list(op.pairs)} (destination, source) "
                f"seen from rank {op.group_rank} of a {op.group_size}-rank "
                "group are not one permutation of the group — some "
                "receive is never matched (the linter did not issue it: "
                "the step would hang or fail)",
                hint="each rank sends to (r + shift) % n and receives "
                     "from (r - shift) % n with one shift, the ring hop "
                     "of parallel.collectives.ring_hop"))

        # ---- CL202: all-reduce of an all-reduced value ----
        if op.name == "all_reduce" and _summing(op) and axes:
            for src in _through_scaling(record, op.reads[0]
                                        if op.reads else ()):
                if (src.kind == "collective" and src.name == "all_reduce"
                        and _summing(src) and src.axes
                        and any(a & b for a in axes for b in src.axes)):
                    findings.append(make_finding(
                        "CL202", loc,
                        f"all_reduce over {_axes_text(axes)} of a value "
                        "already all-reduced over the same group — the "
                        "second reduction multiplies by the group size "
                        "(or is pure redundant traffic)",
                        hint="drop one reduction; if the first was an "
                             "average keep ONLY it"))
                    break

        # ---- CL203: loop-invariant collective in a loop ----
        if op.index in inv:
            findings.append(make_finding(
                "CL203", loc,
                f"{op.name} inside a loop has loop-invariant operands — "
                "every iteration pays the collective for bytes that "
                "never change",
                hint="hoist the collective above the loop and reuse its "
                     "result"))

        # ---- CL204: fp16 summing collective ----
        if _summing(op) and op.in_dtypes and op.in_dtypes[0] == "float16":
            findings.append(make_finding(
                "CL204", loc,
                f"{op.name} sums float16 operands — under loss scaling "
                "the summands approach fp16's 65504 max and the overflow "
                "happens inside the collective, invisible to the "
                "finite-check",
                hint="unscale or upcast to float32/bfloat16 before the "
                     "collective (bf16 carries fp32's exponent range)"))

        # ---- CL205: dead collective ----
        if op.out_keys and not record.used(op.index):
            findings.append(make_finding(
                "CL205", loc,
                f"{op.name} result is never used (no later op reads it, "
                "and it is not an output of the step) — the step pays a "
                "collective it throws away",
                hint="delete the call (a stale metrics line, usually)"))
    return findings
