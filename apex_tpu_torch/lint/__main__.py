"""The lint gate of the port's steps (counterpart of scripts/lint_step.py).

usage:
  python -m apex_tpu_torch.lint [targets...] [--device cpu]
                              # default: gpt bert resnet serve moe ast
  python -m apex_tpu_torch.lint --selftest   # fixture schema-drift gate
  python -m apex_tpu_torch.lint --seeds      # every rule fires on its seed
  python -m apex_tpu_torch.lint --ast PATH...  # source pass over trees
  python -m apex_tpu_torch.lint --json       # machine-readable reports

Builds the flagship GPT-350M / BERT-Large / ResNet-50 / serving / MoE
steps (`lint.flagships`: full width on the card, the default device;
the CPU smoke sizes with `--device cpu`), records one run of each on
clones of its arguments and runs the program passes (dtype-policy,
collectives, donation), plus the AST host-sync pass over the port's
source (`apex_tpu_torch/`, `chip_smoke.py` and the port's examples).
Exit is nonzero on any finding the committed allowlist
(`apex_tpu_torch/lint/allowlist.txt`, committed empty) does not accept.

`--selftest` renders the committed fixture
(`apex_tpu_torch/lint/fixture.json`) through `validate_findings` +
`render_findings` and exits nonzero when the finding schema drifted or
the rendering lost its load-bearing markers.  `--seeds` runs the seeded
program of every rule (`lint.seeds`) on the device and exits nonzero
unless each fires its rule.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
ALLOWLIST = os.path.join(_HERE, "allowlist.txt")
FIXTURE = os.path.join(_HERE, "fixture.json")

# markers the fixture rendering must contain; losing one means the
# renderer no longer tells the story the fixture encodes
_FIXTURE_MARKERS = (
    "=== lint: fixture-step ===",
    "ERROR   CL201",
    "ERROR   CL206",
    "WARNING DP101",
    "WARNING DP105",
    "HS401 examples/torch_broken.py:12",
    "fix: cast the operands",
    "5 new finding(s), 3 error(s)",
    "(1 allowlisted finding(s) accepted)",
)


def ast_trees():
    """The source the default gate walks: the port's package, the chip
    script and the port's examples (repo-relative paths that exist)."""
    paths = [os.path.join(_ROOT, "apex_tpu_torch"),
             os.path.join(_ROOT, "chip_smoke.py")]
    paths += sorted(glob.glob(os.path.join(_ROOT, "examples", "torch_*.py")))
    return [p for p in paths if os.path.exists(p)]


def selftest() -> int:
    from apex_tpu_torch import lint

    with open(FIXTURE) as f:
        rep = json.load(f)
    try:
        lint.validate_findings(rep)
        text = lint.render_findings(rep)
    except ValueError as e:
        print(f"lint --selftest: SCHEMA DRIFT — {e}", file=sys.stderr)
        print("(bump-side change? update apex_tpu_torch/lint/fixture.json "
              "to the new schema)", file=sys.stderr)
        return 1
    missing = [m for m in _FIXTURE_MARKERS if m not in text]
    if missing:
        print(text)
        print(f"lint --selftest: rendering lost expected markers: "
              f"{missing}", file=sys.stderr)
        return 1
    print(text)
    print("lint --selftest: OK")
    return 0


def seeds(device) -> int:
    from apex_tpu_torch.lint import seeds as seeds_lib

    missed = []
    for rule in seeds_lib.SEEDS:
        got = seeds_lib.fire(rule, device)
        print(f"{rule}: {len(got)} finding(s)"
              + (f" at {got[0].location}" if got else ""))
        if not got:
            missed.append(rule)
    if missed:
        print(f"lint --seeds: no finding for {missed}", file=sys.stderr)
        return 1
    print(f"lint --seeds: all {len(seeds_lib.SEEDS)} rules fire")
    return 0


def main(argv=None) -> int:
    from apex_tpu_torch.lint import flagships

    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.lint",
        description="lint gate of the port's flagship steps")
    ap.add_argument("targets", nargs="*",
                    help=f"subset of {sorted(flagships.BUILDERS)} + 'ast' "
                         "(default: all)")
    ap.add_argument("--selftest", action="store_true",
                    help="render the committed fixture; exit 1 on "
                         "schema drift")
    ap.add_argument("--seeds", action="store_true",
                    help="run every rule's seeded program; exit 1 unless "
                         "each fires")
    ap.add_argument("--ast", nargs="+", metavar="PATH", default=None,
                    help="ONLY run the AST pass over these paths")
    ap.add_argument("--allowlist", default=ALLOWLIST,
                    help="allowlist file (default: the committed one)")
    ap.add_argument("--json", action="store_true",
                    help="print LintReport JSON lines instead of text")
    ap.add_argument("--device", default=None,
                    help="where the steps run (default: the card; 'cpu' "
                         "for the CPU smoke sizes)")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if args.seeds:
        return seeds(args.device)

    from apex_tpu_torch import lint
    from apex_tpu_torch.parallel import mesh as M

    allowlist = (lint.load_allowlist(args.allowlist)
                 if os.path.exists(args.allowlist) else [])
    reports = []
    if args.ast is not None:
        targets, ast_paths = [], args.ast
    else:
        targets = args.targets or sorted(flagships.BUILDERS) + ["ast"]
        bad = [t for t in targets
               if t != "ast" and t not in flagships.BUILDERS]
        if bad:
            ap.error(f"unknown target(s) {bad}; choices: "
                     f"{sorted(flagships.BUILDERS) + ['ast']}")
        ast_paths = ast_trees() if "ast" in targets else []
    for t in targets:
        if t == "ast":
            continue
        rep, _ = flagships.lint_target(t, args.device, allowlist=allowlist)
        reports.append(rep)
        M.destroy_model_parallel()
    if ast_paths:
        findings = lint.lint_paths(ast_paths, root=_ROOT)
        new, allowed = lint.apply_allowlist(findings, allowlist)
        reports.append(lint.LintReport(target="ast", new=new,
                                       allowlisted=allowed))

    rc = 0
    for rep in reports:
        if args.json:
            print(json.dumps(rep.to_dict()))
        else:
            print(lint.render_findings(rep))
            print()
        if not rep.ok:
            rc = 1
    if not args.json:
        verdict = "CLEAN" if rc == 0 else "FINDINGS — gate fails"
        print(f"lint: {len(reports)} target(s), {verdict}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
