"""gnn_lint: the distributed-invariant static-analysis gate.

Twin of repro/launch/gnn_lint.py. Builds one representative program per
(entry point x model x aggregation backend x sync strategy x wire codec)
cell — full-batch and mini-batch training forwards, the layer-wise
inference pass and the online serving forward — and runs every registered
rule over the ops they dispatch, the collectives their sync strategies
record, their step carries and their kernel builds (repro_torch.analysis).
The programs run on the card unless `--device cpu` is given; with
`--device cuda` and no GPU it raises. On the CPU the `pallas` cells, which
force the CUDA kernel, are skipped with an info finding. Run from the repo
root:

    PYTHONPATH=src python -m repro_torch.launch.gnn_lint --smoke \\
        --out-json gnn_lint_report.json
    PYTHONPATH=src python -m repro_torch.launch.gnn_lint --smoke \\
        --device cpu

Exit code 0 = no error-level findings; 1 = at least one violation; 2 = an
unknown rule in --rules.

The JSON report (schema "gnn-lint-report/v1"):

    {
      "schema":   "gnn-lint-report/v1",
      "programs": [name, ...],            # every program analyzed
      "rules":    [name, ...],            # every rule run
      "counts":   {"error": n, "warn": n, "info": n},
      "exit_code": 0 | 1,
      "elapsed_s": float,
      "findings": [
        {"rule": str, "program": str,
         "level": "error" | "warn" | "info",
         "message": str, "data": {...}},  # data is rule-specific detail
        ...
      ]
    }
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.core.device import DEVICES, resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.gnn_lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="where the programs run; cuda raises if no GPU is "
                        "visible")
    p.add_argument("--smoke", action="store_true",
                   help="run the full smoke grid (same as --grid smoke; "
                        "the CI gate)")
    p.add_argument("--grid", choices=("tiny", "smoke"), default=None,
                   help="program grid: 'tiny' is a seconds-fast "
                        "cross-section (recorded ops and donation only), "
                        "'smoke' is the full gate incl. collective budgets "
                        "and retrace sweeps (default: tiny)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset (default: all); "
                        "known rules are listed by --list-rules")
    p.add_argument("--out-json", default=None, metavar="PATH",
                   help="write the JSON report here ('-' for stdout)")
    p.add_argument("--inject-violation", default=None, metavar="RULE",
                   help="append a program deliberately violating RULE — "
                        "proves the gate exits non-zero")
    p.add_argument("--deadcode", action="store_true",
                   help="also run the advisory dead-export sweep "
                        "(warn-level findings; never affects exit code)")
    p.add_argument("--list-programs", action="store_true",
                   help="print the grid's program names and exit")
    p.add_argument("--list-rules", action="store_true",
                   help="print registered rules and exit")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    grid = args.grid or ("smoke" if args.smoke else "tiny")

    from repro_torch.analysis import (
        RULES, Finding, build_programs, run_rules, violation_program,
    )

    if args.list_rules:
        for name in sorted(RULES):
            print(f"{name:20s} {RULES[name].doc}")
        return 0

    rules = args.rules.split(",") if args.rules else None
    if rules:
        unknown = sorted(set(rules) - set(RULES))
        if unknown:
            print(f"unknown rules: {unknown}; known: {sorted(RULES)}",
                  file=sys.stderr)
            return 2

    device = resolve_device(args.device)
    # the fixture's programs are tiny: host-side intra-op threads cost more
    # than they save, and on a busy host they oversubscribe its cores
    # (seven CPU smoke runs at once on an 8-core host: 60 s each with them,
    # 6 s without)
    torch.set_num_threads(1)
    programs = build_programs(grid, device=device)
    if args.inject_violation:
        programs.append(violation_program(args.inject_violation, device))
    if args.list_programs:
        for prog in programs:
            print(f"{prog.kind:12s} {prog.name}")
        return 0

    report = run_rules(programs, rules)

    if args.deadcode:
        from repro_torch.analysis.deadcode import dead_exports

        for name, files in dead_exports(os.getcwd()):
            report.findings.append(Finding(
                rule="dead-code", program=files[0], level="warn",
                message=f"public export {name!r} is referenced nowhere "
                        "outside its definition",
                data={"symbol": name, "defined_in": files}))
        report.rules_run.append("dead-code")

    payload = json.dumps(report.to_dict(), indent=2)
    if args.out_json == "-":
        print(payload)
    elif args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(payload + "\n")

    by_level = {"error": [], "warn": [], "info": []}
    for f in report.findings:
        by_level.setdefault(f.level, []).append(f)
    print(f"gnn_lint: {len(report.programs_run)} programs x "
          f"{len(report.rules_run)} rules on {device} in "
          f"{report.elapsed_s:.1f}s — {len(by_level['error'])} error(s), "
          f"{len(by_level['warn'])} warning(s)")
    for f in by_level["error"] + by_level["warn"]:
        print(f"  [{f.level}] {f.rule} :: {f.program}: {f.message}")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())
