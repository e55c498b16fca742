"""Static analysis over the port's own recorded programs.

The counterpart of repro/analysis: the PR gate `launch/gnn_lint.py` builds
one representative program per (entry point x model x backend x sync x
codec) cell, runs every registered rule over them and emits a
machine-readable JSON report — exiting non-zero on any error-level
finding. The rules are the reference's; their raw material is what eager
PyTorch can see: the aten ops a forward dispatches, the collectives the
sync strategies record and the hand kernels' launch counters. The
reference's HLO parser has no twin (eager PyTorch emits no HLO).

  dispatch.py   op recording under a TorchDispatchMode (op census,
                narrowing converts, kernel launches)
  programs.py   the analyzed-program grid + seeded violations
  rules.py      the rule registry (no-scatter, dtype-policy,
                collective-budget, donation, retrace-guard) and Report
  deadcode.py   advisory dead-export sweep over the port's own files
"""

from repro_torch.analysis.dispatch import (
    OpRecorder,
    convert_ops,
    count_primitives,
    narrowing_converts,
    primitive_names,
    record,
)
from repro_torch.analysis.programs import (
    Program,
    build_programs,
    violation_program,
)
from repro_torch.analysis.rules import (
    RULES,
    Finding,
    Report,
    check_budget,
    check_donation,
    check_narrowing,
    check_scatter,
    count_builds,
    register_rule,
    run_rules,
)

__all__ = [
    "OpRecorder",
    "convert_ops",
    "count_primitives",
    "narrowing_converts",
    "primitive_names",
    "record",
    "Program",
    "build_programs",
    "violation_program",
    "RULES",
    "Finding",
    "Report",
    "check_budget",
    "check_donation",
    "check_narrowing",
    "check_scatter",
    "count_builds",
    "register_rule",
    "run_rules",
]
