"""fflint — static strategy & graph verifier for the PCG, searched
strategies, and emitted collectives.

PyTorch counterpart of ``flexflow_tpu/analysis``: the same passes, rule
ids, messages and report format, so the two packages' reports of one
graph and strategy serialize to the same JSON.

A pass-based static-analysis framework that verifies a compiled model's
parallelization BEFORE anything runs: sharding legality against the
mesh, the collective census the strategy implies vs what the simulator
priced (and, optionally, what the step emitted), layout and dtype policy,
cross-host collective ordering, and graph hygiene. Entry points:

* ``lint_model(ff)`` — lint a compiled FFModel (static passes only);
  ``lint_model(ff, hlo=<optimized-HLO text>)`` adds the emitted-side
  checks, ``hlo=True`` takes them from the step's NCCL census;
* ``model.compile(..., lint="warn"|"error")`` / ``FFConfig --lint`` —
  inline linting at compile time, before any parameter is allocated;
* ``orchestrator.plan_model(ff, n)`` — lay a model out over ``n``
  devices without executing it, so a multi-device strategy lints on one;
* ``python -m flexflow_tpu_torch.scripts.fflint --model <zoo> [--json]``
  — the CLI.

Rule catalog: README.md §fflint.
"""

from flexflow_tpu_torch.analysis.dataflow import (EdgeReshard,
                                                  classify_transition,
                                                  edge_reshard_table,
                                                  required_input_specs,
                                                  verify_rewrite_dataflow,
                                                  weight_movement_edges)
from flexflow_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                     LintReport, Severity)
from flexflow_tpu_torch.analysis.orchestrator import (LintContext,
                                                      SkipPass, all_passes,
                                                      lint_model,
                                                      run_passes)

__all__ = [
    "Diagnostic",
    "LintReport",
    "Severity",
    "LintContext",
    "SkipPass",
    "all_passes",
    "lint_model",
    "run_passes",
    "EdgeReshard",
    "classify_transition",
    "edge_reshard_table",
    "required_input_specs",
    "verify_rewrite_dataflow",
    "weight_movement_edges",
]
