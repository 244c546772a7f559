"""fflint passes, the PyTorch counterparts of
``flexflow_tpu/analysis/passes``. Each module exports one pass class
with a stable ``name`` and a ``run(ctx) -> List[Diagnostic]``; the
rule-id ranges are

    FFL0xx  framework (internal errors)
    FFL1xx  sharding-legality
    FFL2xx  collective-inference
    FFL3xx  layout-consistency
    FFL4xx  dtype-policy
    FFL5xx  multihost-order
    FFL6xx  graph-hygiene
    FFL7xx  calibration
    FFL8xx  checkpoint-integrity

The catalog with per-rule descriptions lives in README.md §fflint.
"""
