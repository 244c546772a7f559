"""Train-anywhere / serve-anywhere: deploy a checkpoint manifest.

PyTorch counterpart of ``flexflow_tpu/serve/loader.py``. The v2 per-shard
checkpoint (``flexflow_tpu_torch/ckpt``, or one the JAX package wrote)
records everything a serving process needs: the arrays behind a shard
index, the mesh they were saved on, and the strategy they trained under.
``load_for_serving`` turns that manifest into a compiled INFERENCE model
on this process's one device:

1. ``ckpt/elastic.plan_resume`` classifies the live device count against
   the saving mesh (reuse vs re-search);
2. the model compiles in ``CompMode.INFERENCE``: with a search budget, a
   latency-objective re-search for the serving topology; without one, a
   same-topology deploy reuses the recorded strategy verbatim (its kernel
   choices with it), and a changed topology takes the heuristic default;
3. ``ckpt/sharded.load_sharded(include_opt_state=False)`` reassembles the
   params and op state from the shard index, skipping the optimizer
   moments (an INFERENCE compile allocates none), into the live tensors;
4. ``predict`` and ``serve()`` run the Conv+BN-folded graph
   (``GraphExecutor._inference_nodes``).

``.serve()`` on the result starts the port's ``ServingEngine``.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import Optional

from flexflow_tpu_torch.ffconst import CompMode, LossType
from flexflow_tpu_torch.obs.registry import get_registry


def load_for_serving(manifest_dir: str, ff, *,
                     mesh=None,
                     search_budget: Optional[int] = None,
                     loss_type: LossType = None,
                     machine_spec=None,
                     verify: bool = True):
    """Compile ``ff`` (a built, NOT-yet-compiled FFModel whose layer
    graph matches the checkpointed model) for INFERENCE and restore the
    manifest's params and op state onto it.

    ``mesh`` forces an explicit serving mesh (skipping the search);
    ``search_budget`` (default: 8 when the native search core can be
    built here and no mesh is given, else 0) re-searches
    latency-objective shardings; ``verify=False`` skips shard CRC
    verification on restore. Returns ``ff``, compiled and loaded, with
    ``ff.serve_load_info`` describing what happened."""
    from flexflow_tpu_torch.ckpt import elastic, sharded
    from flexflow_tpu_torch.model import devices_to_run
    from flexflow_tpu_torch.search.native import available

    t0 = time.perf_counter()
    manifest = elastic.load_manifest(manifest_dir)
    n_live = (mesh.size if mesh is not None
              else devices_to_run(ff.config, ff.device))
    plan = elastic.plan_resume(manifest, n_live)
    if search_budget is None:
        search_budget = 8 if (mesh is None and available()) else 0

    cfg = ff.config
    # every compile-steering knob this loader touches is restored after
    # the compile: the config object may be shared with other models
    saved_knobs = {k: getattr(cfg, k)
                   for k in ("search_budget", "enable_parameter_parallel",
                             "only_data_parallel", "import_strategy_file")}
    strategy_tmp = None
    mode = "heuristic"
    if mesh is not None:
        mode = "explicit-mesh"
    elif search_budget > 0:
        # a latency-objective re-search: even on the saving topology the
        # INFERENCE objective may pick another strategy than training did
        cfg.search_budget = int(search_budget)
        cfg.enable_parameter_parallel = True
        cfg.only_data_parallel = False
        mode = "latency-research"
    elif plan["action"] == "reuse" and manifest.get("strategy"):
        # no search, same topology: the recorded strategy verbatim
        fd, strategy_tmp = tempfile.mkstemp(suffix=".strategy.json")
        os.close(fd)
        elastic.write_saved_strategy(manifest, strategy_tmp)
        cfg.import_strategy_file = strategy_tmp
        mode = "reused-saved-strategy"

    try:
        ff.compile(optimizer=None,
                   loss_type=loss_type or LossType.
                   SPARSE_CATEGORICAL_CROSSENTROPY,
                   comp_mode=CompMode.INFERENCE,
                   machine_spec=machine_spec, mesh=mesh)
    finally:
        if strategy_tmp is not None:
            try:
                os.unlink(strategy_tmp)
            except OSError:
                pass
        for k, v in saved_knobs.items():
            setattr(cfg, k, v)
    it = sharded.load_sharded(manifest_dir, ff, verify=verify,
                              include_opt_state=False)
    get_registry().gauge("serve/load_restore_s", time.perf_counter() - t0)
    ff.serve_load_info = dict(
        step=int(manifest.get("step", it)),
        iteration=it,
        plan=plan,
        mode=mode,
        saved_mesh=plan["saved_mesh"],
        live_mesh=dict(ff.mesh.shape),
        saved_objective=(manifest.get("strategy") or {}).get("objective"),
        objective=getattr(ff, "search_objective", None),
        cross_mesh=not elastic.strategy_matches_mesh(manifest, ff.mesh),
        # the per-op kernel choices the deployed model executes
        kernel_choices=getattr(ff, "kernel_choices", None),
    )
    if os.environ.get("FFS_SERVE_VERBOSE"):
        print(f"[serve] load_for_serving: {ff.serve_load_info}",
              file=sys.stderr)
    return ff
