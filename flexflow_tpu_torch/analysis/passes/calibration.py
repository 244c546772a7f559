"""calibration: is the cost model the search just used trustworthy?

PyTorch counterpart of ``flexflow_tpu/analysis/passes/calibration.py``.
It reads the port's calibration file (``search/profile.py``
``calibration_path``: ``FFS_CALIBRATION_FILE``, else the repo root's
``CALIBRATION_GPU.json``; never the JAX package's ``CALIBRATION.json``)
and the port's learned table (``costmodel``), and the platform it audits
is the model's device: ``"gpu"`` on CUDA, ``"cpu"`` otherwise.


The recalibration loop (``python -m flexflow_tpu_torch.scripts.calibrate
--ingest-drift``) folds observed predicted-vs-measured drift from real
training runs into the calibration file as per-op-type correction
factors, which
search/profile.py applies to the measured tables it feeds the native
simulator. This pass audits a searched strategy against that state:

* FFL701  the search priced ops with the analytic roofline only — no
          microbenchmarks (--search-measure-ops) and no ingested drift
          corrections exist for this platform;
* FFL702  op types in this graph carry no correction factor while other
          types do (their relative pricing is the raw analytic model —
          exactly the asymmetry that mis-ranks candidate strategies);
* FFL703  calibration data exists but was taken on a different
          platform/device — stale for this machine.
* FFL704  (INFO) the search priced op classes with a LEARNED cost model
          (``flexflow_tpu_torch/costmodel``) whose held-out error for that class
          exceeds the calibration tolerance — a stale or low-coverage
          model: its rankings for those classes deserve a fresh corpus
          (re-trace + scripts/costmodel.py train) before being trusted.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, info, warning
# the port's calibration file: FFS_CALIBRATION_FILE, else the repo
# root's CALIBRATION_GPU.json
from flexflow_tpu_torch.search.profile import calibration_path


def load_calibration() -> Optional[Dict[str, Any]]:
    try:
        with open(calibration_path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


class CalibrationPass:
    name = "calibration"

    def run(self, ctx) -> List[Diagnostic]:
        if not ctx.searched:
            from flexflow_tpu_torch.analysis.orchestrator import SkipPass
            raise SkipPass("strategy is heuristic (not searched) — "
                           "cost-model calibration does not gate it")
        diags: List[Diagnostic] = []
        cal = load_calibration()
        # op_corrections is platform-first: {platform: {op type: entry}}
        # (scripts/calibrate.py derive_op_corrections) — only the
        # current platform's bucket ever scales measured tables
        all_corrections = (cal or {}).get("op_corrections", {})
        platform = _current_platform(ctx)
        corrections = (all_corrections.get(platform, {})
                       if platform is not None else {})
        measured_ran = bool(ctx.config is not None
                            and getattr(ctx.config, "search_measure_ops",
                                        False))
        learned_ran = bool(
            isinstance(getattr(getattr(ctx, "ff", None), "search_info",
                               None), dict)
            and ctx.ff.search_info.get("cost_model") == "learned")
        if not all_corrections and not measured_ran:
            if not learned_ran:
                # learned pricing IS measurement-derived: when it
                # engaged, the "priced purely analytically" warning is
                # wrong — the staleness audit below applies instead
                diags.append(warning(
                    "FFL701",
                    "search priced every op from the analytic roofline: "
                    "no --search-measure-ops microbenchmarks and no "
                    "ingested drift corrections",
                    hint="run a traced fit (--trace-dir) then "
                         "scripts/calibrate.py --ingest-drift TRACE_DIR "
                         "to close the loop"))
            diags.extend(self._learned_model_diags(ctx, cal))
            return diags
        if cal is not None and platform is not None:
            cal_platform = cal.get("platform")
            if cal_platform and cal_platform != platform:
                diags.append(warning(
                    "FFL703",
                    f"calibration data is from platform "
                    f"{cal_platform!r}; this run is on {platform!r}",
                    hint="re-run scripts/calibrate.py on this machine — "
                         "cross-platform correction factors mislead the "
                         "search"))
        if all_corrections and not corrections:
            diags.append(warning(
                "FFL703",
                f"drift corrections exist only for platform(s) "
                f"{', '.join(sorted(all_corrections))} — none apply on "
                f"{platform!r}",
                hint="re-ingest drift observed on this platform"))
        if corrections:
            graph_types = {n.op.op_type.name for n in ctx.nodes
                           if n.op.flops() > 0}
            missing = sorted(t for t in graph_types
                             if t not in corrections)
            if missing and len(missing) < len(graph_types):
                diags.append(warning(
                    "FFL702",
                    f"no drift correction for op types "
                    f"{', '.join(missing)} while "
                    f"{len(graph_types) - len(missing)} other type(s) "
                    f"are corrected — relative pricing is skewed",
                    hint="ingest drift from a run containing these ops "
                         "(scripts/calibrate.py --ingest-drift)"))
        diags.extend(self._learned_model_diags(ctx, cal))
        return diags

    def _learned_model_diags(self, ctx, cal) -> List[Diagnostic]:
        """FFL704: this strategy was priced by a learned cost model
        whose held-out error for one of the graph's op classes exceeds
        the calibration tolerance (stale / low-coverage model). Keyed
        off the search's own provenance (search_info.cost_model ==
        "learned") so the lint only fires when learned pricing actually
        engaged, and off the COSTMODEL.json artifact's per-class
        held-out error — the number the trainer measured, not a
        re-derivation (the port's ``COSTMODEL_GPU.json`` or
        ``FFS_COSTMODEL_FILE``)."""
        search_info = getattr(getattr(ctx, "ff", None), "search_info",
                              None)
        if not isinstance(search_info, dict) \
                or search_info.get("cost_model") != "learned":
            return []
        try:
            from flexflow_tpu_torch.costmodel import load_model
            model = load_model()
        except Exception:
            return []
        if model is None:
            return []
        tolerance = float((cal or {}).get("tolerance", 0.25))
        graph_types = {n.op.op_type.name for n in ctx.nodes
                       if n.op.flops() > 0}
        diags: List[Diagnostic] = []
        for cname in sorted(graph_types & set(model.classes)):
            cm = model.classes[cname]
            if cm.err_factor - 1.0 <= tolerance:
                continue
            diags.append(info(
                "FFL704",
                f"search priced {cname} with a learned cost model whose "
                f"held-out error is x{cm.err_factor:.2f} "
                f"(> {1 + tolerance:.2f}x calibration tolerance; "
                f"{cm.n_train} training rows, {cm.n_test} held out) — "
                f"stale or low-coverage model for this class",
                hint="collect more traces for this op class (traced "
                     "fits with --search-measure-ops, or "
                     "scripts/roofline.py) and re-run "
                     "scripts/costmodel.py train"))
        return diags


def _current_platform(ctx) -> Optional[str]:
    """The platform of the model's device: ``"gpu"`` on CUDA, else
    ``"cpu"`` (a context without a model: whether a card is visible)."""
    dev = getattr(getattr(ctx, "ff", None), "device", None)
    if dev is None:
        import torch
        return "gpu" if torch.cuda.is_available() else "cpu"
    return "gpu" if dev.type == "cuda" else "cpu"
