"""checkpoint-integrity: will this run's checkpoint actually restore?

PyTorch counterpart of ``flexflow_tpu/analysis/passes/checkpoint.py``,
over the port's ``ckpt`` (``manifest.verify_step_dir``, and the mesh
comparison ``ckpt/elastic.plan_resume`` acts on), which reads and writes
the JAX package's checkpoint format.


Audits the configured checkpoint directory (``--checkpoint-dir``)
against the COMPILED model before training commits to it — the failure
modes that otherwise only surface hours later, at restore time on a
degraded fleet:

* FFL801  the directory holds step directories but NO complete
          (manifest-committed) checkpoint — every save so far died
          before its commit record, so a preemption now loses the run;
* FFL802  the newest complete checkpoint fails deep verification
          (missing shard files, checksum mismatches, shard boxes that
          do not tile a leaf) — on-disk corruption a resume would
          refuse;
* FFL803  the checkpoint's saved state tree is incompatible with the
          live model (leaf missing / extra / global-shape mismatch) —
          the graph changed since the save and resume will raise;
* FFL804  (INFO) the checkpoint was taken on a different mesh — legal,
          the elastic re-shard path engages on load; stated so a
          reviewer knows resume will re-place every shard.

Skips (not "clean") when no checkpoint directory is configured or the
directory is still empty (a fresh launch). The byte-level FFL802
re-read is gated to checkpoints up to ``DEEP_VERIFY_MAX_BYTES``
(256 MB): the lint pipeline runs at compile/startup time, and
re-checksumming a multi-GB checkpoint there would cost minutes of
blocking I/O — above the gate the pass checks structure only
(manifest/index presence, shard-key existence, coverage arithmetic)
and ``python -m flexflow_tpu_torch.scripts.ckpt_inspect`` remains the
offline home of the full rot scan.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, error, info


DEEP_VERIFY_MAX_BYTES = 256 << 20


class CheckpointIntegrityPass:
    name = "checkpoint-integrity"

    def run(self, ctx) -> List[Diagnostic]:
        from flexflow_tpu_torch.analysis.orchestrator import SkipPass

        cdir = getattr(ctx.config, "checkpoint_dir", None) \
            if ctx.config is not None else None
        if not cdir:
            raise SkipPass("no checkpoint directory configured "
                           "(--checkpoint-dir)")
        from flexflow_tpu_torch.ckpt import manifest as mf
        steps = mf.list_steps(cdir)
        if not steps:
            raise SkipPass(f"checkpoint directory '{cdir}' holds no "
                           f"checkpoints yet (fresh launch)")
        diags: List[Diagnostic] = []
        complete = [(s, p) for s, p, ok in steps if ok]
        if not complete:
            diags.append(error(
                "FFL801",
                f"checkpoint directory '{cdir}' holds "
                f"{len(steps)} step director{'ies' if len(steps) != 1 else 'y'} "
                f"but not one complete checkpoint — every save died before "
                f"its manifest commit",
                hint="check the writer logs (fs barrier timeouts point at "
                     "a non-shared filesystem); a preemption now would "
                     "lose the run"))
            return diags
        step, step_dir = complete[-1]
        rep = mf.verify_step_dir(step_dir, deep=False)
        if not rep["errors"] and rep["payload_bytes"] <= DEEP_VERIFY_MAX_BYTES:
            rep = mf.verify_step_dir(step_dir, deep=True)
        for msg in rep["errors"]:
            diags.append(error(
                "FFL802",
                f"checkpoint step {step}: {msg}",
                hint="scripts/ckpt_inspect.py shows the full report; "
                     "restore refuses corrupt checkpoints, so fix or GC "
                     "this one"))
        manifest = rep["manifest"] or {}
        diags.extend(self._tree_compat(ctx, manifest, step))
        mesh_saved = {k: int(v)
                      for k, v in (manifest.get("mesh") or {}).items()}
        mesh_live = dict(ctx.axis_sizes)
        if mesh_saved and mesh_saved != mesh_live:
            diags.append(info(
                "FFL804",
                f"checkpoint step {step} was saved on mesh {mesh_saved}; "
                f"the live mesh is {mesh_live} — elastic resume will "
                f"reassemble every leaf from the shard index and re-place "
                f"it onto the live strategy's shardings",
                hint="expected after a topology change; the recorded "
                     "strategy is only reusable verbatim on the saved "
                     "mesh (ckpt/elastic.plan_resume)"))
        return diags

    def _tree_compat(self, ctx, manifest: Dict[str, Any],
                     step: int) -> List[Diagnostic]:
        """Diff the manifest's params subtree against the LIVE params
        tree (global shapes) — the structure restore will demand."""
        ff = ctx.ff
        if ff is None or not manifest.get("leaves"):
            return []
        from flexflow_tpu_torch.ckpt.tree import flatten_tree
        live = {f"params/{k}": tuple(int(d) for d in v.shape)
                for k, v in flatten_tree(ff.params)
                if hasattr(v, "shape")}
        saved = {k: tuple(int(d) for d in meta["shape"])
                 for k, meta in manifest["leaves"].items()
                 if k.startswith("params/")}
        out: List[Diagnostic] = []
        for k in sorted(set(live) | set(saved)):
            op = k.split("/")[1] if "/" in k else None
            if k not in saved:
                out.append(error(
                    "FFL803",
                    f"checkpoint step {step} has no leaf '{k}' the live "
                    f"model requires — the graph changed since the save "
                    f"and resume will fail",
                    op=op, tensor=k,
                    hint="restore into the model architecture that "
                         "saved, or start fresh"))
            elif k not in live:
                out.append(error(
                    "FFL803",
                    f"checkpoint step {step} carries leaf '{k}' the live "
                    f"model does not own — structure mismatch at resume",
                    op=op, tensor=k,
                    hint="restore into the model architecture that "
                         "saved, or start fresh"))
            elif saved[k] != live[k]:
                out.append(error(
                    "FFL803",
                    f"checkpoint step {step} leaf '{k}' has global shape "
                    f"{list(saved[k])} but the live model expects "
                    f"{list(live[k])}",
                    op=op, tensor=k,
                    hint="parameter shapes must match across resume "
                         "(shardings may differ; shapes may not)"))
        return out
