"""Preemption-aware elastic resume planning.

PyTorch counterpart of ``flexflow_tpu/ckpt/elastic.py``: the same plan
for the same manifest and device count. The port's devices are the ranks
of its process group (one rank a device), so a resume on the saving rank
count reuses the recorded strategy, and one on another count compiles
with a search in the group (rank 0 searches, every rank takes its pick)
before ``load_sharded`` re-cuts every leaf onto the new boxes.

The PCG + strategy decode make resume onto a DIFFERENT topology cheap
for this framework: the checkpoint stores logically-global arrays (a
shard index over the saving mesh) plus the searched strategy it ran
under, and ``FFModel.compile`` already knows how to search a strategy
for whatever devices survived. Resume is therefore a strategy decision,
not a crash:

* same device count → reuse the recorded strategy verbatim (write it to
  a strategy file and compile with ``import_strategy_file`` — zero
  search cost, identical shardings, bit-identical continuation);
* different device count → compile with a search budget for the
  surviving topology; ``load_sharded`` then reassembles each global
  array from the shard index and places it onto the new strategy.

``plan_resume`` encodes that decision; ``serve/loader.py`` consumes it.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from flexflow_tpu_torch.ckpt import manifest as mf


def load_manifest(path: str) -> Dict[str, Any]:
    """Manifest of the newest complete checkpoint under ``path`` (or of
    the specific step dir). Raises FileNotFoundError when none exists —
    never returns a partial checkpoint's view."""
    step_dir = mf.resolve_step_dir(path)
    if step_dir is None:
        raise FileNotFoundError(
            f"no complete checkpoint under '{path}' (a checkpoint is "
            f"complete only once its {mf.MANIFEST_NAME} exists)")
    manifest = mf.read_json(os.path.join(step_dir, mf.MANIFEST_NAME))
    if manifest is None:
        raise FileNotFoundError(f"unreadable manifest in {step_dir}")
    return manifest


def plan_resume(manifest: Dict[str, Any],
                num_devices: int) -> Dict[str, Any]:
    """Decide how the surviving topology resumes from ``manifest``.

    Returns ``{action, saved_mesh, saved_devices, num_devices}`` with
    ``action`` one of:

    * ``"reuse"``    — device count matches the saving mesh: the
      recorded strategy applies verbatim (``write_saved_strategy`` +
      ``FFConfig.import_strategy_file``);
    * ``"research"`` — topology changed: compile with a search budget
      so the native search picks a strategy for what survived, then
      load re-shards from the checkpointed shard index.

    When the saving mesh carried a ``slice`` axis (multi-slice
    training) and the lost devices are a whole number of slices, the
    plan additionally classifies the topology change as
    ``topology="slice_loss"`` with ``lost_slices`` /
    ``surviving_slices`` counts: the surviving fleet is an intact
    (smaller) multi-slice deployment — or a single slice, which
    resumes WITHOUT ``--slices`` — so the re-search runs on the
    surviving slice topology rather than an arbitrary device count.
    Any other mismatch classifies as ``topology="device_change"``.
    """
    saved_mesh = {k: int(v) for k, v in (manifest.get("mesh") or {}).items()}
    saved_devices = int(manifest.get("num_devices") or
                        _prod(saved_mesh.values()))
    action = "reuse" if saved_devices == int(num_devices) else "research"
    plan = dict(action=action, saved_mesh=saved_mesh,
                saved_devices=saved_devices, num_devices=int(num_devices))
    saved_slices = int(saved_mesh.get("slice", 1))
    if action == "research" and saved_slices > 1:
        per_slice = saved_devices // saved_slices
        n = int(num_devices)
        if 0 < n < saved_devices and per_slice > 0 and n % per_slice == 0:
            plan["topology"] = "slice_loss"
            plan["surviving_slices"] = n // per_slice
            plan["lost_slices"] = saved_slices - n // per_slice
            plan["slices"] = n // per_slice  # the resume's --slices value
            return plan
    if action == "research":
        plan["topology"] = "device_change"
    return plan


def write_saved_strategy(manifest: Dict[str, Any], path: str) -> str:
    """Materialize the checkpoint's recorded strategy as a strategy
    file (the ``--import-strategy`` format) for the same-topology
    fast path. Returns ``path``."""
    import json
    strategy = manifest.get("strategy")
    if not strategy:
        raise ValueError("checkpoint manifest carries no strategy record")
    with open(path, "w") as f:
        json.dump(strategy, f, indent=1)
    return path


def strategy_matches_mesh(manifest: Dict[str, Any], mesh) -> bool:
    """Whether the live mesh (``machine.Mesh``) equals the saving mesh
    (axes and extents). False just means the elastic re-shard path
    engages — not an error."""
    saved = {k: int(v) for k, v in (manifest.get("mesh") or {}).items()}
    live = {k: int(v) for k, v in mesh.shape.items()}
    return saved == live


def _prod(vals) -> int:
    out = 1
    for v in vals:
        out *= int(v)
    return out
