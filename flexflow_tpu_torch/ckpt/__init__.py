"""Fault-tolerant checkpointing (v2, per-shard).

PyTorch counterpart of ``flexflow_tpu/ckpt``, with its exports, its file
layout and its on-disk format, so that a checkpoint written by either
package loads in the other:

* per-shard async checkpointing: shard files written off the critical
  path, tmp+rename atomicity, a CRC32 a shard and a manifest-last commit
  record (``sharded``/``manifest``/``manager``);
* resume planning from the manifest's mesh and strategy (``elastic``);
* a deterministic fault-injection harness (``FFS_FAULT``, ``faults``).

``FFModel.load_checkpoint`` auto-detects both formats; ``fit(
checkpoint_dir=..., checkpoint_every=..., resume=...)`` drives the
manager.
"""

from flexflow_tpu_torch.ckpt.elastic import (load_manifest, plan_resume,
                                             strategy_matches_mesh,
                                             write_saved_strategy)
from flexflow_tpu_torch.ckpt.faults import (FaultPlan, get_plan, io_check,
                                            step_hook)
from flexflow_tpu_torch.ckpt.manager import CheckpointManager
from flexflow_tpu_torch.ckpt.manifest import (collect_garbage,
                                              latest_complete, list_steps,
                                              resolve_step_dir,
                                              verify_step_dir)
from flexflow_tpu_torch.ckpt.sharded import (load_sharded, save_sharded,
                                             snapshot, write_snapshot)

__all__ = [
    "CheckpointManager",
    "FaultPlan",
    "collect_garbage",
    "get_plan",
    "io_check",
    "latest_complete",
    "list_steps",
    "load_manifest",
    "load_sharded",
    "plan_resume",
    "resolve_step_dir",
    "save_sharded",
    "snapshot",
    "step_hook",
    "strategy_matches_mesh",
    "verify_step_dir",
    "write_saved_strategy",
    "write_snapshot",
]
