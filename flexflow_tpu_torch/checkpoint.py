"""Training-state checkpoint / resume: the v1 single-file format.

PyTorch counterpart of ``flexflow_tpu/checkpoint.py``: the parameters,
the optimizer state, the op state and the iteration counter in one .npz
plus a JSON manifest, written tmp + ``os.replace`` with the manifest
LAST (a save preempted mid-write leaves the previous pair intact), bf16
leaves stored as uint16 bit views with their true dtype in the manifest.
The keys, manifest fields and bit views are the reference's, so a v1
checkpoint of either package loads in the other. New runs should use
the v2 per-shard package (``flexflow_tpu_torch/ckpt``);
``load_checkpoint`` auto-detects both formats.

The manifest's ``rng`` (the reference's JAX key) is written empty; the
port's generator state travels under ``torch_generator``, as in v2.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from flexflow_tpu_torch.ckpt.manifest import atomic_replace, \
    atomic_write_json
from flexflow_tpu_torch.ckpt.sharded import (GENERATOR_KEY, _capture_state,
                                             generator_record, host_copies,
                                             process_index_count,
                                             restore_state, saved_array,
                                             tensor_of)
from flexflow_tpu_torch.ckpt.tree import (flatten_tree, rebuild_tree,
                                          tree_structure)


def save_checkpoint(path: str, ffmodel) -> None:
    """Write params + optimizer state + op state + iteration counter to
    ``<path>.npz`` and ``<path>.manifest.json``."""
    process_index_count()
    state = _capture_state(ffmodel)
    flat = flatten_tree(state)
    tensors = [(k, v) for k, v in flat if isinstance(v, torch.Tensor)]
    hosts = host_copies([v for _, v in tensors])
    arrays = {}
    dtypes: Dict[str, str] = {}
    for (k, _), h in zip(tensors, hosts):
        saved, true, saved_dt = saved_array(h)
        if saved_dt != true:
            dtypes[k] = true
        arrays[k] = saved
    scalars = {k: v for k, v in flat if not isinstance(v, torch.Tensor)}
    # crash-atomic: .npz first, manifest LAST, each tmp + os.replace
    with atomic_replace(_npz_path(path)) as f:
        np.savez(f, **arrays)
    manifest = {
        "version": 1,
        "iteration": ffmodel._iter,
        "rng": [],
        GENERATOR_KEY: generator_record(ffmodel),
        "structure": tree_structure(state),
        "scalars": scalars,
        "array_keys": sorted(arrays),
        # true dtypes of bit-view-stored leaves
        "dtypes": dtypes,
    }
    atomic_write_json(_manifest_path(path), manifest)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def load_checkpoint(path: str, ffmodel) -> int:
    """Restore a checkpoint onto the live model, in place (v1 or v2).

    ``path`` may be a v1 file stem (``<stem>.npz`` + manifest) or a v2
    per-shard checkpoint directory (a root of ``step_*`` dirs, or one
    step dir): the format is auto-detected. Returns the saved iteration
    counter. Shapes must match the compiled model; a missing or partial
    checkpoint raises."""
    if os.path.isdir(path):
        from flexflow_tpu_torch.ckpt import load_sharded
        return load_sharded(path, ffmodel)
    process_index_count()
    npz_path = _npz_path(path)
    if not (os.path.exists(npz_path)
            and os.path.exists(_manifest_path(path))):
        raise FileNotFoundError(
            f"no checkpoint at '{path}' (expected {npz_path} + "
            f"{_manifest_path(path)})")
    with open(_manifest_path(path)) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    flat = {}
    with np.load(npz_path) as data:
        for k in manifest["array_keys"]:
            arr = data[k]
            flat[k] = tensor_of(arr, dtypes.get(k, str(arr.dtype)))
    flat.update(manifest["scalars"])
    return restore_state(ffmodel, rebuild_tree(manifest["structure"], flat),
                         manifest)
