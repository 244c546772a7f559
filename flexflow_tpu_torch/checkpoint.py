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

Over a process group, as in the reference: every rank gathers each
sharded leaf whole (a collective), rank 0 alone writes, and no rank
returns before the files are durable (a barrier). A load first agrees
across ranks on what each sees (a directory or a file pair), so a
checkpoint some rank cannot see raises the same error on every rank;
each rank then reads the file and keeps its own box of every leaf.
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
                                             _gather_agree, _rank_boxes,
                                             check_whole_shape,
                                             generator_record, host_copies,
                                             process_index_count,
                                             restore_state, saved_array,
                                             tensor_of)
from flexflow_tpu_torch.ckpt.tree import (flatten_tree, rebuild_tree,
                                          tree_structure)


def save_checkpoint(path: str, ffmodel) -> None:
    """Write params + optimizer state + op state + iteration counter to
    ``<path>.npz`` and ``<path>.manifest.json``. Over a process group
    every rank calls it (the gathers are collectives); rank 0 writes and
    every rank returns once the files are durable."""
    from flexflow_tpu_torch import distributed
    rank, count = process_index_count()
    state = _capture_state(ffmodel)
    flat = flatten_tree(state)
    tensors = [(k, v) for k, v in flat if isinstance(v, torch.Tensor)]
    if count > 1 and ffmodel.executor.multi_rank:
        # each sharded leaf whole on every rank
        boxes, comm = _rank_boxes(ffmodel), ffmodel.executor.comm
        tensors = [(k, comm.gather_whole(v, boxes[k][1])
                    if any(boxes[k][1]) else v) for k, v in tensors]
    if rank == 0:
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
    # no rank sees the save complete before the files are durable
    distributed.barrier()


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def load_checkpoint(path: str, ffmodel) -> int:
    """Restore a checkpoint onto the live model, in place (v1 or v2).

    ``path`` may be a v1 file stem (``<stem>.npz`` + manifest) or a v2
    per-shard checkpoint directory (a root of ``step_*`` dirs, or one
    step dir): the format is auto-detected, after the ranks agree on it.
    Returns the saved iteration counter. Shapes must match the compiled
    model; a missing or partial checkpoint raises on every rank."""
    # the format and the visibility come from each rank's own
    # filesystem: agreed first (2 a v2 directory, 1 a v1 file pair, -1
    # neither), so a checkpoint some rank cannot see raises on every rank
    npz_path = _npz_path(path)
    if os.path.isdir(path):
        seen = 2
    elif (os.path.exists(npz_path)
          and os.path.exists(_manifest_path(path))):
        seen = 1
    else:
        seen = -1
    fmt = _gather_agree(seen, f"no checkpoint at '{path}' (expected a v2 "
                              f"checkpoint directory, or {npz_path} + "
                              f"{_manifest_path(path)})")
    if fmt == 2:
        from flexflow_tpu_torch.ckpt import load_sharded
        return load_sharded(path, ffmodel)
    with open(_manifest_path(path)) as f:
        manifest = json.load(f)
    dtypes = manifest.get("dtypes", {})
    boxes = _rank_boxes(ffmodel)
    flat = {}
    with np.load(npz_path) as data:
        for k in manifest["array_keys"]:
            arr = data[k]
            if k in boxes:
                check_whole_shape(k, arr.shape, boxes[k][0])
                if arr.ndim:
                    # this rank's box of the whole leaf
                    arr = arr[tuple(slice(s, e) for s, e in boxes[k][2])]
            flat[k] = tensor_of(arr, dtypes.get(k, str(arr.dtype)))
    flat.update(manifest["scalars"])
    return restore_state(ffmodel, rebuild_tree(manifest["structure"], flat),
                         manifest)
