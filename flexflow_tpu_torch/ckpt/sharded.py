"""Per-shard checkpoint save/load (v2).

PyTorch counterpart of ``flexflow_tpu/ckpt/sharded.py``, writing and
reading the reference's own format, so that a checkpoint written by
either package loads in the other:

* the leaves of ``_capture_state``: ``params``, ``opt_state`` (Adam's
  ``m``, ``v`` and the int32 ``t``) and ``op_state`` (BatchNorm's running
  statistics) without the compute copy, which is re-cast on load;
* one shards file, one index and the manifest (the commit record,
  written last) a process, with a CRC32 a shard (a chunk above
  ``chunk_threshold_bytes``) and retry-with-backoff on transient write
  errors;
* each leaf's true ``dtype`` and its ``saved_dtype``: bf16 leaves are
  stored as uint16 bit views (``tensor.view(torch.int16)``, no
  ``ml_dtypes``), with the dtype string ``"bfloat16"`` the reference
  writes, so restore is bit-exact.

The reference's manifest ``rng`` is a JAX key; the port writes
``"rng": []`` (which the reference's loader skips) and keeps its
``torch.Generator`` state under ``torch_generator``, so that dropout masks
resume bit for bit.

One process holds every leaf whole, so each leaf is one shard box, its
whole shape. Restore still reassembles any shard set: a checkpoint the
JAX package wrote over its 8-device mesh (data-sharded moments among
them) loads into the port's one device, each leaf put together from the
saved boxes (the elastic path; the port's 1-device compile is its
re-placement). A ``torch.distributed`` group of more than one process is
refused: multi-rank checkpoints come with ROADMAP.md Queue 1 item 3.

The snapshot is the one part of a save on the training thread: every
tensor leaf is copied device→host into pinned memory on the current
stream, after the step that wrote it, then the stream is synchronized
once. The writer thread then touches host numpy only.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ckpt import faults
from flexflow_tpu_torch.ckpt import manifest as mf
from flexflow_tpu_torch.ckpt.tree import (flatten_tree, place_tree,
                                          rebuild_tree, tree_structure)
from flexflow_tpu_torch.obs.registry import get_registry

#: the manifest key of the port's generator state ({"device", "state"})
GENERATOR_KEY = "torch_generator"


def process_index_count() -> Tuple[int, int]:
    """(this process's index, the process count): (0, 1) unless a
    ``torch.distributed`` group of more than one process is initialised,
    which raises: multi-rank checkpoints are ROADMAP.md Queue 1 item 3."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "checkpoints across more than one process come with a later "
            "slice of the PyTorch port (ROADMAP.md Queue 1 item 3)")
    return 0, 1


def _retry_io(what: str, fn, heartbeat=None):
    """Run ``fn`` (an atomic write), absorbing transient ``OSError``\\ s
    with bounded exponential backoff. ``FFS_CKPT_IO_RETRIES`` (default
    3) bounds the retries, ``FFS_CKPT_IO_BACKOFF_S`` (default 0.05)
    seeds the delay; each retry bumps ``ckpt/io_retries``. Exhausted
    retries re-raise the LAST ``OSError`` unchanged."""
    import sys

    retries = int(os.environ.get("FFS_CKPT_IO_RETRIES", "3"))
    backoff = float(os.environ.get("FFS_CKPT_IO_BACKOFF_S", "0.05"))
    attempt = 0
    while True:
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = backoff * (2.0 ** attempt)
            attempt += 1
            get_registry().inc("ckpt/io_retries")
            print(f"[ckpt] transient I/O error writing {what}: {e!r} — "
                  f"retry {attempt}/{retries} in {delay * 1e3:.0f}ms",
                  file=sys.stderr, flush=True)
            time.sleep(delay)
            if heartbeat is not None:
                heartbeat(f"ckpt io retry {attempt}")


#: shard payloads above this split into CRC'd chunks at write
#: (``FFS_CKPT_CHUNK_BYTES`` overrides; 0 disables chunking)
DEFAULT_CHUNK_BYTES = 128 << 20


def chunk_threshold_bytes() -> int:
    try:
        return int(os.environ.get("FFS_CKPT_CHUNK_BYTES",
                                  DEFAULT_CHUNK_BYTES))
    except ValueError:
        return DEFAULT_CHUNK_BYTES


def _crc_check(piece: Dict[str, Any], data: np.ndarray,
               what: str) -> None:
    """The one per-piece CRC32 check (whole shards and chunks alike)."""
    crc = mf.crc32_bytes(data.tobytes())
    if crc != int(piece["crc32"]):
        raise ValueError(
            f"checksum mismatch on {what} '{piece['key']}' (stored "
            f"{int(piece['crc32']):#010x}, recomputed {crc:#010x})")


def verify_shard_row(npz, row: Dict[str, Any]) -> None:
    """CRC-verify one index row piece by piece without reassembling
    (``manifest.verify_step_dir``). Raises ValueError on corruption."""
    chunks = row.get("chunks")
    if not chunks:
        _crc_check(row, np.ascontiguousarray(npz[row["key"]]), "shard")
        return
    for ch in chunks:
        _crc_check(ch, np.ascontiguousarray(npz[ch["key"]]), "chunk")


def read_shard_row(npz, row: Dict[str, Any],
                   verify: bool = True) -> np.ndarray:
    """Read one index row's payload from an open npz, whole-shard or
    chunked, verifying CRC32s when ``verify``. Raises ValueError on
    corruption."""
    chunks = row.get("chunks")
    if not chunks:
        data = np.ascontiguousarray(npz[row["key"]])
        if verify:
            _crc_check(row, data, "shard")
        return data
    parts = []
    for ch in chunks:
        part = np.ascontiguousarray(npz[ch["key"]])
        if verify:
            _crc_check(ch, part, "chunk")
        parts.append(part.reshape(-1))
    data = np.concatenate(parts)
    return data.reshape([max(0, b[1] - b[0])
                         for b in row.get("index", [])])


# ---- dtypes: torch <-> the manifest's numpy names ---------------------------

def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a tensor dtype: numpy's, and ``"bfloat16"``
    (the name the reference writes for ml_dtypes' bfloat16)."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return str(torch.empty((), dtype=dtype).numpy().dtype)


def saved_array(t: torch.Tensor) -> Tuple[np.ndarray, str, str]:
    """(array to store, true dtype name, saved dtype name) of a host
    tensor: bf16 as its uint16 bit view, anything else as itself."""
    arr = (t.view(torch.int16).numpy().view(np.uint16)
           if t.dtype == torch.bfloat16 else t.numpy())
    return arr, dtype_name(t.dtype), str(arr.dtype)


def tensor_of(arr: np.ndarray, true_dtype: str) -> torch.Tensor:
    """A stored array as a CPU tensor of its true dtype, bit for bit."""
    # (np.ascontiguousarray would make a 0-d array 1-d)
    arr = np.require(arr, requirements="C")
    if true_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    try:
        arr = arr.view(np.dtype(true_dtype))
    except TypeError:
        raise ValueError(f"checkpoint leaf dtype {true_dtype!r} has no "
                         f"PyTorch counterpart here") from None
    return torch.from_numpy(arr)


def host_copies(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host copies of ``tensors``, never views: CUDA tensors through
    pinned buffers and one non-blocking copy each on the current stream
    (so after whatever step wrote them), then one synchronize; CPU
    tensors cloned."""
    out: List[torch.Tensor] = []
    streams = set()
    for t in tensors:
        t = t.detach()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            streams.add(torch.cuda.current_stream(t.device))
        else:
            h = t.clone()
        out.append(h)
    for s in streams:
        s.synchronize()
    return out


def _capture_state(ffmodel) -> Dict[str, Any]:
    from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY
    return {
        "params": ffmodel.params,
        "opt_state": ffmodel.opt_state,
        # the bf16 working copy is derived from params: re-cast on load
        "op_state": {k: v for k, v in ffmodel.state.items()
                     if k != COMPUTE_PARAMS_KEY},
    }


def whole_box(shape) -> List[List[int]]:
    """The shard box of a whole leaf, [[0, d], ...] ([] for a 0-d one)."""
    return [[0, int(d)] for d in shape]


def generator_record(ffmodel) -> Dict[str, Any]:
    gen = ffmodel._generator
    return dict(device=gen.device.type,
                state=[int(x) for x in gen.get_state().tolist()])


def restore_generator(ffmodel, record: Optional[Dict[str, Any]]) -> None:
    """Set the model's generator to a saved state of a generator on the
    same kind of device (a CPU generator's state means nothing to a CUDA
    one); otherwise the generator is left as it is."""
    if record and record.get("device") == ffmodel._generator.device.type:
        ffmodel._generator.set_state(
            torch.tensor(record["state"], dtype=torch.uint8))


class ShardSnapshot:
    """Host-side copy of this process's shards plus the manifest
    payload: everything the background writer needs, detached from the
    live (rewritten-per-step) device buffers.

    ``shards``: {leaf key: [(box, saved_np_array)]}; checksums are
    computed by ``write_snapshot`` on the writer thread, not here.
    """

    def __init__(self, step: int, process_index: int, process_count: int,
                 shards, leaves, structure, scalars, manifest_extra):
        self.step = step
        self.process_index = process_index
        self.process_count = process_count
        self.shards = shards
        self.leaves = leaves
        self.structure = structure
        self.scalars = scalars
        self.manifest_extra = manifest_extra
        self.payload_bytes = sum(
            a.nbytes for entries in shards.values() for _, a in entries)


def snapshot(ffmodel, step: Optional[int] = None,
             client_state: Optional[Dict[str, Any]] = None) -> ShardSnapshot:
    """Blocking device→host copy of every leaf (the only part of a save
    that runs on the training thread: the next step rewrites the buffers
    read here). ``client_state`` is a JSON-able dict recorded verbatim in
    the manifest."""
    pidx, pcnt = process_index_count()
    step = int(ffmodel._iter if step is None else step)
    state = _capture_state(ffmodel)
    flat = flatten_tree(state)
    keys = [k for k, v in flat if isinstance(v, torch.Tensor)]
    hosts = dict(zip(keys, host_copies(
        [v for _, v in flat if isinstance(v, torch.Tensor)])))
    shards: Dict[str, List[Tuple[List[List[int]], np.ndarray]]] = {}
    leaves: Dict[str, Dict[str, Any]] = {}
    scalars: Dict[str, Any] = {}
    for key, v in flat:
        if key in hosts:
            saved, true, saved_dt = saved_array(hosts[key])
            shards[key] = [(whole_box(saved.shape), saved)]
            leaves[key] = dict(shape=[int(d) for d in saved.shape],
                               dtype=true, saved_dtype=saved_dt)
        else:
            scalars[key] = v

    # strategy + mesh travel in the manifest: a resume on the same
    # topology can reuse the recorded strategy verbatim (ckpt/elastic.py)
    from flexflow_tpu_torch.search.unity import strategy_json
    mesh_axes = dict(ffmodel.mesh.shape)
    extra = dict(
        iteration=int(ffmodel._iter),
        # the reference's JAX key; its loader skips an empty one
        rng=[],
        mesh=mesh_axes,
        num_devices=int(ffmodel.mesh.size),
        strategy=strategy_json(mesh_axes, ffmodel.strategy or {},
                               ffmodel.executor.nodes,
                               objective=getattr(ffmodel,
                                                 "search_objective", None)),
        wall_unix=time.time(),
    )
    extra[GENERATOR_KEY] = generator_record(ffmodel)
    if client_state is not None:
        extra["client_state"] = client_state
    return ShardSnapshot(step, pidx, pcnt, shards, leaves,
                         tree_structure(state), scalars, extra)


def write_snapshot(directory: str, snap: ShardSnapshot,
                   fs_timeout: float = 120.0, heartbeat=None) -> int:
    """Write this process's shard + index files and run the commit
    protocol (the manifest last, once every process's index is visible;
    return only once the manifest exists). Safe on a background thread:
    host arrays and the filesystem only. Transient write errors retry
    with backoff (``_retry_io``). ``heartbeat`` (when the run carries a
    watchdog) marks each completed file as writer progress. Returns this
    process's payload bytes."""
    step_dir = os.path.join(directory, mf.step_dir_name(snap.step))
    os.makedirs(step_dir, exist_ok=True)
    plan = faults.get_plan()
    chunk_bytes = chunk_threshold_bytes()

    arrays: Dict[str, np.ndarray] = {}
    index: Dict[str, List[Dict[str, Any]]] = {}
    for leaf_key, entries in snap.shards.items():
        rows = []
        for i, (box, arr) in enumerate(entries):
            npz_key = f"{leaf_key}::{i}"
            # checksums on the writer thread; the corrupt_shard seam
            # flips bytes AFTER the CRC so the verifier must catch the rot
            payload = arr.tobytes()
            crc = mf.crc32_bytes(payload)
            # the one slicing into chunks: (key, start, stop), shared by
            # the clean-payload CRC pass and the storage pass below
            slices = None
            if chunk_bytes and arr.nbytes > chunk_bytes and arr.size > 1:
                epc = max(1, chunk_bytes // max(1, arr.dtype.itemsize))
                slices = [(f"{npz_key}::c{j}", off,
                           min(off + epc, arr.size))
                          for j, off in enumerate(
                              range(0, arr.size, epc))]
            chunk_meta = None
            if slices is not None:
                flat = arr.reshape(-1)
                chunk_meta = [dict(
                    key=ck,
                    crc32=int(mf.crc32_bytes(flat[o:e].tobytes())),
                    bytes=int(flat[o:e].nbytes)) for ck, o, e in slices]
            if plan is not None:
                hurt = plan.corrupt_bytes(leaf_key, snap.step, payload)
                if hurt is not payload:
                    arr = np.frombuffer(hurt, dtype=arr.dtype).reshape(
                        arr.shape)
            row = dict(key=npz_key, index=box, crc32=int(crc),
                       bytes=int(arr.nbytes))
            if slices is not None:
                flat = arr.reshape(-1)
                for ck, o, e in slices:
                    arrays[ck] = flat[o:e]
                row["chunks"] = chunk_meta
                get_registry().inc("ckpt/chunked_shards")
            else:
                arrays[npz_key] = arr
            rows.append(row)
        index[leaf_key] = rows

    shards_file = mf.shards_name(snap.process_index)
    spath = os.path.join(step_dir, shards_file)

    def _write_shards():
        with mf.atomic_replace(spath) as f:
            if plan is not None:
                plan.write_delay()
            np.savez(f, **arrays)

    _retry_io(shards_file, _write_shards, heartbeat=heartbeat)
    if heartbeat is not None:
        heartbeat(f"ckpt shards step {snap.step}")
    # the index AFTER the shard data it references is durable
    index_path = os.path.join(step_dir, mf.index_name(snap.process_index))
    _retry_io(mf.index_name(snap.process_index),
              lambda: mf.atomic_write_json(
                  index_path,
                  dict(version=mf.CKPT_VERSION, step=snap.step,
                       host=snap.process_index, shards_file=shards_file,
                       shards=index)),
              heartbeat=heartbeat)
    if heartbeat is not None:
        heartbeat(f"ckpt index step {snap.step}")

    index_files = [mf.index_name(h) for h in range(snap.process_count)]
    if snap.process_index == 0:
        mf.wait_for_files([os.path.join(step_dir, n) for n in index_files],
                          fs_timeout, "every host's shard index")
        manifest = dict(
            version=mf.CKPT_VERSION,
            step=snap.step,
            structure=snap.structure,
            scalars=snap.scalars,
            leaves=snap.leaves,
            index_files=index_files,
            num_hosts=snap.process_count,
            **snap.manifest_extra,
        )
        _retry_io(mf.MANIFEST_NAME,
                  lambda: mf.atomic_write_json(
                      os.path.join(step_dir, mf.MANIFEST_NAME), manifest),
                  heartbeat=heartbeat)
    mf.wait_for_files([os.path.join(step_dir, mf.MANIFEST_NAME)],
                      fs_timeout, "the checkpoint manifest")
    return snap.payload_bytes


def save_sharded(directory: str, ffmodel, step: Optional[int] = None,
                 fs_timeout: float = 120.0) -> str:
    """Synchronous per-shard save (snapshot + commit on the calling
    thread). Returns the committed step directory. The async path goes
    through ``CheckpointManager``."""
    snap = snapshot(ffmodel, step=step)
    write_snapshot(directory, snap, fs_timeout=fs_timeout)
    return os.path.join(directory, mf.step_dir_name(snap.step))


# ---------------------------------------------------------------------------
# load


def _box_volume(box, shape=None) -> int:
    """Elements inside a serialized shard box ([] = a 0-d scalar)."""
    if not box:
        return int(np.prod(shape)) if shape else 1
    return int(np.prod([max(0, b[1] - b[0]) for b in box]))


def _boxes_intersect(a, b) -> bool:
    for (s1, e1), (s2, e2) in zip(a, b):
        if min(e1, e2) <= max(s1, s2):
            return False
    return True


def _live_boxes(ffmodel) -> Dict[str, Optional[List[List[List[int]]]]]:
    """The regions of each live leaf this process restores: its whole
    box (one process holds every leaf whole)."""
    return {key: [whole_box(v.shape)] if isinstance(v, torch.Tensor)
            else None
            for key, v in flatten_tree(_capture_state(ffmodel))}


def _select_rows(entries, needed):
    """The read plan for one leaf: ``(selected, skipped, want_elements,
    rank_local)``. Rank-local mode engages only when every saved box
    either exactly matches a needed box or misses the needed region; any
    partial overlap (the saving mesh split the leaf) falls back to the
    full scan, which reassembles the whole array."""
    if needed is None:
        return entries, [], None, False
    needed_keys = {tuple(map(tuple, b)) for b in needed}
    selected, skipped = [], []
    for ent in entries:
        box = ent[1]["index"]
        t = tuple(map(tuple, box))
        if t in needed_keys:
            selected.append(ent)
        elif any(_boxes_intersect(box, nb) for nb in needed):
            return entries, [], None, False
        else:
            skipped.append(ent)
    want = sum(_box_volume(nb) for nb in needed)
    return selected, skipped, want, True


def _gather_agree(value: int, what: str) -> int:
    """Fail-fast agreement on a value across processes; with one process
    a negative value raises FileNotFoundError. More than one process is
    ROADMAP.md Queue 1 item 3 (``process_index_count`` raises)."""
    process_index_count()
    if value < 0:
        raise FileNotFoundError(what)
    return value


def load_sharded(path: str, ffmodel, verify: bool = True,
                 rank_local: bool = True,
                 include_opt_state: bool = True) -> int:
    """Restore a v2 per-shard checkpoint onto the live model, in place.

    ``path`` is a checkpoint root (the newest complete step is taken) or
    a specific ``step_*`` directory. Each leaf is reassembled from the
    shard index, whatever boxes the saving processes wrote, and copied
    into the live tensor. A missing or partial checkpoint raises.
    ``include_opt_state=False`` skips the optimizer-state leaves entirely
    (an INFERENCE compile has none). Returns the restored iteration
    counter."""

    def _wanted(leaf_key: str) -> bool:
        return include_opt_state or not (
            leaf_key == "opt_state" or leaf_key.startswith("opt_state/"))

    step_dir = mf.resolve_step_dir(path)
    local = -1 if step_dir is None else _read_step(step_dir)
    _gather_agree(
        local,
        f"no complete checkpoint under '{path}' — a checkpoint is only "
        f"complete once its {mf.MANIFEST_NAME} commit record exists "
        f"(a save interrupted mid-write leaves none)")
    manifest = mf.read_json(os.path.join(step_dir, mf.MANIFEST_NAME))

    flat: Dict[str, Any] = dict(manifest.get("scalars", {}))
    pending: Dict[str, np.ndarray] = {}
    filled: Dict[str, int] = {}
    want: Dict[str, int] = {}
    local_mode: Dict[str, bool] = {}
    for leaf_key, meta in manifest["leaves"].items():
        if not _wanted(leaf_key):
            continue
        pending[leaf_key] = np.empty([int(d) for d in meta["shape"]],
                                     dtype=np.dtype(meta["saved_dtype"]))
        filled[leaf_key] = 0
        want[leaf_key] = (int(np.prod(meta["shape"]))
                          if meta["shape"] else 1)
        local_mode[leaf_key] = False

    # every process's index rows BEFORE any shard bytes, so the planner
    # sees each leaf's complete saved shard set
    rows_by_leaf: Dict[str, List] = {k: [] for k in pending}
    for idx_file in manifest["index_files"]:
        index = mf.read_json(os.path.join(step_dir, idx_file))
        if index is None:
            raise FileNotFoundError(
                f"checkpoint {step_dir} is incomplete: shard index "
                f"{idx_file} is missing/unreadable despite a manifest — "
                f"refusing a partial restore")
        for leaf_key, rows in index["shards"].items():
            if not _wanted(leaf_key):
                continue
            rows_by_leaf.setdefault(leaf_key, []).extend(
                (index["shards_file"], row) for row in rows)

    live = _live_boxes(ffmodel) if rank_local else {}
    reg = get_registry()
    read_bytes = skipped_bytes = 0
    # plan per leaf, then read file-major: one shards file open at a time
    reads_by_file: Dict[str, List] = {}
    for leaf_key, entries in rows_by_leaf.items():
        selected, skipped, leaf_want, is_local = _select_rows(
            entries, live.get(leaf_key))
        if is_local:
            want[leaf_key] = leaf_want
            local_mode[leaf_key] = True
            skipped_bytes += sum(int(row.get("bytes", 0))
                                 for _, row in skipped)
        for shards_file, row in selected:
            reads_by_file.setdefault(shards_file, []).append(
                (leaf_key, row))
    for shards_file, rows in reads_by_file.items():
        npz = np.load(os.path.join(step_dir, shards_file))
        try:
            for leaf_key, row in rows:
                dest = pending[leaf_key]
                try:
                    data = read_shard_row(npz, row, verify=verify)
                except ValueError as e:  # stored-CRC mismatch
                    raise ValueError(
                        f"checkpoint {step_dir}: {e} on '{leaf_key}' — "
                        f"on-disk corruption; refusing to restore") from e
                except Exception as e:  # zip-level CRC / truncation
                    raise ValueError(
                        f"checkpoint {step_dir}: shard '{row['key']}' of "
                        f"'{leaf_key}' is unreadable ({e}) — on-disk "
                        f"corruption; refusing to restore") from e
                read_bytes += int(row.get("bytes", data.nbytes))
                box = row["index"]
                if box:
                    sl = tuple(slice(b[0], b[1]) for b in box)
                    dest[sl] = data
                    filled[leaf_key] += int(
                        np.prod([b[1] - b[0] for b in box]))
                else:
                    dest[...] = data
                    filled[leaf_key] += 1
        finally:
            npz.close()
    reg.inc("ckpt/restore_read_bytes", read_bytes)
    reg.inc("ckpt/restore_skipped_bytes", skipped_bytes)
    for leaf_key, meta in manifest["leaves"].items():
        if leaf_key not in pending:
            continue  # opt-state leaf skipped by include_opt_state=False
        if filled[leaf_key] != want[leaf_key]:
            scope = ("this host's live shard boxes"
                     if local_mode[leaf_key] else "the global shape")
            raise ValueError(
                f"checkpoint {step_dir}: leaf '{leaf_key}' reassembled "
                f"{filled[leaf_key]}/{want[leaf_key]} elements of "
                f"{scope} — incomplete shard set; refusing a partial "
                f"restore")
        flat[leaf_key] = tensor_of(pending[leaf_key], meta["dtype"])

    if include_opt_state:
        state = rebuild_tree(manifest["structure"], flat)
    else:
        # only the forward's subtrees; the optimizer leaves were never read
        items = manifest["structure"]["items"]
        state = {
            "params": rebuild_tree(items["params"], flat, "params/"),
            "op_state": rebuild_tree(items["op_state"], flat, "op_state/"),
        }
    return restore_state(ffmodel, state, manifest,
                         include_opt_state=include_opt_state)


def restore_state(ffmodel, state: Dict[str, Any], manifest: Dict[str, Any],
                  include_opt_state: bool = True) -> int:
    """Write a rebuilt ``_capture_state`` tree into the live model (in
    place), refresh the compute copy, and restore the iteration counter
    and the generator. Returns the iteration. Shared by v1 and v2."""
    from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY
    live_op_state = {k: v for k, v in ffmodel.state.items()
                     if k != COMPUTE_PARAMS_KEY}
    place_tree(ffmodel.params, state["params"])
    if include_opt_state:
        ffmodel.opt_state = place_tree(ffmodel.opt_state,
                                       state["opt_state"])
    place_tree(live_op_state, state["op_state"])
    ffmodel._compute_params_dirty = True
    ffmodel._refresh_compute_params()
    ffmodel._iter = int(manifest["iteration"])
    restore_generator(ffmodel, manifest.get(GENERATOR_KEY))
    return ffmodel._iter


def _read_step(step_dir: str) -> int:
    m = mf.read_json(os.path.join(step_dir, mf.MANIFEST_NAME))
    return int(m["step"]) if m and "step" in m else -1
