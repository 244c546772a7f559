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

Over a ``torch.distributed`` group (one rank a device, rank r at JAX's
device r of the mesh) each rank holds its box of every leaf: its block of
a parameter under the node's spec, of the f32 master and the moments
under the master spec (its weight-update-sharding shard), every other
leaf whole. Each rank writes only the boxes it is the lowest rank of its
replica group for (the counterpart of the reference's ``replica_id ==
0``), so every box lands once across the group and the boxes are the
ones the JAX package writes for the same strategy on the same mesh; rank
0 commits the manifest once every rank's index is visible. A load agrees
across ranks on the newest complete step before any rank reads, and each
rank reads only the saved boxes that meet its own: exactly its box where
the saving mesh cut the leaf the same way (rank-local), else the saved
rows over its box (elastic: another mesh or rank count). A checkpoint the
JAX package wrote over its 8-device mesh loads so on 8 ranks or on one.

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
    """(this process's rank, the group's size): ``(0, 1)`` without a
    ``torch.distributed`` group."""
    from flexflow_tpu_torch import distributed
    return distributed.process_index(), distributed.process_count()


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


def saved_dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of the dtype a leaf of ``dtype`` is stored
    as (``saved_array``)."""
    return "uint16" if dtype == torch.bfloat16 else dtype_name(dtype)


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


def writes_box(spec, mesh, rank: int) -> bool:
    """Whether ``rank`` writes its box of a leaf under ``spec``: it is
    the lowest rank of the ranks holding that box (coordinate 0 on every
    mesh axis the spec does not split), the counterpart of JAX's
    ``replica_id == 0``."""
    split = {a for axes in spec for a in axes}
    coords = mesh.coords(rank)
    return all(coords[a] == 0 for a in mesh.axis_names
               if mesh.shape[a] > 1 and a not in split)


def _mirrors(slot, params) -> bool:
    """Whether an optimizer-state subtree holds one leaf per parameter
    (Adam's m and v, SGD's momentum): a slot of the parameter tree."""
    return (isinstance(slot, dict) and set(slot) == set(params)
            and all(isinstance(slot[op], dict)
                    and set(slot[op]) == set(params[op]) for op in params))


def _rank_boxes(ffmodel) -> Dict[str, Tuple[Tuple[int, ...], Tuple, List,
                                            bool]]:
    """{leaf key: (whole shape, normalized spec, this rank's box, whether
    it writes that box)} of every tensor leaf of the saved state. Over a
    process group a parameter, and each optimizer slot of the parameter
    tree at the same position, takes the executor's master box of the
    parameter (``executor.master_box``: its WUS shard where weight-update
    sharding cuts it); every other leaf (op state, Adam's step count) is
    whole and replicated, as is every leaf on one process."""
    rank, count = process_index_count()
    ex = ffmodel.executor
    state = _capture_state(ffmodel)
    out = {}
    for key, v in flatten_tree(state):
        if isinstance(v, torch.Tensor):
            shape = tuple(int(d) for d in v.shape)
            out[key] = (shape, ((),) * len(shape), whole_box(shape),
                        rank == 0)
    if count <= 1 or ex is None or not ex.multi_rank:
        return out

    def cut(prefix: str, tree) -> None:
        for op, leaves in tree.items():
            for pn, t in leaves.items():
                shape, spec, box = ex.master_box(op, pn, t)
                out[f"{prefix}{op}/{pn}"] = (shape, spec, box,
                                             writes_box(spec, ex.mesh, rank))

    params = state["params"]
    cut("params/", params)
    opt = state["opt_state"]
    for slot, sub in (opt.items() if isinstance(opt, dict) else ()):
        if _mirrors(sub, params):
            cut(f"opt_state/{slot}/", sub)
    return out


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
    """Blocking device→host copy of the boxes this rank writes (the only
    part of a save that runs on the training thread: the next step
    rewrites the buffers read here). Every rank records every leaf's
    whole shape and dtypes. ``client_state`` is a JSON-able dict
    recorded verbatim in the manifest."""
    pidx, pcnt = process_index_count()
    step = int(ffmodel._iter if step is None else step)
    state = _capture_state(ffmodel)
    flat = flatten_tree(state)
    boxes = _rank_boxes(ffmodel)
    mine = [(k, v) for k, v in flat if k in boxes and boxes[k][3]]
    hosts = dict(zip((k for k, _ in mine),
                     host_copies([v for _, v in mine])))
    shards: Dict[str, List[Tuple[List[List[int]], np.ndarray]]] = {}
    leaves: Dict[str, Dict[str, Any]] = {}
    scalars: Dict[str, Any] = {}
    for key, v in flat:
        if key not in boxes:
            scalars[key] = v
            continue
        shape, _, box, _ = boxes[key]
        if key in hosts:
            saved, _, _ = saved_array(hosts[key])
            shards[key] = [(box, saved)]
        leaves[key] = dict(shape=list(shape), dtype=dtype_name(v.dtype),
                           saved_dtype=saved_dtype_name(v.dtype))

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
    host arrays and the filesystem only, no collective. Observes
    ``ckpt/shard_write_s`` (this rank's shards and index) and
    ``ckpt/commit_s`` (from its index to the manifest's appearance).
    Transient write errors retry with backoff (``_retry_io``).
    ``heartbeat`` (when the run carries a watchdog) marks each completed
    file as writer progress. Returns this process's payload bytes."""
    t_write = time.perf_counter()
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
    t_commit = time.perf_counter()
    reg = get_registry()
    reg.observe("ckpt/shard_write_s", t_commit - t_write)

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
    reg.observe("ckpt/commit_s", time.perf_counter() - t_commit)
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
    """Fail-fast agreement on a value across ranks: every rank must see
    the same non-negative value, or every rank raises the same
    ``FileNotFoundError`` (a checkpoint one rank cannot see must never
    leave the others waiting in a collective). Unanimous absence is a
    wrong or never-saved directory and says only ``what``."""
    from flexflow_tpu_torch import distributed
    if distributed.process_count() <= 1:
        if value < 0:
            raise FileNotFoundError(what)
        return value
    seen, agree = distributed.ranks_agree(value)
    if all(v < 0 for v in seen):
        raise FileNotFoundError(what)
    if any(v < 0 for v in seen) or not agree:
        bad = [r for r, v in enumerate(seen) if v < 0]
        raise FileNotFoundError(
            f"{what} (per-rank view: {seen}"
            + (f"; ranks {bad} cannot see it — the checkpoint "
               f"must be on a filesystem shared by every host" if bad
               else "; the ranks see different checkpoints there — it "
               "must be on a filesystem shared by every host")
            + ")")
    return seen[0]


def check_whole_shape(leaf_key: str, saved, live) -> None:
    """Refuse a saved leaf whose whole shape is not the live model's (a
    cut of a wider leaf would fill this rank's box without a gap)."""
    if tuple(int(d) for d in saved) != tuple(live):
        raise ValueError(
            f"checkpoint shape {tuple(int(d) for d in saved)} != live "
            f"{tuple(live)} for leaf '{leaf_key}'")


def _meet(a, b) -> Optional[List[List[int]]]:
    """The intersection of two boxes, None when empty ([] for 0-d)."""
    out = [[max(s1, s2), min(e1, e2)] for (s1, e1), (s2, e2) in zip(a, b)]
    return None if any(e <= s for s, e in out) else out


def load_sharded(path: str, ffmodel, verify: bool = True,
                 rank_local: bool = True,
                 include_opt_state: bool = True) -> int:
    """Restore a v2 per-shard checkpoint onto the live model, in place.

    ``path`` is a checkpoint root (the newest complete step is taken) or
    a specific ``step_*`` directory. The ranks first agree on that step
    (``_gather_agree``): a missing or partial checkpoint, or one some
    rank cannot see, raises on every rank. Each rank then fills its own
    box of every leaf from the saved boxes, whatever mesh and rank count
    wrote them: with ``rank_local`` (default) a leaf whose saved boxes
    each equal this rank's box or miss it is read box for box, the
    others skipped; otherwise (the saving mesh cut the leaf another way)
    every saved row that meets this rank's box is read. The per-rank
    byte split lands in ``ckpt/restore_read_bytes`` and
    ``ckpt/restore_skipped_bytes``. ``include_opt_state=False`` skips
    the optimizer-state leaves entirely (an INFERENCE compile has none).
    Returns the restored iteration counter."""

    def _wanted(leaf_key: str) -> bool:
        return include_opt_state or not (
            leaf_key == "opt_state" or leaf_key.startswith("opt_state/"))

    step_dir = mf.resolve_step_dir(path)
    local = -1 if step_dir is None else _read_step(step_dir)
    step = _gather_agree(
        local,
        f"no complete checkpoint under '{path}' — a checkpoint is only "
        f"complete once its {mf.MANIFEST_NAME} commit record exists "
        f"(a save interrupted mid-write leaves none)")
    if step_dir is None or _read_step(step_dir) != step:
        # unreachable on one process; a split view raised above
        raise FileNotFoundError(f"checkpoint step mismatch under {path}")
    manifest = mf.read_json(os.path.join(step_dir, mf.MANIFEST_NAME))

    # the region of each live leaf this rank restores: its own box
    boxes = _rank_boxes(ffmodel)
    live = {k: box for k, (_, _, box, _) in boxes.items()}
    flat: Dict[str, Any] = dict(manifest.get("scalars", {}))
    pending: Dict[str, np.ndarray] = {}
    region: Dict[str, List[List[int]]] = {}
    filled: Dict[str, int] = {}
    for leaf_key, meta in manifest["leaves"].items():
        if not _wanted(leaf_key):
            continue
        shape = [int(d) for d in meta["shape"]]
        if leaf_key in boxes:
            check_whole_shape(leaf_key, shape, boxes[leaf_key][0])
        # a leaf the live model lacks is read whole: place_tree names it
        region[leaf_key] = live.get(leaf_key, whole_box(shape))
        pending[leaf_key] = np.empty(
            [e - s for s, e in region[leaf_key]],
            dtype=np.dtype(meta["saved_dtype"]))
        filled[leaf_key] = 0

    # every rank's index rows BEFORE any shard bytes, so the planner
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

    reg = get_registry()
    read_bytes = skipped_bytes = 0
    # plan per leaf, then read file-major: one shards file open at a time
    reads_by_file: Dict[str, List] = {}
    for leaf_key, entries in rows_by_leaf.items():
        selected, skipped, _, is_local = _select_rows(
            entries, [region[leaf_key]] if rank_local else None)
        if not is_local:
            # another cut of the leaf: the saved rows over this box
            selected, skipped = [], []
            for e in entries:
                meets = _meet(e[1]["index"], region[leaf_key]) is not None
                (selected if meets else skipped).append(e)
        skipped_bytes += sum(int(row.get("bytes", 0)) for _, row in skipped)
        for shards_file, row in selected:
            reads_by_file.setdefault(shards_file, []).append(
                (leaf_key, row))
    for shards_file, rows in reads_by_file.items():
        npz = np.load(os.path.join(step_dir, shards_file))
        try:
            for leaf_key, row in rows:
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
                box, reg_box = row["index"], region[leaf_key]
                if not box:
                    pending[leaf_key][...] = data
                    filled[leaf_key] += 1
                    continue
                meet = _meet(box, reg_box)
                if meet is None:
                    continue
                src = tuple(slice(s - b[0], e - b[0])
                            for (s, e), b in zip(meet, box))
                dst = tuple(slice(s - r[0], e - r[0])
                            for (s, e), r in zip(meet, reg_box))
                pending[leaf_key][dst] = data[src]
                filled[leaf_key] += _box_volume(meet)
        finally:
            npz.close()
    reg.inc("ckpt/restore_read_bytes", read_bytes)
    reg.inc("ckpt/restore_skipped_bytes", skipped_bytes)
    for leaf_key, meta in manifest["leaves"].items():
        if leaf_key not in pending:
            continue  # opt-state leaf skipped by include_opt_state=False
        want = _box_volume(region[leaf_key])
        if filled[leaf_key] != want:
            scope = ("this rank's live shard box" if leaf_key in live
                     else "the global shape")
            raise ValueError(
                f"checkpoint {step_dir}: leaf '{leaf_key}' reassembled "
                f"{filled[leaf_key]}/{want} elements of {scope} — "
                f"incomplete shard set; refusing a partial restore")
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
