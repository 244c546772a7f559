"""v2 checkpoint directory layout, commit protocol, and integrity checks.

The PyTorch port's own copy of ``flexflow_tpu/ckpt/manifest.py`` (plain
Python, the same layout and records), so that either package reads what
the other writes.

Layout (one root directory per run):

    <ckpt_dir>/
      step_00000004/
        shards_host0000.npz    each host's addressable shards (tmp+replace)
        index_host0000.json    that host's shard index + checksums
        MANIFEST.json          the COMMIT RECORD — written last, by rank 0
      step_00000008/ ...
      PROGRESS.json            rank-0 heartbeat (restart-lost-step accounting)

Commit protocol: every host writes its shards file, fsyncs, renames,
then writes its index file (atomic) — shard data is durable before any
index references it. Rank 0 then waits for every host's index file to
appear (a filesystem barrier: works from a background writer thread,
needs no collectives, and on a non-shared filesystem fails with an
actionable timeout instead of deadlocking) and writes ``MANIFEST.json``
last. A checkpoint directory without a readable manifest is by
definition incomplete: a preemption at ANY point during save leaves
either a complete previous checkpoint plus an inert partial directory,
or a complete new checkpoint — never an ambiguous state.

``verify_step_dir`` re-derives completeness from first principles
(manifest present, every indexed shard present, checksums match, shard
boxes tile each leaf's global shape).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

MANIFEST_NAME = "MANIFEST.json"
PROGRESS_NAME = "PROGRESS.json"
SUPERVISOR_NAME = "SUPERVISOR.json"
STEP_RE = re.compile(r"^step_(\d{8})$")
CKPT_VERSION = 2


def step_dir_name(step: int) -> str:
    return f"step_{int(step):08d}"


def shards_name(host: int) -> str:
    return f"shards_host{int(host):04d}.npz"


def index_name(host: int) -> str:
    return f"index_host{int(host):04d}.json"


@contextlib.contextmanager
def atomic_replace(path: str, mode: str = "wb"):
    """tmp + fsync + ``os.replace``: the destination either exists
    whole or not at all (the property the manifest-last commit
    protocol rests on). Yields the open tmp file; an exception in the
    body unlinks the tmp and never touches the destination. The ONE
    implementation of the crash-atomicity protocol — the v1 .npz, the
    v2 shard files, and every JSON record go through here."""
    from flexflow_tpu_torch.ckpt import faults
    faults.io_check(path)  # the io_error transient-failure seam
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_",
                               suffix=os.path.basename(path) + ".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    with atomic_replace(path, "w") as f:
        json.dump(obj, f, indent=1)


def read_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def crc32_bytes(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# directory enumeration


def list_steps(directory: str) -> List[Tuple[int, str, bool]]:
    """[(step, step_dir_path, complete)] sorted ascending by step.
    ``complete`` means a readable manifest exists (the commit record);
    deep integrity is ``verify_step_dir``'s job."""
    out = []
    try:
        entries = sorted(os.listdir(directory))
    except OSError:
        return []
    for e in entries:
        m = STEP_RE.match(e)
        if not m:
            continue
        path = os.path.join(directory, e)
        if not os.path.isdir(path):
            continue
        manifest = read_json(os.path.join(path, MANIFEST_NAME))
        out.append((int(m.group(1)), path, manifest is not None))
    return out


def latest_complete(directory: str) -> Optional[Tuple[int, str]]:
    """(step, step_dir) of the newest committed checkpoint, or None."""
    steps = [(s, p) for s, p, ok in list_steps(directory) if ok]
    return steps[-1] if steps else None


def resolve_step_dir(path: str) -> Optional[str]:
    """``path`` may be a step directory or a checkpoint root — return
    the step dir of the newest complete checkpoint (None when there is
    none)."""
    if os.path.isfile(os.path.join(path, MANIFEST_NAME)):
        return path
    latest = latest_complete(path)
    return latest[1] if latest else None


# ---------------------------------------------------------------------------
# integrity verification


def verify_step_dir(step_dir: str, deep: bool = True) -> Dict[str, Any]:
    """Re-derive a checkpoint's integrity from its files.

    Returns ``{complete, errors, step, num_hosts, shard_count,
    payload_bytes, manifest}``. ``deep=True`` additionally re-reads
    every shard and checks its CRC32 against the index (the
    ``corrupt_shard`` fault-injection target); ``deep=False`` checks
    structure only (manifest/index presence, shard-key existence,
    coverage arithmetic).
    """
    import numpy as np

    errors: List[str] = []
    manifest = read_json(os.path.join(step_dir, MANIFEST_NAME))
    if manifest is None:
        return dict(complete=False, step=None, num_hosts=0, shard_count=0,
                    payload_bytes=0, manifest=None,
                    errors=[f"no readable {MANIFEST_NAME} (checkpoint was "
                            f"never committed or is mid-write)"])
    leaves = manifest.get("leaves", {})
    covered = {k: 0 for k in leaves}
    shard_count = 0
    payload_bytes = 0
    for idx_file in manifest.get("index_files", []):
        ipath = os.path.join(step_dir, idx_file)
        index = read_json(ipath)
        if index is None:
            errors.append(f"missing/unreadable shard index {idx_file}")
            continue
        spath = os.path.join(step_dir, index["shards_file"])
        npz = None
        if os.path.exists(spath):
            try:
                npz = np.load(spath)
            except Exception as e:
                errors.append(f"unreadable shards file "
                              f"{index['shards_file']}: {e}")
        else:
            errors.append(f"missing shards file {index['shards_file']}")
        for leaf_key, shards in index.get("shards", {}).items():
            if leaf_key not in leaves:
                errors.append(f"index {idx_file} carries unknown leaf "
                              f"'{leaf_key}'")
                continue
            for sh in shards:
                shard_count += 1
                payload_bytes += int(sh.get("bytes", 0))
                box = sh.get("index", [])
                covered[leaf_key] += int(
                    np.prod([max(0, b[1] - b[0]) for b in box])
                    if box else 1)
                if npz is None:
                    continue
                key = sh["key"]
                # chunked shards (ckpt/sharded.py chunk
                # threshold) store only their chunk entries in the npz;
                # the base key is the row's logical name
                pieces = sh.get("chunks") or [sh]
                missing = [p["key"] for p in pieces
                           if p["key"] not in npz.files]
                if missing:
                    errors.append(
                        f"shard '{key}' pieces {missing} listed in "
                        f"{idx_file} absent from {index['shards_file']}")
                    continue
                if deep:
                    # the shared per-piece CRC check (sharded._crc_check
                    # via verify_shard_row) — same "intact" definition
                    # as restore, but piece-by-piece with NO reassembly:
                    # verifying a multi-GB chunked shard needs O(chunk)
                    # memory, not 2x the shard. Lazy import: sharded
                    # imports this module at top level.
                    from flexflow_tpu_torch.ckpt.sharded import \
                        verify_shard_row
                    try:
                        verify_shard_row(npz, sh)
                    except ValueError as e:  # stored-CRC mismatch
                        errors.append(
                            f"{e} on '{leaf_key}' — on-disk corruption")
                    except Exception as e:  # zip CRC / truncation
                        errors.append(
                            f"shard '{key}' of '{leaf_key}' is "
                            f"unreadable ({e}) — on-disk corruption")
    for leaf_key, meta in leaves.items():
        want = int(np.prod(meta["shape"])) if meta["shape"] else 1
        if covered.get(leaf_key, 0) != want:
            errors.append(
                f"leaf '{leaf_key}': shard boxes cover "
                f"{covered.get(leaf_key, 0)}/{want} elements — "
                f"incomplete shard set")
    return dict(complete=not errors, step=manifest.get("step"),
                num_hosts=len(manifest.get("index_files", [])),
                shard_count=shard_count, payload_bytes=payload_bytes,
                manifest=manifest, errors=errors)


# ---------------------------------------------------------------------------
# filesystem barrier + retain-N garbage collection


def wait_for_files(paths: List[str], timeout_s: float,
                   what: str) -> None:
    """Poll until every path exists (the cross-host commit barrier that
    needs no collectives). Raises TimeoutError with an actionable
    message — the non-shared-filesystem failure mode must be a
    diagnosis, not a hang."""
    deadline = time.monotonic() + timeout_s
    missing = [p for p in paths if not os.path.exists(p)]
    while missing:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint barrier: {what} did not appear within "
                f"{timeout_s:.0f}s: {[os.path.basename(p) for p in missing]}"
                f" — is the checkpoint directory on a filesystem shared "
                f"by every host (GCS/NFS)? Per-shard checkpoints require "
                f"one.")
        time.sleep(0.05)
        missing = [p for p in missing if not os.path.exists(p)]


def collect_garbage(directory: str, retain: int) -> List[str]:
    """Delete committed checkpoints beyond the newest ``retain`` plus
    abandoned partial directories older than the newest committed step.
    NEVER deletes the last complete checkpoint (retain floor of 1), and
    never touches partial dirs newer than it (they may be mid-write).
    Returns the deleted paths. Caller gates to rank 0."""
    import shutil

    retain = max(1, int(retain))
    steps = list_steps(directory)
    complete = [(s, p) for s, p, ok in steps if ok]
    if not complete:
        return []
    newest_complete = complete[-1][0]
    doomed = [p for s, p in complete[:-retain]]
    doomed += [p for s, p, ok in steps
               if not ok and s < newest_complete]
    deleted = []
    for p in doomed:
        try:
            shutil.rmtree(p)
            deleted.append(p)
        except OSError:
            pass
    return deleted


def note_progress(directory: str, iteration: int) -> None:
    """Rank-0 heartbeat: the last iteration the (possibly doomed) run
    reached. Resume reads it to account restart-lost steps in the
    goodput metric."""
    atomic_write_json(os.path.join(directory, PROGRESS_NAME),
                      dict(iteration=int(iteration), wall_unix=time.time()))


def read_progress(directory: str) -> int:
    data = read_json(os.path.join(directory, PROGRESS_NAME))
    return int(data["iteration"]) if data and "iteration" in data else -1


def read_supervisor(directory: str) -> Optional[Dict[str, Any]]:
    """The supervisor's state record (``runtime_health.Supervisor``), when this
    run lives under one — restart counts and cumulative backoff
    downtime, which ``CheckpointManager.finalize`` folds into
    ``goodput_effective``."""
    return read_json(os.path.join(directory, SUPERVISOR_NAME))
