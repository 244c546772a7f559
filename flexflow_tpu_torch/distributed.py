"""Multi-rank execution: the process group, rank agreement and batch rows.

PyTorch counterpart of ``flexflow_tpu/distributed.py``. Where the JAX
package runs one process per host, each driving that host's devices over
one global ``jax.sharding.Mesh``, the port runs one ``torch.distributed``
rank per device: a data x model mesh of n devices is a process group of n
ranks, and rank r holds the mesh position JAX's device r holds
(``machine.Mesh.coords``). Each rank feeds only the batch rows its
position holds (``local_batch_rows``), and the collectives a strategy
needs are issued by the executor over the mesh's subgroups
(``parallel/comm.py``).

Transport: NCCL for CUDA tensors, gloo for CPU tensors. Ranks that share
one card (NCCL refuses two ranks on one GPU) run over gloo only when the
caller names it, ``initialize(..., backend="gloo")``; the collectives
then stage CUDA tensors through host buffers (``parallel/comm.py``).
Nothing here falls back from one backend to the other.

Entry points:
  * ``initialize(...)`` / ``initialize_from_config(cfg)``: start the group
    (explicit arguments, else torchrun's ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``, else
    ``FLEXFLOW_COORDINATOR`` / ``FLEXFLOW_NODE_RANK`` /
    ``FLEXFLOW_NUM_PROCESSES``).
  * ``allgather_value`` / ``ranks_agree``: every rank's copy of a host
    scalar, checked before the first per-batch collective (and before a
    checkpoint load or fresh start diverges the ranks); ``barrier``.
  * ``process_index`` / ``process_count``: the group's (rank, world),
    ``(0, 1)`` without a group.
  * ``local_batch_rows(sharding, global_rows)``: the rows of a batch this
    rank feeds, and at which offset.
  * ``all_gather_host(local, sharding)``: the whole array on every rank.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh: the port's ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Tuple = ()


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *,
               backend: Optional[str] = None,
               local_rank: Optional[int] = None, store=None,
               timeout_s: float = 600.0) -> None:
    """Start the default process group (idempotent).

    ``backend`` None takes NCCL where a CUDA device is present and gloo
    otherwise; ``"gloo"`` with a CUDA device is the caller's choice for
    ranks that share one card. Each rank's CUDA device is
    ``local_rank % torch.cuda.device_count()`` (``LOCAL_RANK``, else the
    rank). The rendezvous is ``store`` or ``init_method`` when given
    (``tcp://host:port``, ``file://path``), else ``env://`` under
    torchrun, else ``tcp://$FLEXFLOW_COORDINATOR``."""
    import torch

    dist = _dist()
    if is_initialized():
        return
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE")
                         or env.get("FLEXFLOW_NUM_PROCESSES") or 1)
    if rank is None:
        rank = int(env.get("RANK") or env.get("FLEXFLOW_NODE_RANK") or 0)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend='nccl' needs a CUDA device; none is "
                           "available")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kwargs = dict(backend=backend, world_size=world_size, rank=rank,
                  timeout=timedelta(seconds=timeout_s))
    if store is not None:
        kwargs["store"] = store
    elif init_method is not None:
        kwargs["init_method"] = init_method
    elif "MASTER_ADDR" in env:
        kwargs["init_method"] = "env://"
    elif env.get("FLEXFLOW_COORDINATOR"):
        kwargs["init_method"] = f"tcp://{env['FLEXFLOW_COORDINATOR']}"
    else:
        raise ValueError(
            "no rendezvous: pass init_method (tcp://host:port or "
            "file://path) or store, launch under torchrun, or set "
            "FLEXFLOW_COORDINATOR")
    dist.init_process_group(**kwargs)


def initialize_from_config(cfg) -> bool:
    """Driver hook: start the group when the launch has more than one
    rank on this node (torchrun's ``WORLD_SIZE``, or
    ``FLEXFLOW_NUM_PROCESSES`` with ``FLEXFLOW_COORDINATOR``), reading the
    rank and rendezvous from the environment or the config's
    ``--coordinator`` / ``--node-rank``. More than one node
    (``--nodes`` / ``FLEXFLOW_NUM_NODES`` above 1) raises: multi-node
    runs are ROADMAP.md Queue 1 item 13. Returns whether a group runs."""
    env = os.environ
    nodes = max(int(getattr(cfg, "num_nodes", 1) or 1),
                int(env.get("FLEXFLOW_NUM_NODES", "1")))
    if nodes > 1:
        raise NotImplementedError(
            f"{nodes} nodes: a multi-node run is ROADMAP.md Queue 1 item 13 "
            f"(it runs on the multi-rank executor of item 3); the port's "
            f"ranks share one node")
    world = int(env.get("WORLD_SIZE") or env.get("FLEXFLOW_NUM_PROCESSES")
                or 1)
    if world <= 1:
        return is_initialized()
    coord = getattr(cfg, "coordinator_address", None)
    rank = getattr(cfg, "node_rank", -1)
    initialize(init_method=f"tcp://{coord}" if coord else None,
               world_size=world, rank=rank if rank >= 0 else None)
    return True


def allgather_value(value: int) -> list:
    """Every rank's copy of a host-side integer (one collective): the
    agreement check that turns a would-be deadlock into a diagnosis
    (loop counts derived from per-rank data must match before any rank
    enters a per-batch collective). One process: ``[value]``."""
    if process_count() <= 1:
        return [int(value)]
    out = [None] * process_count()
    _dist().all_gather_object(out, int(value))
    return [int(v) for v in out]


def ranks_agree(value) -> Tuple[list, bool]:
    """(per-rank values, all equal?) for a host-side integer."""
    vals = allgather_value(value)
    return vals, len(set(vals)) == 1


def barrier() -> None:
    """Every rank waits here until all have arrived (one collective);
    nothing without a group. Never called from the checkpoint writer's
    thread: its barrier is the filesystem's (``ckpt/manifest.py``)."""
    if process_count() > 1:
        _dist().barrier()


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (one collective); the object
    itself without a group."""
    if process_count() <= 1:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


# ---------------------------------------------------------------------------
# per-rank batch rows


def _batch_axes(sharding) -> Tuple[str, ...]:
    spec = tuple(sharding.spec or ())
    if not spec or spec[0] is None:
        return ()
    e = spec[0]
    axes = e if isinstance(e, tuple) else (e,)
    return tuple(a for a in axes if a is not None)


def local_batch_rows(sharding: Sharding, global_rows: int,
                     rank: Optional[int] = None) -> Tuple[int, int]:
    """(rows, offset) of the contiguous block of a ``global_rows``-row
    batch that rank ``rank`` (default: this process's) feeds under
    ``sharding``: the block its mesh position holds along the batch
    dim's axes. One process without a group, or a batch replicated over
    the mesh: ``(global_rows, 0)``."""
    if rank is None:
        if process_count() <= 1:
            return global_rows, 0
        rank = process_index()
    mesh = sharding.mesh
    axes = _batch_axes(sharding)
    parts = 1
    for a in axes:
        parts *= mesh.shape[a]
    if global_rows % parts != 0:
        raise ValueError(f"batch of {global_rows} rows cannot split over "
                         f"{parts} mesh shards")
    rows = global_rows // parts
    return rows, rows * mesh.block_index(axes, rank) if axes else 0


def stage_local_batch(local, sharding: Sharding,
                      global_rows: Optional[int] = None):
    """This rank's rows as the batch it feeds: a rank is one device, so
    its staged batch is ``local`` itself, checked against the rows its
    position holds when ``global_rows`` is given."""
    local = np.asarray(local)
    if global_rows is not None:
        rows, _ = local_batch_rows(sharding, global_rows)
        if local.shape[0] != rows:
            raise ValueError(f"this rank feeds {rows} rows of a "
                             f"{global_rows}-row batch, got "
                             f"{local.shape[0]}")
    return local


def all_gather_host(local, sharding: Sharding) -> np.ndarray:
    """The whole array on every rank, as numpy, from each rank's box
    ``local`` (a tensor) under ``sharding``: the escape hatch of
    ``predict`` and ``get_parameter``. One process: ``local`` itself."""
    import torch

    if process_count() <= 1:
        return np.asarray(local.detach().cpu() if isinstance(
            local, torch.Tensor) else local)
    from flexflow_tpu_torch.parallel.comm import mesh_comm, norm_spec

    comm = mesh_comm(sharding.mesh)
    whole = comm.gather_whole(local, norm_spec(sharding.spec, local.dim(),
                                               sharding.mesh))
    return whole.detach().float().cpu().numpy() if whole.is_floating_point() \
        else whole.detach().cpu().numpy()
