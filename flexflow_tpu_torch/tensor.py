"""Symbolic tensors.

PyTorch counterpart of ``flexflow_tpu/tensor.py``: the frontend-facing
symbolic ``Tensor`` a ``Layer`` produces (no data is attached until
``compile``), and ``ParallelTensorShape``, whose per-dimension
``ParallelDim{size, degree, mesh_axes}`` records how a strategy shards a
tensor. Its ``partition_spec`` is the port's spec form: a tuple with one
entry per (non-replica) dim, each an axis name, a tuple of names, or
None, as ``jax.sharding.PartitionSpec`` holds them in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from flexflow_tpu_torch.ffconst import DataType


@dataclasses.dataclass(frozen=True)
class ParallelDim:
    """One dimension of a parallel tensor: ``size`` its global extent,
    ``degree`` the number of shards along it, ``mesh_axes`` the named mesh
    axes the shards map to (empty = unsharded), ``is_replica_dim`` the
    synthetic leading replica dimension (size == degree, no bytes)."""

    size: int
    degree: int = 1
    mesh_axes: Tuple[str, ...] = ()
    is_replica_dim: bool = False

    def __post_init__(self):
        if self.size % max(self.degree, 1) != 0 and not self.is_replica_dim:
            raise ValueError(
                f"dim size {self.size} not divisible by degree {self.degree}")

    @property
    def shard_size(self) -> int:
        return self.size // self.degree if not self.is_replica_dim else 1


@dataclasses.dataclass(frozen=True)
class ParallelTensorShape:
    """Shape + dtype + per-dim parallel degrees."""

    dims: Tuple[ParallelDim, ...]
    dtype: DataType = DataType.FLOAT

    @classmethod
    def make(cls, sizes: Sequence[int], dtype: DataType = DataType.FLOAT,
             degrees: Optional[Sequence[int]] = None
             ) -> "ParallelTensorShape":
        degrees = degrees or [1] * len(sizes)
        return cls(tuple(ParallelDim(s, d) for s, d in zip(sizes, degrees)),
                   dtype)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims if not d.is_replica_dim)

    @property
    def degrees(self) -> Tuple[int, ...]:
        return tuple(d.degree for d in self.dims)

    @property
    def num_replica(self) -> int:
        return math.prod(d.degree for d in self.dims if d.is_replica_dim)

    @property
    def total_degree(self) -> int:
        return math.prod(d.degree for d in self.dims)

    def num_elements(self) -> int:
        return math.prod(self.sizes) if self.sizes else 1

    def shard_bytes(self) -> int:
        n = 1
        for d in self.dims:
            if not d.is_replica_dim:
                n *= d.shard_size
        return n * self.dtype.size

    def global_bytes(self) -> int:
        return self.num_elements() * self.dtype.size

    def partition_spec(self) -> Tuple:
        """The per-dim spec entries: None, an axis name, or a tuple of
        names (replica dims carry none)."""
        entries = []
        for d in self.dims:
            if d.is_replica_dim:
                continue
            if not d.mesh_axes:
                entries.append(None)
            elif len(d.mesh_axes) == 1:
                entries.append(d.mesh_axes[0])
            else:
                entries.append(tuple(d.mesh_axes))
        return tuple(entries)


class Tensor:
    """Frontend-facing symbolic tensor: shape, dtype, producing layer."""

    _next_guid = [1000]

    def __init__(
        self,
        shape: Sequence[int],
        dtype: DataType = DataType.FLOAT,
        owner_layer=None,
        owner_idx: int = 0,
        name: Optional[str] = None,
    ):
        self.guid = Tensor._next_guid[0]
        Tensor._next_guid[0] += 1
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.name = name or f"tensor_{self.guid}"

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def num_elements(self) -> int:
        return math.prod(self.shape)

    def __repr__(self):
        owner = self.owner_layer.name if self.owner_layer is not None else None
        return f"Tensor({self.shape}, {self.dtype.value}, owner={owner})"
