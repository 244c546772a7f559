"""Symbolic tensors.

PyTorch counterpart of ``flexflow_tpu/tensor.py``'s ``Tensor``: the
frontend-facing symbolic tensor a ``Layer`` produces. No data is attached
until ``compile``. ``ParallelTensorShape`` (per-dimension sharding
degrees) comes with the multi-GPU slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

from flexflow_tpu_torch.ffconst import DataType


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
