"""PCG sharding round-trips: degree form <-> spec form.

PyTorch counterpart of ``flexflow_tpu/parallel/pcg.py``. The canonical
``ParallelDim`` / ``ParallelTensorShape`` classes live in
``flexflow_tpu_torch.tensor`` (re-exported here): every tensor dimension
carries a parallel degree and the mesh axes it is sharded on. A spec is
the port's tuple form of ``jax.sharding.PartitionSpec`` (one entry per
dim: None, an axis name, or a tuple of names) over a ``machine.Mesh``,
whose axis sizes are the degrees.

* ``shape_from_partition_spec(shape, spec, mesh)``: spec form -> degree
  form (degrees read off the mesh's axis sizes);
* ``spec_to_degrees``: the degree vector alone;
* ``replicated_shape``: an unsharded degree-form shape.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from flexflow_tpu_torch.ffconst import DataType
from flexflow_tpu_torch.tensor import ParallelDim, ParallelTensorShape

__all__ = [
    "ParallelDim",
    "ParallelTensorShape",
    "MAX_TENSOR_DIM",
    "replicated_shape",
    "shape_from_partition_spec",
    "spec_to_degrees",
]

MAX_TENSOR_DIM = 8  # the reference's MAX_TENSOR_DIM (config.h)


def replicated_shape(shape: Sequence[int],
                     dtype: DataType = DataType.FLOAT) -> ParallelTensorShape:
    return ParallelTensorShape.make(list(shape), dtype)


def shape_from_partition_spec(shape: Sequence[int], spec: Optional[Sequence],
                              mesh, dtype: DataType = DataType.FLOAT
                              ) -> ParallelTensorShape:
    """Spec form -> degree form, reading degrees off the mesh's axis
    sizes."""
    axis_sizes = dict(mesh.shape)
    entries = list(spec) if spec is not None else []
    entries += [None] * (len(shape) - len(entries))
    dims = []
    for s, a in zip(shape, entries):
        if a is None:
            dims.append(ParallelDim(s))
        else:
            axes = a if isinstance(a, tuple) else (a,)
            deg = 1
            for ax in axes:
                deg *= axis_sizes[ax]
            dims.append(ParallelDim(s, deg, tuple(axes)))
    return ParallelTensorShape(tuple(dims), dtype)


def spec_to_degrees(shape: Sequence[int], spec: Optional[Sequence],
                    mesh) -> List[int]:
    return list(shape_from_partition_spec(shape, spec, mesh).degrees)
