"""Named device meshes.

PyTorch counterpart of ``flexflow_tpu/machine.py``'s ``make_mesh`` only
(the machine model, ``MachineSpec`` and ``CHIP_SPECS``, comes with the
search slice). A ``Mesh`` names its axes and their sizes, as the
reference's ``jax.sharding.Mesh`` does; it holds no devices. One process
runs a mesh whose only axis above 1 is the sequence axis of ring
attention: every ring position lives on the model's one device
(``parallel/ring_attention.py``, ``LocalRing``). A mesh with any other
axis above 1 needs multi-GPU execution (ROADMAP.md Queue 1 item 3).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional


class Mesh:
    """Axis names and sizes of a logical device mesh."""

    def __init__(self, axes: Dict[str, int]):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in axes.items()}
        if any(v < 1 for v in self.shape.values()):
            raise ValueError(f"mesh axes {axes}: every size must be >= 1")

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(num_devices: int, axes: Dict[str, int]) -> Mesh:
    """A named mesh of ``num_devices`` over ``axes`` (axis name -> size),
    whose sizes must multiply to ``num_devices``. Canonical names as in the
    reference: 'data', 'model', 'seq', 'expert'."""
    if math.prod(axes.values()) != num_devices:
        raise ValueError(f"mesh axes {axes} != {num_devices} devices")
    return Mesh(axes)


def local_ring_axis(mesh: Optional[Mesh],
                    seq_axes: Iterable[str] = ("seq",)) -> Optional[str]:
    """The axis of ``mesh`` that one process runs as a ring on one device:
    the one axis above 1, which must be one of ``seq_axes``; None when no
    axis is above 1. Raises NotImplementedError for any other mesh."""
    big = [a for a, n in (mesh.shape if mesh else {}).items() if n > 1]
    if not big:
        return None
    if len(big) > 1 or big[0] not in set(seq_axes):
        raise NotImplementedError(
            f"mesh {mesh.shape}: one process runs only a mesh whose one axis "
            f"above 1 is a ring-attention sequence axis {sorted(seq_axes)}; "
            f"other axes need multi-GPU execution (ROADMAP.md Queue 1 item "
            f"3)")
    return big[0]
