"""Strategy files and choice names (partial).

PyTorch counterpart of the parts of ``flexflow_tpu/search/unity.py`` that
one device needs: ``kernel_choice_of`` / ``remat_choice_of`` read the
suffix lattice of a choice name (canonical order
``base[_wus][_ovl][_k:impl][_r]``), and ``import_strategy_file`` reads a
strategy file written by either package and returns each op's
``choice``. On one device every output and parameter spec is replicated,
so the specs a file carries are accepted and not used.

Not in this slice: a mesh of more than one device (the multi-GPU slice,
4), ``_r`` remat choices (the remat slice, 5), ``export_strategy_file``
and the search itself (the search slice, 3).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Tuple


def kernel_choice_of(choice: Optional[str]) -> Optional[str]:
    """Kernel impl a choice name selects (the ``_k:<impl>`` suffix), or
    None for the default lowering. The trailing ``_r`` remat suffix is
    not part of the impl name."""
    if not choice or "_k:" not in choice:
        return None
    impl = choice.split("_k:", 1)[1]
    if impl.endswith("_r"):
        impl = impl[:-2]
    return impl or None


def remat_choice_of(choice: Optional[str]) -> bool:
    """Whether a choice name selects the rematerialized (``_r``) twin."""
    return bool(choice) and choice.endswith("_r")


def import_strategy_file(path: str, nodes
                         ) -> Tuple[Dict[str, int], Dict[int, Optional[str]]]:
    """Read a strategy file -> (mesh axes, {op guid: choice}) for the ops
    of ``nodes`` the file names. Raises on a mesh of more than one device
    and on a ``_r`` choice, which later slices bring."""
    with open(path) as f:
        data = json.load(f)
    mesh_axes = {k: int(v) for k, v in data["mesh"].items()}
    if math.prod(mesh_axes.values()) > 1:
        raise NotImplementedError(
            f"strategy file {path}: mesh {mesh_axes} spans "
            f"{math.prod(mesh_axes.values())} devices; multi-GPU execution "
            f"comes with the multi-GPU slice of the PyTorch port (slice 4)")
    choices: Dict[int, Optional[str]] = {}
    for node in nodes:
        oj = data["ops"].get(node.op.name)
        if oj is None:
            continue
        choice = oj.get("choice")
        if remat_choice_of(choice):
            raise NotImplementedError(
                f"strategy file {path}: op {node.op.name!r} has the remat "
                f"choice {choice!r}; remat comes with the remat slice of "
                f"the PyTorch port (slice 5)")
        choices[node.op.guid] = choice
    return mesh_axes, choices


def export_strategy_file(*args, **kwargs):
    raise NotImplementedError(
        "export_strategy_file: strategy export comes with the search slice "
        "of the PyTorch port (slice 3)")
