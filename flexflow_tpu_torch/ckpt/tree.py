"""Tree <-> flat-key plumbing shared by both checkpoint formats.

PyTorch counterpart of ``flexflow_tpu/ckpt/tree.py``: one
flatten/skeleton/rebuild/place implementation serves the v1 single-file
path (``flexflow_tpu_torch/checkpoint.py``) and the v2 per-shard package
(``ckpt/sharded.py``): '/'-joined key paths over any nesting of
dict/list/tuple with tensor leaves, and a JSON-able structure skeleton,
both exactly the reference's, so the keys and skeletons in a checkpoint
are the same whichever package wrote it.

``place_tree`` writes restored values INTO the live tensors with
``copy_`` (on their device, cast to their dtype) and never rebinds them:
the compiled steps (``step_graph.py``) hold the first call's carry as
their CUDA graphs' static buffers, so a rebound carry would drop the
forward's graph (``donate=False``) or be copied in on every train call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def flatten_tree(tree, prefix="") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_tree(tree[k], f"{prefix}{k}/")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_tree(v, f"{prefix}{i}/")
        return out
    return [(prefix[:-1], tree)]


def tree_structure(tree):
    """JSON-able skeleton used to rebuild nesting on load."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: tree_structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple",
                "items": [tree_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list",
                "items": [tree_structure(v) for v in tree]}
    return {"__kind__": "leaf"}


def rebuild_tree(skel, flat: Dict[str, Any], prefix=""):
    kind = skel["__kind__"]
    if kind == "dict":
        return {k: rebuild_tree(v, flat, f"{prefix}{k}/")
                for k, v in skel["items"].items()}
    if kind in ("list", "tuple"):
        seq = [rebuild_tree(v, flat, f"{prefix}{i}/")
               for i, v in enumerate(skel["items"])]
        return tuple(seq) if kind == "tuple" else seq
    return flat[prefix[:-1]]


def _same_shifted_names(live: Dict[str, Any], new: Dict[str, Any]) -> bool:
    """True when two key sets agree after stripping trailing _<guid>
    counters from auto-generated op names: a second model built in one
    process, worth its own diagnosis."""
    def stem(k: str) -> str:
        base, _, tail = k.rpartition("_")
        return base if base and tail.isdigit() else k

    return (len(live) == len(new)
            and sorted(map(stem, live)) == sorted(map(stem, new)))


def place_tree(live, new):
    """Write a restored tree into the live one; returns the live tree.

    Structure and per-leaf shapes must match. Each restored leaf (a
    tensor or a numpy array) is copied into the live tensor in place, on
    its device and cast to its dtype, as the reference casts to the live
    dtype. A non-tensor live leaf takes the restored value."""
    if isinstance(live, dict):
        if not isinstance(new, dict) or set(new) != set(live):
            hint = ""
            if isinstance(new, dict) and _same_shifted_names(live, new):
                hint = (
                    " — the op names differ only by their auto-name "
                    "counters: auto-generated names (linear_7, ...) are "
                    "deterministic for a fresh process rebuilding the "
                    "same script (a normal restart), but NOT for a "
                    "second model built in one process; pass explicit "
                    "name= to the ops to make checkpoint keys "
                    "build-order-independent")
            raise ValueError(
                f"checkpoint structure mismatch: expected keys "
                f"{sorted(live)}, found "
                f"{sorted(new) if isinstance(new, dict) else type(new)}"
                f"{hint}")
        for k in live:
            live[k] = place_tree(live[k], new[k])
        return live
    if isinstance(live, (list, tuple)):
        if not isinstance(new, (list, tuple)) or len(new) != len(live):
            raise ValueError(
                f"checkpoint structure mismatch: expected sequence of "
                f"{len(live)}, found {new!r:.80}")
        rebuilt = [place_tree(l, n) for l, n in zip(live, new)]
        return type(live)(rebuilt) if isinstance(live, tuple) else rebuilt
    if isinstance(live, torch.Tensor):
        if tuple(live.shape) != tuple(np.shape(new)):
            raise ValueError(
                f"checkpoint shape {tuple(np.shape(new))} != live "
                f"{tuple(live.shape)}")
        src = new if isinstance(new, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(new))
        with torch.no_grad():
            live.copy_(src)
        return live
    return new
