"""Replay the native core's graph-rewrite trace on the port's OpNodes.

PyTorch counterpart of ``flexflow_tpu/search/rewrite.py``. The native
substitution engine (``native/ffs_subst.hpp``) rewrites the search-side
graph and reports a trace: per applied rule, the removed node guids,
descriptors of the added nodes and an output remap. ``apply_rewrites``
replays it on the materialized node list so the executor runs the
rewritten graph. The port replays the rewrites its ops can run (a
linear-fusion rule's wide LINEAR and its SPLIT, for instance); an added
node of an op type the port lacks fails the replay with the registry's
error.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.executor import OpNode
from flexflow_tpu_torch.ffconst import ActiMode, DataType, OperatorType
from flexflow_tpu_torch.layer import Layer
from flexflow_tpu_torch.ops import OpRegistry


def external_input_ids(nodes) -> Dict[Tuple, int]:
    """Stable negative guid per distinct non-op input ref, in first-seen
    order — must match serialize_graph's numbering exactly."""
    neg_of: Dict[Tuple, int] = {}
    for node in nodes:
        for ref in node.input_refs:
            if ref[0] != "op" and tuple(ref) not in neg_of:
                neg_of[tuple(ref)] = -2 - len(neg_of)
    return neg_of


def _props_from_attrs(op_type: OperatorType, attrs) -> dict:
    """Map a native node descriptor's attrs to Layer properties."""
    a = dict(attrs or {})
    p: dict = {}
    if op_type == OperatorType.LINEAR:
        p["out_dim"] = int(a["out_dim"])
        p["activation"] = ActiMode(int(a.get("activation", 0)))
        p["use_bias"] = bool(a.get("use_bias", 1))
    elif op_type == OperatorType.SPLIT:
        p["sizes"] = tuple(int(s) for s in a["sizes"])
        p["axis"] = int(a.get("axis", -1))
    elif op_type == OperatorType.CONCAT:
        p["axis"] = int(a.get("axis", 0))
    elif op_type == OperatorType.REPARTITION:
        p["dim"] = int(a.get("dim", 0))
        p["degree"] = int(a.get("degree", 1))
        # default axis assignment mirrors FFModel.repartition
        p["axis"] = "data" if p["dim"] == 0 else "model"
    elif op_type in (OperatorType.COMBINE, OperatorType.REDUCTION):
        p["dim"] = int(a.get("dim", 0))
        p["degree"] = int(a.get("degree", 1))
    elif op_type == OperatorType.REPLICATE:
        p["degree"] = int(a.get("degree", 1))
    elif op_type == OperatorType.FUSED_PARALLEL:
        # step chain [[type, dim, degree], ...] -> (type, dim, degree,
        # axis) tuples; axis assignment mirrors FFModel.repartition
        p["ops"] = [
            (str(k), int(d), int(g), "data" if int(d) == 0 else "model")
            for (k, d, g) in a["ops"]
        ]
    elif op_type == OperatorType.CONV2D:
        p["out_channels"] = int(a["out_channels"])
        p["kernel_h"] = int(a.get("kernel_h", 1))
        p["kernel_w"] = int(a.get("kernel_w", 1))
        p["stride_h"] = int(a.get("stride_h", 1))
        p["stride_w"] = int(a.get("stride_w", 1))
        p["padding_h"] = int(a.get("padding_h", 0))
        p["padding_w"] = int(a.get("padding_w", 0))
        p["groups"] = int(a.get("groups", 1))
        p["activation"] = ActiMode(int(a.get("activation", 0)))
        p["use_bias"] = bool(a.get("use_bias", 1))
    else:
        # unary / elementwise / identity need nothing; pass through extras
        for k, v in a.items():
            p[k] = v
    return p


def apply_rewrites(nodes: List[OpNode], rewrites: List[dict],
                   final_ref: Optional[Tuple[int, int]] = None,
                   ) -> Tuple[List[OpNode], Optional[Tuple[int, int]]]:
    """Apply the native rewrite trace to ``nodes``; returns the new node
    list and the (guid, out_idx) the designated output moved to.

    The caller's nodes are never mutated: a failed replay (shape
    cross-check, malformed trace) leaves them intact. All trace errors
    surface as RuntimeError.
    """
    if not rewrites:
        return nodes, final_ref
    try:
        return _apply_rewrites(nodes, rewrites, final_ref)
    except RuntimeError:
        raise
    except Exception as e:  # malformed trace: KeyError, ValueError, ...
        raise RuntimeError(f"rewrite trace replay failed: {e!r}") from e


def _apply_rewrites(nodes, rewrites, final_ref):
    # work on wrapper copies so the caller's OpNodes stay untouched even
    # when a later trace entry fails mid-replay
    nodes = [OpNode(n.op, list(n.input_refs)) for n in nodes]
    neg_of = external_input_ids(nodes)
    ref_of_neg = {v: k for k, v in neg_of.items()}
    # shapes: external inputs learned from their current consumers,
    # op outputs from the producing op
    ext_shape: Dict[int, Tuple[int, ...]] = {}
    for node in nodes:
        for slot, ref in enumerate(node.input_refs):
            if ref[0] != "op":
                ext_shape.setdefault(neg_of[tuple(ref)],
                                     node.op.input_shapes[slot])
    out_shape: Dict[Tuple[int, int], Tuple[int, ...]] = {}
    for node in nodes:
        for i, s in enumerate(node.op.output_shapes):
            out_shape[(node.guid, i)] = tuple(s)

    fin = tuple(final_ref) if final_ref is not None else None
    for entry in rewrites:
        removed = {int(g) for g in entry["removed"]}
        remap = {(int(a), int(b)): (int(c), int(d))
                 for a, b, c, d in entry.get("output_remap", [])}
        new_nodes: List[OpNode] = []
        for desc in entry["added"]:
            op_type = OperatorType[desc["type"]]
            input_refs, in_shapes = [], []
            for sg, si in desc["inputs"]:
                sg, si = int(sg), int(si)
                if sg >= 0:
                    input_refs.append(("op", sg, si))
                    in_shapes.append(out_shape[(sg, si)])
                else:
                    input_refs.append(ref_of_neg[sg])
                    in_shapes.append(ext_shape[sg])
            layer = Layer(op_type, desc["name"], [],
                          data_type=DataType.FLOAT)
            # adopt the native-assigned guid: the returned strategy and
            # downstream edges are keyed by it
            layer.guid = int(desc["guid"])
            Layer._next_guid[0] = max(Layer._next_guid[0], layer.guid + 1)
            layer.properties.update(
                _props_from_attrs(op_type, desc.get("attrs")))
            op = OpRegistry.create(layer, in_shapes)
            got = [tuple(s) for s in op.output_shapes]
            want = [tuple(int(d) for d in s) for s in desc["output_shapes"]]
            if got != want:
                raise RuntimeError(
                    f"rewrite {entry['rule']}: node {desc['name']} shapes "
                    f"{got} != native {want}")
            for i, s in enumerate(got):
                out_shape[(op.guid, i)] = s
            new_nodes.append(OpNode(op, input_refs))

        insert_at = min((i for i, n in enumerate(nodes)
                         if n.guid in removed), default=len(nodes))
        spliced: List[OpNode] = []
        for i, n in enumerate(nodes):
            if i == insert_at:
                spliced.extend(new_nodes)
            if n.guid in removed:
                continue
            n.input_refs = [
                ("op",) + remap[(r[1], r[2])]
                if (r[0] == "op" and (r[1], r[2]) in remap) else r
                for r in n.input_refs
            ]
            spliced.append(n)
        if insert_at == len(nodes):
            spliced.extend(new_nodes)
        nodes = spliced
        if fin is not None and fin in remap:
            fin = remap[fin]
    return nodes, fin
