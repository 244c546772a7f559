"""Conv+BatchNorm fusion eligibility.

The port's part of ``flexflow_tpu/layout.py`` that the search needs:
``serialize_graph`` marks each conv whose sole consumer is a foldable
BatchNorm with the ``bn_fusable`` attr, the legality the native
``_k:conv_bn_fused`` kernel twin gates on. The port has Conv2D but no
BatchNorm yet (ROADMAP.md Queue 1 item 9b), so for its graphs the set is
empty; the rule is written on op types so that it holds when BatchNorm
comes. The port computes the conv family in NCHW: the JAX package's
channels-last pass (``propagate_layouts``) is item 9b too, and
``FFModel.compile`` reports its absence in ``layout_info``
(``model.conv_layout_info``).
"""

from __future__ import annotations

from typing import Dict, Tuple

from flexflow_tpu_torch.ffconst import ActiMode, OperatorType


def train_fusable_conv_guids(nodes, keep_guids=()) -> set:
    """Conv2D guids whose sole consumer is a BatchNorm: the conv's one
    output feeds nothing else, the conv carries no activation of its own,
    and its output is not the designated model output (``keep_guids``)."""
    consumers: Dict[Tuple[int, int], int] = {}
    for node in nodes:
        for ref in node.input_refs:
            if ref[0] == "op":
                k = (ref[1], ref[2])
                consumers[k] = consumers.get(k, 0) + 1
    by_guid = {n.op.guid: n for n in nodes}
    out = set()
    for node in nodes:
        if node.op.op_type != OperatorType.BATCHNORM:
            continue
        ref = node.input_refs[0]
        if ref[0] != "op" or ref[2] != 0:
            continue
        prod = by_guid.get(ref[1])
        if prod is None or prod.op.op_type != OperatorType.CONV2D:
            continue
        if getattr(prod.op, "activation", None) != ActiMode.AC_MODE_NONE:
            continue
        if consumers.get((ref[1], 0), 0) != 1 or ref[1] in keep_guids:
            continue
        out.add(prod.op.guid)
    return out
