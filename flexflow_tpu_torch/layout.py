"""Channels-last layout pass, and the Conv+BatchNorm folds and fusion.

PyTorch counterpart of ``flexflow_tpu/layout.py``. NCHW stays the API
and PCG layout. The pass (``propagate_layouts``) gives each materialized
op an *execution* layout: conv-family ops (Conv2D, Pool2D, BatchNorm,
GroupNorm) compute channels-last, layout-oblivious ops (elementwise,
dropout) pass a channels-last value through, and Concat joins
channels-last values, so that the conversions happen once per conv
chain (at graph inputs and at the first consumer that wants NCHW), not
around every op. The bookkeeping is the reference's, so ``layout_info``
(``enabled``, ``nhwc_ops``, ``transposes``, ``boundaries``) is the JAX
package's for the same graph and mode. The execution is PyTorch's idiom:
a channels-last ("NHWC") value is a logical ``[N, C, H, W]`` tensor in
``torch.channels_last`` memory, not a permuted shape, and a boundary is
``x.contiguous(memory_format=torch.channels_last)`` on the way in and
``x.contiguous()`` on the way out, made by the executor once a value
(``GraphExecutor.run_graph``). cuDNN convolves channels-last natively,
which spares the NCHW<->NHWC transforms it runs around every NCHW call.

Also here, the three ways a Conv2D and its BatchNorm run as one node:
``fold_conv_bn`` (``FoldedConvBN``), the eval fold that eval, forward and
``predict`` run; ``fuse_conv_bn_train`` (``TrainFusedConvBN``), the
train-time ``_k:conv_bn_fused`` region a strategy may choose; and
``train_fusable_conv_guids``, the legality both share, which the search
reads as the ``bn_fusable`` attr.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from flexflow_tpu_torch.ffconst import ActiMode, OperatorType

NCHW = "NCHW"
NHWC = "NHWC"

LAYOUT_MODES = ("auto", "nhwc", "nchw")

# ops that compute channels-last when the pass is on
_NHWC_COMPUTE = {
    OperatorType.CONV2D,
    OperatorType.POOL2D,
    OperatorType.BATCHNORM,
    OperatorType.GROUPNORM,
}

# layout-oblivious single-input ops: a channels-last value flows through
_PASS_THROUGH = {
    OperatorType.RELU, OperatorType.GELU, OperatorType.SIGMOID,
    OperatorType.TANH, OperatorType.ELU, OperatorType.EXP,
    OperatorType.SIN, OperatorType.COS, OperatorType.RSQRT,
    OperatorType.LOG, OperatorType.IDENTITY, OperatorType.POW,
    OperatorType.SCALAR_MULTIPLY, OperatorType.SCALAR_ADD,
    OperatorType.SCALAR_SUB, OperatorType.SCALAR_TRUE_DIV,
    OperatorType.DROPOUT,
}

# elementwise binaries: transparent when both operands have one 4-D shape
_BINARY = {
    OperatorType.EW_ADD, OperatorType.EW_SUB, OperatorType.EW_MUL,
    OperatorType.EW_DIV, OperatorType.EW_MAX, OperatorType.EW_MIN,
}


def _rank4(shape) -> bool:
    return len(shape) == 4


def layout_enabled(mode: str, on_accelerator: bool) -> bool:
    """``"nhwc"`` forces the pass on, ``"nchw"`` off; ``"auto"`` turns it
    on on the card (the reference's "on the accelerator") and keeps NCHW
    on the CPU, so the CPU tests run the reference layout by default."""
    mode = (mode or "auto").lower()
    if mode not in LAYOUT_MODES:
        raise ValueError(f"conv_compute_layout expects auto|nhwc|nchw, got "
                         f"{mode!r}")
    if mode == "nhwc":
        return True
    if mode == "nchw":
        return False
    return on_accelerator


def propagate_layouts(nodes, mode: str = "auto",
                      on_accelerator: bool = False) -> Dict[str, Any]:
    """Assign execution layouts over a materialized OpNode list.

    Sets, on every node, ``input_layouts`` / ``output_layouts`` (what its
    forward consumes and produces). Returns ``enabled``, ``nhwc_ops`` (ops
    computing channels-last), ``transposes`` (the boundary conversions
    the executor makes) and ``boundaries`` (each one's (input ref,
    wanted layout))."""
    enabled = layout_enabled(mode, on_accelerator)
    layout_of: Dict[Tuple[int, int], str] = {}
    nhwc_ops = 0
    boundary: set = set()

    for node in nodes:
        op = node.op
        have: List[str] = [layout_of.get((ref[1], ref[2]), NCHW)
                           if ref[0] == "op" else NCHW  # inputs are NCHW
                           for ref in node.input_refs]
        t = op.op_type
        out_layout = NCHW
        if enabled and t in _NHWC_COMPUTE and op.input_shapes \
                and _rank4(op.input_shapes[0]):
            in_layouts = [NHWC] * len(node.input_refs)
            out_layout = NHWC
            nhwc_ops += 1
        elif enabled and t == OperatorType.CONCAT \
                and all(_rank4(s) for s in op.input_shapes) \
                and have and all(h == NHWC for h in have):
            in_layouts = [NHWC] * len(node.input_refs)
            out_layout = NHWC
            nhwc_ops += 1
        elif enabled and t in _PASS_THROUGH and op.input_shapes \
                and _rank4(op.input_shapes[0]) and have and have[0] == NHWC:
            in_layouts = [NHWC] * len(node.input_refs)
            out_layout = NHWC
        elif enabled and t in _BINARY and len(op.input_shapes) == 2 \
                and all(_rank4(s) for s in op.input_shapes) \
                and op.input_shapes[0] == op.input_shapes[1] \
                and all(h == NHWC for h in have):
            in_layouts = [NHWC, NHWC]
            out_layout = NHWC
        else:
            in_layouts = [NCHW] * len(node.input_refs)

        node.input_layouts = in_layouts
        node.output_layouts = [out_layout] * len(op.output_shapes)
        for i in range(len(op.output_shapes)):
            layout_of[(op.guid, i)] = out_layout
        for ref, want, h in zip(node.input_refs, in_layouts, have):
            if want != h:
                boundary.add((tuple(ref), want))
    return dict(enabled=enabled, nhwc_ops=nhwc_ops,
                transposes=len(boundary),
                boundaries=sorted(boundary, key=repr))


def to_layout(x: torch.Tensor, layout: str) -> torch.Tensor:
    """A 4-D value in the memory format of ``layout`` (a copy unless it is
    already there); values of other ranks have only the one layout."""
    if x.dim() != 4:
        return x
    return x.contiguous(memory_format=torch.channels_last
                        if layout == NHWC else torch.contiguous_format)


# ---------------------------------------------------------------------------
# Conv + BatchNorm as one node


class _ConvBNNode:
    """What a Conv2D and the BatchNorm it feeds share as one node: the
    conv's input, the BN's output (consumers reference the BN's guid) and
    both ops' parameters and state, read under their own names
    (``param_sources``), so that the parameter and state trees keep their
    shape whichever node list runs."""

    op_type = OperatorType.CONV2D

    def __init__(self, conv_op, bn_op):
        self.conv = conv_op
        self.bn = bn_op
        self.name = f"{conv_op.name}+{bn_op.name}"
        self.guid = bn_op.guid
        self.output_shapes = list(bn_op.output_shapes)
        self.param_sources = (conv_op.name, bn_op.name)

    def __repr__(self):
        return f"{type(self).__name__}({self.name})"


class FoldedConvBN(_ConvBNNode):
    """Conv2D + BatchNorm(+ReLU) as one convolution, for eval and
    inference: with the running statistics (m, v) and the BN affine
    (g, b), ``w' = w * g / sqrt(v + eps)`` per output channel and
    ``b' = (conv bias - m) * g / sqrt(v + eps) + b``, computed in f32
    from the live parameters and statistics on every call, then one
    convolution through Conv2D's core with the bias and ReLU epilogue.
    ``transforms.fold_conv_batchnorm`` is the offline form."""

    # the fold reads the f32 master parameters, not the compute copy: the
    # folded weights are rounded to the compute dtype once, after folding
    reads_master_params = True

    def forward_with_state(self, params, inputs, ctx, state):
        (x,) = inputs
        cp = params.get(self.conv.name, {})
        bp = params.get(self.bn.name, {})
        st = (state or {}).get(self.bn.name) or {}
        inv = (torch.rsqrt(st["var"].float() + self.bn.eps)
               * bp["scale"].float())
        w = cp["kernel"].float() * inv[:, None, None, None]
        cb = cp.get("bias")
        base = cb.float() if cb is not None else 0.0
        b = (base - st["mean"].float()) * inv + bp["bias"].float()
        act = ActiMode.AC_MODE_RELU if self.bn.relu else ActiMode.AC_MODE_NONE
        return [self.conv._conv_forward(w, b, x, ctx, act)], {}


class TrainFusedConvBN(_ConvBNNode):
    """Conv2D + BatchNorm as one node at train time: the
    ``_k:conv_bn_fused`` kernel choice. Training BN normalizes with the
    batch's statistics, so nothing folds into the weights: the node runs
    the conv's forward, then the BN's, and returns the BN's new running
    statistics under the BN's name. The reference lets XLA fuse the BN
    into the conv's epilogue inside such a region; eager PyTorch runs
    the same kernels as the unfused pair, so the fused region is the
    pair bit for bit and fuses nothing on the device."""

    def forward_with_state(self, params, inputs, ctx, state):
        y = self.conv.forward(params.get(self.conv.name, {}), inputs, ctx)
        outs, new = self.bn.forward_with_state(
            params.get(self.bn.name, {}), y, ctx,
            (state or {}).get(self.bn.name))
        return outs, ({self.bn.name: new} if new is not None else {})


def _fusable_pairs(nodes, keep_guids=()):
    """(conv guid, bn guid) pairs that may run as one node: the BN's sole
    input is a Conv2D output nothing else consumes, the conv carries no
    activation of its own, and the conv output is not the designated
    model output (``keep_guids``)."""
    consumers: Dict[Tuple[int, int], int] = {}
    for node in nodes:
        for ref in node.input_refs:
            if ref[0] == "op":
                k = (ref[1], ref[2])
                consumers[k] = consumers.get(k, 0) + 1
    by_guid = {n.op.guid: n for n in nodes}
    pairs = []
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
        pairs.append((prod.op.guid, node.op.guid))
    return pairs


def train_fusable_conv_guids(nodes, keep_guids=()) -> set:
    """Conv2D guids whose sole consumer is a foldable BatchNorm: the
    eligibility shared by the eval fold and the ``_k:conv_bn_fused``
    twin (``serialize_graph`` ships it as the ``bn_fusable`` attr)."""
    return {conv_guid for conv_guid, _ in _fusable_pairs(nodes, keep_guids)}


def _replace_pairs(nodes, pairs, make):
    """A new node list with each (conv guid, bn guid) pair of ``pairs``
    one node, ``make(conv op, bn op)``, at the BN's place; the list given
    is never changed."""
    from flexflow_tpu_torch.executor import OpNode

    if not pairs:
        return nodes
    by_guid = {n.op.guid: n for n in nodes}
    replacements = {}
    for conv_guid, bn_guid in pairs:
        conv_node, bn_node = by_guid[conv_guid], by_guid[bn_guid]
        fused = OpNode(make(conv_node.op, bn_node.op),
                       list(conv_node.input_refs))
        fused.output_specs = list(bn_node.output_specs)
        fused.input_layouts = list(getattr(conv_node, "input_layouts", []))
        fused.output_layouts = list(getattr(bn_node, "output_layouts", []))
        replacements[bn_guid] = fused
    folded = {conv_guid for conv_guid, _ in pairs}
    return [replacements.get(n.op.guid, n) for n in nodes
            if n.op.guid not in folded]


def fuse_conv_bn_train(nodes, conv_names, keep_guids=()):
    """The node list with each eligible (Conv2D, BatchNorm) pair whose
    conv is named in ``conv_names`` (the ``_k:conv_bn_fused`` choices) as
    one ``TrainFusedConvBN`` node. A choice on an ineligible pair stays
    unfused, as in the reference."""
    name_of = {n.op.guid: n.op.name for n in nodes}
    pairs = [(c, b) for c, b in _fusable_pairs(nodes, keep_guids)
             if name_of[c] in conv_names]
    return _replace_pairs(nodes, pairs, TrainFusedConvBN)


def fold_conv_bn(nodes, keep_guids=()):
    """The node list with every eligible Conv2D -> BatchNorm(+ReLU) pair
    folded into one ``FoldedConvBN`` node; a new list, so that the
    training step keeps the full graph."""
    return _replace_pairs(nodes, _fusable_pairs(nodes, keep_guids),
                          FoldedConvBN)
