"""layout-consistency: NHWC/NCHW boundary audit.

PyTorch counterpart of ``flexflow_tpu/analysis/passes/layout.py``,
over the port's channels-last ``layout_info`` (``layout.py``
``propagate_layouts``): NHWC is the conv family's execution layout on
the card, NCHW the API boundary.


The layout pass (``flexflow_tpu_torch/layout.py``) records on every node which
physical layout its forward consumes/produces; the executor inserts a
transpose wherever they disagree. That metadata makes layout bugs and
layout waste statically visible:

* FFL301  redundant transpose pair: two user-level TRANSPOSE ops whose
          composed permutation is the identity;
* FFL302  broken NHWC chain: a value round-trips NHWC -> NCHW -> NHWC
          because an NCHW-only op sits between two channels-last ops
          (two boundary transpose pairs where teaching the middle op
          NHWC would cost zero);
* FFL303  layout metadata contradiction: a consumer is recorded as
          reading a layout its producer does not emit AND the value is
          not rank-4 (the executor's transpose fallback only handles
          rank-4), or the per-input/per-output layout lists do not
          match the node's arity.
"""

from __future__ import annotations

from typing import List

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, error, warning
from flexflow_tpu_torch.ffconst import OperatorType

_IDENT_OK = ("NCHW", "NHWC")


class LayoutConsistencyPass:
    name = "layout-consistency"

    def run(self, ctx) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        diags.extend(self._redundant_transposes(ctx))
        diags.extend(self._metadata_audit(ctx))
        diags.extend(self._chain_breaks(ctx))
        return diags

    # ---- FFL301 ------------------------------------------------------------
    def _redundant_transposes(self, ctx) -> List[Diagnostic]:
        diags = []
        consumers = ctx.consumers()
        for node in ctx.nodes:
            op = node.op
            if op.op_type != OperatorType.TRANSPOSE:
                continue
            ref = node.input_refs[0]
            if ref[0] != "op":
                continue
            prod = ctx.by_guid.get(ref[1])
            if prod is None or prod.op.op_type != OperatorType.TRANSPOSE:
                continue
            inner = prod.op.layer.get_property("perm")
            outer = op.layer.get_property("perm")
            if inner is None or outer is None:
                continue
            composed = tuple(inner[p] for p in outer)
            if composed == tuple(range(len(composed))):
                # only truly redundant if nothing else reads the
                # intermediate permuted value
                others = [c for c, _ in consumers.get((ref[1], ref[2]), [])
                          if c is not node]
                if not others:
                    diags.append(warning(
                        "FFL301",
                        f"transpose pair {prod.op.name} -> {op.name} "
                        f"composes to the identity",
                        op=op.name, guid=op.guid,
                        hint="drop both ops; they move every byte of the "
                             "tensor twice for nothing"))
        return diags

    # ---- FFL303 ------------------------------------------------------------
    def _metadata_audit(self, ctx) -> List[Diagnostic]:
        diags = []
        for node in ctx.nodes:
            op = node.op
            in_l = getattr(node, "input_layouts", None)
            out_l = getattr(node, "output_layouts", None)
            if in_l is not None and len(in_l) != len(node.input_refs):
                diags.append(error(
                    "FFL303",
                    f"input_layouts has {len(in_l)} entries for "
                    f"{len(node.input_refs)} inputs",
                    op=op.name, guid=op.guid,
                    hint="layout pass metadata out of sync with the "
                         "graph — re-run propagate_layouts"))
                continue
            if out_l is not None and len(out_l) != len(op.output_shapes):
                diags.append(error(
                    "FFL303",
                    f"output_layouts has {len(out_l)} entries for "
                    f"{len(op.output_shapes)} outputs",
                    op=op.name, guid=op.guid,
                    hint="layout pass metadata out of sync with the "
                         "graph — re-run propagate_layouts"))
                continue
            for i, lay in enumerate(out_l or []):
                if lay not in _IDENT_OK:
                    diags.append(error(
                        "FFL303", f"unknown layout {lay!r} on output {i}",
                        op=op.name, guid=op.guid))
                elif lay == "NHWC" and len(op.output_shapes[i]) != 4:
                    diags.append(error(
                        "FFL303",
                        f"output {i} recorded NHWC but is rank "
                        f"{len(op.output_shapes[i])} — the executor's "
                        f"boundary transpose only handles rank-4 values",
                        op=op.name, guid=op.guid,
                        hint="an NHWC layout on a non-image tensor will "
                             "silently never be transposed back"))
            for j, (want, ref) in enumerate(zip(in_l or [],
                                                node.input_refs)):
                if want not in _IDENT_OK:
                    diags.append(error(
                        "FFL303", f"unknown layout {want!r} on input {j}",
                        op=op.name, guid=op.guid))
                    continue
                have = self._produced_layout(ctx, ref)
                shp = (op.input_shapes[j]
                       if j < len(op.input_shapes) else ())
                if want != have and len(shp) != 4:
                    diags.append(error(
                        "FFL303",
                        f"input {j} wants {want} but its producer emits "
                        f"{have} and the value is rank {len(shp)} — no "
                        f"transpose exists for it",
                        op=op.name, guid=op.guid,
                        hint="the layout pass must only relayout rank-4 "
                             "values"))
        return diags

    # ---- FFL302 ------------------------------------------------------------
    def _chain_breaks(self, ctx) -> List[Diagnostic]:
        """A value produced NHWC, consumed by an NCHW-only op whose own
        output is transposed back to NHWC downstream: two transpose
        pairs an NHWC port of the middle op would eliminate."""
        diags = []
        consumers = ctx.consumers()
        for node in ctx.nodes:
            op = node.op
            in_l = getattr(node, "input_layouts", None) or []
            out_l = getattr(node, "output_layouts", None) or []
            if not in_l or not out_l:
                continue
            # this op consumes NCHW from an NHWC producer...
            breaks_chain = any(
                want == "NCHW"
                and self._produced_layout(ctx, ref) == "NHWC"
                for want, ref in zip(in_l, node.input_refs))
            if not breaks_chain or out_l[0] != "NCHW":
                continue
            # ...and a consumer immediately re-transposes its output
            rejoins = any(
                (getattr(c, "input_layouts", None) or ["NCHW"] * (j + 1))[j]
                == "NHWC"
                for i in range(len(op.output_shapes))
                for c, j in consumers.get((op.guid, i), []))
            if rejoins:
                diags.append(warning(
                    "FFL302",
                    f"{op.op_type.name} breaks an NHWC chain (value "
                    f"round-trips NHWC->NCHW->NHWC around it)",
                    op=op.name, guid=op.guid,
                    hint="teach this op an NHWC execution mode "
                         "(flexflow_tpu/layout.py _NHWC_COMPUTE / "
                         "_PASS_THROUGH) to drop two transposes"))
        return diags

    @staticmethod
    def _produced_layout(ctx, ref) -> str:
        if ref[0] != "op":
            return "NCHW"  # graph inputs are staged NCHW (API boundary)
        prod = ctx.by_guid.get(ref[1])
        if prod is None:
            return "NCHW"
        out_l = getattr(prod, "output_layouts", None)
        return out_l[ref[2]] if out_l and ref[2] < len(out_l) else "NCHW"
