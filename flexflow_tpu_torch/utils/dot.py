"""Graphviz export of the op graph and its chosen strategy.

The port's own copy of ``flexflow_tpu/utils/dot.py`` (the original
FlexFlow's ``Graph::export_strategy_computation_graph``): ``compile``
writes it when ``--export-strategy-computation-graph`` / ``--compgraph``
names a file, with each op's FLOPs under ``--include-costs-dot-graph``.
The file is the JAX package's, byte for byte, for one graph and strategy.
"""

from __future__ import annotations

from typing import Optional


def _fmt_spec(spec) -> str:
    if spec is None:
        return "rep"
    entries = [str(e) if e is not None else "." for e in spec]
    return "[" + ",".join(entries) + "]" if entries else "rep"


def export_strategy_dot(nodes, mesh, path: str,
                        include_costs: bool = False,
                        search_info: Optional[dict] = None) -> None:
    """Write a .dot file: one record node per op showing name, type,
    output shape, and the sharding decision."""
    lines = ["digraph pcg {", '  rankdir="TB";',
             '  node [shape=record, fontsize=10];']
    axes = dict(mesh.shape) if mesh else {}
    lines.append(f'  label="mesh: {axes}";')
    guids = {n.op.guid for n in nodes}
    for node in nodes:
        op = node.op
        spec = node.output_specs[0] if node.output_specs else None
        cost = ""
        if include_costs:
            cost = f"|flops {op.flops():.3g}"
        label = (f"{{{op.name}|{op.op_type.name}|"
                 f"out {tuple(op.output_shapes[0])}|"
                 f"spec {_fmt_spec(spec)}{cost}}}")
        lines.append(f'  n{op.guid} [label="{label}"];')
        for ref in node.input_refs:
            if ref[0] == "op" and ref[1] in guids:
                lines.append(f"  n{ref[1]} -> n{op.guid};")
    if search_info:
        t = search_info.get("predicted_time")
        if t:
            lines.append(
                f'  info [shape=note, label="predicted {t * 1e3:.3f} ms"];')
    lines.append("}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
