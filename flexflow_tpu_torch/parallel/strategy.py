"""Parallelization strategies: per-op sharding assignment over the mesh.

PyTorch counterpart of ``flexflow_tpu/parallel/strategy.py``. A strategy
maps op guid -> ``OpStrategy``: one spec per output and one per
parameter, plus the searched choice name. A spec is a tuple with one
entry per dim, as ``jax.sharding.PartitionSpec`` is in the JAX package:
an axis name, a tuple of names, or None (replicated).

``apply_strategy`` records the specs on the nodes and holds the whole
rule that turns a choice into the kernel an op runs. The port executes a
strategy on
one process's device: a mesh whose only axis above 1 is a ring-attention
sequence axis (``machine.local_ring_axis``); any other mesh raises
(``check_executable``), and executing it is the multi-GPU slice
(ROADMAP.md Queue 1 items 3 and 10). ``FFModel.compile`` records the
specs first and refuses after its lint, so such a strategy still lints.
The port has no manual parallel ops (Repartition, Combine, ...) yet, so
the reference's propagation of their forced layouts has no counterpart
here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.machine import local_ring_axis
from flexflow_tpu_torch.ops.base import DimRole

Spec = Tuple  # entries: axis name, tuple of names, or None


@dataclasses.dataclass
class OpStrategy:
    output_specs: List[Optional[Spec]]
    param_specs: Dict[str, Spec] = dataclasses.field(default_factory=dict)
    # the searched choice name (``base[_wus][_ovl][_k:impl][_r]``), or None
    choice: Optional[str] = None


Strategy = Dict[int, OpStrategy]


def data_parallel_strategy(nodes, mesh) -> Strategy:
    """Batch dim over 'data'; if the mesh carries a 'seq' axis, SEQ-role
    dims shard over it too (activations stay seq-sharded between ring
    attention ops)."""
    dp = mesh.shape.get("data", 1)
    sp = mesh.shape.get("seq", 1)
    strategy: Strategy = {}
    for node in nodes:
        specs = []
        for shp, roles in zip(node.op.output_shapes,
                              node.op.output_dim_roles()):
            entries = [None] * len(shp)
            if (dp > 1 and shp and roles and roles[0] == DimRole.SAMPLE
                    and shp[0] % dp == 0):
                entries[0] = "data"
            if sp > 1:
                for d, role in enumerate(roles):
                    if role == DimRole.SEQ and shp[d] % sp == 0:
                        entries[d] = "seq"
                        break
            specs.append(tuple(entries) if any(e for e in entries) else None)
        strategy[node.op.guid] = OpStrategy(output_specs=specs)
    return strategy


def tensor_parallel_overrides(nodes, mesh, strategy: Strategy) -> Strategy:
    """Shard weight-heavy ops on the 'model' axis: Linear column-parallel
    (kernel [in, out] -> out sharded), attention head-parallel."""
    mp = mesh.shape.get("model", 1)
    if mp <= 1:
        return strategy
    for node in nodes:
        op = node.op
        st = strategy[op.guid]
        if op.op_type == OperatorType.LINEAR and op.out_dim % mp == 0:
            st.param_specs["kernel"] = (None, "model")
            st.param_specs["bias"] = ("model",)
            shp = op.output_shapes[0]
            base = st.output_specs[0] or (None,) * len(shp)
            st.output_specs[0] = tuple(base)[:-1] + ("model",)
        elif (op.op_type == OperatorType.MULTIHEAD_ATTENTION
              and op.num_heads % mp == 0):
            st.param_specs.update(wq=("model", None, None),
                                  wo=("model", None, None))
            # GQA: wk/wv carry num_kv_heads on dim 0
            if op.num_kv_heads % mp == 0:
                st.param_specs.update(wk=("model", None, None),
                                      wv=("model", None, None))
    return strategy


def filter_specs_to_mesh(strategy: Strategy, mesh) -> None:
    """Null the spec entries naming axes ``mesh`` does not carry (a file,
    or a bucket's search, may come from a differently shaped machine); a
    tuple entry keeps the axes the mesh has."""
    valid = set(mesh.axis_names)

    def keep(e):
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a in valid)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return e if e in valid else None

    for st in strategy.values():
        st.output_specs = [tuple(keep(e) for e in s) if s is not None
                           else None for s in st.output_specs]
        st.param_specs = {k: tuple(keep(e) for e in v)
                          for k, v in st.param_specs.items()}


KERNEL_MODES = ("off", "chosen", "all")


def apply_strategy(nodes, strategy: Strategy, mesh, kernels: str = "chosen",
                   training: bool = False, device="cuda"
                   ) -> Optional[Dict[str, str]]:
    """Record each node's specs and act on its choice; return the kernel
    each op runs ({op name -> impl}: the ``_k:`` choices, and each
    attention op's core), or None under ``kernels="off"``.

    A ``_ring`` choice on a mesh with 'seq' above 1 puts an attention op
    on the ring. ``kernels`` says how choices pick kernels:

    - ``"off"``: the kernel dimension is switched off, or never ran (no
      search, no ``_k:`` choice), or the mesh pipelines: every pin is
      cleared and each attention op keeps the availability rule
      (``MultiHeadAttention.selected_impl``); ``_k:`` choices run nothing.
    - ``"chosen"``: a ``_k:flash`` or ``_k:einsum`` suffix pins an
      attention op's core; an attention op without one keeps the
      availability rule, so ``rep`` runs the flash core wherever it can.
      The serving engine's buckets take this rule, as the reference's do,
      although the latency search priced ``rep`` at the einsum core.
    - ``"all"`` (a compile whose strategy was searched, or carries a
      ``_k:`` choice): as "chosen", and an attention op without ``_k:`` is
      pinned to the einsum core where flash would run on ``device`` in
      this mode: the search priced flash there and rejected it.

    Raises NotImplementedError (``machine.local_ring_axis``) on a mesh one
    process cannot run."""
    if kernels not in KERNEL_MODES:
        raise ValueError(f"kernels={kernels!r}: one of {KERNEL_MODES}")
    check_executable(nodes, mesh)
    return _record_strategy(nodes, strategy, mesh, kernels=kernels,
                            training=training, device=device)


def check_executable(nodes, mesh) -> None:
    """Raise NotImplementedError (``machine.local_ring_axis``) unless one
    process runs ``mesh``: no axis above 1, or one ring-attention
    sequence axis ('seq', or an attention op's ``seq_parallel``)."""
    local_ring_axis(mesh, {"seq"} | {
        n.op.seq_parallel for n in nodes
        if getattr(n.op, "seq_parallel", None)})


def _record_strategy(nodes, strategy: Strategy, mesh, kernels: str,
                     training: bool, device) -> Optional[Dict[str, str]]:
    """``apply_strategy`` without the refusal: the specs are recorded and
    the kernels chosen on any mesh. ``FFModel.compile`` lints what this
    records before it refuses a mesh it cannot execute."""
    from flexflow_tpu_torch.search.unity import (executed_kernel_choices,
                                                 kernel_choice_of)

    axis_sizes = mesh.shape
    for node in nodes:
        st = strategy.get(node.op.guid)
        if st is None:
            continue
        node.output_specs = list(st.output_specs)
        node.param_specs = dict(st.param_specs)
        choice = st.choice or ""
        # an "_ep" choice shards the stacked experts over the 'expert'
        # axis (the JAX package's expert_parallel_ffn); such a mesh is
        # refused before it runs (check_executable)
        if (hasattr(node.op, "expert_parallel") and "_ep" in choice
                and axis_sizes.get("expert", 1) > 1):
            node.op.expert_parallel = "expert"
        if node.op.op_type != OperatorType.MULTIHEAD_ATTENTION:
            continue
        if "_ring" in choice and axis_sizes.get("seq", 1) > 1:
            node.op.seq_parallel = "seq"
        if kernels == "off":
            node.op.kernel_impl = None
            continue
        impl = kernel_choice_of(choice)
        if impl in ("flash", "einsum"):
            node.op.kernel_impl = impl
        elif (impl is None and kernels == "all"
              and node.op.selected_impl(device, axis_sizes,
                                        training=training) == "flash"):
            node.op.kernel_impl = "einsum"
    if kernels == "off":
        return None
    return executed_kernel_choices(nodes, strategy, axis_sizes,
                                   training=training, device=device)
