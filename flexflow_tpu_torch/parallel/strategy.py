"""Parallelization strategies: per-op sharding assignment over the mesh.

PyTorch counterpart of ``flexflow_tpu/parallel/strategy.py``. A strategy
maps op guid -> ``OpStrategy``: one spec per output and one per
parameter, plus the searched choice name. A spec is a tuple with one
entry per dim, as ``jax.sharding.PartitionSpec`` is in the JAX package:
an axis name, a tuple of names, or None (replicated).

``apply_strategy`` records the specs on the nodes, propagates the
layouts the manual parallel ops force (``ops/parallel_ops.py``; the
reference's Repartition changes the layout every consumer then sees),
and holds the whole rule that turns a choice into the kernel an op runs.
The port executes a strategy on one process's device when no axis but a
ring-attention sequence axis is above 1, and a data x model mesh over a
process group of one rank a device (``executor.py``, ``parallel/comm.py``).
Over a process group the ``_wus`` and ``_ovl`` choices run too: the
executor shards the master copy and moments over the data axes and
issues the gradient reduce-scatters bucket by bucket (``executor.py``).
``check_executable`` refuses the rest, each naming its ROADMAP.md item:
a 'pipe' axis (item 10), an 'expert' axis and a sequence ring beside
another axis (item 3's second part, ``machine.local_ring_axis``), and a
mesh larger than the process group. ``FFModel.compile`` records the
specs first and refuses after its lint, so such a strategy still lints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.machine import local_ring_axis
from flexflow_tpu_torch.ops.base import DimRole

# ops that keep their input's shape and follow its sharding: a manual
# parallel op's layout propagates through these until the next layout- or
# value-changing op (the reference's Repartition changes the
# ParallelTensor layout every consumer then sees)
_FOLLOW_OPS = frozenset({
    OperatorType.RELU, OperatorType.GELU, OperatorType.SIGMOID,
    OperatorType.TANH, OperatorType.ELU, OperatorType.EXP, OperatorType.SIN,
    OperatorType.COS, OperatorType.POW, OperatorType.RSQRT,
    OperatorType.IDENTITY, OperatorType.SCALAR_MULTIPLY,
    OperatorType.SCALAR_ADD, OperatorType.SCALAR_SUB,
    OperatorType.SCALAR_TRUE_DIV, OperatorType.DROPOUT, OperatorType.CAST,
    OperatorType.SOFTMAX, OperatorType.LAYERNORM, OperatorType.RMSNORM,
})

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
    (kernel [in, out] -> out sharded), attention head-parallel, embedding
    columns."""
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
        elif op.op_type == OperatorType.EMBEDDING and op.out_dim % mp == 0:
            st.param_specs["kernel"] = (None, "model")
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
    on the ring; a ``head`` choice on a 'model' axis above 1 records the
    head-sharded axis. ``kernels`` says how choices pick kernels:

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

    Raises NotImplementedError (``check_executable``) on a mesh this
    process group cannot run."""
    if kernels not in KERNEL_MODES:
        raise ValueError(f"kernels={kernels!r}: one of {KERNEL_MODES}")
    check_executable(nodes, mesh)
    return _record_strategy(nodes, strategy, mesh, kernels=kernels,
                            training=training, device=device)


def executes_on_ranks(nodes, mesh) -> bool:
    """Whether ``mesh`` needs a process group (an axis above 1 that is not
    a one-process ring's), as opposed to one device."""
    big = [a for a, n in (mesh.shape if mesh else {}).items() if n > 1]
    return bool(big) and not (len(big) == 1 and big[0] in _seq_axes(nodes))


def runs_over_group(nodes, mesh) -> bool:
    """Whether this process runs ``mesh`` as one rank of a process group
    of its size (else the mesh is a plan, or refused at compile)."""
    from flexflow_tpu_torch import distributed
    return (executes_on_ranks(nodes, mesh)
            and distributed.process_count() == mesh.size)


def _seq_axes(nodes):
    return {"seq"} | {n.op.seq_parallel for n in nodes
                      if getattr(n.op, "seq_parallel", None)}


def check_executable(nodes, mesh) -> None:
    """Raise NotImplementedError unless this process, or its process
    group, runs ``mesh``: no axis above 1, one ring-attention sequence
    axis on one device (``machine.local_ring_axis``, which also refuses
    'pipe', 'expert' and a ring beside another axis), or a mesh of as
    many positions as the group has ranks (whatever its choices'
    ``_wus`` / ``_ovl`` flags)."""
    from flexflow_tpu_torch import distributed

    local_ring_axis(mesh, _seq_axes(nodes))
    if not executes_on_ranks(nodes, mesh):
        return
    world = distributed.process_count()
    if world != mesh.size:
        raise NotImplementedError(
            f"mesh {mesh.shape} runs one rank a device over a process group "
            f"of {mesh.size} ranks, and this process "
            + (f"is one of {world}" if world > 1 else "has no such group")
            + ": start one with flexflow_tpu_torch.distributed.initialize "
            f"(or torchrun), the multi-GPU slice of the PyTorch port "
            f"(ROADMAP.md Queue 1 item 3.8)")


def _axis_entry_valid(entry, valid_axes) -> bool:
    if entry is None:
        return True
    axes = entry if isinstance(entry, tuple) else (entry,)
    return all(a in valid_axes for a in axes)


def _record_strategy(nodes, strategy: Strategy, mesh, kernels: str,
                     training: bool, device) -> Optional[Dict[str, str]]:
    """``apply_strategy`` without the refusal: the specs are recorded and
    the kernels chosen on any mesh. ``FFModel.compile`` lints what this
    records before it refuses a mesh it cannot execute."""
    from flexflow_tpu_torch.search.unity import (executed_kernel_choices,
                                                 kernel_choice_of)

    axis_sizes = mesh.shape
    by_guid = {n.op.guid: n for n in nodes}
    # guid -> spec entries forced by an upstream manual parallel op
    forced: Dict[int, List] = {}
    for node in nodes:
        _force_layout(node, by_guid, forced, axis_sizes, strategy)
        st = strategy.get(node.op.guid)
        if st is None:
            continue
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
        if "head" in choice and axis_sizes.get("model", 1) > 1:
            node.op.head_parallel = "model"
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


def _force_layout(node, by_guid, forced, axis_sizes, strategy) -> None:
    """Record ``node``'s strategy specs, then the layout a manual parallel
    op forces (``preferred_spec_update`` on its input's entries) and its
    propagation through the shape-keeping ops of ``_FOLLOW_OPS``: the
    reference's ``apply_strategy`` rule, with its two refusals (a
    Repartition degree that is not its axis's size, one axis on two
    dims)."""
    op = node.op
    st = strategy.get(op.guid)
    if st is not None:
        node.output_specs = list(st.output_specs)
        node.param_specs = dict(st.param_specs)
    is_par = getattr(op, "is_parallel_op", False)
    follows = (op.op_type in _FOLLOW_OPS and node.input_refs
               and node.input_refs[0][0] == "op"
               and node.input_refs[0][1] in forced)
    if not ((is_par and hasattr(op, "preferred_spec_update")) or follows):
        return
    ref = node.input_refs[0]
    nd = len(op.output_shapes[0])
    if ref[0] == "op" and ref[1] in forced:
        src = forced[ref[1]]
    elif ref[0] == "op" and ref[1] in by_guid:
        src = by_guid[ref[1]].output_specs[ref[2]]
    else:
        src = None
    entries = (list(src) + [None] * nd)[:nd] if src else [None] * nd
    if is_par:
        if (op.op_type == OperatorType.REPARTITION
                and op.axis in axis_sizes
                and op.repartition_degree != axis_sizes[op.axis]):
            raise ValueError(
                f"repartition degree {op.repartition_degree} != mesh axis "
                f"'{op.axis}' size {axis_sizes[op.axis]}: the degree must "
                f"equal the axis extent")
        entries = op.preferred_spec_update(entries)
    entries = [e if _axis_entry_valid(e, axis_sizes) else None
               for e in entries]
    used = [e for e in entries if e is not None]
    if len(used) != len(set(used)):
        raise ValueError(
            f"parallel op '{op.name}' would shard two dims over the same "
            f"mesh axis ({entries}); repartition a dim that is not "
            f"already sharded on that axis")
    node.output_specs = [tuple(entries)] + list(node.output_specs[1:])
    forced[op.guid] = entries
