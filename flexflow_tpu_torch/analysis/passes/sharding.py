"""sharding-legality: per-dim degrees and parallel-op compatibility.

PyTorch counterpart of ``flexflow_tpu/analysis/passes/sharding.py``:
the same rules over the port's tuple specs. The port executes one
device, but a strategy planned over more (``orchestrator.plan_model``)
is checked as the JAX package checks it.


The PCG's core invariant (tensor.ParallelDim: size % degree == 0) is
enforced dynamically at materialization for degree-form shapes, but a
strategy arrives as specs whose degrees are implied by mesh-axis
extents — nothing checked those until a sharded execution failed (or
worse, silently padded). This pass verifies, without compiling anything:

* FFL101  a spec shards a dim whose extent the implied degree does not
          divide (the shards pad — the simulator priced the unpadded
          tensor);
* FFL102  a spec names a mesh axis the mesh does not carry;
* FFL103  a parameter spec is illegal against the op's parameter shapes;
* FFL104  a parallel op (repartition/combine/replicate/reduction) is
          incompatible with its mesh axis or its producer's sharding;
* FFL105  one spec uses the same mesh axis on two dims;
* FFL106  a pipe mesh whose stage count does not divide the repeated
          blocks (or that has no repeated-block body at all);
* FFL107  dropout/stateful ops inside the repeated blocks a pipe mesh
          would pipeline (op state/rng cannot ride the pipelined body);
* FFL108  the batch does not divide microbatches x data degree.

The FFL106-108 family is the static form of the ValueErrors
the JAX package's ``PipelineGraphExecutor.__init__`` raises at compile
time (the port's pipelined execution is ROADMAP.md Queue 1 item 10) —
lint surfaces them pre-compile with fix hints instead.

Under weight-update sharding the pass additionally verifies the
executor's sharded master/optimizer-state specs (``wus:<param>``
tensors) with the same FFL101/102/105 rules — an illegal WUS shard
would otherwise only surface as padding deep inside the step.
"""

from __future__ import annotations

import math
from typing import Dict, List

from flexflow_tpu_torch.analysis.diagnostics import Diagnostic, error, warning
from flexflow_tpu_torch.ffconst import OperatorType
# parameter name -> shape without allocating: the strategy decoder's own
# notion of which params an op owns, so lint and decode never disagree
from flexflow_tpu_torch.search.unity import _param_shapes


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _spec_entries(spec, ndim: int) -> List:
    entries = list(spec) if spec is not None else []
    return (entries + [None] * ndim)[:ndim]


def _check_spec(spec, shape, axis_sizes: Dict[str, int], op_name: str,
                guid: int, what: str) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    if spec is None:
        return diags
    entries = _spec_entries(spec, len(shape))
    if len(tuple(spec)) > len(shape):
        diags.append(error(
            "FFL103",
            f"{what}: spec {tuple(spec)} has more entries than the "
            f"rank-{len(shape)} tensor",
            op=op_name, guid=guid, tensor=what,
            hint="drop the extra entries; specs index tensor dims"))
    used: Dict[str, int] = {}
    for d, entry in enumerate(entries):
        axes = _entry_axes(entry)
        degree = 1
        for ax in axes:
            if ax not in axis_sizes:
                diags.append(error(
                    "FFL102",
                    f"{what}: dim {d} sharded over mesh axis {ax!r} "
                    f"but the mesh carries {sorted(axis_sizes)}",
                    op=op_name, guid=guid, tensor=what,
                    hint="axis dropped or renamed — re-export the "
                         "strategy against this mesh"))
                continue
            degree *= axis_sizes[ax]
            used[ax] = used.get(ax, 0) + 1
        if degree > 1 and d < len(shape) and shape[d] % degree != 0:
            diags.append(error(
                "FFL101",
                f"{what}: dim {d} extent {shape[d]} not divisible by "
                f"sharding degree {degree} ({'+'.join(axes)})",
                op=op_name, guid=guid, tensor=what,
                hint="GSPMD will pad the shards; the simulator priced "
                     "the unpadded tensor — pick a dividing degree"))
    for ax, n in used.items():
        if n > 1:
            diags.append(error(
                "FFL105",
                f"{what}: mesh axis {ax!r} shards {n} dims of the same "
                f"tensor",
                op=op_name, guid=guid, tensor=what,
                hint="an axis can shard at most one dim per tensor"))
    return diags


class ShardingLegalityPass:
    name = "sharding-legality"

    def run(self, ctx) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        axis_sizes = ctx.axis_sizes
        if not axis_sizes:
            from flexflow_tpu_torch.analysis.orchestrator import SkipPass
            raise SkipPass("no mesh in context")
        for node in ctx.nodes:
            op = node.op
            # the applied (post-apply_strategy) specs on the node are the
            # executor's truth; fall back to the raw strategy entry for
            # contexts built from a strategy alone
            specs = getattr(node, "output_specs", None)
            st = ctx.strategy.get(op.guid)
            if specs is None and st is not None:
                specs = st.output_specs
            for i, spec in enumerate(specs or []):
                if i >= len(op.output_shapes):
                    break
                diags.extend(_check_spec(
                    spec, op.output_shapes[i], axis_sizes, op.name,
                    op.guid, f"out[{i}]"))
            param_specs = getattr(node, "param_specs", None)
            if not param_specs and st is not None:
                param_specs = st.param_specs
            if param_specs:
                shapes = _param_shapes(op)
                for pname, spec in param_specs.items():
                    shp = shapes.get(pname)
                    if shp is None:
                        diags.append(warning(
                            "FFL103",
                            f"param spec for {pname!r} but the op owns no "
                            f"such parameter",
                            op=op.name, guid=op.guid, tensor=pname,
                            hint="stale strategy file? parameter names "
                                 "are the executor's param-tree keys"))
                        continue
                    diags.extend(_check_spec(
                        spec, tuple(shp), axis_sizes, op.name, op.guid,
                        f"param:{pname}"))
            diags.extend(self._check_parallel_op(node, ctx, axis_sizes))
        diags.extend(self._check_wus_specs(ctx, axis_sizes))
        diags.extend(self._check_pipeline(ctx, axis_sizes))
        return diags

    # ---- pipeline legality on pipe meshes (FFL106-108) ---------------------
    @staticmethod
    def _check_pipeline(ctx, axis_sizes) -> List[Diagnostic]:
        pp = axis_sizes.get("pipe", 1)
        if pp <= 1:
            return []
        from flexflow_tpu_torch.parallel.pipeline_detect import (
            detect_repeated_blocks)
        diags: List[Diagnostic] = []
        pb = detect_repeated_blocks(ctx.nodes)
        if pb is None:
            # distinguish "repeated but stateful body" (FFL107) from
            # "no repeated structure at all" (FFL106)
            relaxed = detect_repeated_blocks(ctx.nodes, allow_stateful=True)
            if relaxed is None:
                diags.append(error(
                    "FFL106",
                    f"mesh carries a pipe axis ({pp}) but the graph has "
                    f"no repeated-block body to pipeline",
                    hint="pipeline parallelism needs a run of >= 2 "
                         "structurally-identical shape-preserving blocks; "
                         "drop the pipe axis or restructure the body"))
                return diags
            aux_types = {OperatorType.DROPOUT, OperatorType.EXPERTS,
                         OperatorType.AGGREGATE,
                         OperatorType.AGGREGATE_SPEC, OperatorType.GROUP_BY}
            bad = sorted({
                ctx.nodes[i].op.name
                for blk in relaxed.blocks for i in blk
                if hasattr(ctx.nodes[i].op, "init_state")
                or getattr(ctx.nodes[i].op, "dropout", 0.0)
                or ctx.nodes[i].op.op_type in aux_types})
            diags.append(error(
                "FFL107",
                f"repeated blocks carry dropout/stateful ops "
                f"({', '.join(bad[:4])}{', ...' if len(bad) > 4 else ''}) "
                f"— op state/rng cannot ride the pipeline's shard_map "
                f"body",
                hint="remove dropout from the repeated body (or fold the "
                     "stateful op) before pipelining, or drop the pipe "
                     "axis"))
            pb = relaxed  # divisibility checks still apply
        if pb.num_blocks % pp:
            diags.append(error(
                "FFL106",
                f"{pb.num_blocks} repeated blocks do not divide into "
                f"{pp} pipeline stages",
                hint=f"pick a pipe degree dividing {pb.num_blocks}, or "
                     f"change the repeated-layer count"))
        dp = 1
        for ax in ("data", "replica"):
            dp *= axis_sizes.get(ax, 1)
        ex = getattr(ctx.ff, "executor", None) if ctx.ff is not None \
            else None
        M = int(getattr(ex, "microbatches", 0) or
                getattr(ctx.config, "pipeline_microbatches", 0) or 2 * pp)
        batch = ctx.nodes[pb.blocks[0][0]].op.output_shapes[0][0]
        if batch % (M * dp):
            diags.append(error(
                "FFL108",
                f"batch {batch} does not divide microbatches x data "
                f"degree ({M} x {dp})",
                hint="pick --pipeline-microbatches dividing batch/data "
                     "(or 'auto', which sweeps the divisor lattice)"))
        return diags

    # ---- weight-update-sharding state specs -------------------------------
    @staticmethod
    def _check_wus_specs(ctx, axis_sizes) -> List[Diagnostic]:
        """Verify the data-sharded master-param/optimizer-state layout
        the executor derived for weight-update sharding (the specs the
        f32 master, Adam moments, and the reduce-scattered gradients
        live on: over a process group each rank holds exactly these
        shards, ``executor.master_spec``)."""
        ex = getattr(ctx.ff, "executor", None) if ctx.ff is not None else None
        if ex is None or not getattr(ex, "weight_update_sharding", False):
            return []
        diags: List[Diagnostic] = []
        by_name = {n.op.name: n for n in ctx.nodes}
        for op_name, specs in ex.wus_param_specs().items():
            node = by_name.get(op_name)
            if node is None:
                continue
            shapes = _param_shapes(node.op)
            for pname, spec in specs.items():
                shp = shapes.get(pname)
                if shp is None:
                    continue
                diags.extend(_check_spec(
                    spec, tuple(shp), axis_sizes, op_name, node.op.guid,
                    f"wus:{pname}"))
        return diags

    # ---- parallel-op in/out compatibility (FFL104) ------------------------
    def _check_parallel_op(self, node, ctx, axis_sizes) -> List[Diagnostic]:
        op = node.op
        if not getattr(op, "is_parallel_op", False):
            return []
        diags: List[Diagnostic] = []
        t = op.op_type
        if t == OperatorType.REPARTITION:
            ax = op.axis
            if ax not in axis_sizes:
                diags.append(error(
                    "FFL104",
                    f"repartition over mesh axis {ax!r} but the mesh "
                    f"carries {sorted(axis_sizes)}",
                    op=op.name, guid=op.guid, tensor="out[0]",
                    hint="pass repartition(axis=...) naming a real axis"))
            elif op.repartition_degree != axis_sizes[ax]:
                diags.append(error(
                    "FFL104",
                    f"repartition degree {op.repartition_degree} != mesh "
                    f"axis {ax!r} extent {axis_sizes[ax]}",
                    op=op.name, guid=op.guid, tensor="out[0]",
                    hint="under GSPMD the degree must equal the axis "
                         "extent it maps to"))
        elif t == OperatorType.COMBINE:
            src = self._producer_spec(node, ctx)
            if src is not None:
                d = op.combine_dim % len(op.output_shapes[0])
                entries = _spec_entries(src, len(op.output_shapes[0]))
                if not _entry_axes(entries[d]):
                    diags.append(warning(
                        "FFL104",
                        f"combine(dim={d}) of an input not sharded on "
                        f"that dim — the op is a no-op",
                        op=op.name, guid=op.guid, tensor="in[0]",
                        hint="dead resharding; drop the combine or fix "
                             "the upstream repartition dim"))
        elif t == OperatorType.REDUCTION:
            shp = op.input_shapes[0]
            d = op.reduction_dim % len(shp)
            # degree-divides-extent is enforced at materialization; what
            # is NOT is the degree matching an actual replica factor:
            # reducing a dim the strategy never produced partial copies
            # on silently averages real data
            src = self._producer_spec(node, ctx)
            if src is not None:
                entries = _spec_entries(src, len(shp))
                axes = _entry_axes(entries[d])
                degree = math.prod(axis_sizes.get(a, 1) for a in axes)
                if axes and degree != op.reduction_degree:
                    diags.append(error(
                        "FFL104",
                        f"reduction(dim={d}, degree="
                        f"{op.reduction_degree}) over a dim sharded "
                        f"{degree}-way",
                        op=op.name, guid=op.guid, tensor="in[0]",
                        hint="the reduction degree must equal the "
                             "replica count laid out on that dim"))
        return diags

    @staticmethod
    def _producer_spec(node, ctx):
        ref = node.input_refs[0] if node.input_refs else None
        if not ref or ref[0] != "op":
            return None
        prod = ctx.by_guid.get(ref[1])
        if prod is None:
            return None
        specs = getattr(prod, "output_specs", None)
        if specs is None:
            st = ctx.strategy.get(ref[1])
            specs = st.output_specs if st is not None else None
        if not specs or ref[2] >= len(specs):
            return None
        return specs[ref[2]]
