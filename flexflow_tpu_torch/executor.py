"""Graph executor: runs the materialized op graph forward, and trains it.

PyTorch counterpart of ``flexflow_tpu/executor.py``'s ``GraphExecutor``.
The step bodies run the graph op by op in topological order, on one
device. Values are keyed by ``(producer guid, output index)`` and inputs
are referenced as ``("op", guid, idx)`` / ``("input", name)``, the
reference's scheme.

Where the JAX package jits its steps, the port compiles them into CUDA
graphs (``step_graph.py``): ``make_train_step`` (its carry donated, the
counterpart of ``donate_argnums=(0, 1, 2)``), ``make_multi_step`` (that
step replayed ``num_iters`` times), ``make_eval_step`` and
``make_forward(training=False)``, each captured once for each set of
input shapes and replayed after. They take the batch as host arrays and
cast it on the device. On the CPU the same bodies run eagerly over the
same static buffers. The bodies are the executor's own methods, which
the compiled steps hold weakly, so an executor is freed with its graphs
as soon as its last reference goes. The eager steps stay reachable as
``_train_step_fn``, ``_eval_step_fn`` and ``_forward_fn``: the
references a replayed step is held against.

The forward for inference runs under ``torch.inference_mode``. The train
step runs the forward with grad enabled on the compute copy of the
parameters, gets the gradients from autograd (bf16 under the master-weight
regime: the gradients of the bf16 compute copy), updates the f32 master
parameters and the optimizer state, then re-derives the compute copy from
the new parameters: the JAX step's order. Ops whose strategy choice is
``_k:fused`` update through the fused pass (``ops/fused_update.py``).
An op may emit an auxiliary loss beside its outputs (``forward_with_aux``:
the MoE load-balance loss): ``run_graph`` returns the terms it collected,
the train step adds them to the loss it differentiates, and the eval step
leaves them out, as the JAX package's steps do. They travel as return
values, never as an attribute set on the op, which a CUDA-graph capture
would freeze at the captured tensor.
A mesh reaches the ops through ``OpContext.mesh``: one process runs a
mesh whose one axis above 1 is ring attention's sequence axis, every ring
position on this device.

Over a process group (a data x model mesh, one rank a device; the
counterpart of the JAX package's GSPMD placement), each rank holds its
box of every parameter under the node's param spec (the f32 master, the
compute copy and the optimizer moments alike: ``param_spec``, the
counterpart of ``param_shardings``), the
batch rows its position holds (``local_feeds``: the inputs sharded over
the data axes, ``batch_sharding``; the labels over the model output's
batch axes, ``label_sharding``), and each op's outputs under their specs.
Each op runs by its sharded rule (``parallel/sharded.py``) and the
collectives go through ``parallel/comm.py``. The loss is the mean over
the global batch (each rank's mean weighted by its share of the rows,
summed over the batch axes), the metric sums are summed over them, and
after the backward each gradient is all-reduced over the axes its op's
batch was split over (``OpNode.grad_axes``: the data-axis sum GSPMD
emits), in the order the backward finishes them. Such steps run eagerly
(``StepGraph(capture=False)``), the forward and train step alike; the
Conv+BN folds and fusions and the channels-last layout stay off there.

Weight-update sharding (WUS, the JAX executor's ``wus_spec`` and
``param_shardings(master=True)``): the f32 master copy of a leaf and its
optimizer moments are further cut over the data axes, on the first dim
of the leaf's spec that is free and that the data degree divides
(``wus_spec``, ``master_spec``). Its gradient is reduce-scattered along
that dim (``_wus_reduce``) instead of all-reduced, the optimizer (K4 for
``_k:fused`` ops) updates the rank's shard, and the next step's working
copy is the shard cast and all-gathered over the data axes
(``cast_compute_copy``). The forward reads that working copy in the f32
regime too (``keeps_compute_copy``). Under the overlap (``_Overlap``)
the gradient reduce-scatters are issued bucket by bucket from gradient
hooks while the backward runs; each leaf keeps one collective of its
own size, so the values are those of the synchronous sync, bit for
bit. The gathers run in forward op order either way.

Op state (BatchNorm's running statistics, Cache's last input, f32) is
``state[op name]`` beside the compute copy: the train step returns it
moved, the eval and forward steps read it. It is never cast,
differentiated or updated by the optimizer. Eval, forward and
``predict`` run the node list with every eligible Conv2D -> BatchNorm
pair folded into one convolution
(``layout.fold_conv_bn``; ``fold_conv_bn=False`` runs the full graph);
the train step runs the full graph, with the pairs whose conv chose
``_k:conv_bn_fused`` as one node (``layout.fuse_conv_bn_train``). Values
are kept in their producer's execution layout (``layout.py``): where a
consumer wants the other one, the walk converts the value once and
keeps the conversion while the value lives; the model output leaves
NCHW. Every gradient is made contiguous: cuDNN returns a conv weight's
gradient in its channels-last memory format, and the optimizer's leaves
(and K4) stay contiguous.

Remat (``remat_ops``, the ops whose strategy choice carries ``_r``): in
training such an op's forward runs under a non-reentrant
``torch.utils.checkpoint``, the counterpart of the reference's per-op
``jax.checkpoint``. Autograd then keeps the op's inputs and parameters
and recomputes its interior when the backward reaches it; the values are
those of the plain forward, bit for bit. The recompute of a flash
attention launches K1 a second time, inside the backward (and inside
the captured graph of a compiled step).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from flexflow_tpu_torch.ffconst import CompMode, LossType
from flexflow_tpu_torch.layout import NCHW, NHWC, to_layout
from flexflow_tpu_torch.losses import get_loss_fn
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.ops.base import Op, OpContext
from flexflow_tpu_torch.step_graph import StepGraph

# pseudo-entry in the op-state dict holding the compute-dtype (bf16) copy
# of the parameters under the master-weight mixed-precision regime (never
# collides with op names, which come from Layer naming)
COMPUTE_PARAMS_KEY = "__compute_params__"

# the mesh axes a batch is split over, as the JAX package names them
DATA_AXES = ("slice", "data", "replica")


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The data axes of ``mesh`` (a ``machine.Mesh`` or None), in its
    axis order."""
    if mesh is None:
        return ()
    return tuple(a for a in mesh.axis_names if a in DATA_AXES)


def data_degree(mesh) -> int:
    """The product of ``mesh``'s data-axis sizes: 1 with none."""
    sizes = dict(mesh.shape) if mesh is not None else {}
    deg = 1
    for a in data_axes_of(mesh):
        deg *= sizes[a]
    return deg


class OpNode:
    """One materialized operator + where its inputs come from.

    ``input_refs``: list of ('op', producer_guid, out_idx) or
    ('input', input_name).
    """

    def __init__(self, op: Op, input_refs: List[Tuple]):
        self.op = op
        self.input_refs = input_refs
        # the strategy's specs (parallel/strategy.py apply_strategy): one
        # per output, and one per parameter name
        self.output_specs: List[Optional[Tuple]] = [None] * len(op.output_shapes)
        self.param_specs: Dict[str, Tuple] = {}
        # over a process group: the op's sharded rule and the axes its
        # parameters' gradients are all-reduced over (parallel/sharded.py)
        self.shard_rule: Optional[str] = None
        self.grad_axes: Tuple[str, ...] = ()

    @property
    def guid(self):
        return self.op.guid


def drop_schedule(nodes: List[OpNode], keep) -> List[List[Tuple[int, int]]]:
    """For each node of ``nodes`` (in order), the values ``(guid, output
    index)`` that no later node reads, to be dropped once it has run; the
    values in ``keep`` never are. A graph walk that follows it holds only
    the values still to be read, not every activation of the forward."""
    last: Dict[Tuple[int, int], int] = {}
    for i, node in enumerate(nodes):
        for ref in node.input_refs:
            if ref[0] == "op":
                last[(ref[1], ref[2])] = i
        for j in range(len(node.op.output_shapes)):
            last.setdefault((node.guid, j), i)
    drops: List[List[Tuple[int, int]]] = [[] for _ in nodes]
    keep = {tuple(k) for k in keep}
    for key, i in last.items():
        if key not in keep:
            drops[i].append(key)
    return drops


def remat_refusal(op: Op) -> Optional[str]:
    """Why ``op``'s forward cannot be recomputed in the backward, in the
    words of the native remat gate (``native/ffs_strategy.hpp``
    ``remat_gate``), or None: a recompute would re-advance its state or
    draw its random numbers anew, and so differ from the forward it
    replaces."""
    t = op.op_type.name
    if t in ("BATCHNORM", "EXPERTS", "AGGREGATE", "GROUP_BY", "TOPK",
             "CACHE"):
        return "stateful_interior"
    if t == "DROPOUT" or (getattr(op, "dropout", 0.0) or 0.0) > 0.0:
        return "dropout_interior"
    return None


class GraphExecutor:
    def __init__(self, nodes: List[OpNode], input_names: List[str], final_ref,
                 device: torch.device,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 loss_type: Optional[LossType] = None, metrics=None,
                 optimizer=None, final_is_softmax: bool = False,
                 kernel_choices: Optional[Dict[str, str]] = None,
                 mesh=None, remat_ops: Optional[set] = None,
                 fold_conv_bn: bool = True,
                 weight_update_sharding: bool = False,
                 wus_ops: Optional[set] = None,
                 overlap_grad_sync: bool = False,
                 overlap_bucket_bytes: int = 4_000_000):
        self.nodes = nodes
        self.input_names = input_names
        # (guid, out_idx) of the user-designated model output
        self.final_ref = tuple(final_ref)
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.loss_type = loss_type
        self.metrics = metrics
        self.optimizer = optimizer
        self.final_is_softmax = final_is_softmax
        self.comp_mode = CompMode.TRAINING
        # master-weight regime: the forward reads a compute-dtype copy of
        # the f32 parameters, cast once (at compile, after each train step
        # and after any parameter write) instead of on every call
        self.use_master_copy = compute_dtype != torch.float32
        # per-op kernel implementations from an imported strategy: {op
        # name -> impl}. "fused" routes the op's optimizer update through
        # the fused pass; attention impls ("flash"/"einsum") live on the
        # op itself (MultiHeadAttention.kernel_impl, pinned at compile).
        # None = no kernel choices: every op keeps its default.
        self.kernel_choices = dict(kernel_choices) if kernel_choices else None
        self.fused_update_ops = {
            n for n, impl in (self.kernel_choices or {}).items()
            if impl == "fused"}
        # the compiled mesh (machine.Mesh or None), handed to every op
        self.mesh = mesh
        # a mesh run over a process group, one rank a device; its
        # collectives (parallel/comm.py MeshComm) are made at first use,
        # on every rank in one order
        from flexflow_tpu_torch.parallel.strategy import runs_over_group
        self.multi_rank = runs_over_group(nodes, mesh)
        self._comm = None
        if self.multi_rank:
            from flexflow_tpu_torch.parallel import sharded
            for node in nodes:
                node.shard_rule = sharded.rule_of(node.op)
                node.grad_axes = sharded.grad_axes(node, mesh)
        # weight-update sharding (WUS) and the comms-compute overlap, as
        # the JAX package decides them: on a data degree above 1 the
        # gradient sync is a reduce-scatter onto data-sharded master
        # parameters and moments, and the next step's compute copy is
        # all-gathered from the updated shards; under the overlap the
        # reduce-scatters issue bucket by bucket (overlap_bucket_bytes of
        # gradient each, reverse op order) while the backward still
        # runs. Over a planned mesh (analysis.orchestrator.plan_model)
        # they are the record the lint and the simulator replay read
        # (wus_param_specs).
        self.data_axes = data_axes_of(mesh)
        self.weight_update_sharding = bool(
            weight_update_sharding and data_degree(mesh) > 1)
        self.wus_ops = set(wus_ops) if wus_ops is not None else None
        self.grad_overlap = bool(overlap_grad_sync
                                 and self.weight_update_sharding)
        self.overlap_bucket_bytes = max(1, int(overlap_bucket_bytes))
        # the last train step's gradient buckets under the overlap: one
        # {"bucket", "leaves", "bytes", "pending"} each ("bytes" of the
        # whole leaves' gradients, the partition's measure; "pending" the
        # step's leaves whose gradient was still to come at its issue)
        self.overlap_record: List[Dict[str, int]] = []
        self._leaves = None
        self._by_name = {n.op.name: n for n in nodes}
        # names of the ops whose forward runs under a checkpoint in
        # training (their "_r" choices); None = no remat
        self.remat_ops = set(remat_ops) if remat_ops else None
        for node in nodes:
            if self.remat_ops and node.op.name in self.remat_ops:
                reason = remat_refusal(node.op)
                if reason:
                    raise ValueError(
                        f"op {node.op.name!r} cannot be rematerialized "
                        f"({reason}): recomputing its forward in the "
                        f"backward would not reproduce it; drop its _r "
                        f"choice")
        # the compiled steps ({"train_step" | "eval_step" | "forward" ->
        # StepGraph}) and the memory pool their CUDA graphs share
        self.step_graphs: Dict[str, StepGraph] = {}
        self._graph_pool = None
        self.fold_conv_bn = fold_conv_bn and not self.multi_rank
        # {id(node list): its drop schedule}: the full graph's, and the
        # folded and fused lists' once made
        self._drops = {id(nodes): drop_schedule(nodes, [self.final_ref])}
        self._train_nodes = self._folded_nodes = None
        # the _k:conv_bn_fused choices that could not fuse (the pair is
        # not eligible): they run unfused, as in the reference
        self.unfused_conv_bn: List[str] = []

    @property
    def keeps_compute_copy(self) -> bool:
        """Whether the forward reads a working copy of the parameters
        (the state's ``COMPUTE_PARAMS_KEY``): the compute-dtype copy
        under the master-weight regime, and under WUS the gathered boxes
        of the sharded master (in f32 where the master is the compute
        dtype)."""
        return self.use_master_copy or self.weight_update_sharding

    # ---- weight-update sharding (WUS) --------------------------------------
    def _wus_axis_entry(self):
        da = tuple(self.data_axes)
        return da[0] if len(da) == 1 else da

    def wus_spec(self, op_name: str, pname: str,
                 shape: Tuple[int, ...]) -> Optional[Tuple]:
        """Data-sharded spec of a master-param/optimizer-state leaf, or
        None when the leaf stays replicated (WUS off, scalar, or no free
        dim the data degree divides): the data axes land on the first
        unsharded dividing dim of the strategy's param spec."""
        if not self.weight_update_sharding:
            return None
        if self.wus_ops is not None and op_name not in self.wus_ops:
            return None  # the search chose plain sync for this op
        node = self._by_name.get(op_name)
        if node is None:
            return None
        base = node.param_specs.get(pname, ())
        entries = (list(base) + [None] * len(shape))[:len(shape)]
        deg = data_degree(self.mesh)
        for d, e in enumerate(entries):
            if e is None and shape[d] > 0 and shape[d] % deg == 0:
                entries[d] = self._wus_axis_entry()
                return tuple(entries)
        return None

    def wus_param_specs(self) -> Dict[str, Dict[str, Tuple]]:
        """{op name: {param name: sharded spec}} of every leaf WUS
        shards — the sharded-state record fflint's sharding pass
        verifies against the mesh."""
        if not self.weight_update_sharding:
            return {}
        from flexflow_tpu_torch.search.unity import _param_shapes
        out: Dict[str, Dict[str, Tuple]] = {}
        for node in self.nodes:
            for pname, shp in _param_shapes(node.op).items():
                spec = self.wus_spec(node.op.name, pname, tuple(shp))
                if spec is not None:
                    out.setdefault(node.op.name, {})[pname] = spec
        return out

    def _leaf_layout(self) -> Dict[Tuple[str, str],
                                   Tuple[Tuple[int, ...], Optional[int]]]:
        """{(op name, param name): (whole shape, WUS dim or None)} of
        every parameter leaf, in graph order (each op's leaves in its
        ``param_shapes`` order). Made once."""
        if self._leaves is None:
            from flexflow_tpu_torch.search.unity import _param_shapes
            out = {}
            for node in self.nodes:
                for pname, shp in _param_shapes(node.op).items():
                    shp = tuple(shp)
                    spec = self.wus_spec(node.op.name, pname, shp)
                    dim = None
                    if spec is not None:
                        base = node.param_specs.get(pname, ())
                        base = (list(base) + [None] * len(shp))[:len(shp)]
                        dim = next(d for d, (a, b) in enumerate(
                            zip(base, spec)) if a != b)
                    out[(node.op.name, pname)] = (shp, dim)
            self._leaves = out
        return self._leaves

    def wus_leaves(self) -> Dict[Tuple[str, str], int]:
        """{(op name, param name): dim} of every leaf whose master copy,
        moments and gradient WUS shards over the data axes along
        ``dim``; empty with WUS off."""
        if not self.weight_update_sharding:
            return {}
        return {k: dim for k, (_, dim) in self._leaf_layout().items()
                if dim is not None}

    def _wus_axes(self) -> Tuple[str, ...]:
        """The data axes a WUS shard splits over (those above 1)."""
        return tuple(a for a in self.data_axes if self.mesh.shape[a] > 1)

    def _wus_order(self, keys, reverse: bool) -> List[Tuple[str, str]]:
        """``keys`` in graph op order (``reverse``: the backward's
        completion order the gradient buckets follow), each op's leaves
        in their own order: ``_bucket_order`` of the JAX executor."""
        keys = set(keys)
        nodes = reversed(self.nodes) if reverse else self.nodes
        return [k for node in nodes for k in self._leaf_layout()
                if k[0] == node.op.name and k in keys]

    def _buckets(self, order, itemsize: int) -> List[List[Tuple[str, str]]]:
        """``order`` cut into buckets of ``overlap_bucket_bytes``: a
        bucket closes once its leaves' whole gradients, at ``itemsize``
        bytes an element, reach it (the JAX executor's
        ``_chain_constrained`` partition)."""
        layout = self._leaf_layout()
        buckets, cur, size = [], [], 0
        for key in order:
            cur.append(key)
            size += math.prod(layout[key][0]) * itemsize
            if size >= self.overlap_bucket_bytes:
                buckets.append(cur)
                cur, size = [], 0
        if cur:
            buckets.append(cur)
        return buckets

    def _ctx(self, training: bool, rng=None) -> OpContext:
        return OpContext(training=training, compute_dtype=self.compute_dtype,
                         rng=rng, mesh=self.mesh, device=self.device,
                         comm=self.comm)

    # ---- placement over a process group ------------------------------------
    @property
    def comm(self):
        """The mesh's collectives over the process group
        (``parallel/comm.py``), or None on one device."""
        if self.multi_rank and self._comm is None:
            from flexflow_tpu_torch.parallel.comm import mesh_comm
            self._comm = mesh_comm(self.mesh)
            if self._comm is None:
                raise RuntimeError(
                    f"mesh {self.mesh.shape} runs over a process group of "
                    f"{self.mesh.size} ranks; none is initialized "
                    f"(flexflow_tpu_torch.distributed.initialize)")
        return self._comm

    def param_spec(self, op_name: str, pname: str, ndim: int):
        """The normalized spec of a parameter leaf (``parallel/comm.py``
        ``norm_spec``): the box each rank holds, of the master, the
        compute copy and the moments alike."""
        from flexflow_tpu_torch.parallel.comm import norm_spec
        node = self._by_name.get(op_name)
        spec = node.param_specs.get(pname) if node is not None else None
        return norm_spec(spec, ndim, self.mesh)

    def master_spec(self, op_name: str, pname: str,
                    shape: Tuple[int, ...]):
        """The normalized spec of the master copy of a parameter leaf of
        whole ``shape``, and so of its optimizer moments: its WUS shard
        where WUS shards it, else ``param_spec`` (the JAX executor's
        ``param_shardings(master=True)``)."""
        from flexflow_tpu_torch.parallel.comm import norm_spec
        spec = self.wus_spec(op_name, pname, tuple(shape))
        if spec is None:
            return self.param_spec(op_name, pname, len(shape))
        return norm_spec(spec, len(shape), self.mesh)

    def local_box(self, op_name: str, pname: str,
                  whole: torch.Tensor) -> torch.Tensor:
        """This rank's box of a whole parameter leaf under its master
        spec (itself on one device)."""
        if not self.multi_rank:
            return whole
        for d, axes in enumerate(self.master_spec(op_name, pname,
                                                  tuple(whole.shape))):
            whole = self.comm.own_block(whole, axes, d)
        return whole.contiguous()

    def master_box(self, op_name: str, pname: str, local: torch.Tensor):
        """(whole shape, normalized master spec, this rank's box) over the
        process group of a parameter leaf, or of an optimizer slot of it,
        of which ``local`` is this rank's master box: the block
        ``local_box`` cuts on each dim."""
        shape = self.whole_shape(op_name, pname, local)
        spec = self.master_spec(op_name, pname, shape)
        box = [list(self.comm.block_range(n, axes, d))
               for d, (n, axes) in enumerate(zip(shape, spec))]
        return shape, spec, box

    def whole_shape(self, op_name: str, pname: str,
                    local: torch.Tensor) -> Tuple[int, ...]:
        """The whole shape of a parameter leaf of which ``local`` is this
        rank's master box."""
        if not self.multi_rank:
            return tuple(local.shape)
        known = self._leaf_layout().get((op_name, pname))
        if known is not None:
            return known[0]
        spec = self.param_spec(op_name, pname, local.dim())
        return tuple(n * self.comm.size(axes)
                     for n, axes in zip(local.shape, spec))

    def whole_leaf(self, op_name: str, pname: str,
                   local: torch.Tensor) -> torch.Tensor:
        """The whole parameter leaf on every rank, gathered from each
        rank's master box (itself on one device). Collective."""
        if not self.multi_rank:
            return local
        return self.comm.gather_whole(local, self.master_spec(
            op_name, pname, self.whole_shape(op_name, pname, local)))

    def _batch_axes_spec(self, spec, ndim):
        from flexflow_tpu_torch.parallel.comm import norm_spec
        return (norm_spec(spec, ndim, self.mesh)[0],) + ((),) * (ndim - 1)

    def batch_sharding(self):
        """The model inputs' sharding: the batch over the data axes (the
        JAX executor's ``batch_sharding``)."""
        from flexflow_tpu_torch.distributed import Sharding
        da = tuple(self.data_axes)
        return Sharding(self.mesh, (da,) if da else ())

    def label_sharding(self):
        """The labels' sharding: the batch axes of the model output's
        spec, the rows the loss meets on each rank."""
        from flexflow_tpu_torch.distributed import Sharding
        node = next(n for n in self.nodes if n.guid == self.final_ref[0])
        spec = node.output_specs[self.final_ref[1]]
        return Sharding(self.mesh, (spec[0],) if spec else ())

    def local_feeds(self, inputs, labels=None):
        """The rows of a global batch (host arrays or tensors) this rank
        feeds: the inputs' under ``batch_sharding``, the labels' under
        ``label_sharding``. The batch itself on one device."""
        if not self.multi_rank:
            return inputs, labels
        from flexflow_tpu_torch.distributed import local_batch_rows

        def rows(x, sh):
            n, off = local_batch_rows(sh, x.shape[0], rank=self.comm.rank)
            return x[off:off + n]

        bsh = self.batch_sharding()
        inputs = {k: rows(v, bsh) for k, v in inputs.items()}
        if labels is not None:
            labels = rows(labels, self.label_sharding())
        return inputs, labels

    def _input_spec(self, x):
        from flexflow_tpu_torch.parallel.comm import norm_spec
        return norm_spec(self.batch_sharding().spec, x.dim(), self.mesh)

    def _final_spec(self, ndim):
        from flexflow_tpu_torch.parallel.comm import norm_spec
        node = next(n for n in self.nodes if n.guid == self.final_ref[0])
        return norm_spec(node.output_specs[self.final_ref[1]], ndim,
                         self.mesh)

    # ---- parameter / state initialization ---------------------------------
    def init_params_and_state(self, generator: torch.Generator
                              ) -> Tuple[Dict, Dict]:
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        state: Dict[str, Any] = {}
        for node in self.nodes:
            ps = node.op.init_params(generator)
            if ps:
                # the whole leaf is drawn on every rank (the one-device
                # draw, from one seed), then cut to this rank's master
                # box (its WUS shard under weight-update sharding)
                params[node.op.name] = {
                    pn: self.local_box(node.op.name, pn, t)
                    for pn, t in ps.items()}
            if hasattr(node.op, "init_state"):
                state[node.op.name] = node.op.init_state(generator.device)
        if self.keeps_compute_copy:
            state[COMPUTE_PARAMS_KEY] = self.cast_compute_copy(params)
        return params, state

    def cast_compute_copy(self, params):
        """Compute-dtype copy of the float parameter leaves (the forward's
        working set). Under WUS each sharded leaf's cast is all-gathered
        over the data axes onto the strategy's box, one collective a
        leaf in forward op order, the order the JAX executor chains its
        gathers in under the overlap (``cast_compute_copy`` and
        ``_constrain_compute`` there). Collective under WUS: every rank
        calls it."""
        out = {op: {pn: (a.to(self.compute_dtype)
                         if a.is_floating_point() else a)
                    for pn, a in sub.items()}
               for op, sub in params.items()}
        wus = {k: d for k, d in self.wus_leaves().items()
               if k[0] in out and k[1] in out[k[0]]}
        if not wus:
            return out
        axes, comm = self._wus_axes(), self.comm
        for op, pn in self._wus_order(wus, reverse=False):
            out[op][pn] = comm.all_gather(out[op][pn], axes, wus[(op, pn)])
        return out

    # ---- forward graph traversal ------------------------------------------
    def run_graph(self, params, inputs: Dict[str, torch.Tensor],
                  ctx: OpContext, state=None, nodes=None, master=None):
        """Evaluate ``nodes`` (default: the full graph) in topo order ->
        (values, new op state, auxiliary losses): the model output keyed
        by (producer guid, output index), ``final_ref``, in NCHW;
        ``{op name: state}`` for each op whose state moved; and the
        scalar terms the ops emitted (``forward_with_aux``), in graph
        order. Stateful ops read ``state``; a node standing for several
        ops (a folded or fused Conv+BN) reads their parameters and state
        under their own names, the eval fold
        from ``master`` (the f32 parameters) where given. Each op output
        is dropped once its last consumer has run (``drop_schedule``),
        with its layout conversions, so the walk holds the values still
        to be read, not the whole forward's."""
        nodes = self.nodes if nodes is None else nodes
        drops = self._drops.get(id(nodes))
        if drops is None:
            drops = self._drops[id(nodes)] = drop_schedule(
                nodes, [self.final_ref])
        state = state or {}
        layout_of = {(n.guid, i): lay for n in nodes
                     for i, lay in enumerate(getattr(n, "output_layouts",
                                                     None) or [])}
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        relayout: Dict[Tuple, torch.Tensor] = {}
        new_state: Dict[str, Any] = {}
        aux_losses: List[torch.Tensor] = []

        def fetch(ref, want):
            if ref[0] == "op":
                key = (ref[1], ref[2])
                v, have = values[key], layout_of.get(key, NCHW)
            else:  # graph inputs are staged NCHW
                v, have = inputs[ref[1]], NCHW
            if want == have or v.dim() != 4:
                return v
            k = (tuple(ref), want)
            if k not in relayout:
                relayout[k] = to_layout(v, want)
            return relayout[k]

        comm = self.comm if self.multi_rank else None
        if comm is not None:
            from flexflow_tpu_torch.parallel.sharded import out_specs
        # over a process group: each value's spec, as its producer left it
        spec_of: Dict[Tuple[int, int], Tuple] = {}
        for node, drop in zip(nodes, drops):
            op = node.op
            wants = getattr(node, "input_layouts", None) or \
                [NCHW] * len(node.input_refs)
            args = [fetch(ref, want)
                    for ref, want in zip(node.input_refs, wants)]
            if comm is not None:
                in_specs = [spec_of[(r[1], r[2])] if r[0] == "op"
                            else self._input_spec(a)
                            for r, a in zip(node.input_refs, args)]
                outs, moved, aux = self._sharded_forward(
                    node, params.get(op.name, {}), args, in_specs, ctx,
                    state.get(op.name))
                if moved is not None:
                    new_state[op.name] = moved
                if aux is not None:
                    aux_losses.append(aux)
                for i, sp in enumerate(out_specs(node, self.mesh)):
                    spec_of[(op.guid, i)] = sp
                for i, o in enumerate(outs):
                    values[(op.guid, i)] = o
                del args, outs
                for key in drop:
                    del values[key]
                continue
            sources = getattr(op, "param_sources", None)
            if sources is not None:
                tree = (master if master is not None
                        and getattr(op, "reads_master_params", False)
                        else params)
                outs, moved = op.forward_with_state(
                    {s: tree.get(s, {}) for s in sources}, args, ctx,
                    {s: state.get(s) for s in sources})
                new_state.update(moved)
            elif hasattr(op, "init_state"):
                outs, moved = op.forward_with_state(
                    params.get(op.name, {}), args, ctx, state.get(op.name))
                if moved is not None:
                    new_state[op.name] = moved
            elif hasattr(op, "forward_with_aux"):
                outs, aux = op.forward_with_aux(params.get(op.name, {}),
                                                args, ctx)
                if aux is not None:
                    aux_losses.append(aux)
            else:
                outs = self._op_forward(op, params.get(op.name, {}), args,
                                        ctx)
            for i, o in enumerate(outs):
                values[(op.guid, i)] = o
            del args, outs
            for key in drop:
                del values[key]
                for want in (NCHW, NHWC):
                    relayout.pop((("op",) + key, want), None)
        if layout_of.get(self.final_ref, NCHW) != NCHW:
            values[self.final_ref] = to_layout(values[self.final_ref], NCHW)
        return values, new_state, aux_losses

    def _sharded_forward(self, node, params, args, in_specs, ctx, state):
        """One op on this rank's shards -> (outputs in their specs, moved
        op state or None, auxiliary loss or None): its own sharded
        forward, or its rule's resharding around its plain forward
        (``parallel/sharded.py``), under a remat checkpoint where the op
        has one."""
        from flexflow_tpu_torch.parallel import sharded
        op, comm, rule = node.op, self.comm, node.shard_rule
        moved = aux = None
        if rule == "own":
            outs = self._op_forward(
                op, params, args, ctx,
                call=lambda p, a, c: op.forward_sharded(p, a, in_specs,
                                                        node, c))
            return outs, None, None
        args, params = sharded.prepare(node, rule, comm, args, in_specs,
                                       params)
        if hasattr(op, "init_state"):
            outs, moved = op.forward_with_state(params, args, ctx, state)
        elif hasattr(op, "forward_with_aux"):
            outs, aux = op.forward_with_aux(params, args, ctx)
        else:
            outs = self._op_forward(op, params, args, ctx)
        return sharded.finish(node, rule, comm, outs), moved, aux

    def _training_nodes(self):
        """The node list the train step runs: the (Conv2D, BatchNorm)
        pairs whose conv chose ``_k:conv_bn_fused`` as one fused node
        (``layout.TrainFusedConvBN``, bit-equal to the pair), the rest the
        full graph. A choice whose pair cannot fuse stays unfused and is
        listed in ``unfused_conv_bn``. Made once."""
        if self.multi_rank:
            return self.nodes
        if self._train_nodes is None:
            from flexflow_tpu_torch.layout import fuse_conv_bn_train
            names = {n for n, impl in (self.kernel_choices or {}).items()
                     if impl == "conv_bn_fused"}
            self._train_nodes = fuse_conv_bn_train(
                self.nodes, names, keep_guids={self.final_ref[0]})
            fused = {n.op.conv.name for n in self._train_nodes
                     if hasattr(n.op, "conv")}
            self.unfused_conv_bn = sorted(names - fused)
        return self._train_nodes

    def _inference_nodes(self):
        """The node list eval, forward and ``predict`` run: every eligible
        Conv2D -> BatchNorm(+ReLU) pair folded into one convolution
        (``layout.fold_conv_bn``), or the full graph under
        ``fold_conv_bn=False``. Made once."""
        if not self.fold_conv_bn:
            return self.nodes
        if self._folded_nodes is None:
            from flexflow_tpu_torch.layout import fold_conv_bn
            self._folded_nodes = fold_conv_bn(
                self.nodes, keep_guids={self.final_ref[0]})
        return self._folded_nodes

    def _op_forward(self, op: Op, params, args, ctx: OpContext, call=None):
        """``op.forward``; for a remat op in a forward with grad, under a
        non-reentrant checkpoint (the reentrant form refuses
        ``torch.autograd.grad``). Its parameters and inputs go to the
        checkpoint as tensor arguments, so that what it keeps for the
        backward is saved, and seen by saved-tensor hooks, like what any
        op saves. The RNG state is not kept: no op that draws random
        numbers is rematerialized (``remat_refusal``), and reading it
        would not be legal under a CUDA-graph capture. ``call`` stands
        for ``op.forward`` (the op's sharded forward)."""
        call = call or op.forward
        if not (ctx.training and self.remat_ops and op.name in self.remat_ops
                and torch.is_grad_enabled()):
            return call(params, args, ctx)
        names = list(params)

        def interior(*flat):
            return call(dict(zip(names, flat[:len(names)])),
                        list(flat[len(names):]), ctx)

        return checkpoint(interior, *params.values(), *args,
                          use_reentrant=False, preserve_rng_state=False)

    def _forward_fn(self, training: bool = False):
        """The eager forward: ``fwd(params, state, inputs, rng=None) ->
        output``. Reads the compute copy of the parameters when the state
        carries one. ``training=False`` runs the folded node list
        (``_inference_nodes``) under ``torch.inference_mode``;
        ``training=True`` runs the
        training-mode forward with grad enabled (its output carries the
        autograd graph back to the parameters it was given)."""

        def fwd(params, state, inputs, rng=None):
            ctx = self._ctx(training, rng)
            cparams = state.get(COMPUTE_PARAMS_KEY, params)
            if training:
                with torch.enable_grad():
                    return self.run_graph(cparams, inputs, ctx,
                                          state)[0][self.final_ref]
            with torch.inference_mode():
                out = self.run_graph(cparams, inputs, ctx, state,
                                     self._inference_nodes(),
                                     master=params)[0][self.final_ref]
                if self.multi_rank:
                    # every rank returns the whole output
                    out = self.comm.gather_whole(out,
                                                 self._final_spec(out.dim()))
                return out

        return fwd

    def make_forward(self, training: bool = False):
        """``fwd(params, state, inputs, rng=None) -> output``.
        ``training=False``: the compiled forward (a CUDA-graph replay on
        the card), which takes host arrays or tensors and whose output is
        overwritten by the executor's next compiled call.
        ``training=True`` is the eager training-mode forward
        (``_forward_fn``): its output carries an autograd graph."""
        if training:
            return self._forward_fn(True)
        graph = self._step_graph("forward", self._forward_body,
                                 donate=False)

        def compiled(params, state, inputs, rng=None):
            return graph((params, state), self.local_feeds(inputs)[0],
                         rng)[1]

        return compiled

    def _step_graph(self, name: str, body, *, donate: bool) -> StepGraph:
        """The executor's compiled step ``name``, made at its first use;
        its CUDA graphs draw on the executor's one memory pool. ``body``
        is a method of the executor, which the step holds weakly."""
        graph = self.step_graphs.get(name)
        if graph is None:
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = self.step_graphs[name] = StepGraph(
                body, self.device, name, donate=donate, pool=self._graph_pool,
                capture=not self.multi_rank)
        return graph

    def _cast_feeds(self, inputs, labels=None):
        """A batch as the eager steps take it (``model.stage_array``'s
        casts): floating inputs in the compute dtype, floating labels in
        f32. The compiled steps cast their static feeds so, on the
        device."""
        inputs = {n: x.to(self.compute_dtype) if x.is_floating_point()
                  else x for n, x in inputs.items()}
        if labels is not None and labels.is_floating_point():
            labels = labels.to(torch.float32)
        return inputs, labels

    # the compiled steps' bodies: body(carry, feeds, rng) -> (new carry,
    # outputs) over the static buffers (step_graph.StepGraph)
    def _forward_body(self, carry, inputs, rng):
        return None, self._forward_fn(False)(
            *carry, self._cast_feeds(inputs)[0], rng)

    def _train_body(self, carry, feeds, rng):
        params, opt_state, state, loss, mvals = self._train_step_fn()(
            *carry, *self._cast_feeds(*feeds), rng)
        return (params, opt_state, state), (loss, mvals)

    def _eval_body(self, carry, feeds, rng):
        return None, self._eval_step_fn()(*carry, *self._cast_feeds(*feeds))

    # ---- training ----------------------------------------------------------
    def _loss_value(self, logits, labels):
        """The loss over the global batch: on one device the loss of
        ``logits``; over a process group, each rank's loss on its rows
        (``logits`` taken to the batch sharding of the output's spec,
        whole along every other dim) weighted by its share of the batch
        and summed over the batch axes."""
        if not self.multi_rank:
            return self._local_loss(logits, labels)
        logits, axes = self._rows_of(logits)
        share = self.comm.size(axes)
        return self.comm.reduce(self._local_loss(logits, labels) / share,
                                axes)

    def _rows_of(self, logits):
        """The model output as this rank's rows, whole along every other
        dim, and the axes its batch is split over."""
        have = self._final_spec(logits.dim())
        want = (have[0],) + ((),) * (logits.dim() - 1)
        return self.comm.reshard(logits, have, want), have[0]

    def _metric_sums(self, logits, labels):
        """The metric sums over the global batch (summed over the batch
        axes over a process group)."""
        if not self.multi_rank:
            return self.metrics.compute(logits, labels)
        logits, axes = self._rows_of(logits)
        return {k: self.comm.all_reduce(v, axes)
                for k, v in self.metrics.compute(logits, labels).items()}

    def _local_loss(self, logits, labels):
        fn = get_loss_fn(self.loss_type)
        if self.final_is_softmax and self.loss_type in (
            LossType.CATEGORICAL_CROSSENTROPY,
            LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
        ):
            # final op already produced probabilities (the reference pairs
            # a Softmax op with CE loss)
            logp = torch.log(torch.clamp(logits.float(), 1e-12, 1.0))
            if self.loss_type == LossType.CATEGORICAL_CROSSENTROPY:
                return -torch.mean(torch.sum(labels * logp, dim=-1))
            lab = labels.reshape(labels.shape[0], -1)[:, 0].long()
            return -torch.mean(torch.gather(logp, -1, lab[:, None]))
        return fn(logits, labels)

    def _objective(self, logits, labels, aux_losses):
        """The training objective: the loss plus every auxiliary term the
        ops emitted, added in graph order (the JAX train step's sum)."""
        loss = self._loss_value(logits, labels)
        for a in aux_losses:
            loss = loss + a
        return loss

    def _optimizer_update(self, grads, opt_state, params):
        """Optimizer update honoring per-op ``_k:fused`` kernel choices:
        the chosen ops' leaves update through the fused pass
        (ops/fused_update.py, bit-equal to the plain update); the rest
        take ``optimizer.update`` unchanged."""
        fused = {n for n in self.fused_update_ops if n in params}
        if not fused:
            return self.optimizer.update(grads, opt_state, params)
        from flexflow_tpu_torch.ops.fused_update import fused_optimizer_update
        return fused_optimizer_update(self.optimizer, grads, opt_state,
                                      params, fused)

    def _grad_leaves(self, params, state):
        """The leaves an autograd graph of one step starts from: fresh
        tensors over the parameters the forward reads (the working copy,
        where the executor keeps one), floating ones requiring grad."""
        cparams = (state[COMPUTE_PARAMS_KEY] if self.keeps_compute_copy
                   else params)
        return {op: {pn: t.detach().requires_grad_(t.is_floating_point())
                     for pn, t in sub.items()}
                for op, sub in cparams.items()}

    def grads_of(self, params, state, inputs, labels, rng=None):
        """One forward and backward: (loss, logits, grads); the loss
        includes the ops' auxiliary terms (``_objective``). ``grads`` has
        the tree of ``params``, in the dtype of the tensors the forward
        read (the compute copy's, under the master-weight regime), every
        leaf contiguous. The leaves the autograd graph starts from are
        made fresh here, so no graph outlives the call."""
        return self._forward_backward(params, state, inputs, labels, rng)[:3]

    def _forward_backward(self, params, state, inputs, labels, rng=None):
        """``grads_of``'s (loss, logits, grads) and the op state the
        training forward moved ({op name: state})."""
        leaves = self._grad_leaves(params, state)
        flat = [(op, pn) for op, sub in leaves.items() for pn, t in sub.items()
                if t.requires_grad]
        ctx = self._ctx(True, rng)
        overlap = (self._Overlap(self, leaves, flat)
                   if self.multi_rank and self.grad_overlap else None)
        with torch.enable_grad():
            values, new_state, aux = self.run_graph(
                leaves, inputs, ctx, state, self._training_nodes())
            logits = values[self.final_ref]
            loss = self._objective(logits, labels, aux)
            # a model without trainable leaves (a parameter-free graph)
            # takes an empty update, as the reference's grad of {} does
            got = (torch.autograd.grad(
                loss, [leaves[op][pn] for op, pn in flat], allow_unused=True)
                if flat else ())
        got = dict(zip(flat, got))
        if self.multi_rank:
            got = self._sync_grads(got, overlap)
        # a leaf no gradient reached takes zeros of its master box
        grads = {op: {pn: (got[(op, pn)].contiguous()
                           if got.get((op, pn)) is not None
                           else t.new_zeros(params[op][pn].shape))
                      for pn, t in sub.items()}
                 for op, sub in leaves.items()}
        return loss.detach(), logits.detach(), grads, new_state

    def _wus_reduce(self, key, g, async_op: bool = False):
        """The data-axis part of the sync of WUS leaf ``key``'s gradient
        ``g`` (this rank's box): a reduce-scatter along its WUS dim where
        the op's batch is split over every data axis; else the sum over
        the data axes it is split over, then this rank's block. ->
        the shard, or with ``async_op`` a ``Pending`` of it."""
        from flexflow_tpu_torch.parallel.comm import Pending
        comm, axes = self.comm, self._wus_axes()
        dim = self.wus_leaves()[key]
        have = self._by_name[key[0]].grad_axes
        if all(a in have for a in axes):
            return comm.reduce_scatter(g, axes, dim, async_op=async_op)
        part = tuple(a for a in axes if a in have)
        if part:
            g = comm.all_reduce(g, part)
        out = comm.own_block(g, axes, dim)
        return Pending(None, out) if async_op else out

    def _wus_finish(self, key, shard):
        """A WUS gradient shard summed over the axes its op's batch is
        split over beyond the data axes (``model`` under ``sample2``)."""
        axes = self._wus_axes()
        rest = tuple(a for a in self._by_name[key[0]].grad_axes
                     if a not in axes)
        return self.comm.all_reduce(shard, rest) if rest else shard

    def _sync_grads(self, got, overlap=None):
        """Each gradient summed over the axes its op's batch was split
        over (``OpNode.grad_axes``), last op first: the order the
        backward finishes them. A WUS leaf's becomes its shard
        (``_wus_reduce``, ``_wus_finish``), issued by ``overlap``'s
        buckets where given; every other leaf's is all-reduced."""
        comm = self.comm
        wus = self.wus_leaves()
        shards = overlap.wait(got) if overlap is not None else {}
        for node in reversed(self.nodes):
            for key in [k for k in got if k[0] == node.op.name]:
                g = got[key]
                if g is None:
                    continue
                if key in wus:
                    shard = (shards[key] if key in shards
                             else self._wus_reduce(key, g.contiguous()))
                    got[key] = self._wus_finish(key, shard)
                elif node.grad_axes:
                    got[key] = comm.all_reduce(g.contiguous(),
                                               node.grad_axes)
        return got

    class _Overlap:
        """The bucketed gradient reduce-scatters of one train step. The
        WUS leaves, in reverse op order, are cut into buckets of
        ``overlap_bucket_bytes`` (``_buckets``); a gradient hook on each
        fresh leaf notes its gradient when the backward has made it,
        and the buckets are issued in order, each without waiting, as
        soon as every leaf of it and of the buckets before it has its
        gradient. Each leaf is one reduce-scatter of the size it has
        without the overlap, so the values are the same bit for bit;
        only the time of issue moves. ``wait`` issues what the backward
        left (leaves no gradient reached are skipped, as without the
        overlap) and waits on every bucket. Each bucket's issue is noted
        in the executor's ``overlap_record`` with the step's leaves
        whose gradient was still to come."""

        def __init__(self, ex, leaves, flat):
            self.ex, self.n_leaves = ex, len(flat)
            sharded = ex.wus_leaves()
            wus = [k for k in flat if k in sharded]
            self.itemsize = (leaves[wus[0][0]][wus[0][1]].element_size()
                             if wus else 1)
            self.buckets = ex._buckets(ex._wus_order(wus, reverse=True),
                                       self.itemsize)
            self.grads: Dict[Tuple[str, str], torch.Tensor] = {}
            self.pending: Dict[Tuple[str, str], Any] = {}
            self.next = 0
            ex.overlap_record = []
            for key in flat:
                leaves[key[0]][key[1]].register_hook(self._hook(key))

        def _hook(self, key):
            def note(g):
                self.grads[key] = g
                self._issue(final=False)
            return note

        def _issue(self, final: bool) -> None:
            while self.next < len(self.buckets):
                bucket = self.buckets[self.next]
                if not final and any(k not in self.grads for k in bucket):
                    return
                for key in bucket:
                    g = self.grads.get(key)
                    if g is not None:
                        self.pending[key] = self.ex._wus_reduce(
                            key, g.contiguous(), async_op=True)
                self.ex.overlap_record.append(dict(
                    bucket=self.next, leaves=len(bucket),
                    bytes=sum(math.prod(self.ex._leaf_layout()[k][0])
                              for k in bucket) * self.itemsize,
                    pending=self.n_leaves - len(self.grads)))
                self.next += 1

        def wait(self, got) -> Dict[Tuple[str, str], torch.Tensor]:
            """{WUS leaf: its data-reduced shard}, once all are done."""
            for key, g in got.items():
                if g is not None:
                    self.grads.setdefault(key, g)
            self._issue(final=True)
            return {k: p.wait() for k, p in self.pending.items()}

    def saved_bytes_by_op(self, params, state, inputs, labels,
                          rng=None) -> Dict[str, int]:
        """What autograd keeps for the backward of one training forward
        and its loss, by op: {op name (``"loss"`` for the loss): bytes}.
        Each storage that a saved-tensor hook sees is counted once, whole,
        at the op that saves it first; a remat op's checkpoint keeps its
        inputs and parameters, its interior nothing. The parameter leaves
        themselves are not counted. No backward runs: the graph is
        dropped on return."""
        from torch.autograd.graph import saved_tensors_hooks

        leaves = self._grad_leaves(params, state)
        seen = {t.untyped_storage().data_ptr()
                for sub in leaves.values() for t in sub.values()}
        by_op: Dict[str, int] = {}
        current = ["input"]

        def pack(t):
            storage = t.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                by_op[current[0]] = (by_op.get(current[0], 0)
                                     + storage.nbytes())
            # held (so that no storage is freed and its address reused
            # during the walk) without its grad_fn: a saved output
            # returned as it is would hold its own node, a cycle that
            # keeps the graph alive after the call
            return t.detach()

        def tagged(op, *args, **kw):
            current[0] = op.name
            return type(self)._op_forward(self, op, *args, **kw)

        # each op's forward tags what it saves, for this call only
        self._op_forward = tagged
        try:
            with torch.enable_grad(), saved_tensors_hooks(pack, lambda t: t):
                values, _, aux = self.run_graph(
                    leaves, inputs, self._ctx(True, rng), state,
                    self._training_nodes())
                logits = values[self.final_ref]
                current[0] = "loss"
                loss = self._objective(logits, labels, aux)
        finally:
            del self._op_forward
        del loss, logits, values, aux
        return by_op

    def _train_step_fn(self):
        """The train step as a plain function:
        ``(params, opt_state, state, inputs, labels, rng) -> (params,
        opt_state, state, loss, metric sums)``."""

        def train_step(params, opt_state, state, inputs, labels, rng=None):
            if self.multi_rank:
                self.comm.begin_step()
            loss, logits, grads, moved = self._forward_backward(
                params, state, inputs, labels, rng)
            with torch.no_grad():
                new_params, new_opt_state = self._optimizer_update(
                    grads, opt_state, params)
                new_state = dict(state)
                new_state.update(moved)
                if self.keeps_compute_copy:
                    # the next step's working copy (under WUS gathered
                    # from the updated shards)
                    new_state[COMPUTE_PARAMS_KEY] = \
                        self.cast_compute_copy(new_params)
                metric_vals = self._metric_sums(logits, labels)
            if self.multi_rank:
                self.comm.end_step()
            return new_params, new_opt_state, new_state, loss, metric_vals

        return train_step

    def make_train_step(self):
        """The compiled train step, ``_train_step_fn``'s signature and
        results: ``(params, opt_state, state, inputs, labels, rng=None) ->
        (params, opt_state, state, loss, metric sums)``; the batch may be
        host arrays (the compiled step copies and casts them on the
        device) or the staged tensors the eager step takes. The trees it
        is first called with become its static buffers and come back
        updated (donated); loss and metric sums are overwritten by the
        executor's next compiled call."""
        if self.comp_mode == CompMode.INFERENCE:
            raise RuntimeError(
                "model compiled with CompMode.INFERENCE is forward-only; "
                "re-compile with CompMode.TRAINING to train")
        get_registry().gauge("executor.num_ops", len(self.nodes))
        graph = self._step_graph("train_step", self._train_body, donate=True)

        def train_step(params, opt_state, state, inputs, labels, rng=None):
            (params, opt_state, state), (loss, mvals) = graph(
                (params, opt_state, state), self.local_feeds(inputs, labels),
                rng)
            return params, opt_state, state, loss, mvals

        return train_step

    def make_multi_step(self, num_iters: int, stacked: bool = False):
        """``num_iters`` training steps in one call, the counterpart of the
        JAX package's ``lax.scan`` of the step (the reference's trace
        replay): ``multi(params, opt_state, state, inputs, labels,
        rng=None) -> (params, opt_state, state, losses[num_iters])``.
        ``stacked=False``: (inputs, labels) is one batch reused every
        iteration; ``stacked=True``: each array carries a leading
        ``[num_iters]`` axis and iteration i consumes slice i. The
        compiled one-step graph is replayed ``num_iters`` times, slice i
        copied into its static input buffers before replay i (device to
        device, or host arrays through its pinned buffers); ``losses`` is
        a new f32 tensor each call."""
        if num_iters < 1:
            raise ValueError(f"num_iters must be at least 1, got {num_iters}")
        step = self.make_train_step()

        def multi(params, opt_state, state, inputs, labels, rng=None):
            if stacked:
                lead = {t.shape[0] for t in [labels, *inputs.values()]}
                if lead != {num_iters}:
                    raise ValueError(f"stacked inputs need a leading axis of "
                                     f"{num_iters}, got {sorted(lead)}")
            losses = torch.empty(num_iters, dtype=torch.float32,
                                 device=self.device)
            for i in range(num_iters):
                inp, lab = (({n: x[i] for n, x in inputs.items()}, labels[i])
                            if stacked else (inputs, labels))
                params, opt_state, state, loss, _ = step(
                    params, opt_state, state, inp, lab, rng)
                losses[i] = loss
            return params, opt_state, state, losses

        return multi

    def _eval_step_fn(self):
        """The eager eval step: ``eval_step(params, state, inputs, labels)
        -> (loss, logits, metric sums)``, under ``torch.inference_mode``."""

        def eval_step(params, state, inputs, labels):
            ctx = self._ctx(False)
            with torch.inference_mode():
                logits = self.run_graph(
                    state.get(COMPUTE_PARAMS_KEY, params), inputs, ctx, state,
                    self._inference_nodes(), master=params)[0][self.final_ref]
                loss = self._loss_value(logits, labels)
                return loss, logits, self._metric_sums(logits, labels)

        return eval_step

    def make_eval_step(self):
        """The compiled eval step, ``_eval_step_fn``'s signature and
        results, overwritten by the executor's next compiled call."""
        graph = self._step_graph("eval_step", self._eval_body, donate=False)

        def eval_step(params, state, inputs, labels):
            return graph((params, state),
                         self.local_feeds(inputs, labels))[1]

        return eval_step
