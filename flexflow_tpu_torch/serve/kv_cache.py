"""KV-cache incremental decode for the causal attention family.

PyTorch counterpart of ``flexflow_tpu/serve/kv_cache.py``. A full-sequence
``predict`` recomputes every earlier token's K/V at every generated token;
here the K/V of the positions already seen live in a cache per causal
attention op, ``[B, Hk, S_max, D]`` (kv heads: grouped-query attention
caches the small side), in the executor's compute dtype.

The decode path runs the model's own graph: the layer graph is
re-materialized at the new-token block length (prefill: the prompt's
length; decode: 1) through ``FFModel._materialize_nodes`` and run node by
node, with ``MultiHeadAttention.decode_forward`` writing each block's K/V
into its cache and attending over it. Everything outside attention works
position by position in a decoder, so prefill and N decode steps give the
full-sequence forward's rows.

Each block length is one compiled step (``step_graph.StepGraph``, the
counterpart of the reference's ``jax.jit(step, donate_argnums=(2,))``):
its carry is the compute copy of the parameters, read, and the caches,
updated in place (so nothing is copied back); its feeds are the block's
ids and the position, an int32 ``[1]`` array copied into a static feed
at each call. On the card the first call of a block length runs the step
eagerly and captures it, and every later call replays the graph: a session's
prefill and all its decode steps replay two graphs in all, and no
position is ever captured as a constant. A capture that fails raises. On
the CPU the same body runs eagerly over the same static buffers.

The reference shards the cache over a mesh (``cache_partition_spec``:
heads under model parallelism, the sequence over a ring axis); one device
has no such layout, and a session on a mesh with an axis above 1 raises
(ROADMAP.md Queue 1 item 3.3).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY, drop_schedule
from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.model import host_copy
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.step_graph import StepGraph


def _attention_nodes(ff) -> List[Any]:
    return [n for n in ff.executor.nodes
            if n.op.op_type == OperatorType.MULTIHEAD_ATTENTION]


def _refuse_mesh(ff) -> None:
    big = {a: n for a, n in (ff.mesh.shape if ff.mesh is not None
                             else {}).items() if n > 1}
    if big:
        raise NotImplementedError(
            f"KV-cache decode runs on one device; the model's mesh {big} "
            f"would shard the cache, which comes with multi-GPU execution "
            f"(ROADMAP.md Queue 1 item 3.3)")


def init_kv_cache(ff, batch: Optional[int] = None,
                  max_len: Optional[int] = None, dtype=None
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zero caches on the model's device, one ``{"k", "v"}`` pair for each
    causal attention op, ``[batch, Hk, max_len, D]`` in ``dtype`` (the
    executor's compute dtype by default)."""
    _refuse_mesh(ff)
    batch = int(batch or ff.input_tensors[0].shape[0])
    max_len = int(max_len or ff._declared_seq() or 0)
    if max_len <= 0:
        raise ValueError("model has no sequence dim to cache")
    dtype = dtype or ff.executor.compute_dtype
    caches: Dict[str, Dict[str, torch.Tensor]] = {}
    for node in _attention_nodes(ff):
        op = node.op
        if not op.causal:
            raise NotImplementedError(
                f"attention '{op.name}' is not causal — KV-cache decode "
                f"only decomposes causal attention incrementally")
        shape = (batch, op.num_kv_heads, max_len, op.head_dim)
        # distinct buffers for every entry: each is written in place
        caches[op.name] = dict(
            k=torch.zeros(shape, dtype=dtype, device=ff.device),
            v=torch.zeros(shape, dtype=dtype, device=ff.device))
    if not caches:
        raise ValueError("model has no attention ops — nothing to cache")
    return caches


def _seq_overrides(ff, new_len: int, batch: Optional[int]
                   ) -> Dict[str, Tuple[int, ...]]:
    """INPUT-shape overrides that materialize the graph at ``new_len``
    new-token rows (and ``batch`` rows): dim 1 of every input that carries
    the declared sequence becomes ``new_len``."""
    declared = ff._declared_seq()
    overrides: Dict[str, Tuple[int, ...]] = {}
    for layer in ff.layers:
        if layer.op_type != OperatorType.INPUT:
            continue
        shp = list(layer.outputs[0].shape)
        changed = False
        if declared is not None and len(shp) >= 2 and shp[1] == declared:
            shp[1] = new_len
            changed = True
        if batch is not None and shp and shp[0] != batch:
            shp[0] = batch
            changed = True
        if changed:
            overrides[layer.name] = tuple(shp)
    return overrides


class _BlockStep:
    """The graph materialized at one block length and its compiled step.
    ``body`` is the eager step, the reference a replay is held against."""

    def __init__(self, session: "DecodeSession", t: int, pool):
        ff = session.ff
        self.t = t
        self.nodes, self.input_names, tensor_ref = ff._materialize_nodes(
            _seq_overrides(ff, t, session.batch))
        self.final_ref = ff._select_final_ref(self.nodes, tensor_ref)
        self._drops = drop_schedule(self.nodes, [self.final_ref])
        self.compute_dtype = ff.executor.compute_dtype
        self.mesh = ff.mesh
        self.device = ff.device
        self.graph = StepGraph(self.body, ff.device, f"decode_t{t}",
                               donate=True, pool=pool)

    def body(self, carry, feeds, rng=None):
        """``((params, caches), (inputs, pos), rng) -> ((params, caches),
        logits)``: the block's forward, each causal attention op through
        ``decode_forward`` over its cache (written in place)."""
        params, caches = carry
        inputs, pos = feeds
        cd = self.compute_dtype
        inputs = {n: x.to(cd) if x.is_floating_point() else x
                  for n, x in inputs.items()}
        ctx = OpContext(training=False, compute_dtype=cd, mesh=self.mesh,
                        device=self.device)
        values: Dict[Tuple[int, int], torch.Tensor] = {}
        with torch.no_grad():
            for node, drop in zip(self.nodes, self._drops):
                op = node.op
                args = [values[(r[1], r[2])] if r[0] == "op"
                        else inputs[r[1]] for r in node.input_refs]
                if op.op_type == OperatorType.MULTIHEAD_ATTENTION:
                    c = caches[op.name]
                    y, _, _ = op.decode_forward(params.get(op.name, {}),
                                                args, ctx, c["k"], c["v"],
                                                pos)
                    outs = [y]
                else:
                    outs = op.forward(params.get(op.name, {}), args, ctx)
                for i, o in enumerate(outs):
                    values[(op.guid, i)] = o
                del args, outs
                for key in drop:
                    del values[key]
        return (params, caches), values[self.final_ref]


class DecodeSession:
    """Prefill and incremental decode over the KV cache.

    One session is one batch of sequences decoding in lockstep.
    ``prefill(inputs)`` consumes the prompt block (absolute positions
    0..S0-1), ``decode(inputs)`` one block at the running position; both
    return the logits of the rows they consumed as f32 host arrays. One
    compiled step for each block length (``step_graphs``), kept across
    calls; the caches are updated in place.
    """

    def __init__(self, ff, batch: Optional[int] = None,
                 max_len: Optional[int] = None):
        from flexflow_tpu_torch.executor import GraphExecutor
        if ff.executor is None:
            raise ValueError("compile() the model before decoding")
        if type(ff.executor) is not GraphExecutor:
            raise NotImplementedError(
                "KV-cache decode drives the plain GraphExecutor graph "
                "(pipeline-lowered models are not supported)")
        self.ff = ff
        self.batch = int(batch or ff.input_tensors[0].shape[0])
        self.max_len = int(max_len or ff._declared_seq() or 0)
        self.caches = init_kv_cache(ff, self.batch, self.max_len)
        self.pos = 0
        self._blocks: Dict[int, _BlockStep] = {}
        # the graphs of one session share a memory pool
        self._pool = (torch.cuda.graph_pool_handle()
                      if ff.device.type == "cuda" else None)
        # the decode path runs decode_forward: always the cached einsum
        # (flash has no incremental form over a cache), recorded here
        self.kernel_choices = {
            n.op.name: "cached_einsum" for n in _attention_nodes(ff)}

    def report(self) -> Dict[str, Any]:
        """The session's provenance: geometry, position and the recorded
        attention implementation of each op (``cached_einsum``)."""
        return dict(batch=self.batch, max_len=self.max_len, pos=self.pos,
                    kernel_choices=dict(self.kernel_choices))

    @property
    def step_graphs(self) -> Dict[int, StepGraph]:
        """{block length: its compiled step}; each has ``captures`` and
        ``replays``."""
        return {t: b.graph for t, b in self._blocks.items()}

    def _block(self, t: int) -> _BlockStep:
        if t not in self._blocks:
            self._blocks[t] = _BlockStep(self, t, self._pool)
        return self._blocks[t]

    def _params(self):
        ff = self.ff
        ff._refresh_compute_params()
        return ff.state.get(COMPUTE_PARAMS_KEY, ff.params)

    def _run(self, inputs: Sequence[np.ndarray], t: int,
             eager: bool = False) -> np.ndarray:
        """One block of ``t`` rows at the running position; ``eager``
        runs the block's body on the model's device instead of its
        compiled step (the reference a replay is held against)."""
        if self.pos + t > self.max_len:
            raise ValueError(
                f"decode past max_len: pos {self.pos} + block {t} > "
                f"{self.max_len}")
        feeds = self.ff._host_inputs(list(inputs))
        block = self._block(t)
        pos = np.array([self.pos], dtype=np.int32)
        if eager:
            dev = self.ff.device
            _, logits = block.body(
                (self._params(), self.caches),
                ({n: torch.as_tensor(a, device=dev)
                  for n, a in feeds.items()},
                 torch.as_tensor(pos, device=dev)))
        else:
            _, logits = block.graph((self._params(), self.caches),
                                    (feeds, pos))
        self.pos += t
        return host_copy(logits)

    @staticmethod
    def _as_list(inputs) -> List[np.ndarray]:
        return [np.asarray(x) for x in
                (inputs if isinstance(inputs, (list, tuple)) else [inputs])]

    def prefill(self, inputs: Sequence[np.ndarray]) -> np.ndarray:
        """Consume the prompt block (the inputs that carry the sequence
        shaped ``[B, S0, ...]``); returns the logits of every prompt
        row."""
        if self.pos != 0:
            raise ValueError("prefill must be the session's first call")
        seqful = self._as_list(inputs)
        return self._run(seqful, int(seqful[0].shape[1]))

    def decode(self, inputs: Sequence[np.ndarray]) -> np.ndarray:
        """One incremental block (usually ``[B, 1, ...]``) at the running
        position; returns its logits."""
        seqful = self._as_list(inputs)
        return self._run(seqful, int(seqful[0].shape[1]))

    def generate(self, input_ids: np.ndarray, steps: int) -> np.ndarray:
        """Greedy generation for single-input token models: prefill the
        prompt, then emit ``steps`` argmax tokens. Returns ``[B, S0 +
        steps]`` token ids."""
        ids = np.asarray(input_ids)
        logits = self.prefill([ids])
        toks = [ids]
        for i in range(steps):
            nxt = np.argmax(logits[:, -1, :], axis=-1).astype(ids.dtype)
            toks.append(nxt[:, None])
            if i + 1 < steps:
                logits = self.decode([nxt[:, None]])
        return np.concatenate(toks, axis=1)
