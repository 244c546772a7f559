"""PyTorch port, multi-rank execution of data x model meshes against the
JAX package's run on the 8-virtual-device CPU mesh (``tests/conftest.py``).

The port runs each case as 8 (or 4) gloo ranks spawned here, one a mesh
position, over a FileStore under the test's temporary directory (no
fixed port, so the suite's parallel workers never collide); rank r holds
what JAX's device r holds. The JAX side runs in this process with the
same weights, carried across by name (``weights.from_jax_params`` cuts
each rank's box). Every rank runs the cases one after another in one
spawned world of 8 ranks, the file's only one, and no module-level
import here touches JAX, so a spawned rank imports torch and the port
alone.

Cases:
- (a) ``test_model_training.py::test_dp_matches_single_device``'s MLP on
  ``{"data": 8}``;
- (b) ``::test_parameter_parallel_matches_dp``'s, ``enable_parameter_
  parallel`` on 8 devices (``{"data": 4, "model": 2}``, column-parallel
  dense layers);
- (c) ``test_pcg_parallel_ops.py``'s parallel ops (Repartition, Combine,
  Replicate and the Reduction's values);
- (d) a 2-layer BERT-proxy (hidden 64, 4 heads, seq 32, batch 8) under
  ``dp_head_k:flash`` / ``dp_col_k:fused`` / ``dp_row_k:fused`` on the
  asymmetric ``{"data": 4, "model": 2}``, with its collective census
  against the JAX package's HLO census by kind;
- (e) the same model under the strategy the port's search picks at 8
  devices with parameter parallelism on (weight-update sharding, the
  overlap and the pipeline axis, which later slices execute, off; it
  picks ``{"data": 4, "model": 2}``), executed on 8
  ranks and by the JAX package from the same strategy file;
- (g) the BERT-proxy under the choices (d) leaves out: ``head``,
  ``col`` and ``row`` on replicated rows, ``dp_mp_last`` and
  ``mp_last`` on the residual adds, ``sample2`` (rows over data x
  model), ``rep``;
- (h) a 2-layer Llama with grouped-query attention (one kv head, so
  wk / wv stay replicated beside head-sharded wq / wo), the embedding's
  columns and the gated MLP column / row parallel with ``dp_mp_last``
  elementwise ops between, trained by SGD (which, unlike Adam, keeps a
  wrong gradient scale);
- (f) the forward and VJP of each differentiable collective of
  ``parallel/comm.py`` against ``jax.vjp`` of the sharded global
  function, shard by shard (JAX's device r against rank r);
- a data loader's ``fit_loader`` on the parameter-parallel MLP, against
  ``fit``.

Bounds, ``test_torch_port_train.py``'s (f32 compute on both sides; the
sums run in other orders): per-step loss rtol 1e-4; every parameter
after 3 steps atol 2e-5 and rtol 1e-4. The collectives' values: 1e-6.
"""

import json
import os
import traceback

import numpy as np
import pytest
import torch

STEPS = 3
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
BERT = dict(num_layers=2, hidden_size=64, num_heads=4, seq_length=32,
            batch_size=8)
# (e)'s search: parameter parallelism on; weight-update sharding, the
# overlap, graph rewrites and pipelines (which later slices execute) off
SEARCH_CFG = dict(weight_update_sharding="off", overlap_bucket_mb="off",
                  enable_substitution=False, enable_pipeline_parallel=False,
                  enable_parameter_parallel=True)


def _blobs(n, d, classes, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n)
    x = centers[y] + rs.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def _bert_batch():
    rs = np.random.RandomState(0)
    return (rs.randn(8, 32, 64).astype(np.float32),
            rs.randn(8, 32, 1).astype(np.float32))


def _bert_strategy(mesh, head_axes=("model",)):
    """The strategy file body of the BERT-proxy's ``[mesh]`` layout:
    attention ``dp_head_k:flash``, ffn1 ``dp_col_k:fused``, ffn2
    ``dp_row_k:fused``, every other op ``dp_k:fused``."""
    ops = {}
    dp3 = ["data", None, None]
    for i in range(BERT["num_layers"]):
        for n in (f"ln1_{i}", f"ln2_{i}"):
            ops[n] = dict(choice="dp_k:fused", outputs=[dp3], params={})
        for n in (f"res1_{i}", f"res2_{i}"):
            ops[n] = dict(choice="dp", outputs=[dp3], params={})
        ops[f"attn_{i}"] = dict(
            choice="dp_head_k:flash", outputs=[dp3],
            params={w: [list(head_axes), None, None]
                    for w in ("wq", "wk", "wv", "wo")})
        ops[f"ffn1_{i}"] = dict(choice="dp_col_k:fused",
                                outputs=[["data", None, "model"]],
                                params=dict(kernel=[None, "model"],
                                            bias=["model"]))
        ops[f"ffn2_{i}"] = dict(choice="dp_row_k:fused", outputs=[dp3],
                                params=dict(kernel=["model", None]))
    ops["head"] = dict(choice="dp_k:fused", outputs=[dp3], params={})
    return dict(version=1, mesh=mesh, ops=ops)


# ---- the port's side: one spawned rank ----------------------------------

def _bert_other_choices():
    """(g)'s file body on {"data": 4, "model": 2}."""
    body = _bert_strategy({"data": 4, "model": 2})
    ops = body["ops"]
    rep3, mp3 = [None, None, None], [None, None, "model"]
    s2 = [["data", "model"], None, None]
    heads = {w: ["model", None, None] for w in ("wq", "wk", "wv", "wo")}
    ops["ln1_0"] = dict(choice="rep", outputs=[rep3], params={})
    ops["attn_0"] = dict(choice="head", outputs=[rep3], params=heads)
    ops["res1_0"] = dict(choice="dp_mp_last",
                         outputs=[["data", None, "model"]], params={})
    ops["ffn1_0"] = dict(choice="col", outputs=[mp3],
                         params=dict(kernel=[None, "model"], bias=["model"]))
    ops["ffn2_0"] = dict(choice="row", outputs=[rep3],
                         params=dict(kernel=["model", None]))
    ops["res2_0"] = dict(choice="mp_last", outputs=[mp3], params={})
    for n in ("ln1_1", "attn_1", "ffn2_1"):
        ops[n] = dict(choice="sample2", outputs=[s2], params={})
    ops["head"] = dict(choice="rep", outputs=[rep3], params={})
    return body


LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=1, batch_size=8, seq_length=16)


def _llama_strategy():
    """(h)'s file body on {"data": 4, "model": 2}."""
    dp3, mp3 = ["data", None, None], ["data", None, "model"]
    ops = {"embed_tokens": dict(choice="dp_col", outputs=[mp3],
                                params=dict(kernel=[None, "model"])),
           "final_ln": dict(choice="dp", outputs=[dp3], params={}),
           "lm_head": dict(choice="dp_col", outputs=[mp3],
                           params=dict(kernel=[None, "model"]))}
    for i in range(LLAMA["num_hidden_layers"]):
        for n in ("input_ln", "post_ln", "res1", "res2"):
            ops[f"l{i}_{n}"] = dict(choice="dp", outputs=[dp3], params={})
        ops[f"l{i}_attn"] = dict(
            choice="dp_head", outputs=[dp3],
            params=dict(wq=["model", None, None], wo=["model", None, None]))
        for n in ("gate_proj", "up_proj"):
            ops[f"l{i}_{n}"] = dict(choice="dp_col", outputs=[mp3],
                                    params=dict(kernel=[None, "model"]))
        for n in ("sig", "silu", "swiglu"):
            ops[f"l{i}_{n}"] = dict(choice="dp_mp_last", outputs=[mp3],
                                    params={})
        ops[f"l{i}_down_proj"] = dict(choice="dp_row", outputs=[dp3],
                                      params=dict(kernel=["model", None]))
    return dict(version=1, mesh={"data": 4, "model": 2}, ops=ops)


def _llama_batch():
    rs = np.random.RandomState(1)
    ids = rs.randint(0, LLAMA["vocab_size"] - 1,
                     (LLAMA["batch_size"], LLAMA["seq_length"])
                     ).astype(np.int32)
    return ids, ((ids + 1) % LLAMA["vocab_size"]).astype(np.int32)


def _port_mlp(cfg_kw, mesh=None, batch=64, hidden=16):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.ffconst import ActiMode
    from flexflow_tpu_torch.optimizers import SGDOptimizer

    ff = P.FFModel(P.FFConfig(batch_size=batch, **cfg_kw), device="cpu")
    t = ff.create_tensor((batch, 8), name="x")
    t = ff.dense(t, hidden, activation=ActiMode.AC_MODE_RELU, name="d1")
    t = ff.dense(t, 4, name="d2")
    t = ff.softmax(t, name="sm")
    ff.compile(SGDOptimizer(lr=0.1),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [P.MetricsType.ACCURACY], mesh=mesh)
    return ff


def _port_bert(cfg_kw):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    ff = create_transformer(TransformerConfig(**BERT),
                            P.FFConfig(batch_size=8, **cfg_kw), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _train(ff, x, y, steps=STEPS):
    out = []
    for _ in range(steps):
        ff.fit(x, y, epochs=1, verbose=False)
        out.append(ff._last_loss)
    return out


def _result(ff, losses, **extra):
    from flexflow_tpu_torch.weights import to_jax_params
    return dict(losses=losses, params=to_jax_params(ff),
                mesh=dict(ff.mesh.shape), **extra)


def _case_a(payload):
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.weights import from_jax_params
    ff = _port_mlp(dict(seed=7), mesh=make_mesh(8, {"data": 8}))
    from_jax_params(payload["init"], ff)
    return _result(ff, _train(ff, *payload["data"]))


def _case_b(payload):
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.weights import from_jax_params
    ff = _port_mlp(dict(seed=3, enable_parameter_parallel=True))
    from_jax_params(payload["init"], ff)
    specs = {n.op.name: dict(n.param_specs) for n in ff.executor.nodes}
    out = _result(ff, _train(ff, *payload["data"]), specs=specs)
    out["host"] = distributed.all_gather_host(
        ff.params["d1"]["kernel"],
        distributed.Sharding(ff.mesh, specs["d1"]["kernel"]))
    out["rows"] = distributed.local_batch_rows(
        ff.executor.batch_sharding(), 64)
    return out


def _case_c(payload):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    from flexflow_tpu_torch.weights import from_jax_params
    out = {}
    for kind in ("pipeline", "reduction"):
        ff = P.FFModel(P.FFConfig(batch_size=16, only_data_parallel=True),
                       device="cpu")
        x_t = ff.create_tensor((16, 8), name="x")
        h = ff.dense(x_t, 32, name="d1")
        if kind == "pipeline":
            h = ff.repartition(h, dim=0, degree=8, name="rp")
            h = ff.relu(h, name="r")
            h = ff.combine(h, dim=0, degree=8, name="cb")
            h = ff.replicate(h, degree=8, name="rl")
            h = ff.dense(h, 4, name="d2")
        else:
            h = ff.reduction(h, dim=1, degree=4, name="red")
        ff.compile(SGDOptimizer(lr=0.01),
                   P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [P.MetricsType.MEAN_SQUARED_ERROR])
        from_jax_params(payload[kind]["init"], ff)
        x, y = payload[kind]["data"]
        ff.fit(x, y, epochs=1, verbose=False)
        out[kind] = _result(ff, [ff._last_loss], pred=ff.predict(x),
                            specs={n.op.name: n.output_specs
                                   for n in ff.executor.nodes})
    return out


def _case_bert(payload):
    from flexflow_tpu_torch.obs.inspect import inspect_model_step
    from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from flexflow_tpu_torch.ops.fused_update import fused_adam_multi
    from flexflow_tpu_torch.weights import from_jax_params
    ff = _port_bert(dict(import_strategy_file=payload["strategy"],
                         weight_update_sharding="off",
                         overlap_bucket_mb="off"))
    from_jax_params(payload["init"], ff)
    x, y = _bert_batch()
    losses = _train(ff, x, y)
    census = inspect_model_step(ff)
    ev = ff.evaluate(x, y)
    return _result(ff, losses, census=census["collectives"],
                   source=census["collectives_source"], evaluate=ev,
                   pred=ff.predict(x), record=ff.executor.comm.step_record,
                   rules={n.op.name: n.shard_rule for n in ff.executor.nodes},
                   launches=(flash_fwd.launches, flash_bwd.launches,
                             fused_adam_multi.launches))


def _case_search(payload):
    """A compile that searches over the group: rank 0 searches, every
    rank takes its strategy; one step runs."""
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.optimizers import AdamOptimizer
    ff = create_transformer(TransformerConfig(**BERT), P.FFConfig(
        batch_size=8, search_budget=2, **SEARCH_CFG), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-4), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    ff.fit(*_bert_batch(), epochs=1, verbose=False)
    return dict(mesh=dict(ff.mesh.shape), loss=ff._last_loss,
                choices={n.op.name: ff.strategy[n.op.guid].choice
                         for n in ff.executor.nodes})


def _case_h(payload):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                 create_llama)
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    from flexflow_tpu_torch.weights import from_jax_params
    ff = create_llama(LlamaModelConfig(**LLAMA), P.FFConfig(
        batch_size=LLAMA["batch_size"],
        import_strategy_file=payload["strategy"]), device="cpu")
    ff.compile(SGDOptimizer(lr=0.5), P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [])
    from_jax_params(payload["init"], ff)
    return _result(ff, _train(ff, *_llama_batch()),
                   rules={n.op.name: n.shard_rule for n in ff.executor.nodes})


def _case_f(payload):
    """Each differentiable collective's output and input gradient on
    this rank, from this rank's box of the global inputs."""
    import torch.distributed as dist

    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.parallel.comm import mesh_comm, norm_spec
    mesh = make_mesh(8, {"data": 4, "model": 2})
    comm = mesh_comm(mesh)

    def box(arr, spec):
        t = torch.from_numpy(np.asarray(arr))
        for d, axes in enumerate(norm_spec(spec, t.dim(), mesh)):
            t = comm.own_block(t, axes, d)
        return t.clone().requires_grad_()

    out = {}
    for name, (fn, x_spec, g_spec) in _collective_cases().items():
        x = box(payload["x"], x_spec)
        y = fn(comm, x, box)
        g = box(payload["g"][name], g_spec).detach()
        (gx,) = torch.autograd.grad(y, x, g)
        out[name] = (y.detach().numpy(), gx.numpy())
    dist.barrier()
    return out


def _collective_cases():
    """{name: (fn(comm, x_box, box) -> y_box, x spec, y spec)}; each fn
    is the global function ``_jax_collective_cases`` gives, on the
    rank's boxes."""
    w = np.random.RandomState(3).randn(16, 8).astype(np.float32)
    return {
        # sharded on model -> whole
        "gather": (lambda c, x, box: c.gather(x, ("model",), 1),
                   (None, "model"), (None, None)),
        # whole -> sharded on data x model
        "scatter": (lambda c, x, box: c.scatter(x, ("data", "model"), 0),
                    (None, None), (("data", "model"), None)),
        # the partial sums x @ w over the model-sharded contraction dim
        "reduce": (lambda c, x, box: c.reduce(
            x @ box(w, ("model", None)).detach(), ("model",)),
            ("data", "model"), ("data", None)),
        # column parallel: x whole, w's columns sharded on model
        "copy_to": (lambda c, x, box: c.copy_to(x, ("model",)) @ box(
            w, (None, "model")).detach(),
            ("data", None), ("data", "model")),
        # partial sums reduced and scattered over model on dim 1
        "reduce_scatter": (lambda c, x, box: c.reduce_scatter_grad(
            x @ box(w, ("model", None)).detach(), ("model",), 1),
            ("data", "model"), ("data", "model")),
        # the model sharding moves from dim 0 to dim 1
        "all_to_all": (lambda c, x, box: c.reshard(
            x, (("model",), ()), ((), ("model",))),
            ("model", None), (None, "model")),
        # a general reshard: (data, model) -> (model, data)
        "reshard": (lambda c, x, box: c.reshard(
            x * x, (("data",), ("model",)), (("model",), ("data",))),
            ("data", "model"), ("model", "data")),
    }


def _jax_collective_cases():
    """The global functions of ``_collective_cases``."""
    import jax.numpy as jnp
    w = np.random.RandomState(3).randn(16, 8).astype(np.float32)
    return {
        "gather": lambda x: x,
        "scatter": lambda x: x,
        "reduce": lambda x: x @ w,
        "copy_to": lambda x: x @ w,
        "reduce_scatter": lambda x: x @ w,
        "all_to_all": lambda x: x,
        "reshard": lambda x: jnp.square(x),
    }


def _case_loader(payload):
    """``fit_loader`` over the ranks against ``fit``: every rank stages
    the whole dataset and feeds its rows of each batch."""
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.weights import from_jax_params
    xb, yb = _blobs(64, 8, 4, seed=1)
    runs = []
    for loader in (False, True):
        m = _port_mlp(dict(seed=5, enable_parameter_parallel=True),
                      batch=16)
        from_jax_params(payload["init"], m)
        if loader:
            m.fit_loader(P.create_data_loaders(m, xb, yb), epochs=2,
                         verbose=False)
        else:
            m.fit(xb, yb, epochs=2, verbose=False)
        runs.append(_result(m, m.epoch_losses))
    return runs


CASES = {"a": _case_a, "b": _case_b, "c": _case_c, "d": _case_bert,
         "e": _case_bert, "f": _case_f, "g": _case_bert, "h": _case_h,
         "loader": _case_loader, "search": _case_search}


def _rank_main(rank, world, root, names):
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed
    # one thread a rank: the world's ranks share the host's cores
    torch.set_num_threads(1)
    distributed.initialize(
        store=dist.FileStore(os.path.join(root, f"store{world}"), world),
        world_size=world, rank=rank, backend="gloo", timeout_s=120)
    try:
        payload = torch.load(os.path.join(root, "payload.pt"),
                             weights_only=False)
        res = {}
        for name in names:
            try:
                res[name] = CASES[name](payload.get(name))
            except Exception:
                res[name] = dict(error=traceback.format_exc())
        torch.save(res, os.path.join(root, f"out{world}.{rank}"))
    finally:
        dist.destroy_process_group()


def _spawn(root, world, names):
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(world, root, names), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(root, f"out{world}.{r}"),
                       weights_only=False) for r in range(world)]


# ---- the JAX side and the comparison ------------------------------------

def _jax_mlp(cfg_kw, mesh=None, batch=64, hidden=16):
    import flexflow_tpu as J
    from flexflow_tpu.ffconst import ActiMode
    from flexflow_tpu.optimizers import SGDOptimizer

    ff = J.FFModel(J.FFConfig(batch_size=batch, **cfg_kw))
    t = ff.create_tensor((batch, 8), name="x")
    t = ff.dense(t, hidden, activation=ActiMode.AC_MODE_RELU, name="d1")
    t = ff.dense(t, 4, name="d2")
    t = ff.softmax(t, name="sm")
    ff.compile(SGDOptimizer(lr=0.1),
               J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [J.MetricsType.ACCURACY], mesh=mesh)
    return ff


def _jax_bert(cfg_kw):
    import jax.numpy as jnp

    import flexflow_tpu as J
    from flexflow_tpu.models.transformer import (
        TransformerConfig as JTransformerConfig,
        create_transformer as j_create_transformer)
    from flexflow_tpu.optimizers import AdamOptimizer as JAdam

    ff = j_create_transformer(JTransformerConfig(**BERT),
                              J.FFConfig(batch_size=8, **cfg_kw))
    ff.compile(JAdam(alpha=1e-4, state_dtype=jnp.bfloat16),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [J.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _host_params(ff):
    import jax
    return jax.tree.map(np.asarray, ff.params)


def _jax_train(ff, x, y, steps=STEPS):
    out = []
    for _ in range(steps):
        ff.fit(x, y, epochs=1, verbose=False)
        out.append(float(ff._last_loss))
    return out


def _port_search_strategy(path):
    """The strategy the port's search picks for the BERT-proxy at 8
    devices with parameter parallelism on (cpu-sim machine; weight-update
    sharding, the overlap, graph rewrites and pipelines off), written as
    a strategy file."""
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.machine import MachineSpec
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.search import unity

    ff = create_transformer(TransformerConfig(**BERT), P.FFConfig(
        batch_size=8, **SEARCH_CFG), device="cpu")
    nodes, _, ref = ff._materialize_nodes()
    final = ff._select_final_ref(nodes, ref)
    cfg = ff.config
    cfg.search_budget = 2
    cfg.opt_state_factor = 2.0
    mesh, st, info = unity.graph_optimize(
        nodes, MachineSpec(chip="cpu-sim", chips_per_slice=8), cfg, 8,
        batch=8, final_ref=final)
    unity.export_strategy_file(path, mesh, st, nodes)
    return json.loads(open(path).read())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in both packages: {case: (jax result, [rank results])}.
    The Pallas interpret mode stays set while JAX traces."""
    root = str(tmp_path_factory.mktemp("mesh"))
    from flexflow_tpu.machine import make_mesh as j_make_mesh
    jres, payload = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        # (a)
        x, y = _blobs(64, 8, 4)
        jff = _jax_mlp(dict(seed=7), mesh=j_make_mesh(8, {"data": 8}))
        payload["a"] = dict(init=_host_params(jff), data=(x, y))
        jres["a"] = dict(losses=_jax_train(jff, x, y),
                         params=_host_params(jff))
        # (b)
        jff = _jax_mlp(dict(seed=3, enable_parameter_parallel=True))
        payload["b"] = dict(init=_host_params(jff), data=(x, y))
        jres["b"] = dict(losses=_jax_train(jff, x, y),
                         params=_host_params(jff),
                         mesh=dict(zip(jff.mesh.axis_names,
                                       jff.mesh.devices.shape)),
                         specs={n.op.name: {k: tuple(v) for k, v in
                                            n.param_specs.items()}
                                for n in jff.executor.nodes})
        # (c)
        jres["c"], payload["c"] = {}, {}
        import flexflow_tpu as J
        from flexflow_tpu.optimizers import SGDOptimizer as JSGD
        for kind in ("pipeline", "reduction"):
            jf = J.FFModel(J.FFConfig(batch_size=16, only_data_parallel=True))
            x_t = jf.create_tensor((16, 8), name="x")
            h = jf.dense(x_t, 32, name="d1")
            if kind == "pipeline":
                h = jf.repartition(h, dim=0, degree=8, name="rp")
                h = jf.relu(h, name="r")
                h = jf.combine(h, dim=0, degree=8, name="cb")
                h = jf.replicate(h, degree=8, name="rl")
                h = jf.dense(h, 4, name="d2")
            else:
                h = jf.reduction(h, dim=1, degree=4, name="red")
            jf.compile(JSGD(lr=0.01), J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                       [J.MetricsType.MEAN_SQUARED_ERROR])
            rs = np.random.RandomState(0)
            xc = rs.randn(16, 8).astype(np.float32)
            yc = rs.randn(16, h.shape[-1]).astype(np.float32)
            payload["c"][kind] = dict(init=_host_params(jf), data=(xc, yc))
            jf.fit(xc, yc, epochs=1, verbose=False)
            jres["c"][kind] = dict(
                losses=[float(jf._last_loss)], params=_host_params(jf),
                pred=np.asarray(jf.predict(xc)), x=xc,
                specs={n.op.name: [tuple(s) if s is not None else None
                                   for s in n.output_specs]
                       for n in jf.executor.nodes})
        # (d)
        xb, yb = _bert_batch()
        from flexflow_tpu.obs.inspect import inspect_model_step
        path = os.path.join(root, "d.json")
        with open(path, "w") as f:
            json.dump(_bert_strategy({"data": 4, "model": 2}), f)
        jff = _jax_bert(dict(import_strategy_file=path,
                             weight_update_sharding="off",
                             overlap_bucket_mb="off"))
        payload["d"] = dict(init=_host_params(jff), strategy=path)
        jres["d"] = dict(losses=_jax_train(jff, xb, yb),
                         params=_host_params(jff),
                         evaluate=jff.evaluate(xb, yb),
                         pred=np.asarray(jff.predict(xb)),
                         census=inspect_model_step(jff)["collectives"])
        payload["loader"] = dict(
            init=_host_params(_jax_mlp(dict(seed=5), batch=16)))
        # (g)
        path = os.path.join(root, "g.json")
        with open(path, "w") as f:
            json.dump(_bert_other_choices(), f)
        jff = _jax_bert(dict(import_strategy_file=path))
        payload["g"] = dict(init=_host_params(jff), strategy=path)
        jres["g"] = dict(losses=_jax_train(jff, xb, yb),
                         params=_host_params(jff),
                         evaluate=jff.evaluate(xb, yb),
                         pred=np.asarray(jff.predict(xb)))
        # (h)
        from flexflow_tpu.models.llama import (
            LlamaModelConfig as JLlamaModelConfig,
            create_llama as j_create_llama)
        path = os.path.join(root, "h.json")
        with open(path, "w") as f:
            json.dump(_llama_strategy(), f)
        jff = j_create_llama(JLlamaModelConfig(**LLAMA), J.FFConfig(
            batch_size=LLAMA["batch_size"], import_strategy_file=path))
        jff.compile(JSGD(lr=0.5), J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                    [])
        payload["h"] = dict(init=_host_params(jff), strategy=path)
        jres["h"] = dict(losses=_jax_train(jff, *_llama_batch()),
                         params=_host_params(jff))
        # (e)
        path = os.path.join(root, "e.json")
        body = _port_search_strategy(path)
        jff = _jax_bert(dict(import_strategy_file=path,
                             weight_update_sharding="off",
                             overlap_bucket_mb="off"))
        payload["e"] = dict(init=_host_params(jff), strategy=path)
        jres["e"] = dict(losses=_jax_train(jff, xb, yb),
                         params=_host_params(jff), strategy=body)
        # (f)
        payload["f"] = dict(
            x=np.random.RandomState(1).randn(16, 16).astype(np.float32),
            g={})
        jres["f"] = _jax_collectives(payload["f"])
    torch.save(payload, os.path.join(root, "payload.pt"))
    return jres, _spawn(root, 8, list(CASES))


def _jax_collectives(payload):
    """Each case's global output and input gradient on JAX's 8 devices,
    the cotangent drawn here and handed to the ranks; -> {name: (y
    shards, grad shards)} by device index."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from flexflow_tpu.machine import make_mesh as j_make_mesh
    mesh = j_make_mesh(8, {"data": 4, "model": 2})
    out = {}
    port = _collective_cases()
    for i, (name, fn) in enumerate(_jax_collective_cases().items()):
        _, x_spec, y_spec = port[name]
        x = jax.device_put(payload["x"], NamedSharding(mesh, JP(*x_spec)))
        y, vjp = jax.vjp(lambda a: jax.lax.with_sharding_constraint(
            fn(a), NamedSharding(mesh, JP(*y_spec))), x)
        g = np.random.RandomState(10 + i).randn(*y.shape).astype(np.float32)
        payload["g"][name] = g
        (gx,) = vjp(jax.device_put(g, NamedSharding(mesh, JP(*y_spec))))
        gx = jax.device_put(gx, NamedSharding(mesh, JP(*x_spec)))
        shards = lambda a: {s.device.id: np.asarray(s.data)
                            for s in a.addressable_shards}
        out[name] = (shards(y), shards(gx))
    return out


def _port(ranks, case):
    for r in ranks:
        if isinstance(r[case], dict) and "error" in r[case]:
            pytest.fail(r[case]["error"])
    return ranks[0][case]


def _check_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _check_params(got, want):
    assert set(got) == set(want)
    for layer, sub in want.items():
        assert set(got[layer]) == set(sub), layer
        for name, w in sub.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(w),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{layer}/{name}")


def _same_on_every_rank(ranks, case, key="params"):
    first = ranks[0][case][key]
    for r in ranks[1:]:
        for layer, sub in first.items():
            for name, a in sub.items():
                np.testing.assert_array_equal(r[case][key][layer][name], a)


@pytest.mark.parametrize("case", ["a", "b"])
def test_mlp_matches_the_jax_mesh(runs, case):
    """(a) data parallel over 8 ranks, (b) the parameter-parallel MLP on
    the mesh both packages pick: per-step losses and every parameter
    after 3 steps, the same whole array on every rank."""
    jres, eight = runs
    got = _port(eight, case)
    _check_losses(got["losses"], jres[case]["losses"])
    _check_params(got["params"], jres[case]["params"])
    _same_on_every_rank(eight, case)
    if case == "b":
        np.testing.assert_array_equal(got["host"],
                                      got["params"]["d1"]["kernel"])
        # rank 0 feeds the first 16 rows (data index 0)
        assert got["rows"] == (16, 0)
        assert got["mesh"] == jres["b"]["mesh"] == {"data": 4, "model": 2}
        assert got["specs"]["d1"] == jres["b"]["specs"]["d1"] == dict(
            kernel=(None, "model"), bias=("model",))


@pytest.mark.parametrize("kind", ["pipeline", "reduction"])
def test_parallel_ops_match_the_jax_mesh(runs, kind):
    """(c) Repartition -> relu -> Combine -> Replicate, and a Reduction:
    the forced specs, the step's loss, the parameters and ``predict``;
    the Reduction's values are the replica groups' sums."""
    jres, eight = runs
    got = _port(eight, "c")[kind]
    want = jres["c"][kind]
    assert {k: [tuple(s) if s is not None else None for s in v]
            for k, v in got["specs"].items()} == want["specs"]
    _check_losses(got["losses"], want["losses"])
    _check_params(got["params"], want["params"])
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-4,
                               atol=1e-5)
    if kind == "reduction":
        k, b = got["params"]["d1"]["kernel"], got["params"]["d1"]["bias"]
        ref = (want["x"] @ k + b).reshape(16, 4, 8).sum(axis=1)
        np.testing.assert_allclose(got["pred"], ref, rtol=1e-4, atol=1e-4)
    else:
        assert got["specs"]["rp"] == [("data", None)]
        assert got["specs"]["rl"] == [(None, None)]


@pytest.mark.parametrize("case", ["d", "e", "g", "h"])
def test_bert_proxy_matches_the_jax_mesh(runs, case):
    """(d) head / column / row parallelism on {"data": 4, "model": 2},
    (e) the port's searched 8-device strategy, (g) the other choices,
    (h) the GQA Llama: losses, parameters, ``evaluate`` and ``predict``
    (d, g), each op's sharded rule (d, h)."""
    jres, eight = runs
    got = _port(eight, case)
    _check_losses(got["losses"], jres[case]["losses"])
    _check_params(got["params"], jres[case]["params"])
    _same_on_every_rank(eight, case)
    if case in ("d", "g"):
        assert got["mesh"] == {"data": 4, "model": 2}
        np.testing.assert_allclose(got["evaluate"]["loss"],
                                   jres[case]["evaluate"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["pred"], jres[case]["pred"],
                                   rtol=1e-4, atol=1e-5)
    if case == "d":
        assert got["rules"]["attn_0"] == got["rules"]["ffn1_0"] == "own"
        assert got["rules"]["ln1_0"] == "per_sample"
        assert got["rules"]["res1_0"] == "elementwise"
    elif case == "h":
        assert got["rules"]["embed_tokens"] == got["rules"]["l0_attn"] == \
            "own"
        assert got["rules"]["l0_silu"] == "elementwise"
        assert got["rules"]["l0_input_ln"] == "per_sample"
    elif case == "e":
        assert len(jres["e"]["strategy"]["ops"]) == 15
        assert got["mesh"] == jres["e"]["strategy"]["mesh"]


def test_census_against_the_jax_hlo_census(runs):
    """The port's record of one train step, by kind, beside the JAX
    package's HLO census of the same strategy. The port issues one
    all-reduce a gradient leaf, one a row-parallel output, one a column
    input's gradient; XLA combines all-reduces, so counts differ by
    design: each kind the port issues is one the compiled JAX step
    holds, and both move all-reduce bytes. The port's all-gathers (none
    here: every op's input already has the layout it computes on) would
    be XLA's too."""
    jres, eight = runs
    got = _port(eight, "d")
    assert got["source"] == "process_group:gloo"
    port_kinds = set(got["census"])
    jax_kinds = {k for k, e in jres["d"]["census"].items() if e["count"]}
    assert "all-reduce" in port_kinds and "all-reduce" in jax_kinds
    assert port_kinds <= jax_kinds | {"all-gather"}, (port_kinds, jax_kinds)
    # per leaf: the replicated leaves sum over data, the head- and
    # column-sharded ones over data too; row partials and column input
    # gradients over model
    axes = {a for _, a, _ in got["record"]}
    assert axes <= {("data",), ("model",)}
    assert got["census"]["all-reduce"]["count"] == len(got["record"])
    assert got["census"]["all-reduce"]["bytes"] > 0


def test_collectives_and_their_vjps_match_jax_shards(runs):
    """(f) every differentiable collective: rank r's output and input
    gradient equal JAX device r's shard of the sharded global function's
    output and ``jax.vjp``."""
    jres, eight = runs
    for name, (y_want, g_want) in jres["f"].items():
        for r, ranks in enumerate(eight):
            if "error" in ranks["f"]:
                pytest.fail(ranks["f"]["error"])
            y, g = ranks["f"][name]
            np.testing.assert_allclose(y, y_want[r], rtol=1e-6, atol=1e-5,
                                       err_msg=f"{name} rank {r}")
            np.testing.assert_allclose(g, g_want[r], rtol=1e-6, atol=1e-5,
                                       err_msg=f"{name} grad rank {r}")


def test_fit_loader_matches_fit_over_ranks(runs):
    """A loader's ``fit_loader`` (the ranks agreeing on num_batches) is
    ``fit`` bit for bit over 8 ranks."""
    _, eight = runs
    fit, loader = _port(eight, "loader")
    assert fit["losses"] == loader["losses"]
    for layer, sub in fit["params"].items():
        for name, a in sub.items():
            np.testing.assert_array_equal(loader["params"][layer][name], a)


def test_a_search_over_the_group_gives_every_rank_one_strategy(runs):
    """``compile(search_budget=2)`` in the 8-rank group: rank 0's search,
    broadcast, is (e)'s strategy on every rank, and its step runs."""
    jres, eight = runs
    got = [r["search"] for r in eight]
    for g in got:
        if "error" in g:
            pytest.fail(g["error"])
    want = {n: op["choice"] for n, op in jres["e"]["strategy"]["ops"].items()}
    assert all(g["choices"] == want for g in got)
    assert got[0]["mesh"] == jres["e"]["strategy"]["mesh"]
    assert len({g["loss"] for g in got}) == 1 and np.isfinite(got[0]["loss"])
