"""PyTorch port, the Unity search against the JAX package.

Two graphs, built in both packages: the transformer (2 layers, hidden
256, 4 heads, S 128, batch 8) and the MLP (64 -> 128 -> 128 -> 10, batch
8). Both packages number layers with a process-wide counter; each pair is
built from the same counter value (``_aligned``), so op guids and the
names derived from them agree and whole requests can be compared. The
machine is the JAX package's ``"cpu-sim"`` at 1, 4 and 8 devices.

Tolerances:
- the request JSON (graph, machine, config), the native response and
  the strategy JSON: exact (the same bytes through ``json.dumps``);
- predicted times: exact (the same native core on the same request);
- 3-step losses of ``compile(search_budget=2)``: rtol 1e-4, as in
  ``tests/test_torch_port_train.py`` (f32 on both sides, sums in
  different orders);
- predictions of the linear-fusion graph, SPLIT and SOFTMAX forward and
  VJP: atol/rtol 1e-5 (f32; only the order of the sums differs).

Where the packages part: under ``--search-measure-ops`` on the card the
port's measured table also carries an attention op's flash-kernel rows
("<guid>:fwd:flash", "<guid>:bwd:flash") and times "<guid>:fwd" on the
einsum core (``search/profile.py`` ``microbenchmark``), which the JAX
package never sends; on the CPU, where these tests run, both packages
send the plain rows only.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.ffconst as jconst
import flexflow_tpu.search.native as jnative
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import MachineSpec as JMachineSpec
from flexflow_tpu.models.mlp import create_mlp as j_create_mlp
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.ops import OpRegistry as JRegistry
from flexflow_tpu.ops.base import OpContext as JContext
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec
from flexflow_tpu_torch.models import (TransformerConfig, create_mlp,
                                       create_transformer)
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.base import OpContext as PContext
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.search import native, unity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

SMALL = dict(num_layers=2, hidden_size=256, num_heads=4, seq_length=128,
             batch_size=8)
MLP = dict(batch_size=8, in_dim=64, hidden_dims=(128, 128), out_dim=10)
DEVICES = (1, 4, 8)
LOSS_RTOL = 1e-4
ATOL = RTOL = 1e-5


def _aligned():
    """Start both packages' layer and tensor counters at one value."""
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _pair(model, **cfg):
    """(JAX model, port model) of ``model``, uncompiled, guids aligned."""
    _aligned()
    if model == "transformer":
        jff = j_create_transformer(JTransformerConfig(**SMALL),
                                   J.FFConfig(batch_size=8, **cfg))
        pff = create_transformer(TransformerConfig(**SMALL),
                                 P.FFConfig(batch_size=8, **cfg),
                                 device="cpu")
    else:
        jff = j_create_mlp(**MLP, ff_config=J.FFConfig(batch_size=8, **cfg))
        pff = create_mlp(**MLP, ff_config=P.FFConfig(batch_size=8, **cfg),
                         device="cpu")
    return jff, pff


def _graph(ff):
    nodes, _, tensor_ref = ff._materialize_nodes()
    return nodes, ff._select_final_ref(nodes, tensor_ref)


def _search_config(ff, training, budget=2):
    cfg = ff.config
    cfg.search_budget = budget
    mode = jconst.CompMode if isinstance(ff, J.FFModel) else pconst.CompMode
    cfg.computation_mode = mode.TRAINING if training else mode.INFERENCE
    cfg.opt_state_factor = 2.0 if training else 0.0
    return cfg


def _dumps(x):
    return json.dumps(x, sort_keys=True)


@pytest.fixture
def requests_seen(monkeypatch):
    """Record every request each package hands its native core."""
    seen = {"jax": [], "port": []}
    j_real, p_real = jnative.native_optimize, native.native_optimize

    def j_spy(req):
        seen["jax"].append(json.loads(json.dumps(req)))
        return j_real(req)

    def p_spy(req):
        seen["port"].append(json.loads(json.dumps(req)))
        return p_real(req)

    monkeypatch.setattr(jnative, "native_optimize", j_spy)
    monkeypatch.setattr(native, "native_optimize", p_spy)
    return seen


# ---- the request -------------------------------------------------------------

@pytest.mark.parametrize("model", ["transformer", "mlp"])
def test_serialize_graph_matches(model):
    jff, pff = _pair(model)
    (jn, jf), (pn, pf) = _graph(jff), _graph(pff)
    want = junity.serialize_graph(jn, final_guid=jf[0])
    got = unity.serialize_graph(pn, final_guid=pf[0])
    assert _dumps(got) == _dumps(want)


@pytest.mark.parametrize("n", DEVICES)
@pytest.mark.parametrize("comm", [1.0, 0.5])
def test_machine_to_json_matches(n, comm):
    want = junity.machine_to_json(JMachineSpec(chip="cpu-sim",
                                               chips_per_slice=n), n,
                                  comm_bytes_factor=comm)
    got = unity.machine_to_json(MachineSpec(chip="cpu-sim",
                                            chips_per_slice=n), n,
                                comm_bytes_factor=comm)
    assert _dumps(got) == _dumps(want)


@pytest.mark.parametrize("model", ["transformer", "mlp"])
def test_request_and_native_response_match(model, requests_seen):
    """The whole request each package builds is the same, and the port's
    library answers it as the JAX package's ``native_optimize`` does."""
    jff, pff = _pair(model)
    for ff, mod, spec in ((jff, junity, JMachineSpec), (pff, unity,
                                                         MachineSpec)):
        nodes, final = _graph(ff)
        mod.graph_optimize(nodes, spec(chip="cpu-sim", chips_per_slice=4),
                           _search_config(ff, True), 4, batch=8,
                           final_ref=final)
    (jreq,), (preq,) = requests_seen["jax"], requests_seen["port"]
    assert _dumps(preq) == _dumps(jreq)
    assert _dumps(native.native_optimize(preq)) \
        == _dumps(jnative.native_optimize(jreq))


@pytest.mark.parametrize("training", [True, False],
                         ids=["training", "inference"])
@pytest.mark.parametrize("n", DEVICES)
@pytest.mark.parametrize("model", ["transformer", "mlp"])
def test_graph_optimize_strategy_json_matches(model, n, training):
    jff, pff = _pair(model)
    out = []
    for ff, mod, spec in ((jff, junity, JMachineSpec), (pff, unity,
                                                         MachineSpec)):
        nodes, final = _graph(ff)
        mesh, st, info = mod.graph_optimize(
            nodes, spec(chip="cpu-sim", chips_per_slice=n),
            _search_config(ff, training), n, batch=8, final_ref=final)
        out.append((mod.strategy_json(mesh, st,
                                      info.get("rewritten_nodes", nodes),
                                      objective=info["objective"]),
                    info["predicted_time"], info["objective"]))
    (want, want_t, want_obj), (got, got_t, got_obj) = out
    assert _dumps(got) == _dumps(want)
    assert got_t == want_t and got_obj == want_obj
    assert got_obj == ("step_time" if training else "latency")


# ---- compile and serve with a budget ------------------------------------------

@pytest.fixture(scope="module")
def searched(tmp_path_factory):
    """``compile(search_budget=2)`` of the transformer in both packages on
    one device, Adam with bf16 moments, strategies exported; the port
    carries the JAX model's parameters; 3 one-batch steps in each. The
    search gives attention ``rep_k:flash``: the JAX package runs its
    Pallas kernels in interpret mode, the port the kernels' plain
    versions."""
    tmp = tmp_path_factory.mktemp("searched")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jff, pff = _pair("transformer", search_budget=2)
        jff.config.workers_per_node = 1
        jff.config.export_strategy_file = str(tmp / "jax.json")
        pff.config.export_strategy_file = str(tmp / "port.json")
        jff.compile(JAdam(alpha=1e-4, state_dtype=jnp.bfloat16),
                    J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    [J.MetricsType.MEAN_SQUARED_ERROR])
        pff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                    P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    [P.MetricsType.MEAN_SQUARED_ERROR])
        from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
        rs = np.random.RandomState(0)
        x = rs.randn(8, 128, 256).astype(np.float32)
        y = rs.randn(8, 128, 1).astype(np.float32)
        losses = []
        for _ in range(3):
            jff.fit(x, y, epochs=1, verbose=False)
            pff.fit(x, y, epochs=1, verbose=False)
            losses.append((jff._last_loss, pff._last_loss))
        yield jff, pff, losses, tmp


def test_compile_with_search_exports_the_same_strategy(searched):
    jff, pff, _, tmp = searched
    want = json.loads((tmp / "jax.json").read_text())
    got = json.loads((tmp / "port.json").read_text())
    assert got == want
    assert got["objective"] == "step_time" and got["mesh"] == {"data": 1}
    assert pff.search_objective == jff.search_objective == "step_time"
    assert pff.search_info["predicted_time"] \
        == jff.search_info["predicted_time"]
    assert pff.search_info["cost_model"] == "analytic"


def test_compile_with_search_runs_the_same_kernels(searched):
    jff, pff, _, _ = searched
    assert pff.kernel_choices == jff.executor.kernel_choices \
        == {"attn_0": "flash", "attn_1": "flash"}
    assert pff.executor.fused_update_ops == jff.executor.fused_update_ops
    assert {n.op.name: n.op.kernel_impl for n in pff.executor.nodes
            if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION} \
        == {n.op.name: n.op.kernel_impl for n in jff.executor.nodes
            if n.op.op_type == J.OperatorType.MULTIHEAD_ATTENTION}
    want = junity.executed_kernel_choices(
        jff.executor.nodes, jff.strategy, {"data": 1}, training=True)
    got = unity.executed_kernel_choices(
        pff.executor.nodes, pff.strategy, {"data": 1}, training=True,
        device="cpu")
    assert got == want


def test_compile_with_search_losses_match(searched):
    _, _, losses, _ = searched
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_serving_search_matches_per_bucket():
    """``serve(search_budget=2)``: each bucket's objective, mesh and
    predicted latency, and the strategy its latency search returns, equal
    the JAX package's."""
    jff, pff = _pair("transformer", workers_per_node=1)
    jff.compile(None, J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                comp_mode=J.CompMode.INFERENCE)
    pff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                comp_mode=P.CompMode.INFERENCE)
    jeng, peng = jff.serve(search_budget=2), pff.serve(search_budget=2)
    jrep, prep = jeng.bucket_report(), peng.bucket_report()
    assert sorted(prep) == sorted(jrep) == ["1", "2", "4", "8"]
    for b in prep:
        for key in ("objective", "mesh", "predicted_latency_s",
                    "strategy_differs_from_training"):
            assert prep[b][key] == jrep[b][key], (b, key)
        assert prep[b]["objective"] == f"latency@batch{b}"
        out = []
        for ff, eng in ((jff, jeng), (pff, peng)):
            over = {"input": (int(b), 128, 256)}
            nodes, _, tensor_ref = ff._materialize_nodes(over)
            final = ff._select_final_ref(nodes, tensor_ref)
            st, mesh, _, _, _ = eng._search_bucket(nodes, int(b), 2, 1,
                                                   final)
            mod = junity if ff is jff else unity
            axes = (dict(zip(mesh.axis_names, mesh.devices.shape))
                    if ff is jff else mesh.shape)
            out.append(mod.strategy_json(axes, st, nodes))
        assert _dumps(out[1]) == _dumps(out[0])


# ---- the linear-fusion rewrite -----------------------------------------------

def _fusion_pair():
    """Two linears on one input, summed: the substitution engine fuses
    them into one wide LINEAR and a SPLIT."""
    _aligned()
    out = []
    for pkg, kw in ((J, dict(workers_per_node=1)), (P, {})):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=64, search_budget=3,
                                      enable_parameter_parallel=False, **kw),
                         **({} if pkg is J else dict(device="cpu")))
        t = ff.create_tensor((64, 256))
        a = ff.dense(t, 128, name="qa")
        b = ff.dense(t, 128, name="qb")
        out.append((ff, ff.add(a, b)))
    return out


def test_linear_fusion_rewrite_matches(tmp_path):
    (jff, jout), (pff, pout) = _fusion_pair()
    for ff, out, pkg in ((jff, jout, J), (pff, pout, P)):
        from flexflow_tpu.optimizers import SGDOptimizer as JSGD
        from flexflow_tpu_torch.optimizers import SGDOptimizer as PSGD
        ff.config.export_strategy_file = str(tmp_path / f"{pkg.__name__}.json")
        ff.compile((JSGD if pkg is J else PSGD)(lr=0.1),
                   pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                   outputs=out)
    jtypes = [n.op.op_type.name for n in jff.executor.nodes]
    ptypes = [n.op.op_type.name for n in pff.executor.nodes]
    assert ptypes == jtypes
    assert ptypes.count("LINEAR") == 1 and "SPLIT" in ptypes
    assert [n.op.name for n in pff.executor.nodes] \
        == [n.op.name for n in jff.executor.nodes]
    assert pff.search_info["predicted_time"] \
        == jff.search_info["predicted_time"]
    assert json.loads((tmp_path / "flexflow_tpu_torch.json").read_text()) \
        == json.loads((tmp_path / "flexflow_tpu.json").read_text())
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    x = np.random.RandomState(0).randn(64, 256).astype(np.float32)
    np.testing.assert_allclose(pff.predict(x), np.asarray(jff.predict(x)),
                               atol=ATOL, rtol=RTOL)


# ---- SPLIT and SOFTMAX --------------------------------------------------------

OP_CASES = {
    "split_last": ("SPLIT", (4, 8, 24), dict(sizes=(8, 16), axis=-1)),
    "split_dim1": ("SPLIT", (4, 12, 16), dict(sizes=(4, 4, 4), axis=1)),
    "softmax_last": ("SOFTMAX", (4, 8, 10), dict(axis=-1)),
    "softmax_dim1": ("SOFTMAX", (4, 8, 10), dict(axis=1)),
    "softmax_2d": ("SOFTMAX", (8, 10), dict(axis=-1)),
}


def _op_pair(case):
    op_type, shape, props = OP_CASES[case]
    jl = JLayer(getattr(jconst.OperatorType, op_type), case, [])
    jl.properties.update(props)
    pl = PLayer(getattr(pconst.OperatorType, op_type), case, [])
    pl.properties.update(props)
    x = np.random.RandomState(len(case)).randn(*shape).astype(np.float32)
    return JRegistry.create(jl, [shape]), PRegistry.create(pl, [shape]), x


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_split_softmax_forward_and_vjp_match(case):
    """Forward, then the VJP of the outputs' sum against a random
    cotangent each (jax.vjp against torch autograd), atol/rtol 1e-5."""
    jop, pop, x = _op_pair(case)
    jctx = JContext(training=True, compute_dtype=jnp.float32)
    want, vjp = jax.vjp(lambda v: jop.forward({}, [v], jctx), jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = pop.forward({}, [tx], PContext(training=True,
                                         compute_dtype=torch.float32))
    assert len(got) == len(want)
    rs = np.random.RandomState(1)
    cots = [rs.randn(*w.shape).astype(np.float32) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=ATOL, rtol=RTOL)
    (want_gx,) = vjp([jnp.asarray(c) for c in cots])
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_split_softmax_search_metadata_match(case):
    jop, pop, _ = _op_pair(case)
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert [[r.value for r in roles] for roles in pop.output_dim_roles()] \
        == [[r.value for r in roles] for roles in jop.output_dim_roles()]
    assert unity._node_attrs(pop) == junity._node_attrs(jop)


# ---- the native core's build -------------------------------------------------

def _stat(path):
    return (hashlib.sha256(path.read_bytes()).hexdigest(),
            path.stat().st_mtime_ns)


def test_port_builds_its_own_library_and_leaves_native_alone(tmp_path,
                                                              monkeypatch):
    """The port's search core is built under ``flexflow_tpu_torch/_build/``,
    and a port search leaves ``native/libffsearch.so`` (the JAX package's)
    with its bytes and mtime. The search reads the sources from a copy of
    ``native/`` holding a ``libffsearch.so`` of known bytes, so that the
    JAX package's own build of the real file, which its tests may run in
    another worker at the same time, cannot disturb the check; the copy's
    sources are the same bytes, so the port uses its usual build."""
    copy = tmp_path / "native"
    copy.mkdir()
    for src in native.NATIVE_DIR.iterdir():
        if src.suffix in (".cpp", ".hpp"):
            (copy / src.name).write_bytes(src.read_bytes())
    ref_lib = copy / "libffsearch.so"
    ref_lib.write_bytes(b"the JAX package's library")
    before = _stat(ref_lib)
    names = sorted(f.name for f in copy.iterdir())
    lib = native.library_path()
    monkeypatch.setattr(native, "NATIVE_DIR", copy)
    assert native.library_path() == lib
    pff = _pair("mlp")[1]
    nodes, final = _graph(pff)
    unity.graph_optimize(nodes, MachineSpec(chips_per_slice=4),
                         _search_config(pff, True), 4, batch=8,
                         final_ref=final)
    assert _stat(ref_lib) == before
    assert sorted(f.name for f in copy.iterdir()) == names
    assert lib.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "flexflow_tpu_torch"
    assert lib.exists() and lib.name.startswith("libffsearch-")
    assert native.ffs_version().startswith("ffsearch")


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "ffs_search.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="ffs_search.cpp") as e:
        native.build()
    assert "error" in str(e.value)
    assert not any(p.suffix == ".so" for p in (tmp_path / "_build").iterdir())


def test_a_failed_core_call_raises_with_the_worker_log(tmp_path,
                                                       monkeypatch):
    """The core runs in this process: a library that does not load fails
    the call with the loader's own error, naming the library; the next
    call loads the real build."""
    monkeypatch.setattr(native, "build", lambda: tmp_path / "missing.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="loading the native search core") as e:
        native.native_optimize({})
    assert "missing.so" in str(e.value)
    monkeypatch.undo()
    assert native.ffs_version().startswith("ffsearch")


def test_the_core_hides_its_libstdcxx():
    """The core links its own libstdc++ with every symbol hidden, so none
    of its references can bind to the process's libstdc++ (PyTorch's): a
    core built by a compiler that exported a static libstdc++ died of a
    null locale facet in the training process on an H100 host. Neither
    the core nor anything it depends on exports ``std::locale``."""
    lib = native._load()
    assert lib.ffs_version().decode().startswith("ffsearch")
    for sym in ("_ZNSt6locale7classicEv",
                "_ZNSt7num_putIcSt19ostreambuf_iteratorIcSt11char_traitsIcEEE2idE"):
        assert not hasattr(lib, sym), sym

