"""PyTorch port, the compiled steps (``step_graph.py``) against the JAX
package's jitted ones.

On the CPU a compiled step runs its body eagerly over the same static
buffers and static outputs that a CUDA graph replays on the card, so
these tests see what a replay would alias: the carried trees keep their
storage, outputs are rewritten by the next call, and a loop that keeps an
output past the next call reads the wrong values.

- (a) ``make_multi_step`` on ``tests/test_multi_step.py``'s model (dense
  8 -> 16 ReLU -> 2, SGD lr 0.05, MSE) against the JAX package's, one
  batch reused and 4 stacked batches: rtol 1e-5, atol 1e-6, the JAX
  test's own tolerance.
- (b) a 2-layer transformer (hidden 64, 4 heads, seq 32, batch 4; Adam
  with bf16 moments; attention ``dp_k:flash`` and every other op
  ``dp_k:fused``, a strategy file the JAX package exported): the
  compiled step 3 times and ``make_multi_step(3)`` against the JAX
  ``make_multi_step(3)``, at ``test_torch_port_train.py``'s tolerances
  (loss rtol 1e-4; params atol 2e-5, rtol 1e-4; m and v within 1 bf16 ulp
  of each leaf's scale).
- (c) the compiled step against the eager ``_train_step_fn`` bit for
  bit, every carried leaf keeping its storage; with a bf16 compute copy,
  ``set_parameter`` between steps re-casts into the copy's own tensors.
- (d) ``fit`` over 3 distinct batches in one epoch: the epoch's report
  equals the JAX package's (rtol 1e-5, atol 1e-6).
- (e) ``set_parameter`` between two compiled steps, against the JAX
  sequence (rtol 1e-5, atol 1e-6).
- (f) two different batches in turn through one serving bucket, each
  with its own rows (exactly ``predict``'s).
- (g) on the card (``cuda``-marked): captured against eager bit for bit
  over 3 steps, launches per replay, a replayed bucket forward; and on
  the CPU the K4 leaf-table bookkeeping a capture relies on.
"""

import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
import flexflow_tpu_torch as P
from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.step_graph import flatten, unflatten
from flexflow_tpu_torch.weights import from_jax_params

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
SMALL = dict(num_layers=2, hidden_size=64, num_heads=4, seq_length=32,
             batch_size=4)


# ---- (a), (d), (e): the MLP of tests/test_multi_step.py ------------------

def _jax_mlp():
    ff = J.FFModel(J.FFConfig(batch_size=16, only_data_parallel=True, seed=7,
                              workers_per_node=1))
    t = ff.create_tensor((16, 8))
    h = ff.dense(t, 16, activation=JActiMode.AC_MODE_RELU, name="h")
    ff.dense(h, 2, name="out")
    ff.compile(J.SGDOptimizer(lr=0.05),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [J.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _port_mlp(jff):
    ff = P.FFModel(P.FFConfig(batch_size=16, seed=7), device="cpu")
    t = ff.create_tensor((16, 8))
    h = ff.dense(t, 16, activation=ActiMode.AC_MODE_RELU, name="h")
    ff.dense(h, 2, name="out")
    ff.compile(SGDOptimizer(lr=0.05), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    from_jax_params(jax.tree.map(np.asarray, jff.params), ff)
    return ff


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_multi_step_matches_the_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(16, 8).astype(np.float32)
    y = rs.randn(16, 2).astype(np.float32)
    jff = _jax_mlp()
    pff = _port_mlp(jff)
    jp, _, _, jlosses = jff.executor.make_multi_step(3)(
        jff.params, jff.opt_state, jff.state, jff._stage_inputs([x]),
        jff._shard_batch(y), jax.random.PRNGKey(0))
    multi = pff.executor.make_multi_step(3)
    pp, po, ps, losses = multi(pff.params, pff.opt_state, pff.state,
                               pff._stage_inputs([x]), pff._stage_labels(y))
    assert losses.shape == (3,)
    _close(losses, jlosses)
    _close(pp["out"]["kernel"], jp["out"]["kernel"])
    # the carry came back in the model's own tensors
    assert pp["out"]["kernel"] is pff.params["out"]["kernel"]


def test_stacked_multi_step_matches_the_reference():
    rs = np.random.RandomState(1)
    xs = rs.randn(4, 16, 8).astype(np.float32)  # 4 distinct batches
    ys = rs.randn(4, 16, 2).astype(np.float32)
    jff = _jax_mlp()
    pff = _port_mlp(jff)
    jname = jff.executor.input_names[0]
    jp, _, _, jlosses = jff.executor.make_multi_step(4, stacked=True)(
        jff.params, jff.opt_state, jff.state, {jname: jnp.asarray(xs)},
        jnp.asarray(ys), jax.random.PRNGKey(0))
    name = pff.executor.input_names[0]
    multi = pff.executor.make_multi_step(4, stacked=True)
    pp, _, _, losses = multi(pff.params, pff.opt_state, pff.state,
                             {name: torch.from_numpy(xs)},
                             torch.from_numpy(ys))
    assert len(set(np.asarray(jlosses).tolist())) == 4
    _close(losses, jlosses)
    _close(pp["out"]["kernel"], jp["out"]["kernel"])
    with pytest.raises(ValueError, match="leading axis of 4"):
        multi(pp, pff.opt_state, pff.state, {name: torch.from_numpy(xs[:3])},
              torch.from_numpy(ys[:3]))


def test_fit_report_over_distinct_batches_matches_the_reference():
    """One epoch of 3 batches: the metric sums of batch 0 must survive
    the next two steps, which rewrite the step's outputs."""
    rs = np.random.RandomState(2)
    x = rs.randn(48, 8).astype(np.float32)
    y = rs.randn(48, 2).astype(np.float32)
    jff = _jax_mlp()
    pff = _port_mlp(jff)
    jff.fit(x, y, epochs=1, verbose=False)
    pff.fit(x, y, epochs=1, verbose=False)
    want, got = jff._metrics_acc.report(), pff._metrics_acc.report()
    assert set(got) == set(want) == {"mse_loss"}
    _close(got["mse_loss"], want["mse_loss"])
    _close(pff._last_loss, jff._last_loss)
    _close(pff.get_parameter("out"), np.asarray(jff.params["out"]["kernel"]))


def test_set_parameter_between_compiled_steps_matches_the_reference():
    rs = np.random.RandomState(3)
    x = rs.randn(16, 8).astype(np.float32)
    y = rs.randn(16, 2).astype(np.float32)
    w = rs.randn(16, 2).astype(np.float32) * 0.1
    jff = _jax_mlp()
    pff = _port_mlp(jff)
    for ff in (jff, pff):
        ff.fit(x, y, epochs=1, verbose=False)
        ff.set_parameter("out", w)
        ff.fit(x, y, epochs=1, verbose=False)
    _close(pff._last_loss, jff._last_loss)
    for layer in ("h", "out"):
        _close(pff.get_parameter(layer), np.asarray(jff.params[layer]["kernel"]))
    assert pff.executor.step_graphs["train_step"].captures == 1


# ---- (b): the fused path's transformer ----------------------------------

@pytest.fixture(scope="module")
def fused_pair(tmp_path_factory):
    """A JAX transformer through an exported, edited strategy file
    (attention ``dp_k:flash``, the rest ``dp_k:fused``), its
    ``make_multi_step(3)`` results, the file and a batch. Pallas runs in
    interpret mode while JAX traces."""
    path = str(tmp_path_factory.mktemp("strategy") / "s.json")
    rs = np.random.RandomState(4)
    x = rs.randn(4, 32, 64).astype(np.float32)
    y = rs.randn(4, 32, 1).astype(np.float32)

    def jax_model(**kw):
        ff = j_create_transformer(JTransformerConfig(**SMALL), J.FFConfig(
            batch_size=4, workers_per_node=1, **kw))
        ff.compile(JAdam(alpha=1e-3, state_dtype=jnp.bfloat16),
                   J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [J.MetricsType.MEAN_SQUARED_ERROR])
        return ff

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jax_model(export_strategy_file=path)
        with open(path) as f:
            data = json.load(f)
        for name, op in data["ops"].items():
            op["choice"] = ("dp_k:flash" if name.startswith("attn")
                            else "dp_k:fused")
        with open(path, "w") as f:
            json.dump(data, f)
        jff = jax_model(import_strategy_file=path)
        init = jax.tree.map(np.asarray, jff.params)
        p, o, _, losses = jff.executor.make_multi_step(3)(
            jff.params, jff.opt_state, jff.state, jff._stage_inputs([x]),
            jff._shard_batch(y), jax.random.PRNGKey(0))
        yield dict(path=path, x=x, y=y, init=init,
                   params=jax.tree.map(np.asarray, p),
                   opt_state=jax.tree.map(np.asarray, o),
                   losses=np.asarray(losses),
                   choices=jff.executor.kernel_choices)


def _port_transformer(pair):
    ff = create_transformer(TransformerConfig(**SMALL), P.FFConfig(
        batch_size=4, import_strategy_file=pair["path"]), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    from_jax_params(pair["init"], ff)
    return ff


def _bf16_leaf_ulps(a, b) -> float:
    b = np.asarray(b).astype(np.float64)
    a = np.asarray(a, dtype=np.float64)
    scale = max(float(np.abs(b).max()), 1e-38)
    return float(np.abs(a - b).max() / 2.0 ** (np.floor(np.log2(scale)) - 7))


@pytest.mark.parametrize("form", ["step", "multi_step"])
def test_fused_transformer_matches_the_reference(fused_pair, form):
    pff = _port_transformer(fused_pair)
    assert pff.kernel_choices == fused_pair["choices"]
    ex = pff.executor
    inputs = pff._stage_inputs([fused_pair["x"]])
    labels = pff._stage_labels(fused_pair["y"])
    p, o, s = pff.params, pff.opt_state, pff.state
    if form == "step":
        step = ex.make_train_step()
        losses = []
        for _ in range(3):
            p, o, s, loss, _ = step(p, o, s, inputs, labels)
            losses.append(float(loss))
    else:
        p, o, s, losses = ex.make_multi_step(3)(p, o, s, inputs, labels)
    np.testing.assert_allclose(np.asarray(losses), fused_pair["losses"],
                               rtol=LOSS_RTOL)
    for layer, sub in fused_pair["params"].items():
        for name, want in sub.items():
            np.testing.assert_allclose(p[layer][name].numpy(), want,
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{layer}/{name}")
    assert int(o["t"]) == int(fused_pair["opt_state"]["t"]) == 3
    for key in ("m", "v"):
        for layer, sub in fused_pair["opt_state"][key].items():
            for name, want in sub.items():
                got = o[key][layer][name]
                assert got.dtype == torch.bfloat16
                assert _bf16_leaf_ulps(got.float().numpy(), want) <= 1.0, \
                    f"{key}/{layer}/{name}"


# ---- (c): against the eager step, bit for bit ---------------------------

def _clone(tree):
    leaves, spec = flatten(tree)
    return unflatten(spec, [t.clone() for t in leaves])


def _bits_equal(a, b):
    la, sa = flatten(a)
    lb, sb = flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def _mixed_strategy_model(tmp_path, bf16_copy=False):
    """The SMALL transformer, attention on the plain Adam update and every
    other op ``dp_k:fused`` (updated in place); with ``bf16_copy`` a bf16
    compute copy of the parameters, as the card's master-weight regime
    keeps one."""
    path = str(tmp_path / "s.json")
    ff = create_transformer(TransformerConfig(**SMALL), P.FFConfig(
        batch_size=4, export_strategy_file=path), device="cpu")
    ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    with open(path) as f:
        data = json.load(f)
    for name, op in data["ops"].items():
        op["choice"] = "dp" if name.startswith("attn") else "dp_k:fused"
    with open(path, "w") as f:
        json.dump(data, f)
    ff = create_transformer(TransformerConfig(**SMALL), P.FFConfig(
        batch_size=4, import_strategy_file=path), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    if bf16_copy:
        ex = ff.executor
        ex.compute_dtype, ex.use_master_copy = torch.bfloat16, True
        ff.state[COMPUTE_PARAMS_KEY] = ex.cast_compute_copy(ff.params)
    return ff


@pytest.mark.parametrize("bf16_copy", [False, True])
def test_compiled_step_is_the_eager_step_in_place(tmp_path, bf16_copy):
    ff = _mixed_strategy_model(tmp_path, bf16_copy)
    ex = ff.executor
    assert ex.fused_update_ops and "attn_0" not in ex.fused_update_ops
    rs = np.random.RandomState(5)
    batches = [ff._stage_inputs([rs.randn(4, 32, 64).astype(np.float32)])
               for _ in range(3)]
    labels = ff._stage_labels(rs.randn(4, 32, 1).astype(np.float32))
    eager = ex._train_step_fn()
    ep, eo, es = _clone(ff.params), _clone(ff.opt_state), _clone(ff.state)
    step = ex.make_train_step()
    p, o, s = ff.params, ff.opt_state, ff.state
    leaves, _ = flatten((p, o, s))
    ptrs = [t.data_ptr() for t in leaves]
    for inputs in batches:
        ep, eo, es, eloss, em = eager(ep, eo, es, inputs, labels)
        p, o, s, loss, m = step(p, o, s, inputs, labels)
        assert torch.equal(loss, eloss) and _bits_equal(m, em)
    assert _bits_equal((p, o, s), (ep, eo, es))
    after, _ = flatten((p, o, s))
    assert [t.data_ptr() for t in after] == ptrs
    assert int(o["t"]) == 3
    if bf16_copy:
        # a parameter write reaches the next step through the copy's own
        # tensors: re-cast in place, not rebound
        copy_leaf = s[COMPUTE_PARAMS_KEY]["ffn1_0"]["kernel"]
        w = rs.randn(*copy_leaf.shape).astype(np.float32) * 0.01
        ff.set_parameter("ffn1_0", w)
        ep["ffn1_0"]["kernel"].copy_(torch.from_numpy(w))
        es[COMPUTE_PARAMS_KEY] = ex.cast_compute_copy(ep)
        ff.fit(np.zeros((4, 32, 64), np.float32), np.zeros((4, 32, 1),
               np.float32), epochs=1, verbose=False)
        ep, eo, es, _, _ = eager(
            ep, eo, es, ff._stage_inputs([np.zeros((4, 32, 64), np.float32)]),
            ff._stage_labels(np.zeros((4, 32, 1), np.float32)))
        assert ff.state[COMPUTE_PARAMS_KEY]["ffn1_0"]["kernel"] is copy_leaf
        assert _bits_equal((ff.params, ff.opt_state, ff.state),
                           (ep, eo, es))


def test_a_carry_of_other_tensors_is_copied_into_the_step_buffers(tmp_path):
    """Donation: the step keeps its first call's tensors and takes the
    values of others (the optimizer state imported mid-run)."""
    ff = _mixed_strategy_model(tmp_path)
    x = np.random.RandomState(6).randn(4, 32, 64).astype(np.float32)
    y = np.zeros((4, 32, 1), np.float32)
    ff.fit(x, y, epochs=1, verbose=False)
    first = ff.opt_state["m"]["ffn1_0"]["kernel"]
    ff.opt_state = _clone(ff.opt_state)
    ff.fit(x, y, epochs=1, verbose=False)
    assert ff.opt_state["m"]["ffn1_0"]["kernel"] is first
    assert int(ff.opt_state["t"]) == 2
    bad = _clone(ff.opt_state)
    bad["m"]["ffn1_0"]["kernel"] = bad["m"]["ffn1_0"]["kernel"].float()
    with pytest.raises(ValueError, match="carried tensor"):
        ff.executor.make_train_step()(ff.params, bad, ff.state,
                                      ff._stage_inputs([x]),
                                      ff._stage_labels(y))


def test_eval_and_forward_are_compiled_once_a_shape(tmp_path):
    ff = _mixed_strategy_model(tmp_path)
    reg = get_registry()
    jits = reg.to_dict()["counters"].get("executor.eval_step_jits", 0)
    rs = np.random.RandomState(7)
    x = rs.randn(8, 32, 64).astype(np.float32)
    y = rs.randn(8, 32, 1).astype(np.float32)
    want = ff.executor._eval_step_fn()(
        ff.params, ff.state, ff._stage_inputs([x[:4]]),
        ff._stage_labels(y[:4]))[0]
    rep = ff.evaluate(x, y)
    ff.evaluate(x, y)
    assert ff.executor.step_graphs["eval_step"].captures == 1
    assert reg.to_dict()["counters"]["executor.eval_step_jits"] == jits + 1
    a, b = ff.predict(x[:4]), ff.predict(x[4:])
    assert not np.array_equal(a, b)  # the first result is not a view
    fwd = ff.executor._forward_fn()
    assert np.array_equal(a, fwd(ff.params, ff.state,
                                 ff._stage_inputs([x[:4]])).numpy())
    assert ff.executor.step_graphs["forward"].captures == 1
    assert np.isfinite(rep["loss"]) and float(want) > 0


def test_trees_flatten_and_rebuild():
    t = torch.zeros(2)
    tree = {"a": {"k": t, "b": [t, (t, 3)]}, "t": t, "none": None}
    leaves, spec = flatten(tree)
    assert len(leaves) == 4 and unflatten(spec, leaves) == tree
    assert flatten({"a": {"k": t}})[1] != flatten({"a": {"j": t}})[1]


# ---- (f): the serving bucket --------------------------------------------

def test_two_batches_through_one_bucket_keep_their_rows():
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=4), device="cpu")
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               comp_mode=P.CompMode.INFERENCE)
    engine = ff.serve(batch_buckets=(4,))
    rs = np.random.RandomState(8)
    batches = [rs.randn(4, 32, 64).astype(np.float32) for _ in range(2)]
    reqs = []
    for xb in batches:
        reqs.append([engine.submit([row]) for row in xb])
        engine.pump()
    for xb, rb in zip(batches, reqs):
        got = np.stack([r.wait(10) for r in rb])
        assert np.array_equal(got, ff.predict(xb))
    be = engine.buckets[4]
    assert be.executor.step_graphs["forward"].captures == 1


def test_process_group_ring_refuses_a_capture(monkeypatch):
    from flexflow_tpu_torch.parallel.ring_attention import ProcessGroupRing

    ring = ProcessGroupRing.__new__(ProcessGroupRing)
    ring.size = 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ring.hop(torch.zeros(1), torch.zeros(1))


def test_k4_leaf_tables_reserve_what_a_capture_takes(monkeypatch):
    """The bookkeeping K4's launch relies on under capture (on the card
    the replay faulted when a capture allocated its own table): an eager
    call reserves a spare table of its size outside any capture, a
    capture takes it and fills it only once the capture has ended, then
    hands it to its graph and keeps no reference to it; a capture
    without a spare raises; eager tables are evicted oldest first.
    (Pinning needs CUDA; on the CPU the upload is a copy.)"""
    from flexflow_tpu_torch.ops import fused_update as FU

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    tables, dev = FU._LeafTables(), torch.device("cpu")
    rows = lambda k: [(k, k + 1, k + 2, k + 3, 1024, 0), (k, k, k, k, 5, 1)]
    eager = tables.get(rows(10), dev)
    assert eager.tolist() == [list(r) for r in rows(10)]
    assert tables.get(rows(10), dev) is eager  # one upload a set of leaves
    capturing[0] = True
    spare = tables._spares[(dev, 2)]
    captured = tables.get(rows(20), dev)
    assert captured is spare and (dev, 2) not in tables._spares
    with pytest.raises(RuntimeError, match="reserved"):
        tables.get(rows(30), dev)
    capturing[0] = False
    held = tables.end_capture(False)
    assert len(held) == 1 and held[0] is captured
    assert captured.tolist() == [list(r) for r in rows(20)]
    assert tables.end_capture(False) == []
    gone = weakref.ref(captured)
    del held, captured, spare
    assert gone() is None  # the graph that held it was its only owner
    for k in range(40, 40 + 2 * tables.EAGER_TABLES):
        tables.get(rows(k), dev)
    assert (dev, tuple(rows(10))) not in tables._tables  # evicted
    assert len(tables._tables) == tables.EAGER_TABLES
    capturing[0] = True
    tables.get(rows(50), dev)
    capturing[0] = False
    assert tables.end_capture(True) == [] and tables._taken == []


# Each kernel's name as libcuda gives it (Itanium-mangled; the
# sources put the kernels in an anonymous namespace, which nvcc names
# after the file, as in the two names ptxas reported) for the kernels a
# launch can run: K1 bf16 and f32, K5's forward, the dQ kernels of K2/K3
# (bf16, f32) and K5's backward, the dK/dV and delta kernels that run
# beside them, and K4.
MANGLED = {
    "_ZN12_GLOBAL__N_114flash_fwd_bf16ILi64ELi128ELi2ELi3E13__nv_bfloat16EEv"
    "PKS1_S3_S3_PT3_Pfifi": "flash_fwd.launches",
    "_ZN12_GLOBAL__N_113flash_fwd_f32ILi64EEEvPKfS2_S2_PfS3_ifi":
        "flash_fwd.launches",
    "_ZN12_GLOBAL__N_114flash_fwd_bf16ILi64ELi64ELi2ELi4EfEEvPK13__nv_bfloa"
    "t16S3_S3_PT3_Pfifi": "flash_fwd.lse_launches",
    "_ZN12_GLOBAL__N_117flash_bwd_dq_bf16ILi64ELi64ELi1ELi2ELb0EEEvPK13__nv_"
    "bfloat16S3_S3_S3_S3_PKfS5_PfPS1_ifi": "flash_bwd.launches",
    "_ZN50_GLOBAL__N__55c6de5e_17_flash_attn_bwd_cu_b60e33d716flash_bwd_dq_f"
    "32ILi128EEEvPKfS2_S2_S2_S2_S2_Pfifi": "flash_bwd.launches",
    "_ZN50_GLOBAL__N__55c6de5e_17_flash_attn_bwd_cu_b60e33d717flash_bwd_dq_b"
    "f16ILi128ELi64ELi1ELi2ELb1EEEvPK13__nv_bfloat16S3_S3_S3_S3_PKfS5_PfPS1_"
    "ifi": "flash_bwd.lse_launches",
    "_ZN12_GLOBAL__N_119flash_bwd_dkdv_bf16ILi64ELi64ELi1ELi2EEEvPK13__nv_bf"
    "loat16S3_S3_S3_PKfS5_PS1_S6_ifi": None,
    "_ZN12_GLOBAL__N_119flash_bwd_delta_f32ILi64EEEvPKfS2_S2_PfP13__nv_bfloa"
    "t16i": None,
    "_ZN12_GLOBAL__N_110fused_adamI13__nv_bfloat16S1_EEvPKliPKfffffff":
        "fused_adam_multi.launches",
}
DEMANGLED = {
    "void (anonymous namespace)::flash_fwd_bf16<64, 128, 2, 3, "
    "__nv_bfloat16>(__nv_bfloat16 const*, float*, int, float, int)":
        "flash_fwd.launches",
    "void flash_fwd_f32<64>(float const*, float*, int, float, int)":
        "flash_fwd.launches",
    "void (anonymous namespace)::flash_fwd_bf16<64, 64, 2, 4, float>("
    "__nv_bfloat16 const*, float*, float*, int, float, int)":
        "flash_fwd.lse_launches",
    "void (anonymous namespace)::flash_bwd_dq_bf16<64, 64, 1, 2, false>("
    "__nv_bfloat16 const*, float*, int, float, int)": "flash_bwd.launches",
    "void (anonymous namespace)::flash_bwd_dq_bf16<64, 64, 1, 2, true>("
    "__nv_bfloat16 const*, float*, int, float, int)":
        "flash_bwd.lse_launches",
    "void flash_bwd_dkdv_bf16<64, 64, 1, 2>(__nv_bfloat16 const*, int)": None,
    "void (anonymous namespace)::fused_adam<__nv_bfloat16, float>(long "
    "const*, int)": "fused_adam_multi.launches",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
    "FusedAdamMathFunctor<float, 4>>(int)": None,
    "ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_tn": None,
}


@pytest.mark.parametrize("names", [MANGLED, DEMANGLED],
                         ids=["mangled", "demangled"])
def test_each_launch_counts_the_one_kernel_that_names_it(names):
    """The registry a replay counts by: every kernel wrapper registered
    once, and each kernel name claimed by exactly the counter whose
    launch runs it once (none for the kernels that run beside it, or for
    a library's)."""
    import flexflow_tpu_torch.ops.flash_attention  # noqa: F401
    import flexflow_tpu_torch.ops.fused_update  # noqa: F401
    from flexflow_tpu_torch.step_graph import launch_counters

    counters = {f"{fn.__name__}.{attr}": test
                for fn, attr, test in launch_counters()}
    assert len(counters) == len(launch_counters()) == 5
    for name, owner in names.items():
        claimed = [c for c, test in counters.items() if test(name)]
        assert claimed == ([owner] if owner else []), name


def test_a_deleted_model_frees_its_executor_without_the_collector(tmp_path):
    """The executor holds its compiled steps and they hold it only
    weakly: with the collector off, deleting the model frees the
    executor, its graphs and their buffers at once."""
    ff = _mixed_strategy_model(tmp_path)
    rs = np.random.RandomState(11)
    x = rs.randn(4, 32, 64).astype(np.float32)
    y = rs.randn(4, 32, 1).astype(np.float32)
    ff.fit(x, y, epochs=1, verbose=False)
    ff.evaluate(x, y)
    ff.predict(x)
    graphs = ff.executor.step_graphs
    assert set(graphs) == {"train_step", "eval_step", "forward"}
    gone = [weakref.ref(ff.executor)] + [weakref.ref(g)
                                         for g in graphs.values()]
    del graphs
    gc.collect()
    gc.disable()
    try:
        del ff
        assert [r() for r in gone] == [None] * len(gone)
    finally:
        gc.enable()


@pytest.mark.parametrize("bf16_copy", [False, True])
def test_compiled_step_takes_host_arrays_as_the_staged_batch(tmp_path,
                                                              bf16_copy):
    """Host arrays go into the static feeds as they are and are cast
    inside the step: bit for bit the eager step on the staged batch."""
    ff = _mixed_strategy_model(tmp_path, bf16_copy)
    ex = ff.executor
    rs = np.random.RandomState(12)
    xs = [rs.randn(4, 32, 64).astype(np.float32) for _ in range(2)]
    y = rs.randn(4, 32, 1).astype(np.float32)
    eager = ex._train_step_fn()
    ep, eo, es = _clone(ff.params), _clone(ff.opt_state), _clone(ff.state)
    step = ex.make_train_step()
    p, o, s = ff.params, ff.opt_state, ff.state
    name = ex.input_names[0]
    for x in xs:
        ep, eo, es, eloss, _ = eager(ep, eo, es, ff._stage_inputs([x]),
                                     ff._stage_labels(y))
        p, o, s, loss, _ = step(p, o, s, {name: x}, y)
        assert torch.equal(loss, eloss)
    assert _bits_equal((p, o, s), (ep, eo, es))
    graph = ex.step_graphs["train_step"]
    assert graph.captures == 1
    step(p, o, s, ff._stage_inputs([xs[0]]), ff._stage_labels(y))
    # the batch staged in bf16 is another signature; in f32 on the CPU
    # it is the same
    assert graph.captures == (2 if bf16_copy else 1)


def test_a_forward_over_other_tensors_drops_the_graph_of_the_old(tmp_path):
    """A non-donated step (the forward) reads its carry in place: called
    with other tensors it captures anew and lets the old ones go."""
    ff = _mixed_strategy_model(tmp_path)
    x = np.random.RandomState(13).randn(4, 32, 64).astype(np.float32)
    fwd = ff.executor.make_forward()
    graph = ff.executor.step_graphs["forward"]
    want = fwd(ff.params, ff.state, {ff.executor.input_names[0]: x}).clone()
    other = _clone(ff.params)
    old = weakref.ref(flatten(other)[0][0])
    got = fwd(other, ff.state, {ff.executor.input_names[0]: x})
    assert torch.equal(got, want) and graph.captures == 2
    del other
    fwd(ff.params, ff.state, {ff.executor.input_names[0]: x})
    assert graph.captures == 3 and len(graph._entries) == 1
    assert old() is None


# ---- (g): on the card ----------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the sm_90a kernels "
                    "have no CPU mode (run with pytest -m cuda on the card)")


@pytest.mark.cuda
def test_captured_step_is_bit_equal_to_eager_on_card(cuda_card, tmp_path):
    from flexflow_tpu_torch.step_graph import read_launch_counts

    cfg = TransformerConfig(num_layers=2, hidden_size=128, num_heads=2,
                            seq_length=128, batch_size=4)
    path = str(tmp_path / "s.json")
    ops = {}
    probe = create_transformer(cfg, P.FFConfig(batch_size=4), device="cuda")
    for layer in probe.layers:
        if layer.op_type != P.OperatorType.INPUT:
            ops[layer.name] = dict(
                choice="dp_k:flash" if layer.name.startswith("attn")
                else "dp_k:fused", outputs=[None], params={})
    with open(path, "w") as f:
        json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f)
    ff = create_transformer(cfg, P.FFConfig(batch_size=4,
                                            import_strategy_file=path),
                            device="cuda")
    ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    ex = ff.executor
    rs = np.random.RandomState(9)
    inputs = ff._stage_inputs([rs.randn(4, 128, 128).astype(np.float32)])
    labels = ff._stage_labels(rs.randn(4, 128, 1).astype(np.float32))
    eager = ex._train_step_fn()
    ep, eo, es = _clone(ff.params), _clone(ff.opt_state), _clone(ff.state)
    step = ex.make_train_step()
    p, o, s = ff.params, ff.opt_state, ff.state
    want = {"flash_fwd.launches": 2, "flash_fwd.lse_launches": 0,
            "flash_bwd.launches": 2, "flash_bwd.lse_launches": 0,
            "fused_adam_multi.launches": 1}
    for i in range(3):
        ep, eo, es, eloss, _ = eager(ep, eo, es, inputs, labels)
        before = read_launch_counts()
        p, o, s, loss, _ = step(p, o, s, inputs, labels)
        got = {k: v - before[k] for k, v in read_launch_counts().items()}
        # K1, K2 a layer, K4 once: launched by the first call, the
        # captured graph's nodes by the replays
        assert got == want, got
        assert torch.equal(loss, eloss)
    torch.cuda.synchronize()
    assert _bits_equal((p, o, s), (ep, eo, es))
    graph = ex.step_graphs["train_step"]
    assert graph.captures == 1 and graph.replays == 2
    assert graph.launches_a_replay() == want

    engine = ff.serve(batch_buckets=(4,))
    be = engine.buckets[4]
    fwd_graph = be.executor.step_graphs["forward"]
    assert fwd_graph.captures == 1
    x = rs.randn(4, 128, 128).astype(np.float32)
    reqs = [engine.submit([row]) for row in x]
    engine.pump()
    assert fwd_graph.replays == 1
    got = np.stack([r.wait(30) for r in reqs])
    assert np.array_equal(got, ff.predict(x))
