"""PyTorch port, the layout pass, the Conv+BN folds and the
``_k:conv_bn_fused`` region against the JAX package.

The graphs are ``tests/test_layout.py``'s: the conv chain (conv -> BN
with ReLU -> average pool -> conv with ReLU -> GroupNorm -> flat ->
dense, every channels-last op and a pass-through) and the branchy graph
(a stem conv feeding two conv branches and a pool that concat on the
channel axis), built in both packages with aligned layer counters (so
that unnamed layers, and the layout pass's boundaries, carry the same
names), the JAX model's parameters (and op state) carried into the port,
one device, f32 compute. On one seeded batch (numpy):

- the layout pass: ``layout_info`` equals the JAX package's under
  ``"nhwc"``; channels-last against NCHW, forward and one SGD epoch
  (every parameter and BN running statistic); ``"auto"`` is NCHW on the
  CPU; every parameter, gradient and moment leaf stays contiguous;
- the eval fold: folded against unfolded eval and ``predict``; the
  port's against the JAX package's, both folded; a conv with its own
  activation is not folded; ``transforms.fold_conv_batchnorm`` on both
  packages from one state: the same recompiled graph and predictions;
- ``_k:conv_bn_fused``: the fused region bit-equal to its unfused pair
  (losses, parameters, BN state), chosen through a strategy file, an
  ineligible choice left unfused and recorded, and its training against
  the JAX package's fused run.

Tolerances are ``tests/test_layout.py``'s: predictions rtol 1e-4 and
atol 1e-5, leaves after an SGD epoch 1e-5, eval losses 1e-4 apart; the
port against the JAX package: losses rtol 1e-4, leaves 1e-5 (f32 on
both sides, sums in different orders).
"""

import json

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.tensor import Tensor as JTensor
from flexflow_tpu.transforms import fold_conv_batchnorm as j_fold
import flexflow_tpu_torch as P
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.layout import FoldedConvBN, TrainFusedConvBN
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.transforms import fold_conv_batchnorm
from flexflow_tpu_torch.weights import from_jax_params, from_jax_state

B = 4
RS = np.random.RandomState(0)
X = RS.randn(8, 3, 16, 16).astype(np.float32)
Y = RS.randint(0, 10, (8, 1)).astype(np.int32)
XB = RS.randn(B, 4, 12, 12).astype(np.float32)
PRED = dict(rtol=1e-4, atol=1e-5)
LEAF_TOL = 1e-5
LOSS_RTOL = 1e-4
SCE = "SPARSE_CATEGORICAL_CROSSENTROPY"


def _model(pkg, batch=B, **cfg):
    if pkg is J:
        return J.FFModel(J.FFConfig(batch_size=batch, workers_per_node=1,
                                    only_data_parallel=True, **cfg))
    return P.FFModel(P.FFConfig(batch_size=batch, only_data_parallel=True,
                                **cfg), device="cpu")


def _sgd(pkg):
    return (J.SGDOptimizer if pkg is J else SGDOptimizer)(lr=0.05)


def chain(pkg, layout="nchw", fold=True, comp_mode="TRAINING", opt=None):
    ff = _model(pkg, conv_compute_layout=layout, fold_conv_bn=fold)
    acti, pool = pkg.ActiMode, pkg.PoolType
    t = ff.create_tensor((B, 3, 16, 16))
    x = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1)
    x = ff.batch_norm(x, relu=True)
    x = ff.pool2d(x, 2, 2, 2, 2, 0, 0, pool_type=pool.POOL_AVG)
    x = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation=acti.AC_MODE_RELU)
    x = ff.group_norm(x, 4)
    x = ff.flat(x)
    out = ff.dense(x, 10)
    ff.compile(opt or _sgd(pkg), pkg.LossType[SCE], [], outputs=out,
               comp_mode=pkg.CompMode[comp_mode])
    return ff


def branchy(pkg, layout="nchw"):
    ff = _model(pkg, conv_compute_layout=layout)
    relu = pkg.ActiMode.AC_MODE_RELU
    t = ff.create_tensor((B, 4, 12, 12))
    s = ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1, activation=relu)
    b1 = ff.conv2d(s, 8, 1, 1, 1, 1, 0, 0, activation=relu)
    b2 = ff.conv2d(s, 8, 3, 3, 1, 1, 1, 1, activation=relu)
    b3 = ff.pool2d(s, 3, 3, 1, 1, 1, 1, pool_type=pkg.PoolType.POOL_AVG)
    x = ff.concat([b1, b2, b3], axis=1)
    x = ff.flat(x)
    out = ff.dense(x, 5)
    ff.compile(_sgd(pkg), pkg.LossType[SCE], [], outputs=out)
    return ff


def conv_bn_pair(pkg, conv_act=False, strategy=None, fused=False):
    """``tests/test_kernel_search.py``'s fused-region model: a conv
    without bias -> BN with ReLU -> flat -> dense."""
    ff = _model(pkg, batch=8, seed=42)
    if strategy:
        ff.config.import_strategy_file = strategy
    x = ff.create_tensor((8, 3, 16, 16), name="x")
    t = ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="c1", use_bias=False,
                  activation=(pkg.ActiMode.AC_MODE_RELU if conv_act
                              else pkg.ActiMode.AC_MODE_NONE))
    t = ff.batch_norm(t, relu=True, name="bn")
    t = ff.flat(t)
    ff.dense(t, 10, name="fc")
    ff.compile((J.SGDOptimizer if pkg is J else SGDOptimizer)(lr=0.01),
               pkg.LossType[SCE], [])
    if fused:
        ff.executor.kernel_choices = {"c1": "conv_bn_fused"}
    return ff


def _aligned():
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start
        starts.append(start)
    return starts


def jax_and_port(build, *args, **kw):
    """The JAX model and its port twin (layers numbered alike), the port
    carrying the JAX model's parameters and op state."""
    starts = _aligned()
    jff = build(J, *args, **kw)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    pff = build(P, *args, **kw)
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    from_jax_state(_jax_state(jff), pff)
    return jff, pff


def port_twins(build, kw_b=None, **kw):
    """Two port models of one graph from one start of the counters, the
    second built with ``kw_b`` over ``kw`` and carrying the first's
    parameters."""
    starts = _aligned()
    a = build(P, **kw)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    b = build(P, **dict(kw, **(kw_b or {})))
    for op, sub in a.params.items():
        for pn in sub:
            b.set_parameter(op, a.get_parameter(op, pn), pn)
    return a, b


def _jax_state(jff):
    return {k: {n: np.asarray(v) for n, v in sub.items()}
            for k, sub in jff.state.items() if not k.startswith("__")}


def _port_state(pff):
    return {k: {n: v.numpy() for n, v in sub.items()}
            for k, sub in pff.state.items() if not k.startswith("__")}


def _max_gap(a, b):
    return max(float(np.abs(np.asarray(a[op][pn]) - np.asarray(b[op][pn]))
                     .max()) for op in a for pn in a[op])


def _port_params(pff):
    return {op: {pn: t.numpy() for pn, t in sub.items()}
            for op, sub in pff.params.items()}


# ---- the layout pass ------------------------------------------------------

@pytest.mark.parametrize("build", [chain, branchy])
def test_layout_info_matches_jax(build):
    """Under "nhwc" the port's pass reports the JAX package's numbers and
    boundaries: one conversion into channels-last at the input and one
    out of it at the flat, for the chain and for the branches alike."""
    jff, pff = jax_and_port(build, "nhwc")
    assert pff.layout_info == jff.layout_info
    assert pff.layout_info["enabled"] is True
    assert pff.layout_info["nhwc_ops"] == 5
    assert pff.layout_info["transposes"] == 2
    kinds = {n.op.op_type.name: n.output_layouts[0]
             for n in pff.executor.nodes}
    assert kinds["FLAT"] == kinds["LINEAR"] == "NCHW"
    assert all(kinds[k] == "NHWC" for k in ("CONV2D", "POOL2D")
               if k in kinds)


def test_auto_is_nchw_on_the_cpu():
    ff = chain(P, "auto")
    assert ff.layout_info == dict(enabled=False, nhwc_ops=0, transposes=0,
                                  boundaries=[])
    with pytest.raises(ValueError, match="auto|nhwc|nchw"):
        chain(P, "nwhc")


def test_nhwc_against_nchw_forward_and_sgd_epoch():
    """Channels-last and NCHW execution from one set of parameters: the
    forward, then every parameter and BN running statistic after an SGD
    epoch (two steps)."""
    a, b = port_twins(chain, layout="nchw", kw_b=dict(layout="nhwc"))
    assert b.layout_info["enabled"] and not a.layout_info["enabled"]
    np.testing.assert_allclose(a.predict(X[:B]), b.predict(X[:B]), **PRED)
    for ff in (a, b):
        ff.fit(X, Y, batch_size=B, epochs=1, verbose=False)
    assert _max_gap(_port_params(a), _port_params(b)) < LEAF_TOL
    assert _max_gap(_port_state(a), _port_state(b)) < LEAF_TOL
    xa, xb = port_twins(branchy, layout="nchw", kw_b=dict(layout="nhwc"))
    np.testing.assert_allclose(xa.predict(XB), xb.predict(XB), **PRED)


def test_leaves_stay_contiguous_under_channels_last(monkeypatch):
    """cuDNN hands back a conv weight's gradient in channels-last memory;
    the executor makes every gradient contiguous, so that every
    parameter, compute-copy and Adam moment leaf stays contiguous, and
    the step is the one with contiguous gradients, bit for bit. The CPU's
    convolution returns contiguous weight gradients, so this one hands
    the executor channels-last ones the way cuDNN does."""
    real_grad = torch.autograd.grad

    def channels_last_grad(outputs, inputs, **kw):
        got = real_grad(outputs, inputs, **kw)
        return tuple(g.contiguous(memory_format=torch.channels_last)
                     if g is not None and g.dim() == 4 else g for g in got)

    plain, patched = port_twins(chain, layout="nhwc",
                                opt=AdamOptimizer(alpha=1e-2))
    plain.fit(X[:B], Y[:B], epochs=1, verbose=False)
    monkeypatch.setattr(torch.autograd, "grad", channels_last_grad)
    grads = patched.executor.grads_of(patched.params, patched.state,
                                      patched._stage_inputs([X[:B]]),
                                      patched._stage_labels(Y[:B]))[2]
    patched.fit(X[:B], Y[:B], epochs=1, verbose=False)
    leaves = ([t for sub in patched.params.values() for t in sub.values()]
              + [t for key in ("m", "v")
                 for sub in patched.opt_state[key].values()
                 for t in sub.values()]
              + [t for sub in grads.values() for t in sub.values()])
    assert all(t.is_contiguous() for t in leaves)
    for op, sub in plain.params.items():
        for pn, t in sub.items():
            assert torch.equal(t, patched.params[op][pn]), f"{op}/{pn}"


# ---- the eval fold --------------------------------------------------------

def test_fold_applied_to_inference_nodes_only():
    ff = chain(P)
    full = ff.executor.nodes
    folded = ff.executor._inference_nodes()
    assert len(folded) == len(full) - 1
    assert [type(n.op) for n in folded].count(FoldedConvBN) == 1
    assert ff.executor._training_nodes() is full
    unfolded = chain(P, fold=False).executor
    assert unfolded._inference_nodes() is unfolded.nodes


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_fold_against_no_fold(layout):
    """After an SGD epoch (running statistics away from 0 and 1), the
    folded eval and ``predict`` against the unfolded ones."""
    a, b = port_twins(chain, layout=layout, kw_b=dict(fold=False))
    assert len(b.executor._inference_nodes()) == len(b.executor.nodes)
    for ff in (a, b):
        ff.fit(X, Y, batch_size=B, epochs=1, verbose=False)
    np.testing.assert_allclose(a.predict(X[:B]), b.predict(X[:B]), **PRED)
    ea = a.evaluate(X, Y, batch_size=B)
    eb = b.evaluate(X, Y, batch_size=B)
    assert abs(ea["loss"] - eb["loss"]) < 1e-4


def test_folded_eval_and_predict_match_jax():
    """Both packages folded, after one SGD epoch from one state: the
    losses, the trained parameters and running statistics, ``predict``
    and ``evaluate``."""
    jff, pff = jax_and_port(chain, "nchw")
    for ff in (jff, pff):
        ff.fit(X, Y, batch_size=B, epochs=1, verbose=False)
    np.testing.assert_allclose(pff._last_loss, float(jff._last_loss),
                               rtol=LOSS_RTOL)
    assert _max_gap(jax.tree.map(np.asarray, jff.params),
                    _port_params(pff)) < LEAF_TOL
    assert _max_gap(_jax_state(jff), _port_state(pff)) < LEAF_TOL
    np.testing.assert_allclose(pff.predict(X[:B]),
                               np.asarray(jff.predict(X[:B])), **PRED)
    np.testing.assert_allclose(pff.evaluate(X, Y, batch_size=B)["loss"],
                               jff.evaluate(X, Y, batch_size=B)["loss"],
                               rtol=LOSS_RTOL)


def test_conv_with_activation_not_folded():
    ff = conv_bn_pair(P, conv_act=True)
    assert len(ff.executor._inference_nodes()) == len(ff.executor.nodes)


def test_offline_fold_matches_jax():
    """``transforms.fold_conv_batchnorm`` on an INFERENCE model of each
    package, from one set of parameters and running statistics: one fold,
    the same recompiled graph (names, types, shapes), the same folded
    weights, and predictions that equal the unfolded model's."""
    jff, pff = jax_and_port(chain, "nchw", comp_mode="INFERENCE")
    rs = np.random.RandomState(4)
    bn = next(k for k in _jax_state(jff))
    st = {bn: {"mean": rs.randn(8).astype(np.float32),
               "var": rs.uniform(0.5, 2, 8).astype(np.float32)}}
    for k, v in st[bn].items():
        jff.state[bn][k] = jax.numpy.asarray(v)
    from_jax_state(st, pff)
    before = np.asarray(jff.predict(X[:B]))
    np.testing.assert_allclose(pff.predict(X[:B]), before, **PRED)
    assert j_fold(jff) == fold_conv_batchnorm(pff) == 1
    assert [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in pff.executor.nodes] \
        == [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in jff.executor.nodes]
    assert _max_gap(jax.tree.map(np.asarray, jff.params),
                    _port_params(pff)) < LEAF_TOL
    after = pff.predict(X[:B])
    np.testing.assert_allclose(after, np.asarray(jff.predict(X[:B])), **PRED)
    np.testing.assert_allclose(after, before, **PRED)
    with pytest.raises(ValueError, match="INFERENCE"):
        fold_conv_batchnorm(chain(P))


# ---- the train-time fused region -----------------------------------------

def _train_pair(ff, steps=3):
    rs = np.random.RandomState(0)
    x = rs.randn(8, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, (8, 1)).astype(np.int32)
    losses = []
    for _ in range(steps):
        ff.fit([x], y, epochs=1, verbose=False)
        losses.append(float(ff._last_loss))
    return losses


def test_conv_bn_fused_is_bit_equal_to_the_pair():
    """``tests/test_kernel_search.py:324`` on the port: 3 SGD steps with
    and without the fused region, losses, parameters and BN running
    statistics bit for bit."""
    plain, fused = conv_bn_pair(P), conv_bn_pair(P, fused=True)
    nodes = fused.executor._training_nodes()
    assert [type(n.op) for n in nodes].count(TrainFusedConvBN) == 1
    assert _train_pair(plain) == _train_pair(fused)
    for tree in ("params", "state"):
        a, b = getattr(plain, tree), getattr(fused, tree)
        assert sorted(a) == sorted(b)
        for op in a:
            for pn in a[op]:
                assert torch.equal(a[op][pn], b[op][pn]), f"{op}/{pn}"


def _strategy_file(tmp_path, choices):
    path = tmp_path / "strategy.json"
    path.write_text(json.dumps(dict(version=1, mesh={"data": 1}, ops={
        name: dict(choice=choice, outputs=[None], params={})
        for name, choice in choices.items()})))
    return str(path)


@pytest.mark.parametrize("conv_act", [False, True])
def test_conv_bn_fused_through_a_strategy_file(tmp_path, conv_act):
    """A ``dp_k:conv_bn_fused`` choice from a strategy file is recorded in
    ``kernel_choices`` and, on an eligible pair, runs as one node; on a
    conv with its own activation it stays unfused, as in the reference,
    and ``unfused_conv_bn`` names it."""
    path = _strategy_file(tmp_path, {"c1": "dp_k:conv_bn_fused",
                                     "bn": "dp", "fc": "dp"})
    ff = conv_bn_pair(P, conv_act=conv_act, strategy=path)
    assert ff.kernel_choices == {"c1": "conv_bn_fused"}
    fused = [type(n.op) for n in ff.executor._training_nodes()].count(
        TrainFusedConvBN)
    assert fused == (0 if conv_act else 1)
    assert ff.executor.unfused_conv_bn == (["c1"] if conv_act else [])
    assert np.isfinite(_train_pair(ff, steps=1)).all()


def test_conv_bn_fused_matches_jax():
    """Both packages' fused regions over 3 SGD steps from one state:
    losses, parameters and BN running statistics."""
    jff, pff = jax_and_port(conv_bn_pair, fused=True)
    assert any("+" in n.op.name for n in jff.executor._training_nodes())
    np.testing.assert_allclose(_train_pair(pff), _train_pair(jff),
                               rtol=LOSS_RTOL)
    assert _max_gap(jax.tree.map(np.asarray, jff.params),
                    _port_params(pff)) < LEAF_TOL
    assert _max_gap(_jax_state(jff), _port_state(pff)) < LEAF_TOL


@pytest.mark.parametrize("build", ["chain", "pair", "pair_act"])
def test_search_request_matches_jax(build):
    """The search request of a graph with BatchNorm, GroupNorm and a
    fusable (or, with the conv's own activation, unfusable) pair: the
    JAX package's, the ``bn_fusable`` attrs included, byte for byte."""
    from flexflow_tpu.search import unity as junity
    from flexflow_tpu_torch.search import unity
    fn, kw = {"chain": (chain, {}), "pair": (conv_bn_pair, {}),
              "pair_act": (conv_bn_pair, dict(conv_act=True))}[build]
    jff, pff = jax_and_port(fn, **kw)
    want = junity.serialize_graph(jff.executor.nodes,
                                  final_guid=jff.executor.final_ref[0])
    got = unity.serialize_graph(pff.executor.nodes,
                                final_guid=pff.executor.final_ref[0])
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert sum("bn_fusable" in n["attrs"] for n in got) \
        == (0 if build == "pair_act" else 1)


# ---- flags and state carrying --------------------------------------------

def test_layout_and_fold_flags_parse_as_the_reference():
    argv = ["--conv-layout", "NHWC", "--disable-conv-bn-fold", "--rest"]
    jc, pc = J.FFConfig(), P.FFConfig()
    assert jc.parse_args(argv) == pc.parse_args(argv) == ["--rest"]
    assert (pc.conv_compute_layout, pc.fold_conv_bn) \
        == (jc.conv_compute_layout, jc.fold_conv_bn) == ("nhwc", False)
    with pytest.raises(ValueError, match="auto|nhwc|nchw"):
        P.FFConfig().parse_args(["--conv-layout", "nwhc"])


def test_from_jax_state_checks_the_trees():
    jff, pff = jax_and_port(chain, "nchw")
    state = _jax_state(jff)
    bn = next(iter(state))
    with pytest.raises(ValueError, match="trees differ"):
        from_jax_state({**state, "extra": state[bn]}, pff)
    with pytest.raises(ValueError, match="shape"):
        from_jax_state({bn: {"mean": np.zeros(3, np.float32),
                             "var": state[bn]["var"]}}, pff)
    with pytest.raises(ValueError, match="dtype"):
        from_jax_state({bn: {k: v.astype(np.float64)
                             for k, v in state[bn].items()}}, pff)


@pytest.mark.cuda
def test_channels_last_step_on_the_card():
    """On the card "auto" computes channels-last: one Adam step of the
    conv chain, every leaf contiguous, and the replayed step finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the channels-last conv chain's "
                    "step under cuDNN")
    ff = P.FFModel(P.FFConfig(batch_size=B), device="cuda")
    t = ff.create_tensor((B, 3, 16, 16))
    x = ff.batch_norm(ff.conv2d(t, 8, 3, 3, 1, 1, 1, 1))
    ff.dense(ff.flat(x), 10)
    ff.compile(AdamOptimizer(alpha=1e-3), P.LossType[SCE], [])
    assert ff.layout_info["enabled"]
    ff.fit(X[:B], Y[:B], epochs=2, verbose=False)
    assert np.isfinite(ff.epoch_losses).all()
    assert all(t.is_contiguous() for sub in ff.params.values()
               for t in sub.values())
    assert all(t.is_contiguous() for key in ("m", "v")
               for sub in ff.opt_state[key].values() for t in sub.values())
