"""PyTorch port: deploy from a checkpoint, and recompile on a condition.

- ``serve.load_for_serving`` on a v2 checkpoint the port's training run
  wrote: an INFERENCE compile reusing the recorded strategy (its kernel
  choices too), the parameters and BatchNorm statistics restored without
  the optimizer state, the eval fold on; its ``predict`` equals, bit for
  bit, the ``predict`` of a training model after ``load_checkpoint``, and
  ``serve()`` answers a full batch with those rows. The JAX package's
  ``load_for_serving`` on the same checkpoint predicts the same within
  ``RTOL`` of the largest output (f32 on both sides; sums in different
  orders). Models: a 2-layer BERT-proxy with ``dp_k:flash`` /
  ``dp_k:fused`` choices, and a small Conv+BN model (the eval fold).
- ``recompile_on_condition``: a widened dense layer gets fresh
  parameters; every other leaf keeps its trained value bit for bit, the
  iteration count survives, and training goes on.
"""

import json

import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.serve import load_for_serving as j_load_for_serving
import flexflow_tpu_torch as P
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.recompile import RecompileState
from flexflow_tpu_torch.serve import load_for_serving

RTOL = 1e-4
SMALL = dict(num_layers=2, hidden_size=64, num_heads=2, seq_length=32,
             batch_size=4)
MSE = "MEAN_SQUARED_ERROR_AVG_REDUCE"
SCE = "SPARSE_CATEGORICAL_CROSSENTROPY"


def _strategy(ff, path):
    ops = {layer.name: dict(
        choice="dp_k:flash" if layer.op_type == P.OperatorType.
        MULTIHEAD_ATTENTION else "dp_k:fused", outputs=[None], params={})
        for layer in ff.layers if layer.op_type != P.OperatorType.INPUT}
    with open(path, "w") as f:
        json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f)


def bert(pkg, tmp_path=None):
    if pkg is J:
        return j_create_transformer(JTransformerConfig(**SMALL), J.FFConfig(
            batch_size=4, workers_per_node=1))
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=4), device="cpu")
    if tmp_path is not None:
        path = str(tmp_path / "strategy.json")
        _strategy(ff, path)
        ff.config.import_strategy_file = path
    return ff


def conv_bn(pkg, tmp_path=None):
    if pkg is J:
        ff = J.FFModel(J.FFConfig(batch_size=4, workers_per_node=1))
    else:
        ff = P.FFModel(P.FFConfig(batch_size=4), device="cpu")
    t = ff.create_tensor((4, 3, 8, 8), name="x")
    t = ff.conv2d(t, 6, 3, 3, 1, 1, 1, 1, name="c1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
    t = ff.dense(ff.flat(t, name="flat"), 5, name="fc")
    ff.softmax(t, name="sm")
    return ff


MODELS = {"bert": (bert, MSE), "conv_bn": (conv_bn, SCE)}


def _data(name):
    rs = np.random.RandomState(5)
    if name == "bert":
        return (rs.randn(8, 32, 64).astype(np.float32),
                rs.randn(8, 32, 1).astype(np.float32))
    return (rs.randn(8, 3, 8, 8).astype(np.float32),
            rs.randint(0, 5, (8, 1)).astype(np.int32))


@pytest.fixture(scope="module", params=sorted(MODELS))
def deployed(request, tmp_path_factory):
    """(name, training model reloaded, served model, checkpoint dir, x)."""
    name = request.param
    build, loss = MODELS[name]
    tmp = tmp_path_factory.mktemp(name)
    x, y = _data(name)
    ff = build(P, tmp)
    ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
               P.LossType[loss], [])
    ff.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(tmp / "ck"),
           checkpoint_every=2)
    trained = build(P, tmp)
    trained.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
                    P.LossType[loss], [])
    assert trained.load_checkpoint(str(tmp / "ck")) == 4
    served = load_for_serving(str(tmp / "ck"), build(P), search_budget=0,
                              loss_type=P.LossType[loss])
    return name, trained, served, str(tmp / "ck"), x[:4]


def test_loader_reuses_the_saved_strategy(deployed):
    name, trained, served, _, _ = deployed
    info = served.serve_load_info
    assert info["mode"] == "reused-saved-strategy"
    assert info["plan"]["action"] == "reuse" and not info["cross_mesh"]
    assert (info["step"], info["iteration"]) == (4, 4)
    assert served.opt_state is None
    assert served.config.computation_mode == P.CompMode.INFERENCE
    if name == "bert":
        assert all(info["kernel_choices"][op] == "flash"
                   for op in info["kernel_choices"] if op.startswith("attn"))
    else:
        # the Conv+BN pair folds in the served forward
        assert len(served.executor._inference_nodes()) < \
            len(served.executor.nodes)
        assert torch.equal(served.state["bn1"]["mean"],
                           trained.state["bn1"]["mean"])


def test_served_predict_equals_the_training_model(deployed):
    _, trained, served, _, x = deployed
    np.testing.assert_array_equal(served.predict(x), trained.predict(x))


def test_serve_answers_with_the_predict_rows(deployed):
    _, _, served, _, x = deployed
    want = served.predict(x)
    engine = served.serve()
    reqs = [engine.submit([x[i]]) for i in range(len(x))]
    assert engine.pump() == len(x)
    rows = np.stack([r.wait(10) for r in reqs])
    np.testing.assert_array_equal(rows, want)


def test_the_reference_loader_predicts_the_same(deployed):
    name, _, served, ckpt, x = deployed
    build, loss = MODELS[name]
    jff = j_load_for_serving(ckpt, build(J), search_budget=0,
                             loss_type=J.LossType[loss])
    assert jff.serve_load_info["step"] == 4
    want = np.asarray(jff.predict(x))
    got = served.predict(x)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def test_default_budget_plans_a_latency_search(tmp_path, monkeypatch):
    """With no budget given and the native core available, the loader
    asks the compile for a latency-objective search (the compile itself
    is stubbed here: the search is the search tests' subject)."""
    from flexflow_tpu_torch.search import native
    x, y = _data("conv_bn")
    ff = conv_bn(P)
    ff.compile(AdamOptimizer(alpha=1e-3), P.LossType[SCE], [])
    ff.fit(x, y, epochs=1, verbose=False, checkpoint_dir=str(tmp_path))
    monkeypatch.setattr(native, "available", lambda: True)
    seen = {}
    served = conv_bn(P)
    real = served.compile

    def compile_spy(*a, **k):
        seen["budget"] = served.config.search_budget
        served.config.search_budget = 0
        return real(*a, **k)

    served.compile = compile_spy
    load_for_serving(str(tmp_path), served, loss_type=P.LossType[SCE])
    assert seen["budget"] == 8
    assert served.serve_load_info["mode"] == "latency-research"
    assert served.config.search_budget == 0  # the knob restored


def test_loader_refuses_a_missing_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="no complete checkpoint"):
        load_for_serving(str(tmp_path), conv_bn(P), search_budget=0)


# ---- recompile_on_condition ----------------------------------------------------

def _mlp(width):
    ff = P.FFModel(P.FFConfig(batch_size=16), device="cpu")
    t = ff.create_tensor((16, 8), name="x")
    t = ff.dense(t, 16, activation=P.ActiMode.AC_MODE_RELU, name="d0")
    t = ff.dense(t, width, activation=P.ActiMode.AC_MODE_RELU, name="wide")
    ff.dense(t, 4, name="head")
    return ff


def test_recompile_widens_a_dense_and_keeps_every_untouched_leaf():
    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype(np.float32)
    y = rs.randn(32, 4).astype(np.float32)
    ff = _mlp(16)
    ff.compile(AdamOptimizer(alpha=1e-2), P.LossType[MSE], [])
    ff.fit(x, y, epochs=2, verbose=False)
    before = {(l, n): t.clone() for l, sub in ff.params.items()
              for n, t in sub.items()}
    old_executor = ff.executor
    fired = []

    def widen(model):
        layer = next(l for l in model.layers if l.name == "wide")
        layer.properties["out_dim"] = 32

    state = RecompileState(lambda: not fired and not fired.append(1),
                           widen)
    assert ff.recompile_on_condition(state)
    assert not ff.recompile_on_condition(state)  # the trigger fired once
    assert state.recompilations == 1 and ff._iter == 4
    assert ff.executor is not old_executor
    assert tuple(ff.params["wide"]["kernel"].shape) == (16, 32)
    assert tuple(ff.params["head"]["kernel"].shape) == (32, 4)
    for (layer, name), t in before.items():
        if layer == "d0" or (layer, name) == ("head", "bias"):
            assert torch.equal(ff.params[layer][name], t), (layer, name)
    # the optimizer state starts afresh
    assert int(ff.opt_state["t"]) == 0
    ff.fit(x, y, epochs=1, verbose=False)
    assert np.isfinite(ff._last_loss) and ff._iter == 6


def test_recompile_matches_the_reference():
    """The same widening through both packages: the same surviving
    leaves, the same new shapes."""
    from flexflow_tpu.recompile import RecompileState as JRecompileState

    def build(pkg):
        if pkg is J:
            ff = J.FFModel(J.FFConfig(batch_size=16, workers_per_node=1))
        else:
            ff = P.FFModel(P.FFConfig(batch_size=16), device="cpu")
        t = ff.create_tensor((16, 8), name="x")
        t = ff.dense(t, 16, name="d0")
        ff.dense(t, 4, name="head")
        return ff

    shapes = {}
    for pkg, opt, state_cls in ((J, J.AdamOptimizer(), JRecompileState),
                                (P, AdamOptimizer(), RecompileState)):
        ff = build(pkg)
        ff.compile(opt, pkg.LossType[MSE], [])

        def widen(model):
            next(l for l in model.layers if l.name == "d0") \
                .properties["out_dim"] = 24

        assert ff.recompile_on_condition(state_cls(lambda: True, widen))
        shapes[pkg.__name__] = {(l, n): tuple(np.shape(t))
                                for l, sub in ff.params.items()
                                for n, t in sub.items()}
    assert shapes["flexflow_tpu"] == shapes["flexflow_tpu_torch"]
