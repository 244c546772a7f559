"""PyTorch port, the OSDI'22 protocol's other five models against the JAX
package: DLRM, XDL, CANDLE-Uno, ResNeXt-50 and Inception-v3.

Each model is built in both packages at the small configuration of
``tests/test_model_zoo.py`` (ResNeXt at image 32; Inception reduced, at
image 75 with 10 classes), compiled for training with Adam (alpha 1e-3,
f32 moments) and the model's loss, on one device; the JAX model's
parameters are carried into the port. Then, on one seeded batch (inputs
and labels made with numpy):

- ``predict`` of the batch in both packages;
- three training steps: the first through the reference's step-by-step
  loop (``set_batch``, ``forward``, ``zero_gradients``, ``backward``,
  ``update``), as ``tests/test_model_zoo.py``'s ``one_step`` runs it,
  the next two through ``fit``; a second port model from the same
  parameters takes three ``fit`` steps, and its first must be the loop's
  step exactly (the loop's ``update`` is ``fit``'s compiled step).

Tolerances (f32 compute on both sides; only the order of sums differs):
- ``predict``: 1e-5 of the output's largest magnitude;
- per-step losses: rtol 1e-4;
- every parameter leaf after the 3 steps: 1e-3 of the JAX leaf's largest
  magnitude (the largest gap seen is 3.4e-4 of it, on a bias leaf that
  starts at zero; Adam moves every leaf by up to 3e-3 in the 3 steps, so
  a leaf left unchanged or moved at another scale lies far outside).
"""

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models import (CandleUnoConfig as JCandleUnoConfig,
                                 DLRMConfig as JDLRMConfig,
                                 InceptionConfig as JInceptionConfig,
                                 ResNeXtConfig as JResNeXtConfig,
                                 XDLConfig as JXDLConfig,
                                 create_candle_uno as j_create_candle_uno,
                                 create_dlrm as j_create_dlrm,
                                 create_inception_v3 as j_create_inception,
                                 create_resnext50 as j_create_resnext,
                                 create_xdl as j_create_xdl)
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models import (CandleUnoConfig, DLRMConfig,
                                       InceptionConfig, ResNeXtConfig,
                                       XDLConfig, create_candle_uno,
                                       create_dlrm, create_inception_v3,
                                       create_resnext50, create_xdl)
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

ALPHA = 1e-3
STEPS = 3
PREDICT_TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-3
NCHW_LAYOUT = dict(enabled=False, nhwc_ops=0, transposes=0, boundaries=[])

MSE, SCE = "MEAN_SQUARED_ERROR_AVG_REDUCE", "SPARSE_CATEGORICAL_CROSSENTROPY"
# name -> (JAX builder, JAX config, port builder, port config, config
# fields, input shapes (int: ids below it; else float), label shape and
# kind, loss, metric)
MODELS = {
    "dlrm": (j_create_dlrm, JDLRMConfig, create_dlrm, DLRMConfig,
             dict(batch_size=8, vocab_size=1000, num_sparse_features=4),
             [((8, 1), 1000)] * 4 + [((8, 16), None)], ((8, 1), None),
             MSE, "MEAN_SQUARED_ERROR"),
    "xdl": (j_create_xdl, JXDLConfig, create_xdl, XDLConfig,
            dict(batch_size=8, embedding_size=(1000, 1000)),
            [((8, 1), 1000)] * 2, ((8, 1), 2), SCE, "ACCURACY"),
    "candle_uno": (j_create_candle_uno, JCandleUnoConfig, create_candle_uno,
                   CandleUnoConfig,
                   dict(batch_size=8, dense_layers=(32,) * 2,
                        dense_feature_layers=(32,) * 2,
                        input_features={"dose1": 1, "cell": 24,
                                        "drug_desc": 40}),
                   [((8, 1), None), ((8, 24), None), ((8, 40), None)],
                   ((8, 1), None), MSE, "MEAN_SQUARED_ERROR"),
    "resnext": (j_create_resnext, JResNeXtConfig, create_resnext50,
                ResNeXtConfig,
                dict(batch_size=2, image_size=32, stages=(1, 1, 1, 1),
                     cardinality=8),
                [((2, 3, 32, 32), None)], ((2, 1), 1000), SCE, "ACCURACY"),
    "inception": (j_create_inception, JInceptionConfig, create_inception_v3,
                  InceptionConfig,
                  dict(batch_size=2, image_size=75, num_classes=10,
                       reduced=True),
                  [((2, 3, 75, 75), None)], ((2, 1), 10), SCE, "ACCURACY"),
}


def _aligned():
    """Start both packages' layer and tensor counters at one value, so
    that unnamed layers get the same names in both; returns the starts."""
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start
        starts.append(start)
    return starts


def _batch(name):
    *_, in_specs, (y_shape, y_hi), _, _ = MODELS[name]
    rs = np.random.RandomState(len(name))
    xs = [rs.randint(0, hi, shp).astype(np.int32) if hi
          else rs.randn(*shp).astype(np.float32) for shp, hi in in_specs]
    y = (rs.randint(0, y_hi, y_shape).astype(np.int32) if y_hi
         else rs.rand(*y_shape).astype(np.float32))
    return xs, y


def build_models(name, ports=1):
    """The JAX model and ``ports`` port models of ``name``, each compiled
    for training on one device, every port model carrying the JAX
    model's parameters (its layers numbered as the JAX model's)."""
    jb, jc, pb, pc, kw, _, _, loss, metric = MODELS[name]
    starts = _aligned()
    jff = jb(jc(**kw), J.FFConfig(batch_size=kw["batch_size"],
                                  workers_per_node=1))
    jff.compile(JAdam(alpha=ALPHA), getattr(J.LossType, loss),
                [getattr(J.MetricsType, metric)])
    jparams = jax.tree.map(np.asarray, jff.params)
    out = [jff]
    ends = []
    for _ in range(ports):
        PLayer._next_guid[0], PTensor._next_guid[0] = starts
        pff = pb(pc(**kw), P.FFConfig(batch_size=kw["batch_size"]),
                 device="cpu")
        pff.compile(AdamOptimizer(alpha=ALPHA), getattr(P.LossType, loss),
                    [getattr(P.MetricsType, metric)])
        from_jax_params(jparams, pff)
        out.append(pff)
        ends = [PLayer._next_guid[0], PTensor._next_guid[0]]
    PLayer._next_guid[0], PTensor._next_guid[0] = ends
    return out


def _loop_step(ff, xs, y):
    """``tests/test_model_zoo.py``'s ``one_step``, after compile."""
    ff.set_batch(xs, y)
    ff.forward()
    ff.zero_gradients()
    ff.backward()
    ff.update()
    return float(ff._last_loss)


@pytest.fixture(scope="module", params=sorted(MODELS))
def zoo(request):
    name = request.param
    jff, pff, fit_ff = build_models(name, ports=2)
    xs, y = _batch(name)
    out = dict(name=name, jff=jff, pff=pff,
               predict=(np.asarray(jff.predict(xs)), pff.predict(xs)))
    losses = [(_loop_step(jff, xs, y), _loop_step(pff, xs, y))]
    fit_ff.fit(xs, y, epochs=1, verbose=False)
    out["loop_vs_fit"] = (
        losses[0][1], fit_ff._last_loss,
        [(torch.equal(t, fit_ff.params[op][pn]), f"{op}/{pn}")
         for op, sub in pff.params.items() for pn, t in sub.items()])
    for _ in range(STEPS - 1):
        jff.fit(xs, y, epochs=1, verbose=False)
        pff.fit(xs, y, epochs=1, verbose=False)
        losses.append((float(jff._last_loss), pff._last_loss))
    out["losses"] = losses
    return out


def test_trained_parameters_match_jax(zoo):
    """Every port leaf after the 3 Adam steps against the JAX model's,
    within PARAM_TOL of the JAX leaf's largest magnitude."""
    jff, pff = zoo["jff"], zoo["pff"]
    assert sorted((op, pn) for op, sub in pff.params.items() for pn in sub) \
        == sorted((op, pn) for op, sub in jff.params.items() for pn in sub)
    for op, sub in jff.params.items():
        for pn, w in sub.items():
            w = np.asarray(w)
            np.testing.assert_allclose(
                pff.params[op][pn].numpy(), w, rtol=0,
                atol=PARAM_TOL * np.abs(w).max(), err_msg=f"{op}/{pn}")


def test_builds_the_reference_graph(zoo):
    """The same layers, op types, output shapes and parameter shapes."""
    jff, pff = zoo["jff"], zoo["pff"]
    jnodes, pnodes = jff.executor.nodes, pff.executor.nodes
    assert [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in pnodes] \
        == [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in jnodes]
    assert {op: {pn: tuple(t.shape) for pn, t in sub.items()}
            for op, sub in pff.params.items()} \
        == {op: {pn: tuple(np.shape(t)) for pn, t in sub.items()}
            for op, sub in jff.params.items()}
    assert pff.layout_info == jff.layout_info == NCHW_LAYOUT


def test_predict_matches_jax(zoo):
    want, got = zoo["predict"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PREDICT_TOL * np.abs(want).max())


def test_training_losses_match_jax(zoo):
    """The loop's first step, then two ``fit`` steps, in both packages."""
    losses = zoo["losses"]
    assert len(losses) == STEPS and all(np.isfinite(losses).ravel())
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_loop_step_is_fits_first_step(zoo):
    """``set_batch; forward; zero_gradients; backward; update`` leaves the
    loss and every parameter exactly as one ``fit`` step does."""
    loop_loss, fit_loss, same = zoo["loop_vs_fit"]
    assert loop_loss == fit_loss
    assert [name for ok, name in same if not ok] == []


def test_loop_refuses_a_shorter_sequence():
    """A ``seq_length`` below the model's sequence extent runs the JAX
    package's bucket executor at the next power of two, at least 16
    (before the port had buckets it raised naming ROADMAP item 8): a
    seq-16 model has no shorter bucket and runs full length, a seq-64
    model at ``seq_length=8`` runs the 16 bucket. On a model without a
    sequence dim it is ignored, as the reference ignores it; ``forward``
    before ``set_batch`` is refused."""
    from flexflow_tpu_torch.models import TransformerConfig, create_transformer
    rs = np.random.RandomState(0)
    for seq, want in ((16, []), (64, [16])):
        ff = create_transformer(TransformerConfig(
            num_layers=1, hidden_size=32, num_heads=2, seq_length=seq,
            batch_size=2), device="cpu")
        ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        ff.set_batch(rs.randn(2, seq, 32).astype(np.float32),
                     rs.randn(2, seq, 1).astype(np.float32))
        ff.forward(seq_length=seq)
        ff.backward()
        ff.update()
        assert np.isfinite(ff._last_loss)
        ff.forward(seq_length=8)
        ff.backward()
        ff.update()
        assert np.isfinite(ff._last_loss)
        assert list(ff._seq_execs) == want
    with pytest.raises(ValueError, match="set_batch"):
        fresh = create_dlrm(DLRMConfig(batch_size=2, vocab_size=10,
                                       num_sparse_features=1), device="cpu")
        fresh.compile(AdamOptimizer(),
                      P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        fresh.forward()


@pytest.mark.parametrize("mode", ["auto", "nchw", "nhwc"])
def test_conv_layout(mode):
    """The layout pass: ``"auto"`` (NCHW on the CPU) and ``"nchw"`` report
    no pass; ``"nhwc"`` runs it, and its ``layout_info`` is the JAX
    package's for the same ResNeXt graph."""
    kw = dict(batch_size=1, image_size=32, stages=(1, 1, 1, 1),
              cardinality=2)
    starts = _aligned()
    jff = j_create_resnext(JResNeXtConfig(**kw), J.FFConfig(
        batch_size=1, workers_per_node=1, conv_compute_layout=mode))
    jff.compile(JAdam(), getattr(J.LossType, SCE))
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    ff = create_resnext50(ResNeXtConfig(**kw),
                          P.FFConfig(batch_size=1, conv_compute_layout=mode),
                          device="cpu")
    ff.compile(AdamOptimizer(), P.LossType[SCE])
    assert ff.layout_info == jff.layout_info
    if mode == "nhwc":
        # every conv and pool (13 convs, 2 pools) channels-last; the
        # input and the flat's input are the two boundaries
        assert ff.layout_info["enabled"] and ff.layout_info["nhwc_ops"] == 15
        assert ff.layout_info["transposes"] == 2
    else:
        assert ff.layout_info == NCHW_LAYOUT


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: one training step of each "
                           "model with K4 launched on it")
@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_on_the_card_launches_fused_adam(name, tmp_path):
    """One ``fit`` step of each small model on the card through a strategy
    file that gives every op ``dp_k:fused``: the loss is finite and K4
    launches once (every leaf in one launch); the replayed second step
    launches it once more."""
    import json
    from flexflow_tpu_torch.ops.fused_update import fused_adam_multi

    _, _, pb, pc, kw, _, _, loss, _ = MODELS[name]
    ff = pb(pc(**kw), P.FFConfig(batch_size=kw["batch_size"]),
            device="cuda")
    path = tmp_path / "strategy.json"
    path.write_text(json.dumps(dict(version=1, mesh={"data": 1}, ops={
        layer.name: dict(choice="dp_k:fused", outputs=[None], params={})
        for layer in ff.layers
        if layer.op_type != P.OperatorType.INPUT})))
    ff.config.import_strategy_file = str(path)
    ff.compile(AdamOptimizer(state_dtype=torch.bfloat16),
               getattr(P.LossType, loss))
    xs, y = _batch(name)
    before = fused_adam_multi.launches
    ff.fit(xs, y, epochs=2, verbose=False)
    assert np.isfinite(ff.epoch_losses).all()
    assert fused_adam_multi.launches - before == 2
