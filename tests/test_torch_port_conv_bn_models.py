"""PyTorch port, ResNet-50 with BatchNorm and AlexNet against the JAX
package.

Each model is built in both packages at a small configuration (ResNet
with ``batch_norm=True``, one bottleneck a stage, image 32, batch 2;
AlexNet with BatchNorm off and on, image 64, batch 2, 10 classes, its two
dropouts set to rate 0 in both packages, since JAX's PRNG has no torch
twin), compiled for training with SGD (lr 1e-2) and the sparse
categorical cross-entropy on one device; the JAX model's
parameters and BN running statistics are carried into the port
(``from_jax_params``, ``from_jax_state``). Then, on one seeded batch
(numpy): the reference graph, ``predict`` (the eval fold on both sides),
three ``fit`` steps, and every parameter leaf and running statistic
after them.

SGD, not the zoo's Adam: a BatchNorm subtracts its batch mean, so the
bias of the conv feeding it has a gradient of exactly 0 in exact
arithmetic, and what either package computes is rounding noise. Adam
normalizes each element's step, so its first step moves such a bias by
+-alpha, the sign the noise's; the two packages' biases then part by up
to 2 alpha a step, and so do the running means that include them (seen:
4e-3 on a bias leaf whose JAX values stay under 2.1e-3). SGD steps by the
gradient, so noise moves a leaf by noise, and every leaf is compared.
Adam itself is held to the JAX package in ``tests/test_torch_port_zoo.py``
and ``tests/test_torch_port_adam.py``.

Tolerances, ``tests/test_torch_port_zoo.py``'s (f32 compute on both
sides; only the order of sums differs): ``predict`` 1e-5 of the output's
largest magnitude; per-step losses rtol 1e-4; every parameter leaf and
running statistic after the 3 steps 1e-3 of the JAX leaf's largest
magnitude.
"""

import jax
import numpy as np
import pytest

import flexflow_tpu as J
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.models import (ResNetConfig as JResNetConfig,
                                 create_alexnet as j_create_alexnet,
                                 create_resnet as j_create_resnet)
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models import (ResNetConfig, create_alexnet,
                                       create_resnet)
from flexflow_tpu_torch.optimizers import SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params, from_jax_state

LR = 1e-2
STEPS = 3
PREDICT_TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-3
BATCH = 2
SCE = "SPARSE_CATEGORICAL_CROSSENTROPY"

RESNET = dict(batch_size=BATCH, image_size=32, stages=(1, 1, 1, 1),
              batch_norm=True)
ALEXNET = dict(batch_size=BATCH, image_size=64, num_classes=10)
# name -> (build the JAX model, build the port model on the CPU, image)
MODELS = {
    "resnet_bn": (
        lambda cfg: j_create_resnet(JResNetConfig(**RESNET), cfg),
        lambda cfg: create_resnet(ResNetConfig(**RESNET), cfg,
                                  device="cpu"), 32),
    "alexnet": (
        lambda cfg: j_create_alexnet(ff_config=cfg, **ALEXNET),
        lambda cfg: create_alexnet(ff_config=cfg, device="cpu", **ALEXNET),
        64),
    "alexnet_bn": (
        lambda cfg: j_create_alexnet(ff_config=cfg, batch_norm=True,
                                     **ALEXNET),
        lambda cfg: create_alexnet(ff_config=cfg, batch_norm=True,
                                   device="cpu", **ALEXNET), 64),
}


def _without_dropout(ff):
    for layer in ff.layers:
        if layer.op_type.name == "DROPOUT":
            layer.properties["rate"] = 0.0
    return ff


def build_pair(name):
    """The JAX model and its port twin, layers numbered alike, both
    compiled for training, the port carrying the JAX model's parameters
    and running statistics."""
    jb, pb, _ = MODELS[name]
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start
        starts.append(start)
    jff = _without_dropout(jb(J.FFConfig(batch_size=BATCH,
                                         workers_per_node=1)))
    jff.compile(JSGD(lr=LR), J.LossType[SCE], [J.MetricsType.ACCURACY])
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    pff = _without_dropout(pb(P.FFConfig(batch_size=BATCH)))
    pff.compile(SGDOptimizer(lr=LR), P.LossType[SCE],
                [P.MetricsType.ACCURACY])
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    from_jax_state({k: {n: np.asarray(v) for n, v in sub.items()}
                    for k, sub in jff.state.items()
                    if not k.startswith("__")}, pff)
    return jff, pff


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    name = request.param
    jff, pff = build_pair(name)
    rs = np.random.RandomState(len(name))
    image = MODELS[name][2]
    x = rs.randn(BATCH, 3, image, image).astype(np.float32)
    y = rs.randint(0, 10, (BATCH, 1)).astype(np.int32)
    out = dict(name=name, jff=jff, pff=pff,
               predict=(np.asarray(jff.predict(x)), pff.predict(x)))
    losses = []
    for _ in range(STEPS):
        jff.fit(x, y, epochs=1, verbose=False)
        pff.fit(x, y, epochs=1, verbose=False)
        losses.append((float(jff._last_loss), pff._last_loss))
    out["losses"] = losses
    return out


def test_builds_the_reference_graph(model):
    """The same layers, op types, output shapes, parameter shapes and op
    state, and the conv layers' Conv+BN pairs the eval fold takes."""
    jff, pff = model["jff"], model["pff"]
    assert [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in pff.executor.nodes] \
        == [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in jff.executor.nodes]
    assert {op: {pn: tuple(t.shape) for pn, t in sub.items()}
            for op, sub in pff.params.items()} \
        == {op: {pn: tuple(np.shape(t)) for pn, t in sub.items()}
            for op, sub in jff.params.items()}
    assert sorted(k for k in pff.state if not k.startswith("__")) \
        == sorted(k for k in jff.state if not k.startswith("__"))
    assert [n.op.name for n in pff.executor._inference_nodes()] \
        == [n.op.name for n in jff.executor._inference_nodes()]
    if model["name"] == "resnet_bn":
        assert len(pff.executor.nodes) \
            - len(pff.executor._inference_nodes()) == 17  # 5 + 4 x 3 pairs


def test_predict_matches_jax(model):
    want, got = model["predict"]
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PREDICT_TOL * np.abs(want).max())


def test_training_losses_match_jax(model):
    losses = model["losses"]
    assert len(losses) == STEPS and np.isfinite(losses).all()
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _cancelled_biases(ff):
    """The convs that feed a BatchNorm: the BN subtracts its batch mean,
    so the exact gradient of their bias is 0."""
    nodes = ff.executor.nodes
    fed = {n.input_refs[0][1] for n in nodes
           if n.op.op_type.name == "BATCHNORM" and n.input_refs[0][0] == "op"}
    return {n.op.name for n in nodes
            if n.op.guid in fed and n.op.op_type.name == "CONV2D"}


def test_trained_parameters_match_jax(model):
    """Every parameter leaf after the 3 SGD steps within PARAM_TOL of the
    JAX leaf's largest magnitude; the bias of a conv that feeds a BN,
    whose exact gradient is 0, stays at its initial 0 within rounding
    (seen: 5e-8) in both packages."""
    jff, pff = model["jff"], model["pff"]
    cancelled = _cancelled_biases(pff)
    assert bool(cancelled) == model["name"].endswith("_bn")
    for op, sub in jff.params.items():
        for pn, w in sub.items():
            w, got = np.asarray(w), pff.params[op][pn].numpy()
            if pn == "bias" and op in cancelled:
                assert np.abs(w).max() <= 1e-6 and np.abs(got).max() <= 1e-6
                continue
            np.testing.assert_allclose(
                got, w, rtol=0, atol=PARAM_TOL * np.abs(w).max(),
                err_msg=f"{op}/{pn}")


def test_running_statistics_match_jax(model):
    """Every BN's running statistics after the 3 steps: the variance
    within PARAM_TOL of its largest value, the mean within PARAM_TOL of
    the BN's largest running standard deviation (a channel mean is a sum
    of activations of that spread, which may cancel to far below it:
    seen, a 1x1 map's mean 1.24e-3 of its own largest value apart)."""
    jff, pff = model["jff"], model["pff"]
    bns = {k: sub for k, sub in jff.state.items() if not k.startswith("__")}
    assert bool(bns) == model["name"].endswith("_bn")
    for op, sub in bns.items():
        var, mean = np.asarray(sub["var"]), np.asarray(sub["mean"])
        ours = pff.state[op]
        np.testing.assert_allclose(ours["var"].numpy(), var, rtol=0,
                                   atol=PARAM_TOL * var.max(),
                                   err_msg=f"{op}/var")
        np.testing.assert_allclose(ours["mean"].numpy(), mean, rtol=0,
                                   atol=PARAM_TOL * np.sqrt(var.max()),
                                   err_msg=f"{op}/mean")
