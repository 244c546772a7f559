"""PyTorch port, the Keras frontend against the JAX package's.

Every model of ``tests/test_keras_frontend.py`` is built through both
packages' Keras API (the port with ``device="cpu"``), with explicit layer
names so both name their layers alike; the JAX model's initial weights
go into the port through ``get_weights`` / ``set_weights``. Then:
``predict`` agrees at 1e-5, and each ``fit`` epoch's loss at rtol 1e-4
(f32 on both sides, sums in other orders), as do ``evaluate``'s metrics.
Also the callbacks, the padded ``predict`` tail, the weight accessors,
the datasets (the same synthetic arrays as the JAX package's) and the
constant, uniform and normal initializers a Dense layer takes.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.keras as JK
import flexflow_tpu.keras.layers as JL
import flexflow_tpu.keras.optimizers as JO
import flexflow_tpu_torch.keras as PK
import flexflow_tpu_torch.keras.layers as PL
import flexflow_tpu_torch.keras.optimizers as PO
from flexflow_tpu_torch.keras.backend import to_categorical
from flexflow_tpu_torch.keras.callbacks import EarlyStopping, History
from flexflow_tpu_torch.initializers import (ConstantInitializer,
                                             NormInitializer,
                                             UniformInitializer)

RTOL = 1e-4


def blobs(n=512, d=16, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n)
    x = (centers[y] + rs.randn(n, d)).astype(np.float32)
    return x, y.astype(np.int32).reshape(-1, 1)


def mlp(K, L, O):
    return K.Sequential([L.Input((16,), name="x"),
                         L.Dense(64, activation="relu", name="d1"),
                         L.Dense(4, activation="softmax", name="d2")]), \
        dict(optimizer=O.SGD(learning_rate=0.1),
             loss="sparse_categorical_crossentropy", metrics=["accuracy"],
             batch_size=64)


def cnn(K, L, O):
    return K.Sequential([L.Input((1, 12, 12), name="x"),
                         L.Conv2D(4, 3, activation="relu", name="c1"),
                         L.MaxPooling2D(2, name="p1"),
                         L.Flatten(name="f1"),
                         L.Dense(3, activation="softmax", name="d1")]), \
        dict(optimizer="sgd", loss="sparse_categorical_crossentropy",
             metrics=["accuracy"], batch_size=16)


def categorical(K, L, O):
    return K.Sequential([L.Input((16,), name="x"),
                         L.Dense(4, activation="softmax", name="d1")]), \
        dict(optimizer=O.SGD(0.1), loss="categorical_crossentropy",
             metrics=["accuracy"], batch_size=64)


def functional(K, L, O):
    inp = L.Input((16,), name="x")
    a = L.Dense(32, activation="relu", name="a")(inp)
    b = L.Dense(32, activation="tanh", name="b")(inp)
    h = L.Add(name="add")([a, b])
    h2 = L.Concatenate(axis=-1, name="cat")([h, a])
    out = L.Dense(4, activation="softmax", name="out")(h2)
    return K.Model(inputs=inp, outputs=out), \
        dict(optimizer=O.SGD(0.1), loss="sparse_categorical_crossentropy",
             metrics=["accuracy"], batch_size=64)


def linear_mse(K, L, O):
    return K.Sequential([L.Input((16,), name="x"),
                         L.Dense(4, name="dense_out")]), \
        dict(optimizer="sgd", loss="mse", batch_size=64)


def _data(name):
    if name == "cnn":
        rs = np.random.RandomState(0)
        return (rs.randn(32, 1, 12, 12).astype(np.float32),
                rs.randint(0, 3, (32, 1)).astype(np.int32))
    x, y = blobs()
    if name == "categorical":
        y = to_categorical(y, 4)
    if name == "linear_mse":
        y = np.random.RandomState(2).randn(512, 4).astype(np.float32)
    return x, y


MODELS = {"mlp": (mlp, 4), "cnn": (cnn, 1), "categorical": (categorical, 3),
          "functional": (functional, 4), "linear_mse": (linear_mse, 2)}


def _pair(name):
    build, epochs = MODELS[name]
    jm, jkw = build(JK, JL, JO)
    jm.ffconfig = J.FFConfig(batch_size=jkw["batch_size"],
                             workers_per_node=1)
    jm.compile(**jkw)
    pm, pkw = build(PK, PL, PO)
    pm.device = "cpu"
    pm.compile(**pkw)
    # the JAX model's initial weights, layer by layer
    for jl, pl in zip(jm.layers, pm.layers):
        assert jl.name == pl.name and type(jl).__name__ == type(pl).__name__
        if jl._param_names():
            pl.set_weights([np.asarray(w) for w in jl.get_weights()])
    return jm, pm, epochs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_jax(name):
    jm, pm, epochs = _pair(name)
    x, y = _data(name)
    np.testing.assert_allclose(pm.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-5, atol=1e-5)
    hj = jm.fit(x, y, epochs=epochs, verbose=False)
    hp = pm.fit(x, y, epochs=epochs, verbose=False)
    np.testing.assert_allclose(hp["loss"], [float(v) for v in hj["loss"]],
                               rtol=RTOL)
    rj = jm.evaluate(x, y, verbose=False)
    rp = pm.evaluate(x, y, verbose=False)
    assert set(rp) == set(rj)
    for k in rj:
        np.testing.assert_allclose(rp[k], float(rj[k]), rtol=RTOL, atol=1e-6)
    if name in ("mlp", "functional"):
        assert rp["accuracy"] > 0.9
    if name == "categorical":
        assert rp["accuracy"] > 0.8


def test_the_model_runs_where_it_was_asked():
    _, pm, _ = _pair("mlp")
    assert pm.ff.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for sub in pm.ff.params.values()
               for t in sub.values())


def test_callbacks_early_stopping():
    x, y = blobs()
    model = PK.Sequential([PL.Input((16,), name="x"),
                           PL.Dense(4, activation="softmax")], device="cpu")
    model.compile(optimizer=PO.SGD(0.05),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], batch_size=64)
    hist = History()
    es = EarlyStopping(monitor="loss", patience=0, min_delta=10.0)
    h = model.fit(x, y, epochs=10, callbacks=[hist, es], verbose=False)
    # min_delta=10 never improves: the first epoch sets best, the second
    # trips patience=0, so exactly 2 epochs ran
    assert len(hist.history["loss"]) == 2
    assert len(h["loss"]) == 2


def test_predict_handles_remainder():
    x, _ = blobs(n=100)
    model = PK.Sequential([PL.Input((16,), name="x"), PL.Dense(4)],
                          device="cpu")
    model.compile(optimizer="sgd", loss="mse", batch_size=64)
    assert model.predict(x).shape == (100, 4)


def test_get_set_weights():
    x, _ = blobs()
    model = PK.Sequential([PL.Input((16,), name="x"),
                           PL.Dense(4, name="dense_out")], device="cpu")
    model.compile(optimizer="sgd", loss="mse", batch_size=64)
    (k, b) = model.layers[-1].get_weights()
    assert k.shape == (16, 4)
    model.layers[-1].set_weights([np.ones_like(k), np.zeros_like(b)])
    out = model.predict(x[:64])
    np.testing.assert_allclose(out[:, 0], x[:64].sum(axis=1), rtol=1e-4)
    assert [w.shape for w in model.get_weights()] == [(16, 4), (4,)]


@pytest.mark.parametrize("loader", ["mnist", "cifar10", "reuters"])
def test_datasets_match_jax(loader, monkeypatch):
    """Synthetic data from the same seeds as the JAX package's: equal
    arrays, nothing downloaded."""
    import flexflow_tpu.keras.datasets as jd
    import flexflow_tpu_torch.keras.datasets as pd

    monkeypatch.delenv("FLEXFLOW_TPU_DATA", raising=False)
    monkeypatch.setattr(jd, "_DATA_DIR", "/nonexistent")
    (pxt, pyt), (pxe, pye) = getattr(pd, loader).load_data()
    (jxt, jyt), (jxe, jye) = getattr(jd, loader).load_data()
    for got, want in ((pxt, jxt), (pyt, jyt), (pxe, jxe), (pye, jye)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if loader == "mnist":
        assert pxt.shape[1:] == (28, 28) and pxt.dtype == np.uint8


def test_constant_initializer_gives_its_value():
    g = torch.Generator().manual_seed(0)
    t = ConstantInitializer(0.25)(g, (3, 5))
    assert t.shape == (3, 5) and t.dtype == torch.float32
    assert torch.equal(t, torch.full((3, 5), 0.25))
    assert ConstantInitializer(2)(g, (4,), torch.bfloat16).dtype \
        == torch.bfloat16


def test_uniform_initializer_range_and_moments():
    """jax's PRNG has no torch twin: the draw is held by its range and
    moments (mean within 5 standard errors, variance (b-a)^2/12 within
    2%)."""
    lo, hi, n = -0.2, 0.6, 200_000
    t = UniformInitializer(seed=3, min_val=lo, max_val=hi)(
        torch.Generator().manual_seed(1), (n,))
    assert t.shape == (n,) and t.dtype == torch.float32
    assert t.min() >= lo and t.max() < hi
    sd = (hi - lo) / 12 ** 0.5
    assert abs(t.mean().item() - (lo + hi) / 2) < 5 * sd / n ** 0.5
    np.testing.assert_allclose(t.var().item(), sd ** 2, rtol=2e-2)


def test_norm_initializer_moments():
    mean, std, n = 0.5, 2.0, 200_000
    t = NormInitializer(seed=4, mean=mean, stddev=std)(
        torch.Generator().manual_seed(2), (400, 500))
    assert t.shape == (400, 500) and t.dtype == torch.float32
    assert abs(t.mean().item() - mean) < 5 * std / n ** 0.5
    np.testing.assert_allclose(t.std().item(), std, rtol=2e-2)
    # the same generator state draws the same values
    again = NormInitializer(mean=mean, stddev=std)(
        torch.Generator().manual_seed(2), (400, 500))
    assert torch.equal(t, again)


def test_dense_takes_kernel_and_bias_initializers():
    model = PK.Sequential(
        [PL.Input((8,)),
         PL.Dense(3, name="d", kernel_initializer=ConstantInitializer(0.5),
                  bias_initializer=UniformInitializer(min_val=1.0,
                                                      max_val=2.0))],
        device="cpu")
    model.compile(optimizer="sgd", loss="mse", batch_size=4)
    k, b = model.layers[-1].get_weights()
    np.testing.assert_array_equal(k, np.full((8, 3), 0.5, np.float32))
    assert ((b >= 1.0) & (b < 2.0)).all()
