"""PyTorch port: carrying the JAX model's parameters into the port.

The layouts are identical by construction, so a carried tree round-trips
exactly; a missing, extra or misshapen leaf raises.
"""

import jax
import numpy as np
import pytest

import flexflow_tpu as J
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
import flexflow_tpu_torch as P
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.weights import from_jax_params

SMALL = dict(num_layers=1, hidden_size=64, num_heads=2, seq_length=8,
             batch_size=2)


@pytest.fixture(scope="module")
def jax_params():
    ff = j_create_transformer(JTransformerConfig(**SMALL),
                              J.FFConfig(batch_size=2, workers_per_node=1))
    ff.compile(None, J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=J.CompMode.INFERENCE)
    return jax.tree.map(np.asarray, ff.params)


def _port():
    ff = create_transformer(TransformerConfig(**SMALL), device="cpu")
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=P.CompMode.INFERENCE)
    return ff


def test_round_trip(jax_params):
    ff = _port()
    from_jax_params(jax_params, ff)
    assert sorted(ff.params) == sorted(jax_params)
    for layer, sub in jax_params.items():
        assert sorted(ff.params[layer]) == sorted(sub)
        for name, arr in sub.items():
            np.testing.assert_array_equal(ff.get_parameter(layer, name), arr)
    assert set(ff.get_layer_names()) >= set(jax_params)


def test_without_model_returns_cpu_tensors(jax_params):
    tree = from_jax_params(jax_params)
    for layer, sub in jax_params.items():
        for name, arr in sub.items():
            np.testing.assert_array_equal(tree[layer][name].numpy(), arr)


def _edited(tree, fn):
    out = {k: dict(v) for k, v in tree.items()}
    fn(out)
    return out


@pytest.mark.parametrize("edit,match", [
    (lambda t: t["attn_0"].__setitem__("wq", np.zeros((2, 64, 16),
                                                       np.float32)),
     "attn_0/wq: shape"),
    (lambda t: t["ffn1_0"].pop("bias"), "missing \\['ffn1_0/bias'\\]"),
    (lambda t: t["head"].__setitem__("extra", np.zeros(1, np.float32)),
     "extra \\['head/extra'\\]"),
    (lambda t: t.__setitem__("__compute_params__", {}), "compute copy"),
])
def test_mismatched_tree_raises(jax_params, edit, match):
    with pytest.raises(ValueError, match=match):
        from_jax_params(_edited(jax_params, edit), _port())


def test_set_parameter_refreshes_the_forward(jax_params):
    ff = _port()
    from_jax_params(jax_params, ff)
    x = np.random.RandomState(1).randn(2, 8, 64).astype(np.float32)
    before = ff.predict(x)
    ff.set_parameter("head", np.zeros((1,), np.float32) + 1.0, "bias")
    np.testing.assert_allclose(ff.predict(x), before + 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="shape mismatch"):
        ff.set_parameter("head", np.zeros((2,), np.float32), "bias")
