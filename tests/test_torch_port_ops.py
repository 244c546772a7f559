"""PyTorch port, the slice's ops against the JAX package's ops.

Each case builds the same layer in both packages, gives both the same
parameters (random, made with numpy from a seed, so biases and norm
affines are not trivially zero) and the same inputs, and compares f32
outputs at atol 1e-5 / rtol 1e-5 — f32 on both sides; only the order of
the sums differs. The ops' search metadata (flops, params_elems, dim
roles) must agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.config as jconfig
import flexflow_tpu.ffconst as jconst
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.ops import OpRegistry as JRegistry
from flexflow_tpu.ops.base import OpContext as JContext
import flexflow_tpu_torch.config as pconfig
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.base import OpContext as PContext

ATOL = RTOL = 1e-5


def _enum_map(props, const):
    """Translate enum members named 'ActiMode.X' into ``const``'s enums."""
    return {k: getattr(getattr(const, v.split(".")[0]), v.split(".")[1])
            if isinstance(v, str) and v.startswith("ActiMode.") else v
            for k, v in props.items()}


def _pair(op_type, input_shapes, props, seed=0):
    jl = JLayer(getattr(jconst.OperatorType, op_type), f"op_{op_type}", [])
    jl.properties.update(_enum_map(props, jconst))
    pl = PLayer(getattr(pconst.OperatorType, op_type), f"op_{op_type}", [])
    pl.properties.update(_enum_map(props, pconst))
    jop = JRegistry.create(jl, input_shapes)
    pop = PRegistry.create(pl, input_shapes)
    rs = np.random.RandomState(seed)
    shapes = {k: np.shape(v)
              for k, v in jop.init_params(jax.random.PRNGKey(0)).items()}
    params = {k: (rs.randn(*s) * 0.3).astype(np.float32)
              for k, s in shapes.items()}
    inputs = [rs.randn(*s).astype(np.float32) for s in input_shapes]
    return jop, pop, params, inputs


def _run_both(jop, pop, params, inputs):
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x) for x in inputs],
                          JContext(training=False, compute_dtype=jnp.float32))
    (got,) = pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                         [torch.from_numpy(x) for x in inputs],
                         PContext(training=False, compute_dtype=torch.float32))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    return jop, pop


CASES = {
    "linear": ("LINEAR", [(2, 8, 16)], dict(out_dim=24)),
    "linear_relu": ("LINEAR", [(2, 8, 16)],
                    dict(out_dim=24, activation="ActiMode.AC_MODE_RELU")),
    "linear_nobias": ("LINEAR", [(4, 16)], dict(out_dim=8, use_bias=False)),
    "layernorm": ("LAYERNORM", [(2, 8, 32)], dict(axes=(-1,), eps=1e-5)),
    "ew_add": ("EW_ADD", [(2, 8, 32), (2, 8, 32)], {}),
    "relu": ("RELU", [(2, 8, 32)], dict(scalar=None, inplace=False)),
    "mha": ("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
            dict(embed_dim=32, num_heads=4)),
    "mha_causal": ("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
                   dict(embed_dim=32, num_heads=4, causal=True)),
    "mha_rope_gqa": ("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
                     dict(embed_dim=32, num_heads=4, num_kv_heads=2,
                          rope=True)),
    "mha_qkv_bias": ("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
                     dict(embed_dim=32, num_heads=4, qkv_bias=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    op_type, shapes, props = CASES[case]
    _run_both(*_pair(op_type, shapes, props, seed=len(case)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_matches_jax(case):
    """Training-mode forward and its gradients: jax.vjp against torch
    autograd with the same cotangent, for every input and parameter (f32,
    atol/rtol 1e-5 of each gradient's max |value|). MHA runs its einsum
    core on both sides here."""
    op_type, shapes, props = CASES[case]
    jop, pop, params, inputs = _pair(op_type, shapes, props, seed=len(case))
    jctx = JContext(training=True, compute_dtype=jnp.float32)
    if op_type == "MULTIHEAD_ATTENTION":
        jop.kernel_impl = "einsum"
    want, vjp = jax.vjp(
        lambda p, xs: jop.forward(p, xs, jctx)[0],
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(x) for x in inputs])
    cot = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(cot))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = [torch.from_numpy(x).requires_grad_() for x in inputs]
    (got,) = pop.forward(tp, tx, PContext(training=True,
                                          compute_dtype=torch.float32))
    got.backward(torch.from_numpy(cot))
    pairs = [(tp[k].grad, want_gp[k]) for k in params]
    pairs += [(x.grad, g) for x, g in zip(tx, want_gx)]
    for g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_metadata_matches_jax(case):
    op_type, shapes, props = CASES[case]
    jop, pop, params, _ = _pair(op_type, shapes, props)
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert pop.params_elems() == jop.params_elems()
    assert [[r.value for r in roles] for roles in pop.output_dim_roles()] \
        == [[r.value for r in roles] for roles in jop.output_dim_roles()]
    # the port's own initializers give the same parameter tree
    ours = pop.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} \
        == {k: v.shape for k, v in params.items()}


def test_mha_projections_keep_head_first_layout():
    _, pop, params, _ = _pair("MULTIHEAD_ATTENTION", [(2, 16, 32)] * 3,
                              dict(embed_dim=32, num_heads=4, qkv_bias=True))
    assert params["wq"].shape == (4, 32, 8) and params["wo"].shape == (4, 8, 32)
    assert params["bq"].shape == (4, 8) and params["bo"].shape == (32,)


def test_mha_kernel_impl_flash_raises_where_kernel_cannot_run():
    """A flash choice the kernel cannot take (cross-attention, Sq != Sk)
    runs the einsum core, as the reference does, and records why in
    ``_kernel_fallback`` with the reference's words; a kernel that fails
    to build or launch still raises (``test_torch_port_flash``). On the
    CPU a forced flash core on self-attention runs FlashAttention through
    the plain versions."""
    jop, pop, params, inputs = _pair(
        "MULTIHEAD_ATTENTION", [(2, 16, 128), (2, 12, 128), (2, 12, 128)],
        dict(embed_dim=128, num_heads=2, kernel_impl="flash"))
    (got,) = pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                         [torch.from_numpy(x) for x in inputs], PContext())
    (want,) = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                          [jnp.asarray(x) for x in inputs],
                          JContext(training=False, compute_dtype=jnp.float32))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())
    assert pop._kernel_fallback == jop._kernel_fallback is not None
    assert pop.selected_impl("cpu") == "einsum"
    assert pop.selected_impl("cuda") == "einsum"
    _, pop, params, inputs = _pair(
        "MULTIHEAD_ATTENTION", [(2, 16, 128)] * 3,
        dict(embed_dim=128, num_heads=2, kernel_impl="flash"))
    assert pop.selected_impl("cpu") == "flash"
    assert pop.selected_impl("cuda") == "flash"


def test_unported_op_raises():
    # REPARTITION stays unported until the multi-GPU slice (ROADMAP.md
    # item 3)
    layer = PLayer(pconst.OperatorType.REPARTITION, "repartition", [])
    layer.properties.update(dim=0, degree=2, axis="data")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PRegistry.create(layer, [(8, 16)])


@pytest.mark.parametrize("name", ["OperatorType", "DataType", "ActiMode",
                                  "LossType", "CompMode", "MetricsType",
                                  "PoolType"])
def test_enums_match_jax(name):
    j, p = getattr(jconst, name), getattr(pconst, name)
    assert [(m.name, m.value) for m in p] == [(m.name, m.value) for m in j]


def test_datatype_maps_to_torch():
    assert pconst.DataType.BFLOAT16.torch_dtype == torch.bfloat16
    assert pconst.DataType.FLOAT.size == 4
    assert pconst.DataType.INT64.torch_dtype == torch.int64


def test_ffconfig_fields_and_defaults_match_jax():
    j = {f.name: f.default for f in dataclasses.fields(jconfig.FFConfig)}
    p = {f.name: f.default for f in dataclasses.fields(pconfig.FFConfig)}
    assert list(p) == list(j)
    for k in j:
        jv, pv = j[k], p[k]
        if isinstance(jv, jconst.CompMode):
            jv, pv = jv.name, pv.name
        assert pv == jv, k


def test_parse_args_reads_the_slice_flags():
    argv = ["-b", "16", "--seed", "7", "-ll:gpu", "1", "--budget", "0",
            "--epochs", "3", "app-flag"]
    p, j = pconfig.FFConfig(), jconfig.FFConfig()
    rest = p.parse_args(argv)
    j.parse_args(argv)
    for k in ("batch_size", "batch_size_explicit", "seed",
              "workers_per_node", "search_budget", "epochs"):
        assert getattr(p, k) == getattr(j, k), k
    assert rest == ["app-flag"]
