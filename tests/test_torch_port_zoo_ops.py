"""PyTorch port, the model zoo's ops against the JAX package's: Concat,
Conv2D, Pool2D and Flat.

Each case builds the same layer in both packages, gives both the same
parameters and inputs (random, made with numpy from a seed), and
compares the forward and the VJP (jax.vjp against torch autograd, one
random cotangent, for every input and parameter) in f32 and in bf16
compute. The ops' search metadata must agree exactly.

Tolerances, each against the largest magnitude of the value compared:
- f32: 1e-5 (f32 on both sides; the convolutions sum up to a few
  hundred products in different orders);
- bf16: 2^-6 (x and the kernel are rounded to bf16 on both sides; each
  side rounds its convolution's and pool's result to bf16 once, from
  sums taken in different orders, so a value may land one bf16 step,
  2^-8 of its magnitude, away; the VJP rounds twice more).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.ffconst as jconst
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.ops import OpRegistry as JRegistry
from flexflow_tpu.ops.base import OpContext as JContext
from flexflow_tpu.search import unity as junity
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.base import OpContext as PContext
from flexflow_tpu_torch.search import unity

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _conv(cout, k, s, p, groups=1, act="AC_MODE_NONE", bias=True):
    return dict(out_channels=cout, kernel_h=k[0], kernel_w=k[1],
                stride_h=s, stride_w=s, padding_h=p[0], padding_w=p[1],
                groups=groups, activation=("ActiMode", act), use_bias=bias)


def _pool(k, s, p, kind="POOL_MAX", act="AC_MODE_NONE"):
    return dict(kernel_h=k[0], kernel_w=k[1], stride_h=s, stride_w=s,
                padding_h=p[0], padding_w=p[1], pool_type=("PoolType", kind),
                activation=("ActiMode", act))


CASES = {
    "concat_axis0_2d": ("CONCAT", [(3, 5), (2, 5), (4, 5)], dict(axis=0)),
    "concat_axis1_2d": ("CONCAT", [(4, 3), (4, 6)], dict(axis=1)),
    "concat_last_2d": ("CONCAT", [(4, 3), (4, 5), (4, 1)], dict(axis=-1)),
    "concat_axis1_4d": ("CONCAT", [(2, 3, 5, 5), (2, 4, 5, 5)],
                        dict(axis=1)),
    "concat_last_4d": ("CONCAT", [(2, 3, 4, 2), (2, 3, 4, 5)],
                       dict(axis=-1)),
    "conv_3x3": ("CONV2D", [(2, 4, 9, 9)], _conv(6, (3, 3), 1, (1, 1))),
    "conv_groups8_relu": ("CONV2D", [(2, 16, 8, 8)],
                          _conv(32, (3, 3), 1, (1, 1), groups=8,
                                act="AC_MODE_RELU")),
    "conv_stride2_7x7": ("CONV2D", [(2, 3, 15, 15)],
                         _conv(8, (7, 7), 2, (3, 3), act="AC_MODE_RELU")),
    "conv_1x7": ("CONV2D", [(2, 6, 7, 9)], _conv(5, (1, 7), 1, (0, 3))),
    "conv_7x1_nobias": ("CONV2D", [(2, 6, 9, 7)],
                        _conv(5, (7, 1), 1, (3, 0), bias=False)),
    "pool_max_pad": ("POOL2D", [(2, 3, 9, 9)], _pool((3, 3), 2, (1, 1))),
    "pool_avg_pad": ("POOL2D", [(2, 3, 8, 8)],
                     _pool((3, 3), 1, (1, 1), kind="POOL_AVG")),
    "pool_global_avg": ("POOL2D", [(2, 5, 7, 7)],
                        _pool((7, 7), 1, (0, 0), kind="POOL_AVG")),
    "pool_max_relu": ("POOL2D", [(2, 3, 8, 8)],
                      _pool((3, 3), 2, (0, 0), act="AC_MODE_RELU")),
    "flat": ("FLAT", [(2, 3, 4, 5)], {}),
}


def _props(props, const):
    return {k: getattr(getattr(const, v[0]), v[1]) if isinstance(v, tuple)
            else v for k, v in props.items()}


def _pair(case):
    op_type, shapes, props = CASES[case]
    jl = JLayer(getattr(jconst.OperatorType, op_type), f"op_{case}", [])
    jl.properties.update(_props(props, jconst))
    pl = PLayer(getattr(pconst.OperatorType, op_type), f"op_{case}", [])
    pl.properties.update(_props(props, pconst))
    jop, pop = JRegistry.create(jl, shapes), PRegistry.create(pl, shapes)
    rs = np.random.RandomState(len(case))
    params = {k: (rs.randn(*np.shape(v)) * 0.3).astype(np.float32)
              for k, v in jop.init_params(jax.random.PRNGKey(0)).items()}
    inputs = [rs.randn(*s).astype(np.float32) for s in shapes]
    return jop, pop, params, inputs


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_vjp_match_jax(case, dname):
    """The training-mode forward in ``dname`` compute (inputs in that
    dtype, parameters f32, as the executor passes them), then the VJP of
    one cotangent with respect to every input and parameter."""
    jop, pop, params, inputs = _pair(case)
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    jctx = JContext(training=True, compute_dtype=jdt)
    want, vjp = jax.vjp(
        lambda p, xs: jop.forward(p, xs, jctx)[0],
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(x, jdt) for x in inputs])
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = [torch.from_numpy(x).to(tdt).requires_grad_() for x in inputs]
    (got,) = pop.forward(tp, tx, PContext(training=True, compute_dtype=tdt))
    assert got.dtype == tdt and str(want.dtype) == dname
    _close(got, want, TOL[dname])
    cot = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(cot, jdt))
    got.backward(torch.from_numpy(cot).to(tdt))
    for k in params:
        _close(tp[k].grad, want_gp[k], TOL[dname])
    for x, w in zip(tx, want_gx):
        _close(x.grad, w, TOL[dname])


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_metadata_matches_jax(case):
    jop, pop, params, _ = _pair(case)
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert pop.params_elems() == jop.params_elems()
    assert [[r.value for r in roles] for roles in pop.output_dim_roles()] \
        == [[r.value for r in roles] for roles in jop.output_dim_roles()]
    assert unity._node_attrs(pop) == junity._node_attrs(jop)
    assert unity._param_shapes(pop) == junity._param_shapes(jop)
    ours = pop.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} \
        == {k: v.shape for k, v in params.items()}
