"""PyTorch port, the tensor-op surface against the JAX package's ops.

The fifteen ops the frontends import graphs into: BatchMatmul, Reshape,
Transpose, Reverse, Cast, Const, Where, Expand, Einsum, ReduceMax,
Gather, ReduceSum, Mean, TopK and ArgTopK. Each case builds the same
layer in both packages and feeds both the same numpy inputs (made from a
seed): the f32 forward at atol/rtol 1e-5, the VJP (jax.vjp against torch
autograd with one cotangent) at rtol 1e-5 and atol 1e-5 of each
gradient's max |value|, and the search metadata (shapes, flops, parameter
count, dim roles, parameter tree) exactly.

Where the packages part: JAX runs without 64-bit types, so ``cast`` to
``DT_INT64`` and the top-k indices are int32 there and int64 here; the
values are held, not the dtypes. ``lax.top_k`` and ``torch.topk`` may
order tied entries apart, so the top-k inputs have no ties (random
normals). An integer output (indices, an int cast) has no gradient: the
JAX VJP gives zeros and the port's output does not require grad.
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
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.base import OpContext as PContext

ATOL = RTOL = 1e-5

# input specs: ("f", shape) random normals; ("mask", shape) 0/1 floats;
# ("idx", shape, n) integers in [0, n); props may name a DataType by its
# member name under "dtype"
CASES = {
    "batch_matmul": ("BATCHMATMUL", [("f", (2, 3, 4, 5)), ("f", (2, 3, 5, 6))],
                     {}),
    "batch_matmul_bcast": ("BATCHMATMUL", [("f", (2, 8, 16)), ("f", (16, 4))],
                           dict(a_seq_length_dim=1)),
    "reshape": ("RESHAPE", [("f", (2, 8, 16))], dict(shape=(2, 16, 8))),
    "transpose": ("TRANSPOSE", [("f", (2, 4, 8, 6))], dict(perm=(0, 2, 1, 3))),
    "reverse": ("REVERSE", [("f", (2, 8, 16))], dict(axis=1)),
    "cast_f16": ("CAST", [("f", (4, 16))], dict(dtype="HALF")),
    "cast_int64": ("CAST", [("idx", (4, 16), 50)], dict(dtype="INT64")),
    "constant": ("CONST", [], dict(value=("f", (3, 8)))),
    "constant_trainable": ("CONST", [], dict(value=("f", (3, 8)),
                                             trainable=True)),
    "where_mask": ("WHERE", [("mask", (2, 8)), ("f", (2, 8)), ("f", (1, 8))],
                   {}),
    "where_bcast": ("WHERE", [("mask", (8, 8)), ("f", (2, 4, 8, 8)),
                              ("f", ())], {}),
    "expand": ("EXPAND", [("f", (2, 1, 8))], dict(shape=(2, 5, 8))),
    "expand_rank": ("EXPAND", [("f", (8,))], dict(shape=(3, 8))),
    "einsum_outer": ("EINSUM", [("f", (2, 8)), ("f", (2, 8))],
                     dict(equation="bi,bj->bij")),
    "einsum_attn": ("EINSUM", [("f", (2, 4, 8, 16)), ("f", (2, 4, 6, 16))],
                    dict(equation="bhqd,bhkd->bhqk")),
    "einsum_implicit": ("EINSUM", [("f", (4, 8)), ("f", (8, 5))],
                        dict(equation="ij,jk")),
    "reduce_max": ("REDUCE_MAX", [("f", (2, 8, 16))],
                   dict(axes=(-1,), keepdims=True)),
    "reduce_max_two": ("REDUCE_MAX", [("f", (2, 8, 16))], dict(axes=(0, 2))),
    "gather": ("GATHER", [("f", (4, 8)), ("idx", (4, 3), 8)], dict(axis=1)),
    "gather_axis0": ("GATHER", [("f", (6, 5)), ("idx", (3, 5), 6)],
                     dict(axis=0)),
    "reduce_sum": ("REDUCE_SUM", [("f", (2, 8, 16))], dict(axes=(1,))),
    "reduce_sum_keep": ("REDUCE_SUM", [("f", (2, 8, 16))],
                        dict(axes=(1, 2), keepdims=True)),
    "mean": ("MEAN", [("f", (2, 8, 16))], dict(axes=(2,), keepdims=True)),
    "mean_two": ("MEAN", [("f", (2, 3, 4, 4))], dict(axes=(2, 3))),
    "top_k": ("TOPK", [("f", (4, 10))], dict(k=3)),
    "arg_top_k": ("ARG_TOPK", [("f", (2, 3, 10))], dict(k=4)),
}

# the fifteen builders' op types, each covered above
OP_TYPES = {"BATCHMATMUL", "RESHAPE", "TRANSPOSE", "REVERSE", "CAST", "CONST",
            "WHERE", "EXPAND", "EINSUM", "REDUCE_MAX", "GATHER", "REDUCE_SUM",
            "MEAN", "TOPK", "ARG_TOPK"}


def _array(spec, rs):
    kind, shape = spec[0], spec[1]
    if kind == "f":
        return np.asarray(rs.randn(*shape), np.float32)
    if kind == "mask":
        return (rs.rand(*shape) > 0.5).astype(np.float32)
    return rs.randint(0, spec[2], size=shape).astype(np.float32)


def _props(props, const, rs):
    out = {}
    for k, v in props.items():
        if k == "dtype":
            v = getattr(const.DataType, v)
        elif k == "value":
            v = _array(v, rs)
        out[k] = v
    return out


def _pair(case, seed=0):
    op_type, specs, props = CASES[case]
    rs = np.random.RandomState(seed)
    inputs = [_array(s, rs) for s in specs]
    shapes = [x.shape for x in inputs]
    value_seed = rs.randint(1 << 30)
    jl = JLayer(getattr(jconst.OperatorType, op_type), f"op_{case}", [])
    jl.properties.update(_props(props, jconst,
                                np.random.RandomState(value_seed)))
    pl = PLayer(getattr(pconst.OperatorType, op_type), f"op_{case}", [])
    pl.properties.update(_props(props, pconst,
                                np.random.RandomState(value_seed)))
    jop = JRegistry.create(jl, shapes)
    pop = PRegistry.create(pl, shapes)
    params = {k: (rs.randn(*np.shape(v)) * 0.3).astype(np.float32)
              for k, v in jop.init_params(jax.random.PRNGKey(0)).items()}
    return jop, pop, params, inputs


def _forward_both(jop, pop, params, inputs, training=False):
    want = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                       [jnp.asarray(x) for x in inputs],
                       JContext(training=training, compute_dtype=jnp.float32))
    got = pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                      [torch.from_numpy(x) for x in inputs],
                      PContext(training=training,
                               compute_dtype=torch.float32))
    return want, got


def test_every_builder_op_type_has_cases():
    assert {c[0] for c in CASES.values()} == OP_TYPES


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    jop, pop, params, inputs = _pair(case, seed=len(case))
    want, got = _forward_both(jop, pop, params, inputs)
    assert len(got) == len(want) == len(pop.output_shapes)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype.kind in "iu":
            # int32 in the JAX package, int64 here: the values agree
            assert g.dtype == torch.int64 and w.dtype == np.int32
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            assert g.dtype == getattr(torch, w.dtype.name)
            np.testing.assert_allclose(g.float().numpy(),
                                       w.astype(np.float32),
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_vjp_matches_jax(case):
    """Training-mode forward and its gradients with respect to every
    float input and parameter, through the first output; an index input
    (Gather's, an int cast's) is held fixed on both sides."""
    jop, pop, params, inputs = _pair(case, seed=len(case))
    op_type = CASES[case][0]
    fixed = {i for i, s in enumerate(CASES[case][1]) if s[0] == "idx"}
    if op_type == "CAST" and CASES[case][2]["dtype"] == "INT64":
        fixed = set()  # the cast's input is float (integral values)
    free = [i for i in range(len(inputs)) if i not in fixed]
    jctx = JContext(training=True, compute_dtype=jnp.float32)

    def jfn(p, xs):
        full = [jnp.asarray(x) for x in inputs]
        for i, x in zip(free, xs):
            full[i] = x
        return jop.forward(p, full, jctx)[0]

    want, vjp = jax.vjp(jfn, {k: jnp.asarray(v) for k, v in params.items()},
                        [jnp.asarray(inputs[i]) for i in free])
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = [torch.from_numpy(x) for x in inputs]
    for i in free:
        tx[i] = tx[i].clone().requires_grad_()
    got = pop.forward(tp, tx, PContext(training=True,
                                       compute_dtype=torch.float32))[0]
    if not got.is_floating_point():
        # an integer output: no gradient in either package
        assert not got.requires_grad
        cot = np.zeros(want.shape, jax.dtypes.float0)
        jp, jx = vjp(cot)
        for w in list(jp.values()) + list(jx):
            assert not np.asarray(w).any()
        return
    cot = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(cot).astype(want.dtype))
    if got.requires_grad:
        got.backward(torch.from_numpy(cot).to(got.dtype))
    pairs = [(tp[k].grad, want_gp[k]) for k in params]
    pairs += [(tx[i].grad, g) for i, g in zip(free, want_gx)]
    for g, w in pairs:
        w = np.asarray(w).astype(np.float32)
        g = (torch.zeros(w.shape) if g is None else g.float()).numpy()
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_metadata_matches_jax(case):
    jop, pop, params, _ = _pair(case)
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert pop.params_elems() == jop.params_elems()
    assert [[r.value for r in roles] for roles in pop.output_dim_roles()] \
        == [[r.value for r in roles] for roles in jop.output_dim_roles()]
    assert {k: tuple(v) for k, v in pop.param_shapes().items()} \
        == {k: v.shape for k, v in params.items()}
    ours = pop.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} \
        == {k: v.shape for k, v in params.items()}
    for attr in ("axis", "k"):
        assert getattr(pop, attr, None) == getattr(jop, attr, None)


def test_trainable_constant_starts_at_its_value():
    _, pop, _, _ = _pair("constant_trainable")
    (w,) = pop.init_params(torch.Generator().manual_seed(0)).values()
    np.testing.assert_array_equal(w.numpy(), pop.value)


def test_where_reads_a_float_condition_as_nonzero():
    """The fx sdpa translation hands Where a float tril constant as its
    condition: nonzero is true, as ``jnp.where`` reads it."""
    jop, pop, _, _ = _pair("where_mask")
    cond = np.array([[0.0, 1.0, -2.0, 0.5]], np.float32)
    a = np.ones((1, 4), np.float32)
    b = np.zeros((1, 4), np.float32)
    want, got = _forward_both(jop, pop, {}, [cond, a, b])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), [[0.0, 1.0, 1.0, 1.0]])


def _model_pair(build, batch=4):
    """One graph through both packages' FFModel builders, compiled for
    training with SGD and MSE on one device (port on the CPU)."""
    import flexflow_tpu as jff
    import flexflow_tpu_torch as pff
    from flexflow_tpu.optimizers import SGDOptimizer as JSGD
    from flexflow_tpu_torch.optimizers import SGDOptimizer as PSGD

    out = []
    for pkg, sgd, kw in ((jff, JSGD, {}), (pff, PSGD, {"device": "cpu"})):
        ff = pkg.FFModel(pkg.FFConfig(batch_size=batch, workers_per_node=1),
                         **kw)
        build(ff)
        ff.compile(sgd(lr=0.05), pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [])
        out.append(ff)
    return out


def _graph(ff):
    """Every builder of the surface in one differentiable graph."""
    x = ff.create_tensor((4, 8, 16))
    h = ff.dense(x, 16, name="proj")
    q = ff.reshape(h, (4, 8, 2, 8), name="q")
    q = ff.transpose(q, (0, 2, 1, 3), name="qt")
    s = ff.batch_matmul(q, ff.transpose(q, (0, 1, 3, 2), name="kt"),
                        name="scores")
    mask = ff.constant(np.tril(np.ones((8, 8), np.float32)), name="mask")
    neg = ff.constant(np.float32(-1e9), name="neg")
    s = ff.where(mask, s, neg, name="masked")
    s = ff.subtract(s, ff.reduce_max(s, [-1], keepdims=True, name="mx"),
                    name="shift")
    p = ff.exp(s, name="e")
    p = ff.divide(p, ff.reduce_sum(p, [-1], keepdims=True, name="den"),
                  name="p")
    o = ff.einsum("bhqk,bhkd->bhqd", [p, q], name="o")
    o = ff.reverse(ff.transpose(o, (0, 2, 1, 3), name="ot"), 1, name="rev")
    o = ff.reshape(o, (4, 8, 16), name="flat")
    pos = ff.constant(np.linspace(-1, 1, 16, dtype=np.float32), name="pos",
                      trainable=True)
    o = ff.add(o, ff.expand(pos, (4, 8, 16), name="pos_b"), name="add_pos")
    o = ff.cast(o, jconst_or_p(ff).DataType.FLOAT, name="cast")
    return ff.mean(o, [1], keepdims=False, name="pool")


def jconst_or_p(ff):
    return jconst if type(ff).__module__.startswith("flexflow_tpu.") \
        else pconst


def _carry(jm, pm):
    from flexflow_tpu_torch.weights import from_jax_params

    from_jax_params({l: {n: np.asarray(a) for n, a in sub.items()}
                     for l, sub in jm.params.items()}, pm)


def test_builders_predict_and_train_through_both_packages():
    """The builders in one graph (with a trainable constant carried by
    ``weights.from_jax_params``): predict at 1e-5, three SGD steps' losses
    at rtol 1e-4, and the trainable constant moves alike."""
    jm, pm = _model_pair(_graph)
    assert set(pm.params) == set(jm.params) and "pos" in pm.params
    _carry(jm, pm)
    rs = np.random.RandomState(0)
    x = rs.randn(4, 8, 16).astype(np.float32)
    y = rs.randn(4, 16).astype(np.float32)
    np.testing.assert_allclose(pm.predict(x), np.asarray(jm.predict(x)),
                               rtol=1e-5, atol=1e-5)
    before = pm.get_parameter("pos", "weight").copy()
    for _ in range(3):
        jm.fit(x, y, epochs=1, verbose=False)
        pm.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(pm._last_loss, float(jm._last_loss),
                               rtol=1e-4)
    after = pm.get_parameter("pos", "weight")
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, np.asarray(jm.params["pos"]["weight"]),
                               rtol=1e-4, atol=1e-6)


def test_top_k_and_gather_builders_run_through_both_packages():
    def build(ff):
        x = ff.create_tensor((4, 10))
        vals, idx = ff.top_k(x, 3, name="tk")
        arg = ff.arg_top_k(x, 3, name="atk")
        g = ff.gather(x, arg, axis=1, name="g")
        return ff.add(vals, g, name="out")

    jm, pm = _model_pair(build)
    x = np.random.RandomState(3).randn(4, 10).astype(np.float32)
    want = np.asarray(jm.predict(x))
    np.testing.assert_allclose(pm.predict(x), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want, 2 * -np.sort(-x, axis=1)[:, :3])


def test_begin_and_end_trace_are_no_ops():
    import flexflow_tpu_torch as pff

    ff = pff.FFModel(pff.FFConfig(batch_size=2), device="cpu")
    assert ff.begin_trace(1) is None and ff.end_trace(1) is None
