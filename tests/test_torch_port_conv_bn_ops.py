"""PyTorch port, BatchNorm, GroupNorm and Dropout against the JAX
package's ops.

Each case builds the same layer in both packages, gives both the same
parameters, inputs and (for BatchNorm) running statistics, random and
made with numpy from a seed, and compares the forward, the VJP (jax.vjp
against torch autograd, one random cotangent, for every input and
parameter) and BatchNorm's new running statistics, in f32 and in bf16
compute. BatchNorm runs in training and in eval, with and without state,
with its ReLU on and off; GroupNorm with its affine on and off; Dropout
at rate 0 in training and at 0.5 in eval (the identity both). Each op
given its input in ``torch.channels_last`` memory (as the layout pass
hands it channels-last values) gives its NCHW result and keeps the
memory format. Dropout at a rate above 0 draws from torch's generator,
which has no JAX twin: it is held to its statistics and its scale.

Tolerances, each against the largest magnitude of the value compared,
those of ``tests/test_torch_port_zoo_ops.py``: f32 1e-5, bf16 2^-6 (the
output is rounded to bf16 once on each side from f32 values computed in
different orders, so a value may land one bf16 step away; the VJP
rounds twice more). The running statistics are f32 on both sides: 1e-5.
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
STATE_TOL = 1e-5

# name -> (op type, input shapes, properties, training, with state)
CASES = {
    f"bn_{mode}_{st}_{relu}": (
        "BATCHNORM", [(4, 6, 5, 5)], dict(relu=relu == "relu"),
        mode == "train", st == "state")
    for mode in ("train", "eval") for st in ("state", "nostate")
    for relu in ("relu", "norelu")}
CASES.update({
    "gn_affine": ("GROUPNORM", [(2, 8, 5, 6)], dict(groups=4), True, False),
    "gn_noaffine": ("GROUPNORM", [(2, 6, 4, 4)],
                    dict(groups=3, affine=False, eps=1e-3), True, False),
    "gn_2d": ("GROUPNORM", [(4, 12)], dict(groups=2), True, False),
    "gn_3d": ("GROUPNORM", [(2, 8, 7)], dict(groups=4), True, False),
    "gn_per_channel": ("GROUPNORM", [(2, 6, 3, 5)], dict(groups=6), True,
                       False),
    "dropout_rate0_train": ("DROPOUT", [(4, 6, 3, 3)], dict(rate=0.0), True,
                            False),
    "dropout_eval": ("DROPOUT", [(4, 16)], dict(rate=0.5), False, False),
})


def _pair(case):
    op_type, shapes, props, training, with_state = CASES[case]
    jl = JLayer(getattr(jconst.OperatorType, op_type), f"op_{case}", [])
    jl.properties.update(props)
    pl = PLayer(getattr(pconst.OperatorType, op_type), f"op_{case}", [])
    pl.properties.update(props)
    jop, pop = JRegistry.create(jl, shapes), PRegistry.create(pl, shapes)
    rs = np.random.RandomState(len(case))
    params = {k: (1.0 + 0.3 * rs.randn(*np.shape(v))).astype(np.float32)
              for k, v in jop.init_params(jax.random.PRNGKey(0)).items()}
    inputs = [(rs.randn(*s) * 2 + 0.5).astype(np.float32) for s in shapes]
    state = None
    if with_state:
        c = shapes[0][1]
        state = {"mean": rs.randn(c).astype(np.float32),
                 "var": rs.uniform(0.5, 2.0, c).astype(np.float32)}
    return jop, pop, params, inputs, state, training


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def _port_forward(pop, params, xs, ctx, state):
    if state is None:
        return pop.forward(params, xs, ctx)[0], None
    (out,), new = pop.forward_with_state(params, xs, ctx, state)
    return out, new


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_vjp_match_jax(case, dname):
    """The forward in ``dname`` compute (inputs in that dtype, parameters
    and state f32, as the executor passes them), BatchNorm's new running
    statistics, then the VJP of one cotangent with respect to every
    input and parameter."""
    jop, pop, params, inputs, state, training = _pair(case)
    jdt, tdt = getattr(jnp, dname), getattr(torch, dname)
    jctx = JContext(training=training, compute_dtype=jdt)
    jstate = (None if state is None
              else {k: jnp.asarray(v) for k, v in state.items()})
    kw = {} if jstate is None else dict(state=jstate)
    want, vjp = jax.vjp(
        lambda p, xs: jop.forward(p, xs, jctx, **kw)[0],
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(x, jdt) for x in inputs])
    # the new state, out of a forward that is not traced
    jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                [jnp.asarray(x, jdt) for x in inputs], jctx, **kw)
    want_state = getattr(jop, "_new_state", None) if training else None
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = [torch.from_numpy(x).to(tdt).requires_grad_() for x in inputs]
    tstate = (None if state is None
              else {k: torch.from_numpy(v) for k, v in state.items()})
    got, new_state = _port_forward(
        pop, tp, tx, PContext(training=training, compute_dtype=tdt), tstate)
    assert got.dtype == tdt and str(want.dtype) == dname
    _close(got, want, TOL[dname])
    if want_state is not None:
        for k in ("mean", "var"):
            assert new_state[k].dtype == torch.float32
            assert not new_state[k].requires_grad
            _close(new_state[k], want_state[k], STATE_TOL)
    else:
        assert new_state is None
    cot = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    want_gp, want_gx = vjp(jnp.asarray(cot, jdt))
    got.backward(torch.from_numpy(cot).to(tdt))
    for k in params:
        _close(tp[k].grad, want_gp[k], TOL[dname])
    for x, w in zip(tx, want_gx):
        _close(x.grad, w, TOL[dname])


@pytest.mark.parametrize("case", ["bn_train_state_relu", "bn_eval_state_relu",
                                  "gn_affine", "gn_noaffine",
                                  "gn_per_channel", "dropout_rate0_train"])
def test_channels_last_mode_is_the_nchw_result(case):
    """A ``torch.channels_last`` value gives the NCHW value's output and
    new state, bit for bit, in channels-last memory."""
    _, pop, params, inputs, state, training = _pair(case)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    tstate = (None if state is None
              else {k: torch.from_numpy(v) for k, v in state.items()})
    ctx = PContext(training=training)
    x = torch.from_numpy(inputs[0])
    want, want_state = _port_forward(pop, tp, [x], ctx, tstate)
    got, got_state = _port_forward(
        pop, tp, [x.contiguous(memory_format=torch.channels_last)], ctx,
        tstate)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if want_state is not None:
        for k in want_state:
            torch.testing.assert_close(got_state[k], want_state[k],
                                       rtol=0, atol=1e-7)


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_metadata_matches_jax(case):
    jop, pop, params, _, _, _ = _pair(case)
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert pop.params_elems() == jop.params_elems()
    assert [[r.value for r in roles] for roles in pop.output_dim_roles()] \
        == [[r.value for r in roles] for roles in jop.output_dim_roles()]
    assert unity._node_attrs(pop) == junity._node_attrs(jop)
    assert unity._param_shapes(pop) == junity._param_shapes(jop)
    ours = pop.init_params(torch.Generator().manual_seed(0))
    theirs = jop.init_params(jax.random.PRNGKey(0))
    assert {k: v.numpy().tolist() for k, v in ours.items()} \
        == {k: np.asarray(v).tolist() for k, v in theirs.items()}
    if hasattr(jop, "init_state"):
        assert {k: v.numpy().tolist()
                for k, v in pop.init_state("cpu").items()} \
            == {k: np.asarray(v).tolist()
                for k, v in jop.init_state().items()}


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_statistics_and_scale(rate, dname):
    """In training, the share of zeros lies within 5 binomial standard
    deviations of ``rate``, every kept element is x / (1 - rate) rounded
    to x's dtype, the gradient is the mask times the scale, one generator
    seed gives one mask, and a second draw from the generator another."""
    _, pop, _, _, _, _ = _pair("dropout_eval")
    pop.rate = rate
    tdt = getattr(torch, dname)
    x = (torch.rand(64, 512, generator=torch.Generator().manual_seed(1))
         + 0.5).to(tdt).requires_grad_()
    ctx = PContext(training=True, compute_dtype=tdt,
                   rng=torch.Generator().manual_seed(5))
    (y,) = pop.forward({}, [x], ctx)
    (again,) = pop.forward({}, [x], PContext(
        training=True, compute_dtype=tdt,
        rng=torch.Generator().manual_seed(5)))
    (other,) = pop.forward({}, [x], ctx)
    assert y.dtype == tdt and torch.equal(y, again)
    assert not torch.equal(y, other)
    zero = y == 0
    share = zero.float().mean().item()
    assert abs(share - rate) <= 5 * (rate * (1 - rate) / zero.numel()) ** 0.5
    assert torch.equal(y[~zero], (x.detach() / (1.0 - rate))[~zero])
    y.backward(torch.ones_like(y))
    want_grad = torch.where(zero, 0.0, torch.ones_like(y) / (1.0 - rate))
    assert torch.equal(x.grad, want_grad.to(tdt))


def test_dropout_in_training_needs_a_generator():
    _, pop, _, inputs, _, _ = _pair("dropout_eval")
    with pytest.raises(ValueError, match="needs rng"):
        pop.forward({}, [torch.from_numpy(inputs[0])],
                    PContext(training=True))
