"""PyTorch port, the mixture-of-experts ops and models against the JAX
package: ``ops/moe.py`` (``make_dispatch_tensors``, GroupBy, Aggregate,
AggregateSpec, Cache), ``ops/experts.py`` (Experts), ``FFModel.moe`` /
``experts`` / ``group_by`` / ``aggregate`` / ``cache`` and
``models/moe_model.py``.

Inputs are made from a seed with numpy and fed to both packages; the
JAX side runs on one device (``workers_per_node=1``) in f32, as the
port does on the CPU. Overflow is forced (a capacity below the tokens
an expert receives) wherever a capacity is involved, so that the
flattening order of the capacity positions shows.

Tolerances:
- dispatch and combine tensors: exact (0/1 masks and one product);
- op forwards: atol and rtol 1e-5 (f32 sums in other orders);
- VJPs (jax.grad against torch autograd of ``<cot, out> + aux``): 1e-5
  of each gradient's largest magnitude;
- model losses over SGD and Adam steps from carried weights: rtol 1e-4;
  op state (Cache) after three steps: 1e-5 of its largest magnitude;
- the search's request and strategy JSON at 1 and 8 planned devices:
  exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.ffconst as jconst
import flexflow_tpu.search.native as jnative
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import MachineSpec as JMachineSpec
from flexflow_tpu.models.moe_model import (MoEConfig as JMoEConfig,
                                           create_moe as j_create_moe,
                                           create_moe_encoder as j_create_enc)
from flexflow_tpu.ops import OpRegistry as JRegistry
from flexflow_tpu.ops.base import OpContext as JContext
from flexflow_tpu.ops.moe import make_dispatch_tensors as j_dispatch
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec, make_mesh
from flexflow_tpu_torch.models import MoEConfig, create_moe, create_moe_encoder
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.base import OpContext as PContext
from flexflow_tpu_torch.ops.moe import (expert_capacity, load_balance_loss,
                                        make_dispatch_tensors)
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.search import native, unity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params, from_jax_state

FWD_TOL = 1e-5
VJP_TOL = 1e-5
LOSS_RTOL = 1e-4
STATE_TOL = 1e-5


def _starts():
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        s = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = s
        starts.append(s)
    return starts


def _settle():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def _softmax(z):
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


# ---- dispatch tensors ------------------------------------------------------

@pytest.mark.parametrize("b,k,e,alpha", [(16, 2, 4, 0.5), (12, 1, 3, 0.5),
                                         (32, 2, 8, 0.25), (8, 2, 4, 2.0)])
def test_dispatch_tensors_equal_the_references(b, k, e, alpha):
    """Exactly the JAX package's tensors, with tokens past an expert's
    capacity dropped: at alpha below 1 some expert overflows, and the
    positions follow the flattened [B*K, E] order."""
    rs = np.random.RandomState(b * 10 + e)
    assign = rs.randint(0, e, (b, k)).astype(np.int32)
    gates = rs.rand(b, k).astype(np.float32)
    cap = expert_capacity(b, k, e, alpha)
    want_d, want_c = j_dispatch(jnp.asarray(assign), jnp.asarray(gates), e,
                                cap)
    got_d, got_c = make_dispatch_tensors(torch.from_numpy(assign).long(),
                                         torch.from_numpy(gates), e, cap)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    counts = np.bincount(assign.ravel(), minlength=e)
    kept = got_d.numpy().sum()
    assert kept == np.minimum(counts, cap).sum()
    if alpha < 1:
        assert counts.max() > cap  # overflow was forced


# ---- the ops, forward and VJP ----------------------------------------------

def _op_pair(op_type, name, props, shapes):
    jl = JLayer(getattr(jconst.OperatorType, op_type), name, [])
    jl.properties.update(props)
    pl = PLayer(getattr(pconst.OperatorType, op_type), name, [])
    pl.properties.update(props)
    return JRegistry.create(jl, shapes), PRegistry.create(pl, shapes)


B, D, E, K, C_ALPHA = 16, 6, 4, 2, 0.5


def _case(name, seed=0):
    """(op type, props, input arrays, which inputs are differentiable,
    param arrays)."""
    rs = np.random.RandomState(seed)
    gate = _softmax(rs.randn(B, E).astype(np.float32))
    assign = np.argsort(-gate, axis=-1)[:, :K].astype(np.int32)
    preds = np.take_along_axis(gate, assign, -1)
    cap = expert_capacity(B, K, E, C_ALPHA)
    outs = [rs.randn(cap, D).astype(np.float32) for _ in range(E)]
    x = rs.randn(B, D).astype(np.float32)
    if name == "group_by":
        return ("GROUP_BY", dict(n=E, alpha=C_ALPHA), [x, assign], [0], {})
    if name in ("aggregate", "aggregate_aux", "aggregate_spec"):
        lam = 0.3 if name == "aggregate_aux" else 0.0
        op = "AGGREGATE_SPEC" if name == "aggregate_spec" else "AGGREGATE"
        return (op, dict(n=E, lambda_bal=lam),
                [preds, assign, assign, gate] + outs,
                [0, 3] + list(range(4, 4 + E)), {})
    if name == "cache":
        return ("CACHE", dict(num_batches=1), [x], [0], {})
    if name in ("experts", "experts_aux"):
        h = 5
        params = {"w_h": rs.randn(E, D, h).astype(np.float32) * 0.5,
                  "b_h": rs.randn(E, h).astype(np.float32) * 0.1,
                  "w_o": rs.randn(E, h, D).astype(np.float32) * 0.5,
                  "b_o": rs.randn(E, D).astype(np.float32) * 0.1}
        return ("EXPERTS", dict(n=E, k=K, hidden_size=h, alpha=C_ALPHA,
                                lambda_bal=0.3 if name == "experts_aux"
                                else 0.0),
                [x, gate], [0, 1], params)
    raise KeyError(name)


OP_CASES = ["group_by", "aggregate", "aggregate_aux", "aggregate_spec",
            "cache", "experts", "experts_aux"]


def _to_j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _to_p(arrs):
    return [torch.from_numpy(np.array(a)).long() if a.dtype.kind in "iu"
            else torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("name", OP_CASES)
def test_op_forward_matches_jax(name):
    op_type, props, xs, _, params = _case(name)
    jop, pop = _op_pair(op_type, f"op_{name}", props, [a.shape for a in xs])
    assert pop.output_shapes == jop.output_shapes
    assert pop.flops() == jop.flops()
    assert pop.params_elems() == jop.params_elems()
    assert [tuple(r.name for r in roles) for roles in pop.output_dim_roles()] \
        == [tuple(r.name for r in roles) for roles in jop.output_dim_roles()]
    if params:
        assert {k: tuple(v) for k, v in pop.param_shapes().items()} == {
            k: tuple(np.shape(v)) for k, v in
            jop.init_params(jax.random.PRNGKey(0)).items()}
    want = jop.forward({k: jnp.asarray(v) for k, v in params.items()},
                       _to_j(xs), JContext(training=True,
                                           compute_dtype=jnp.float32))
    got = pop.forward({k: torch.from_numpy(v) for k, v in params.items()},
                      _to_p(xs), PContext(training=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL,
                                   rtol=FWD_TOL)
    j_aux = getattr(jop, "_aux_loss", None)
    p_aux = (pop.forward_with_aux(
        {k: torch.from_numpy(v) for k, v in params.items()}, _to_p(xs),
        PContext(training=True))[1]
        if hasattr(pop, "forward_with_aux") else None)
    if props.get("lambda_bal", 0.0) > 0:
        assert j_aux is not None and p_aux is not None
        np.testing.assert_allclose(float(p_aux), float(j_aux), rtol=FWD_TOL)
    else:
        assert j_aux is None and p_aux is None


@pytest.mark.parametrize("name", OP_CASES)
def test_op_vjp_matches_jax(name):
    """Gradients of ``sum_i <cot_i, out_i> + aux`` with respect to every
    float input and parameter (the assignments held fixed)."""
    op_type, props, xs, free, params = _case(name, seed=1)
    jop, pop = _op_pair(op_type, f"op_{name}", props, [a.shape for a in xs])
    rs = np.random.RandomState(7)
    cots = [rs.randn(*s).astype(np.float32) for s in jop.output_shapes]
    jctx = JContext(training=True, compute_dtype=jnp.float32)

    def jfn(p, free_xs):
        full = _to_j(xs)
        for i, v in zip(free, free_xs):
            full[i] = v
        outs = jop.forward(p, full, jctx)
        total = sum(jnp.sum(o * c) for o, c in zip(outs, cots))
        aux = getattr(jop, "_aux_loss", None)
        jop._aux_loss = None
        return total + aux if aux is not None else total

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_p, want_x = jax.grad(jfn, argnums=(0, 1))(
        jp, [jnp.asarray(xs[i]) for i in free])
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = _to_p(xs)
    for i in free:
        tx[i] = tx[i].clone().requires_grad_()
    ctx = PContext(training=True)
    if hasattr(pop, "forward_with_aux"):
        outs, aux = pop.forward_with_aux(tp, tx, ctx)
    else:
        outs, aux = pop.forward(tp, tx, ctx), None
    total = sum(torch.sum(o * torch.from_numpy(c))
                for o, c in zip(outs, cots))
    if aux is not None:
        total = total + aux
    total.backward()
    pairs = [(tp[k].grad, want_p[k], k) for k in params]
    pairs += [(tx[i].grad, w, f"input {i}") for i, w in zip(free, want_x)]
    for g, w, what in pairs:
        w = np.asarray(w)
        scale = max(np.abs(w).max(), 1e-30)
        if g is None:  # an input the op does not read: JAX's zero grad
            assert not w.any(), what
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=VJP_TOL * scale, err_msg=what)


def test_cache_state_over_three_steps_matches_jax():
    """Cache's state threaded through three forwards: the cached input and
    the score (default the mean squared difference) equal the JAX op's
    ``_new_state`` each step; without state it only passes through."""
    shape = (4, 6)
    jop, pop = _op_pair("CACHE", "cache", dict(num_batches=1), [shape])
    jstate = jop.init_state()
    pstate = pop.init_state(torch.device("cpu"))
    assert {k: tuple(np.shape(v)) for k, v in jstate.items()} == {
        k: tuple(v.shape) for k, v in pstate.items()}
    rs = np.random.RandomState(3)
    for step in range(3):
        x = rs.randn(*shape).astype(np.float32)
        jout = jop.forward({}, [jnp.asarray(x)], JContext(training=True),
                           state=jstate)
        jstate, jop._new_state = jop._new_state, None
        pout, pstate = pop.forward_with_state({}, [torch.from_numpy(x)],
                                              PContext(training=True),
                                              pstate)
        np.testing.assert_array_equal(pout[0].numpy(), np.asarray(jout[0]))
        for k in ("cached", "score"):
            np.testing.assert_allclose(pstate[k].numpy(),
                                       np.asarray(jstate[k]),
                                       atol=STATE_TOL, rtol=STATE_TOL,
                                       err_msg=f"step {step} {k}")
        assert float(pstate["score"]) > 0
    assert pop.forward_with_state({}, [torch.zeros(shape)],
                                  PContext(), None)[1] is None


def test_load_balance_uses_all_topk_slots():
    """The reference's case (``tests/test_expert_parallel.py``): the aux
    loss is E * <f, P> with f the token fraction over ALL top-k slots."""
    b, d, e, k = 8, 4, 4, 2
    layer = PLayer(pconst.OperatorType.EXPERTS, "ex", [])
    layer.properties.update(dict(n=e, k=k, hidden_size=6, alpha=2.0,
                                 lambda_bal=1.0))
    op = PRegistry.create(layer, [(b, d), (b, e)])
    params = op.init_params(torch.Generator().manual_seed(0))
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(b, d).astype(np.float32))
    gate = _softmax(rs.randn(b, e).astype(np.float32))
    assign = np.asarray(jax.lax.top_k(jnp.asarray(gate), k)[1])
    p_mean = gate.mean(0)
    f_full = np.zeros(e)
    for col in range(k):
        f_full += np.bincount(assign[:, col], minlength=e)
    f_full /= b * k
    f_top1 = np.bincount(assign[:, 0], minlength=e) / b
    want_full = e * np.sum(f_full * p_mean)
    want_top1 = e * np.sum(f_top1 * p_mean)
    assert want_full != pytest.approx(want_top1)  # a discriminating gate
    _, aux = op.forward_with_aux(params, [x, torch.from_numpy(gate)],
                                 PContext(training=True))
    assert float(aux) == pytest.approx(want_full, rel=1e-5)


def test_experts_route_ties_as_lax_top_k():
    """A router whose probabilities tie (a uniform gate, and bf16-rounded
    ones): the experts' output and aux loss equal the JAX op's, which
    routes each token to the lower-indexed experts first."""
    b, d, e, k = 12, 4, 4, 2
    rs = np.random.RandomState(5)
    h = 3
    params = {"w_h": rs.randn(e, d, h).astype(np.float32),
              "b_h": rs.randn(e, h).astype(np.float32),
              "w_o": rs.randn(e, h, d).astype(np.float32),
              "b_o": rs.randn(e, d).astype(np.float32)}
    x = rs.randn(b, d).astype(np.float32)
    uniform = np.full((b, e), 1.0 / e, np.float32)
    rounded = np.asarray(jnp.asarray(
        _softmax(rs.randn(b, e).astype(np.float32) * 0.01)).astype(
        jnp.bfloat16).astype(jnp.float32))
    props = dict(n=e, k=k, hidden_size=h, alpha=0.5, lambda_bal=0.1)
    for gate in (uniform, rounded):
        jop, pop = _op_pair("EXPERTS", "ex", props, [(b, d), (b, e)])
        want = jop.forward({n: jnp.asarray(v) for n, v in params.items()},
                           _to_j([x, gate]), JContext(training=True))
        got, aux = pop.forward_with_aux(
            {n: torch.from_numpy(v) for n, v in params.items()},
            _to_p([x, gate]), PContext(training=True))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(float(aux), float(jop._aux_loss),
                                   rtol=FWD_TOL)


def test_experts_over_an_expert_axis_raise_naming_item_3():
    layer = PLayer(pconst.OperatorType.EXPERTS, "ex", [])
    layer.properties.update(dict(n=4, k=1, hidden_size=3,
                                 expert_parallel="expert"))
    op = PRegistry.create(layer, [(8, 4), (8, 4)])
    params = op.init_params(torch.Generator().manual_seed(0))
    ctx = PContext(training=True, mesh=make_mesh(4, {"expert": 4}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        op.forward(params, [torch.zeros(8, 4), torch.full((8, 4), 0.25)],
                   ctx)


# ---- the models ------------------------------------------------------------

FLAT = dict(batch_size=16, input_dim=32, num_exp=4, num_select=2,
            hidden_size=16)
ENC = dict(batch_size=4, num_encoder_layers=2, hidden_size=16, num_exp=2,
           num_select=1, seq_length=8, num_classes=5)
# name -> (model kind, config fields, fused, optimizer, loss)
MODELS = {
    "flat_fused_adam": ("flat", FLAT, True, "adam", "sce"),
    "flat_unfused_adam": ("flat", FLAT, False, "adam", "sce"),
    "flat_fused_sgd_overflow": ("flat", dict(FLAT, alpha=0.5), True, "sgd",
                                "sce"),
    "flat_unfused_sgd_overflow": ("flat", dict(FLAT, alpha=0.5), False,
                                  "sgd", "sce"),
    "encoder_sgd": ("enc", ENC, True, "sgd", "mse"),
    "encoder_adam_overflow": ("enc", dict(ENC, alpha=0.5, num_select=2),
                              True, "adam", "mse"),
    # tests/test_model_training.py's test_moe_trains_with_lb_loss
    "training_lb_sgd": ("blobs", dict(batch_size=64, input_dim=8,
                                      num_exp=4, num_select=2,
                                      hidden_size=16, num_classes=4),
                        True, "sgd", "sce"),
}
STEPS = 3


def _jax_unfused(cfg_kw):
    """The JAX package's create_moe with ``moe(fused=False)``."""
    cfg = JMoEConfig(**cfg_kw)
    ff = J.FFModel(J.FFConfig(batch_size=cfg.batch_size, workers_per_node=1))
    t = ff.create_tensor((cfg.batch_size, cfg.input_dim), name="input")
    t = ff.moe(t, cfg.num_exp, cfg.num_select, cfg.hidden_size, cfg.alpha,
               cfg.lambda_bal, fused=False, name="moe")
    t = ff.dense(t, cfg.num_classes, name="head")
    ff.softmax(t)
    return ff


def _blobs_model(pkg, kw):
    """``tests/test_model_training.py``'s MoE: input -> moe -> dense ->
    softmax, unnamed layers."""
    cfg = (pkg.FFConfig(batch_size=kw["batch_size"], workers_per_node=1)
           if pkg is J else pkg.FFConfig(batch_size=kw["batch_size"]))
    ff = pkg.FFModel(cfg) if pkg is J else pkg.FFModel(cfg, device="cpu")
    t = ff.create_tensor((kw["batch_size"], kw["input_dim"]))
    t = ff.moe(t, num_exp=kw["num_exp"], num_select=kw["num_select"],
               expert_hidden_size=kw["hidden_size"], alpha=2.0,
               lambda_bal=0.04)
    t = ff.dense(t, kw["num_classes"])
    ff.softmax(t)
    return ff


def build_pair(name, lambda_bal=None):
    kind, kw, fused, opt, loss = MODELS[name]
    kw = dict(kw) if lambda_bal is None else dict(kw, lambda_bal=lambda_bal)
    starts = _starts()
    if kind == "blobs":
        jff = _blobs_model(J, kw)
    elif kind == "flat":
        jff = (j_create_moe(JMoEConfig(**kw), J.FFConfig(
            batch_size=kw["batch_size"], workers_per_node=1))
            if fused else _jax_unfused(kw))
    else:
        jff = j_create_enc(JMoEConfig(**kw), J.FFConfig(
            batch_size=kw["batch_size"], workers_per_node=1))
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    if kind == "blobs":
        pff = _blobs_model(P, kw)
    elif kind == "flat":
        pff = create_moe(MoEConfig(**kw), P.FFConfig(
            batch_size=kw["batch_size"]), device="cpu", fused=fused)
    else:
        pff = create_moe_encoder(MoEConfig(**kw), P.FFConfig(
            batch_size=kw["batch_size"]), device="cpu")
    _settle()
    jl = (J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY if loss == "sce"
          else J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    pl = getattr(P.LossType, jl.name)
    if opt == "adam":
        jff.compile(JAdam(alpha=1e-2), jl, [])
        pff.compile(AdamOptimizer(alpha=1e-2), pl, [])
    else:
        jff.compile(JSGD(lr=0.1), jl, [])
        pff.compile(SGDOptimizer(lr=0.1), pl, [])
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    return jff, pff


def batch_of(name, seed=0):
    kind, kw, *_ = MODELS[name]
    rs = np.random.RandomState(seed)
    bsz = kw["batch_size"]
    if kind in ("flat", "blobs"):
        x = rs.randn(bsz, kw["input_dim"]).astype(np.float32)
        y = rs.randint(0, kw.get("num_classes", 10),
                       (bsz, 1)).astype(np.int32)
    else:
        x = rs.randn(bsz, kw["seq_length"], kw["hidden_size"]).astype(
            np.float32)
        y = rs.randn(bsz, kw["seq_length"], kw["num_classes"]).astype(
            np.float32)
    return x, y


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_trains_as_the_reference(name):
    """The same graph (layer names, op types, shapes, parameter tree),
    ``predict`` before training, then STEPS ``fit`` steps, each loss (the
    load-balance terms included) within LOSS_RTOL of the JAX model's, and
    the parameters after them."""
    jff, pff = build_pair(name)
    assert [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in pff.executor.nodes] \
        == [(n.op.name, n.op.op_type.name, n.op.output_shapes)
            for n in jff.executor.nodes]
    x, y = batch_of(name)
    want = np.asarray(jff.predict(x))
    got = pff.predict(x)
    np.testing.assert_allclose(got, want, atol=FWD_TOL * np.abs(want).max(),
                               rtol=0)
    for step in range(STEPS):
        xs, ys = batch_of(name, seed=step + 1)
        jff.fit(xs, ys, epochs=1, verbose=False)
        pff.fit(xs, ys, epochs=1, verbose=False)
        np.testing.assert_allclose(pff._last_loss, float(jff._last_loss),
                                   rtol=LOSS_RTOL, err_msg=f"step {step}")
    for op, sub in jff.params.items():
        for pn, w in sub.items():
            w = np.asarray(w)
            np.testing.assert_allclose(
                pff.params[op][pn].numpy(), w, rtol=0,
                atol=1e-3 * max(np.abs(w).max(), 1e-6),
                err_msg=f"{op}/{pn}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_load_balance_term_is_in_the_objective(fused):
    """The loss at lambda_bal 0.04 minus the loss at 0, from the same
    weights and batch, is the recomputed load-balance term; the JAX
    package's loss at 0.04 is the port's. Eval leaves the term out."""
    name = "flat_fused_adam" if fused else "flat_unfused_adam"
    jff, pff = build_pair(name, lambda_bal=0.04)
    _, pff0 = build_pair(name, lambda_bal=0.0)
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff0)
    x, y = batch_of(name, seed=9)
    ex = pff.executor
    inputs = {"input": torch.from_numpy(x)}
    labels = torch.from_numpy(y)
    loss = float(ex.grads_of(pff.params, pff.state, inputs, labels)[0])
    loss0 = float(pff0.executor.grads_of(pff0.params, pff0.state, inputs,
                                         labels)[0])
    # the term, from the router's probabilities
    from flexflow_tpu_torch.ops.reduce import top_k
    g = pff.params["moe_gate"]
    probs = torch.softmax(torch.from_numpy(x) @ g["kernel"] + g["bias"], -1)
    assign = top_k(probs, MODELS[name][1]["num_select"])[1]
    term = float(load_balance_loss(assign, probs, 4, 0.04))
    assert term > 0
    np.testing.assert_allclose(loss - loss0, term, rtol=1e-4)
    jff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(loss, float(jff._last_loss), rtol=LOSS_RTOL)
    # eval: the plain loss, no term
    ev = pff0.evaluate(x, y)["loss"]
    ev_aux = pff.evaluate(x, y)["loss"]
    np.testing.assert_allclose(ev_aux, loss0, rtol=LOSS_RTOL)
    np.testing.assert_allclose(ev, loss0, rtol=LOSS_RTOL)


def test_cache_model_state_and_weights_carry_across():
    """A model with a Cache between two dense layers, trained 3 SGD
    steps in both packages: the losses and Cache's state (the last
    batch's activation and its score against the one before) agree, and
    ``from_jax_state`` carries the JAX state into the port."""
    starts = _starts()
    jff = J.FFModel(J.FFConfig(batch_size=8, workers_per_node=1))
    t = jff.create_tensor((8, 6))
    t = jff.cache(jff.dense(t, 5, name="d1"), name="cache")
    jff.dense(t, 3, name="d2")
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    pff = P.FFModel(P.FFConfig(batch_size=8), device="cpu")
    t = pff.create_tensor((8, 6))
    t = pff.cache(pff.dense(t, 5, name="d1"), name="cache")
    pff.dense(t, 3, name="d2")
    _settle()
    jff.compile(JSGD(lr=0.1), J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    pff.compile(SGDOptimizer(lr=0.1),
                P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    rs = np.random.RandomState(2)
    for step in range(3):
        x = rs.randn(8, 6).astype(np.float32)
        y = rs.randn(8, 3).astype(np.float32)
        jff.fit(x, y, epochs=1, verbose=False)
        pff.fit(x, y, epochs=1, verbose=False)
        np.testing.assert_allclose(pff._last_loss, float(jff._last_loss),
                                   rtol=LOSS_RTOL)
        for k in ("cached", "score"):
            w = np.asarray(jff.state["cache"][k])
            np.testing.assert_allclose(
                pff.state["cache"][k].numpy(), w, rtol=0,
                atol=STATE_TOL * max(np.abs(w).max(), 1e-6),
                err_msg=f"step {step} {k}")
    fresh = P.FFModel(P.FFConfig(batch_size=8), device="cpu")
    t = fresh.create_tensor((8, 6))
    fresh.dense(fresh.cache(fresh.dense(t, 5, name="d1"), name="cache"), 3,
                name="d2")
    fresh.compile(SGDOptimizer(lr=0.1),
                  P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    from_jax_state(jax.tree.map(np.asarray, jff.state), fresh)
    np.testing.assert_array_equal(fresh.state["cache"]["cached"].numpy(),
                                  np.asarray(jff.state["cache"]["cached"]))


def test_stacked_expert_leaves_carry_and_a_transposed_leaf_is_refused():
    """``from_jax_params`` copies the stacked ``w_h [E, D, H]`` ... leaves
    bit for bit; a ``w_h`` given as ``[E, H, D]`` (D != H) is refused."""
    jff, pff = build_pair("flat_fused_sgd_overflow")
    jp = jax.tree.map(np.asarray, jff.params)
    for pn in ("w_h", "b_h", "w_o", "b_o"):
        np.testing.assert_array_equal(pff.params["moe_experts"][pn].numpy(),
                                      jp["moe_experts"][pn])
    e, d, h = jp["moe_experts"]["w_h"].shape
    assert d != h
    bad = {k: dict(v) for k, v in jp.items()}
    bad["moe_experts"]["w_h"] = np.transpose(jp["moe_experts"]["w_h"],
                                             (0, 2, 1))
    with pytest.raises(ValueError, match="moe_experts/w_h"):
        from_jax_params(bad, pff)


# ---- the search ------------------------------------------------------------

# a flat MoE whose experts the JAX search shards over an expert axis at 8
# devices (an "_ep" choice)
FAT = dict(batch_size=64, input_dim=1024, num_exp=8, num_select=2,
           hidden_size=4096)
SEARCH_MODELS = {"moe": ("flat", FLAT), "moe_encoder": ("enc", ENC),
                 "moe_unfused": ("unfused", FLAT), "moe_fat": ("flat", FAT)}


def _search_pair(name):
    kind, kw = SEARCH_MODELS[name]
    starts = _starts()
    jcfg = J.FFConfig(batch_size=kw["batch_size"], workers_per_node=1)
    pcfg = P.FFConfig(batch_size=kw["batch_size"])
    if kind == "unfused":
        jff = _jax_unfused(kw)
    else:
        jb = j_create_moe if kind == "flat" else j_create_enc
        jff = jb(JMoEConfig(**kw), jcfg)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    if kind == "unfused":
        pff = create_moe(MoEConfig(**kw), pcfg, device="cpu", fused=False)
    else:
        pb = create_moe if kind == "flat" else create_moe_encoder
        pff = pb(MoEConfig(**kw), pcfg, device="cpu")
    _settle()
    return jff, pff


def _search(ff, mod, spec, n):
    nodes, tensor_ref = ff._materialize_nodes()[::2]
    final = ff._select_final_ref(nodes, tensor_ref)
    cfg = ff.config
    cfg.search_budget = 2
    mode = jconst.CompMode if isinstance(ff, J.FFModel) else pconst.CompMode
    cfg.computation_mode = mode.TRAINING
    cfg.opt_state_factor = 2.0
    mesh, st, info = mod.graph_optimize(
        nodes, spec(chip="cpu-sim", chips_per_slice=n), cfg, n,
        batch=ff.input_tensors[0].shape[0], final_ref=final)
    return mod.strategy_json(mesh, st, info.get("rewritten_nodes", nodes),
                             objective=info["objective"]), info


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("name", sorted(SEARCH_MODELS))
def test_search_request_and_strategy_match(name, n, monkeypatch):
    """The request each package hands its native core, the strategy JSON
    and the predicted time, at ``n`` planned devices."""
    seen = {"jax": [], "port": []}
    for mod, key in ((jnative, "jax"), (native, "port")):
        real = mod.native_optimize

        def spy(req, real=real, key=key):
            seen[key].append(json.loads(json.dumps(req)))
            return real(req)
        monkeypatch.setattr(mod, "native_optimize", spy)
    jff, pff = _search_pair(name)
    want, jinfo = _search(jff, junity, JMachineSpec, n)
    got, pinfo = _search(pff, unity, MachineSpec, n)
    assert json.dumps(seen["port"], sort_keys=True) \
        == json.dumps(seen["jax"], sort_keys=True)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert pinfo["predicted_time"] == jinfo["predicted_time"]
    if name == "moe_fat" and n == 8:
        assert got["mesh"].get("expert", 1) > 1
        assert "_ep" in got["ops"]["moe_experts"]["choice"]


def test_an_expert_parallel_strategy_is_recorded_and_refused(tmp_path):
    """The 8-device ``_ep`` strategy the search picks for the fat MoE, as
    a strategy file: ``compile`` records the expert axis on the Experts
    op, then refuses the mesh, naming item 3, before allocating."""
    _, pff = _search_pair("moe_fat")
    st, _ = _search(pff, unity, MachineSpec, 8)
    path = tmp_path / "ep.json"
    path.write_text(json.dumps(st))
    _, fresh = _search_pair("moe_fat")
    fresh.config.import_strategy_file = str(path)
    fresh.config.search_budget = 0
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        fresh.compile(SGDOptimizer(lr=0.01),
                      P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    experts = next(n.op for n in fresh.executor.nodes
                   if n.op.op_type.name == "EXPERTS")
    assert experts.expert_parallel == "expert"
    assert fresh.params == {}


def test_roofline_cli_counts_the_references_moe_rows(tmp_path, monkeypatch,
                                                     capsys):
    """``python -m flexflow_tpu_torch.scripts.roofline --model moe
    --device cpu``: the JAX script's CPU configuration of the flat MoE,
    each row's op type, FLOPs and bytes the JAX ops' (the Experts op's
    FLOPs count the routing einsums)."""
    from flexflow_tpu.search.profile import op_io_bytes
    from flexflow_tpu_torch.scripts import roofline as proofline
    from flexflow_tpu_torch.search import profile

    monkeypatch.setattr(profile, "_MIN_DELTA_S", 0.002)
    out = str(tmp_path / "rf")
    assert proofline.main(["--model", "moe", "--device", "cpu", "--no-bwd",
                           "--repeats", "1", "--out", out]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["model"] == "moe" and line["batch"] == 8
    rep = json.load(open(out + ".json"))
    jff = j_create_moe(JMoEConfig(batch_size=8, input_dim=64, num_exp=4,
                                  num_select=2, hidden_size=32),
                       J.FFConfig(batch_size=8, workers_per_node=1))
    nodes, _, _ = jff._materialize_nodes()
    want = [(n.op.op_type.name, float(n.op.flops()), op_io_bytes(n.op, 4.0))
            for n in nodes]
    got = [(r["type"], r["flops"], r["bytes"]) for r in rep["rows"]]
    assert got == want and "EXPERTS" in [t for t, _, _ in got]
