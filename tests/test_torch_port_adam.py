"""PyTorch port, the fused Adam update (K4) and the optimizers against the
JAX package.

The port's ``fused_adam_multi`` on CPU tensors runs its plain version,
``fused_adam_reference`` (``_adam_math`` leaf by leaf); the JAX side runs
its ``_adam_math`` and the Pallas kernel ``fused_adam_leaf`` in interpret
mode. Inputs are made from a seed with numpy and handed to both.

Tolerances:
- Against the JAX package: at most 1 ulp, in the stored dtype (f32 p; f32
  or bf16 m, v), of the leaf's largest |value|. Bit-equality does not hold
  on the CPU: XLA's CPU backend contracts ``a * b + c`` into fused
  multiply-adds (one rounding where the expression has two), and
  PyTorch's AVX-512 ``sqrt`` on the CPU is not correctly rounded. Where a
  sum cancels, one rounding of its terms is a large share of a small
  result, hence the leaf-scale ulp. (On the card the CUDA kernel is held
  bit-equal to the plain version, whose CUDA ops round once each.)
- alpha_t against the JAX package's: at most 1 f32 ulp (the two ``pow``
  implementations may differ by one).
- The fused update against the port's own ``optimizer.update``: bit-equal.
"""

import ml_dtypes
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.fused_update import _adam_math as j_adam_math
from flexflow_tpu.ops.fused_update import fused_adam_leaf
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                 fused_adam_reference,
                                                 fused_optimizer_update)
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.weights import _tensor_like

BETAS = dict(beta1=0.9, beta2=0.999, eps=1e-8)
# leaf shapes: lane-aligned ones take the Pallas kernel on the JAX side,
# the others its XLA route (same math); the port's kernel takes any size
SHAPES = [(64, 128), (1000,), (3, 7), (1,)]


def _t(a) -> torch.Tensor:
    """numpy (bf16 as ml_dtypes) -> CPU tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def _ulps(a, b) -> float:
    """Largest |a - b| in ulps of the largest |b| of the leaf, in b's
    dtype (f32 or bf16)."""
    a, b = np.asarray(a), np.asarray(b)
    mant = 7 if b.dtype == ml_dtypes.bfloat16 else 23
    a, b = a.astype(np.float64), b.astype(np.float64)
    scale = max(float(np.abs(b).max()), 1e-38)
    return float(np.abs(a - b).max() / 2.0 ** (np.floor(np.log2(scale)) - mant))


def _leaf(shape, sdt, seed):
    rs = np.random.RandomState(seed)
    p = rs.randn(*shape).astype(np.float32)
    g = (rs.randn(*shape) * 1e-2).astype(np.float32)
    m = (rs.randn(*shape) * 1e-2).astype(sdt)
    v = (rs.rand(*shape) * 1e-4).astype(sdt)
    return p, g, m, v


def _jax_alpha_t(opt, t):
    """The JAX package's alpha_t of step t (f32), as its update forms it."""
    tf = jnp.asarray(t, jnp.float32)
    return opt.alpha * jnp.sqrt(1.0 - opt.beta2 ** tf) / (1.0 - opt.beta1 ** tf)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("sdt", [np.float32, ml_dtypes.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_adam_matches_jax(monkeypatch, sdt, t, wd):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
    a = np.float32(_jax_alpha_t(JAdam(alpha=1e-3), t))
    leaves = [_leaf(s, sdt, seed=i + 10 * t) for i, s in enumerate(SHAPES)]
    got = fused_adam_reference(
        *[[_t(x[i]) for x in leaves] for i in range(4)], torch.tensor(a),
        wd=wd, **BETAS)
    for leaf, out in zip(leaves, got):
        out = [_np(x) for x in out]
        j = [jnp.asarray(x) for x in leaf]
        for ref in (j_adam_math(*j, a, wd=wd, **BETAS),
                    fused_adam_leaf(*j, a, wd=wd, **BETAS)):
            for o, r in zip(out, ref):
                assert o.dtype == np.asarray(r).dtype
                assert _ulps(o, r) <= 1.0


def test_fused_multi_updates_in_place_on_cpu():
    leaves = [_leaf(s, ml_dtypes.bfloat16, seed=i) for i, s in
              enumerate(SHAPES)]
    ps, gs, ms, vs = ([_t(x[i]) for x in leaves] for i in range(4))
    a = torch.tensor(np.float32(3e-4))
    want = fused_adam_reference(ps, gs, ms, vs, a, wd=0.01, **BETAS)
    ids = [x.data_ptr() for x in ps + ms + vs]
    before = fused_adam_multi.launches
    fused_adam_multi(ps, gs, ms, vs, a, wd=0.01, **BETAS)
    assert fused_adam_multi.launches == before  # CPU: no kernel launch
    assert [x.data_ptr() for x in ps + ms + vs] == ids
    for got, w in zip(zip(ps, ms, vs), want):
        for x, y in zip(got, w):
            assert torch.equal(x, y)


def _tree(sdt=torch.float32, seed=0):
    """A small {op: {param: tensor}} tree: params, grads, and Adam state
    after a few steps."""
    rs = np.random.RandomState(seed)
    shapes = {"ffn": {"kernel": (16, 8), "bias": (8,)},
              "ln": {"scale": (16,), "bias": (16,)},
              "attn": {"wq": (2, 16, 8), "bo": (16,)}}
    mk = lambda s, k=1.0: {op: {n: torch.from_numpy(
        (rs.randn(*shp) * k).astype(np.float32)) for n, shp in sub.items()}
        for op, sub in s.items()}
    params, grads = mk(shapes), mk(shapes, 1e-2)
    m = {op: {n: x.to(sdt) for n, x in sub.items()}
         for op, sub in mk(shapes, 1e-2).items()}
    v = {op: {n: x.abs().to(sdt) for n, x in sub.items()}
         for op, sub in mk(shapes, 1e-2).items()}
    return params, grads, m, v


@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_fused_optimizer_update_equals_adam_update(sdt):
    """The _k:fused route (ffn, ln) and the plain route (attn) in one
    update give what AdamOptimizer.update gives for the whole tree, to
    the bit."""
    params, grads, m, v = _tree(sdt)
    opt = AdamOptimizer(alpha=1e-3, weight_decay=0.01, state_dtype=sdt)
    state = {"m": m, "v": v, "t": torch.tensor(4, dtype=torch.int32)}
    clone = lambda tr: {op: {n: x.clone() for n, x in sub.items()}
                        for op, sub in tr.items()}
    want_p, want_s = opt.update(grads, state, params)
    got_p, got_s = fused_optimizer_update(
        opt, grads, {"m": clone(m), "v": clone(v), "t": state["t"]},
        clone(params), {"ffn", "ln"})
    assert list(got_p) == list(params)
    assert int(got_s["t"]) == int(want_s["t"]) == 5
    for op in params:
        for n in params[op]:
            assert torch.equal(got_p[op][n], want_p[op][n])
            assert torch.equal(got_s["m"][op][n], want_s["m"][op][n])
            assert torch.equal(got_s["v"][op][n], want_s["v"][op][n])


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_fused_optimizer_update_equals_sgd_update(momentum, nesterov):
    params, grads, m, _ = _tree()
    opt = SGDOptimizer(lr=0.1, momentum=momentum, nesterov=nesterov,
                       weight_decay=1e-3)
    state = {"v": m} if momentum else {}
    want_p, want_s = opt.update(grads, state, params)
    got_p, got_s = fused_optimizer_update(opt, grads, state, params,
                                          {"ffn"})
    for op in params:
        for n in params[op]:
            assert torch.equal(got_p[op][n], want_p[op][n])
            if momentum:
                assert torch.equal(got_s["v"][op][n], want_s["v"][op][n])


def test_adam_update_matches_jax_on_a_carried_state():
    """One AdamOptimizer.update from a mid-training state (t = 5, bf16
    moments, weight decay) in both packages; the JAX state is carried into
    the port leaf for leaf, so bias correction resumes at step 6."""
    params, grads, m, v = _tree(torch.bfloat16, seed=3)
    jopt = JAdam(alpha=1e-3, weight_decay=0.01, state_dtype=jnp.bfloat16)
    popt = AdamOptimizer(alpha=1e-3, weight_decay=0.01,
                         state_dtype=torch.bfloat16)
    to_j = lambda tr: jax.tree.map(lambda x: jnp.asarray(_np(x)), tr)
    jstate = {"m": to_j(m), "v": to_j(v), "t": jnp.asarray(5, jnp.int32)}
    jp, js = jopt.update(to_j(grads), jstate, to_j(params))
    pstate = popt.init(params)
    pstate["m"] = {op: {n: _tensor_like(np.asarray(a), pstate["m"][op][n], n)
                        for n, a in sub.items()}
                   for op, sub in jstate["m"].items()}
    pstate["v"] = {op: {n: _tensor_like(np.asarray(a), pstate["v"][op][n], n)
                        for n, a in sub.items()}
                   for op, sub in jstate["v"].items()}
    pstate["t"] = torch.tensor(5, dtype=torch.int32)
    pp, ps = popt.update(grads, pstate, params)
    _, alpha_t = popt.step_scalars(pstate["t"])
    assert alpha_t.dtype == torch.float32
    assert _ulps(alpha_t.numpy(), _jax_alpha_t(jopt, 6)) <= 1.0
    assert int(ps["t"]) == int(js["t"]) == 6
    for op in params:
        for n in params[op]:
            assert _ulps(pp[op][n].numpy(), np.asarray(jp[op][n])) <= 1.0
            assert _ulps(_np(ps["m"][op][n]), np.asarray(js["m"][op][n])) <= 1
            assert _ulps(_np(ps["v"][op][n]), np.asarray(js["v"][op][n])) <= 1


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_update_matches_jax(nesterov):
    params, grads, mom, _ = _tree(seed=4)
    kw = dict(lr=0.05, momentum=0.9, nesterov=nesterov, weight_decay=1e-3)
    to_j = lambda tr: jax.tree.map(lambda x: jnp.asarray(x.numpy()), tr)
    jp, js = JSGD(**kw).update(to_j(grads), {"v": to_j(mom)}, to_j(params))
    pp, ps = SGDOptimizer(**kw).update(grads, {"v": mom}, params)
    for op in params:
        for n in params[op]:
            assert _ulps(pp[op][n].numpy(), np.asarray(jp[op][n])) <= 1.0
            assert _ulps(ps["v"][op][n].numpy(),
                         np.asarray(js["v"][op][n])) <= 1.0


def test_adam_init_matches_jax_layout():
    params, _, _, _ = _tree()
    st = AdamOptimizer(state_dtype=torch.bfloat16).init(params)
    assert st["t"].dtype == torch.int32 and int(st["t"]) == 0
    assert all(x.dtype == torch.bfloat16 and not x.any()
               for sub in st["m"].values() for x in sub.values())
    assert SGDOptimizer().init(params) == {}


def test_other_devices_raise():
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fused_adam_multi([x], [x], [x], [x], torch.tensor(1.0), wd=0.0,
                         **BETAS)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernel has no CPU mode "
                    "(run with python3 chip_smoke.py or pytest -m cuda on "
                    "the H100)")


@pytest.mark.cuda
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_kernel_is_bit_equal_to_plain_version_on_card(cuda_card, sdt):
    """On the card: one launch over leaves of every size class, bit-equal
    to _adam_math run leaf by leaf with PyTorch's own kernels."""
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(1024, 1024), (4096,), (1000,), (3, 7), (1,)]
    ps = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    gs = [(torch.randn(s, generator=g, device="cuda") * 1e-2).bfloat16()
          for s in shapes]
    ms = [(torch.randn(s, generator=g, device="cuda") * 1e-2).to(sdt)
          for s in shapes]
    vs = [(torch.rand(s, generator=g, device="cuda") * 1e-4).to(sdt)
          for s in shapes]
    a = torch.tensor(3e-4, device="cuda")
    want = fused_adam_reference(ps, gs, ms, vs, a, wd=0.01, **BETAS)
    before = fused_adam_multi.launches
    fused_adam_multi(ps, gs, ms, vs, a, wd=0.01, **BETAS)
    torch.cuda.synchronize()
    assert fused_adam_multi.launches == before + 1
    for got, w in zip(zip(ps, ms, vs), want):
        for x, y in zip(got, w):
            assert torch.equal(x, y)
