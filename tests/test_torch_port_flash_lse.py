"""PyTorch port, K5 (``flash_attention_lse``) against the JAX package.

K5 is flash attention with o in f32 and an lse that is differentiated
too: the block that ring attention merges. The port's
``flash_attention_lse`` / ``FlashAttentionLSE`` on CPU tensors run the
plain versions (``flash_lse_reference`` forward, ``flash_bwd_reference``
backward with g_lse); the JAX side runs
``pallas_kernels.flash_attention_lse`` in interpret mode
(``FLEXFLOW_TPU_PALLAS=interpret``, as ``tests/test_ring_flash_attention.py``
sets it) and the einsum path ``_xla_attention_lse`` through ``jax.vjp``.
Inputs are made from a seed with numpy and handed to both.

Tolerances (f32 on both sides, sums in other orders): the forward's o and
lse at atol/rtol 1e-5; the VJP with a nonzero g_lse at atol 1e-4 of each
gradient's max |value| and rtol 1e-4 (the einsum path normalises P
before its products, the plain version after, and g_lse enters every
score's gradient); the plain VJP against the Pallas backward at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas_kernels import (_xla_attention_lse,
                                             flash_attention_lse as jax_lse)
from flexflow_tpu_torch.ops.flash_attention import (
    BWD_ARGTYPES, FlashAttentionLSE, bwd_launch_args, bwd_scratch,
    flash_attention_lse, flash_bwd, flash_bwd_reference, flash_fwd,
    flash_lse_reference, fwd_launch_args)

TOL = 1e-5
VJP_TOL = 1e-4
CASES = [(s, d, causal) for s in (128, 256) for d in (8, 64)
         for causal in (False, True)]
IDS = [f"S{s}-D{d}-{'causal' if c else 'full'}" for s, d, c in CASES]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernels have no CPU mode "
                    "(run with python3 chip_smoke.py or pytest -m cuda on "
                    "the H100)")


def _inputs(bh, s, d, seed):
    """numpy q, k, v, dO and g_lse."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(bh, s, d).astype(np.float32) for _ in range(4))
    return q, k, v, do, rs.randn(bh, s).astype(np.float32)


def _port_vjp(q, k, v, do, glse, causal):
    """(o, lse, dq, dk, dv) of ``FlashAttentionLSE`` on CPU tensors."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = FlashAttentionLSE.apply(q, k, v, causal)
    grads = torch.autograd.grad((o, lse), (q, k, v),
                                (torch.from_numpy(do), torch.from_numpy(glse)))
    return (o.detach(), lse.detach()) + grads


def _assert_scaled(got, want, tol):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=tol,
                                   atol=tol * np.abs(w).max())


@pytest.mark.parametrize("s,d,causal", CASES, ids=IDS)
def test_plain_matches_pallas_flash_attention_lse(interpret, s, d, causal):
    """The forward: o in f32 and lse, against the Pallas kernel in
    interpret mode."""
    q, k, v, _, _ = _inputs(2, s, d, seed=s + d + causal)
    fwd0, lse0 = flash_fwd.launches, flash_fwd.lse_launches
    o, lse = flash_attention_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal)
    assert (flash_fwd.launches, flash_fwd.lse_launches) == (fwd0, lse0)
    assert o.dtype == torch.float32 and lse.shape == (2, s)
    jo, jlse = jax_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("s,d,causal", CASES, ids=IDS)
def test_vjp_with_lse_gradient_matches_jax(s, d, causal):
    """``FlashAttentionLSE``'s VJP with a nonzero g_lse against ``jax.vjp``
    of the JAX package's einsum path ``_xla_attention_lse``."""
    q, k, v, do, glse = _inputs(2, s, d, seed=10 + s + d + causal)
    got = _port_vjp(q, k, v, do, glse, causal)
    (jo, jlse), vjp = jax.vjp(
        lambda a, b, c: _xla_attention_lse(a, b, c, causal),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = (jo, jlse) + vjp((jnp.asarray(do), jnp.asarray(glse)))
    _assert_scaled(got, want, VJP_TOL)


@pytest.mark.parametrize("s,d,causal", CASES[:4], ids=IDS[:4])
def test_vjp_matches_pallas_backward_with_glse(interpret, s, d, causal):
    """The same VJP against ``jax.vjp`` of the Pallas
    ``flash_attention_lse`` (its backward kernel with g_lse) in interpret
    mode."""
    q, k, v, do, glse = _inputs(2, s, d, seed=20 + s + d + causal)
    got = _port_vjp(q, k, v, do, glse, causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_lse(a, b, c, causal, True),
                     *(jnp.asarray(x) for x in (q, k, v)))
    _assert_scaled(got[2:], vjp((jnp.asarray(do), jnp.asarray(glse))), TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_gradcheck_f64(causal):
    """The autograd Function's backward (the plain backward with g_lse) is
    the derivative of its forward, in both outputs, and so is autograd's
    own through the plain forward."""
    g = torch.Generator().manual_seed(7 + causal)
    q, k, v = (torch.randn(2, 6, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttentionLSE.apply(a, b, c, causal), (q, k, v))
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_lse_reference(a, b, c, causal), (q, k, v))


def test_unused_output_gradient_is_zero():
    """A None gradient (an output not used) counts as zero: o alone gives
    the K1 backward's gradients, lse alone the g_lse term's."""
    q, k, v, do, glse = _inputs(2, 64, 8, seed=3)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = FlashAttentionLSE.apply(*t, True)
    got = torch.autograd.grad(o, t, torch.from_numpy(do))
    o_ref, lse_ref = flash_lse_reference(*(x.detach() for x in t), True)
    want = flash_bwd_reference(*(x.detach() for x in t), o_ref, lse_ref,
                               torch.from_numpy(do), True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    o, lse = FlashAttentionLSE.apply(*t, True)
    got = torch.autograd.grad(lse, t, torch.from_numpy(glse))
    want = flash_bwd_reference(*(x.detach() for x in t), o_ref, lse_ref,
                               torch.zeros_like(o_ref), True,
                               torch.from_numpy(glse))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_cpu_forward_takes_an_f32_output_from_bf16_inputs():
    """``flash_fwd(..., out_dtype=f32)`` on bf16 CPU tensors: o in f32,
    the plain version of K5 on the bf16 values, no launch counted."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(2, 96, 64, 4)[:3])
    counts = (flash_fwd.launches, flash_fwd.lse_launches)
    o, lse = flash_fwd(q, k, v, True, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    assert (flash_fwd.launches, flash_fwd.lse_launches) == counts
    want, want_lse = flash_lse_reference(q.float(), k.float(), v.float(), True)
    torch.testing.assert_close(o, want, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, want_lse, atol=1e-6, rtol=1e-6)
    counts = (flash_bwd.launches, flash_bwd.lse_launches)
    dq, dk, dv = flash_bwd(q, k, v, o, lse, torch.ones_like(o), True)
    assert (flash_bwd.launches, flash_bwd.lse_launches) == counts
    assert dq.dtype == torch.bfloat16


def _lse_tensors(bh=2, s=96, d=64):
    """Valid CPU stand-ins for K5's backward entry: bf16 q, k, v, f32 o,
    lse, f32 dO, g_lse, bf16 dq, dk, dv, the delta scratch and the bf16
    dO scratch."""
    g = torch.Generator().manual_seed(5)
    bf = lambda: torch.randn(bh, s, d, generator=g).bfloat16()
    f32 = lambda: torch.randn(bh, s, d, generator=g)
    rows = lambda: torch.randn(bh, s, generator=g)
    return dict(q=bf(), k=bf(), v=bf(), o=f32(), lse=rows(), do=f32(),
                glse=rows(), dq=bf(), dk=bf(), dv=bf(), dlt=rows(),
                do16=bf())


def test_lse_launch_args_follow_the_entry_point():
    """``bwd_launch_args`` gives ``ff_flash_attn_bwd`` K5's arguments in
    order: q, k, v, dO, lse, O, g_lse, the delta scratch, the bf16 dO
    scratch, dq, dk, dv, BH, S, D, K5's dtypes (2), causal and the
    stream; ``bwd_scratch`` makes the dO scratch for K5's mix only; and
    ``fwd_launch_args`` names K5's dtypes (2) when o is f32 beside bf16
    inputs and asked for."""
    x = _lse_tensors()
    args = bwd_launch_args(*x.values(), causal=True, stream=7)
    assert len(args) == len(BWD_ARGTYPES) == 18
    ptr = lambda n: x[n].data_ptr()
    assert args[:12] == tuple(ptr(n) for n in (
        "q", "k", "v", "do", "lse", "o", "glse", "dlt", "do16", "dq", "dk",
        "dv"))
    assert args[12:] == (2, 96, 64, 2, 1, 7)
    x["glse"] = None
    assert bwd_launch_args(*x.values(), causal=False, stream=0)[6] is None
    dlt, do16 = bwd_scratch(x["q"], x["o"])
    assert dlt.shape == (2, 96) and dlt.dtype == torch.float32
    assert do16.shape == (2, 96, 64) and do16.dtype == torch.bfloat16
    assert bwd_scratch(x["q"], x["o"].bfloat16())[1] is None
    x = _lse_tensors()
    fwd = fwd_launch_args(x["q"], x["k"], x["v"], x["o"], x["lse"], False, 0,
                          out_dtype=torch.float32)
    assert fwd[5:] == (2, 96, 64, 2, 0, 0)


@pytest.mark.parametrize("name,bad", [
    ("o", lambda x: x.bfloat16()),               # O must be f32
    ("do", lambda x: x.bfloat16()),              # dO must be f32
    ("q", lambda x: x.float()),                  # q, k, v must be bf16
    ("v", lambda x: x.half()),                   # no kernel dtype
    ("dq", lambda x: x.float()),                 # dq in q's dtype
    ("do16", lambda x: x.float()),               # the dO scratch is bf16
    ("do16", lambda x: x[:1]),                   # ... of q's shape
    ("o", lambda x: x.double()),                 # f32, not f64
    ("do16", lambda x: None),                    # K5 needs the dO scratch
], ids=["o-bf16", "do-bf16", "q-f32", "v-f16", "dq-f32", "do16-f32",
        "do16-shape", "o-f64", "do16-missing"])
def test_lse_launch_args_refuse_every_other_mix(name, bad):
    """``_check_panels`` takes K5's mix (bf16 panels with f32 O and dO)
    and refuses every other one."""
    x = _lse_tensors()
    x[name] = bad(x[name])
    with pytest.raises(ValueError):
        bwd_launch_args(*x.values(), causal=False, stream=0)


def test_launch_args_keep_one_dtype_outside_k5():
    """Outside K5 the checks demand one dtype: the forward's entry refuses
    an f32 o that was not asked for, and the backward's entry takes the
    bf16 dO scratch only with K5's mix."""
    x = _lse_tensors()
    with pytest.raises(ValueError):
        fwd_launch_args(x["q"], x["k"], x["v"], x["o"], x["lse"], False, 0)
    with pytest.raises(ValueError):
        fwd_launch_args(x["q"], x["k"], x["v"], x["o"].bfloat16(), x["lse"],
                        False, 0, out_dtype=torch.float32)
    one = {n: (t.bfloat16() if t.dim() == 3 else t) for n, t in x.items()}
    with pytest.raises(ValueError, match="scratch"):
        bwd_launch_args(*one.values(), causal=False, stream=0)
    one.pop("do16")
    assert bwd_launch_args(*one.values(), causal=False, stream=0)[15] == 1


def test_launch_args_refuse_misaligned_panels():
    """The kernels read 16 bytes at a time: a panel that starts off a
    16-byte boundary raises."""
    x = _lse_tensors()
    x["o"] = torch.randn(2 * 96 * 64 + 1)[1:].view(2, 96, 64)
    with pytest.raises(ValueError, match="aligned"):
        bwd_launch_args(*x.values(), causal=False, stream=0)


EDGES = [(s, d, causal) for s in (1, 63, 65, 127, 128, 129, 512)
         for d in (64, 128) for causal in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,causal", EDGES,
                         ids=[f"S{s}-D{d}-{int(c)}" for s, d, c in EDGES])
def test_kernel_matches_plain_version_on_card(cuda_card, s, d, causal):
    """K5 on the card against its plain version from the same bf16
    inputs, forward (o within 2^-8 of P|V| + 1e-4 element by element,
    the most P's bf16 rounding moves it; lse 1e-3; and o in f32: past
    S 1, at most the causal row 0 and 1% besides are values a bf16 holds
    exactly) and backward with g_lse (2e-2 of each output's max, floored
    at 1e-3 of the largest), two runs bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(s + d + causal)
    q, k, v = (torch.randn(4, s, d, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    do = torch.randn(4, s, d, generator=g, device="cuda")
    glse = torch.randn(4, s, generator=g, device="cuda")
    o, lse = flash_fwd(q, k, v, causal, out_dtype=torch.float32)
    again = flash_fwd(q, k, v, causal, out_dtype=torch.float32)
    assert all(torch.equal(a, b) for a, b in zip((o, lse), again))
    ref_o, ref_lse = flash_lse_reference(q.float(), k.float(), v.float(),
                                         causal)
    assert o.dtype == torch.float32
    ref_pv, _ = flash_lse_reference(q.float(), k.float(), v.float().abs(),
                                    causal)
    assert bool(((o - ref_o).abs() <= ref_pv * 2.0 ** -8 + 1e-4).all())
    if s > 1:
        exact = (o.bfloat16().float() == o).float().mean().item()
        assert exact <= (1 / s if causal else 0.0) + 0.01
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    got = flash_bwd(q, k, v, o, lse, do, causal, glse)
    assert all(torch.equal(a, b) for a, b in
               zip(got, flash_bwd(q, k, v, o, lse, do, causal, glse)))
    want = flash_bwd_reference(q.float(), k.float(), v.float(), o, lse, do,
                               causal, glse)
    scales = [w.abs().max().item() for w in want]
    scales = [max(sc, 1e-3 * max(scales)) for sc in scales]
    for a, w, sc in zip(got, want, scales):
        assert (a.float() - w).abs().max().item() <= 2e-2 * sc
