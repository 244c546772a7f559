"""PyTorch port, flash-attention backward (K2/K3) against the JAX package.

The port's ``flash_bwd`` on CPU tensors runs its plain PyTorch version,
``flash_bwd_reference``; the JAX side runs the Pallas kernels
``_flash_bwd`` (K2) and ``_flash_bwd_blocked`` (K3) in interpret mode, as
the JAX package's own tests run them on the CPU. Inputs are made from a
seed with numpy and handed to both; o and lse come from the port's plain
forward, so both backwards start from the same saved tensors.

Tolerance: f32 on both sides, only the order of the sums differs:
atol 1e-5 of the output's max |value|, rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas_kernels import _flash_bwd, _flash_bwd_blocked
from flexflow_tpu_torch.ops.attention import scaled_dot_product_attention
from flexflow_tpu_torch.ops.flash_attention import (FlashAttention,
                                                    flash_attention,
                                                    flash_bwd,
                                                    flash_bwd_reference,
                                                    flash_fwd,
                                                    flash_fwd_reference)

TOL = 1e-5


def _case(bh, s, d, causal, with_glse, seed):
    """numpy q, k, v, dO, g_lse (None = zero) and the plain forward's o,
    lse for them."""
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(bh, s, d).astype(np.float32) for _ in range(4))
    glse = rs.randn(bh, s).astype(np.float32) if with_glse else None
    o, lse = flash_fwd_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal)
    return q, k, v, do, glse, o.numpy(), lse.numpy()


def _port(q, k, v, do, glse, o, lse, causal):
    t = torch.from_numpy
    return flash_bwd(t(q), t(k), t(v), t(o), t(lse), t(do), causal,
                     None if glse is None else t(glse))


def _jax(fn, q, k, v, do, glse, o, lse, causal):
    j = jnp.asarray
    return fn(j(q), j(k), j(v), j(o), j(lse)[:, None, :], j(do), causal,
              True, glse=None if glse is None else j(glse)[:, None, :])


def _assert_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL,
                                   atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("with_glse", [False, True], ids=["glse0", "glse"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [128, 256])
def test_matches_pallas_flash_bwd(s, d, causal, with_glse):
    """K2: the single-block backward, S <= 1024."""
    case = _case(2, s, d, causal, with_glse, seed=s + d + 2 * causal)
    before = flash_bwd.launches
    got = _port(*case, causal)
    assert flash_bwd.launches == before  # CPU tensors launch no kernel
    assert all(g.dtype == torch.float32 and g.shape == (2, s, d) for g in got)
    _assert_close(got, _jax(_flash_bwd, *case, causal))


@pytest.mark.parametrize("with_glse", [False, True], ids=["glse0", "glse"])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_flash_bwd_blocked(causal, with_glse):
    """K3: the K-blocked backward (dQ accumulated across K blocks), called
    directly at S = 256 (it takes any S % 128 == 0)."""
    case = _case(2, 256, 64, causal, with_glse, seed=11 + causal)
    _assert_close(_port(*case, causal),
                  _jax(_flash_bwd_blocked, *case, causal))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_function_gradcheck(causal):
    """The autograd Function's backward is the derivative of its forward:
    torch.autograd.gradcheck in f64 through the plain versions."""
    g = torch.Generator().manual_seed(int(causal))
    q, k, v = (torch.randn(2, 6, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: FlashAttention.apply(a, b, c, causal), (q, k, v))


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_reach_the_callers_layout(causal):
    """flash_attention on [B, H, S, D] strided views (as the projections
    give them): the gradients come back in the caller's layout and equal
    autograd's through the einsum core. f32, atol/rtol 1e-5."""
    rs = np.random.RandomState(5 + causal)
    base = [torch.from_numpy(rs.randn(2, 64, 3, 16).astype(np.float32))
            .requires_grad_() for _ in range(3)]
    views = [x.permute(0, 2, 1, 3) for x in base]
    assert not views[0].is_contiguous()
    dy = torch.from_numpy(rs.randn(2, 3, 64, 16).astype(np.float32))
    got = torch.autograd.grad(flash_attention(*views, causal=causal), base,
                              dy)
    want = torch.autograd.grad(
        scaled_dot_product_attention(*views, causal=causal), base, dy)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 64, 3, 16)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                   atol=TOL * b.abs().max().item())


def test_routes_through_function_only_with_grad():
    """With grad enabled flash_attention records FlashAttention's node;
    under inference_mode it calls the bare forward (the serving path)."""
    q = torch.randn(1, 2, 32, 8, requires_grad=True)
    out = flash_attention(q, q, q)
    # the [B,H,S,D] view of the Function's folded output
    assert "FlashAttention" in type(out.grad_fn.next_functions[0][0]).__name__
    with torch.inference_mode():
        out = flash_attention(q, q, q)
    assert out.grad_fn is None
    want, _ = flash_fwd(*(q.detach().reshape(2, 32, 8),) * 3)
    np.testing.assert_array_equal(out.reshape(2, 32, 8).numpy(),
                                  want.numpy())


def test_glse_enters_as_the_lse_gradient():
    """g_lse is the upstream gradient of the forward's lse: the plain
    backward with g_lse equals autograd of sum(o * dO) + sum(lse * g_lse)
    through the plain forward (f64)."""
    rs = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rs.randn(2, 16, 8)).requires_grad_()
               for _ in range(3))
    do, glse = torch.from_numpy(rs.randn(2, 16, 8)), \
        torch.from_numpy(rs.randn(2, 16))
    o, lse = flash_fwd_reference(q, k, v, True)
    want = torch.autograd.grad((o * do).sum() + (lse * glse).sum(),
                               (q, k, v))
    got = flash_bwd_reference(q.detach(), k.detach(), v.detach(), o.detach(),
                              lse.detach(), do, True, glse)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-10)


def test_other_devices_raise():
    q = torch.empty(2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_bwd(q, q, q, q, torch.empty(2, 128, device="meta"), q)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernel has no CPU mode "
                    "(run with python3 chip_smoke.py or pytest -m cuda on "
                    "the H100)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,d,causal", [(512, 64, False), (200, 128, True)])
def test_kernel_matches_plain_version_on_card(cuda_card, dtype, s, d, causal):
    """On the card: the CUDA backward against its plain version computed in
    f32 from the same inputs, with a random g_lse. bf16: 2e-2 of each
    output's max |value| (bf16 operands of the five products and bf16
    outputs); f32: 1e-4."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(16, s, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    glse = torch.randn(16, s, generator=g, device="cuda")
    o, lse = flash_fwd(q, k, v, causal)
    before = flash_bwd.launches
    got = flash_bwd(q, k, v, o, lse, do, causal, glse)
    torch.cuda.synchronize()
    assert flash_bwd.launches == before + 1
    want = flash_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                               lse, do.float(), causal, glse)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(got, want):
        assert (a.float() - b).abs().max().item() <= tol * b.abs().max().item()
