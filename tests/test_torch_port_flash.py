"""PyTorch port, flash-attention forward (K1) against the JAX package.

The port's ``flash_fwd`` on CPU tensors runs its plain PyTorch version;
the JAX side runs the Pallas kernel ``_flash_fwd`` in interpret mode, as
the JAX package's own tests run it on the CPU. Inputs are made from a
seed with numpy and handed to both.

Tolerance: atol 1e-5, rtol 1e-5 — f32 on both sides; only the order of
the sums differs.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.attention import (
    scaled_dot_product_attention as jax_sdpa)
from flexflow_tpu.ops.pallas_kernels import _flash_fwd
from flexflow_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_available,
                                                    flash_fwd,
                                                    flash_fwd_reference)

ATOL = RTOL = 1e-5


def _qkv(bh, s, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(bh, s, d).astype(np.float32) for _ in range(3)]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernel has no CPU mode "
                    "(run with python3 chip_smoke.py or pytest -m cuda on "
                    "the H100)")


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_flash_fwd(monkeypatch, s, causal):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
    q, k, v = _qkv(4, s, 64, seed=s + causal)
    want_o, want_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, True)
    before = flash_fwd.launches
    o, lse = flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), causal)
    assert o.dtype == torch.float32 and lse.shape == (4, s)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0, :],
                               atol=ATOL, rtol=RTOL)
    assert flash_fwd.launches == before  # CPU tensors launch no kernel


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_length_matches_jax_attention(causal):
    """S = 100: the TPU kernel cannot take it (S % 128), so the JAX side
    is the einsum attention and jax.scipy's logsumexp of its scores."""
    s, d = 100, 64
    q, k, v = _qkv(4, s, d, seed=7 + causal)
    want_o = jax_sdpa(*(jnp.asarray(x)[:, None] for x in (q, k, v)),
                      causal=causal)[:, 0]
    scores = jnp.einsum("bqd,bkd->bqk", q, k) / jnp.sqrt(jnp.float32(d))
    if causal:
        mask = jnp.tril(jnp.ones((s, s), bool))
        scores = jnp.where(mask, scores, jnp.finfo(jnp.float32).min)
    want_lse = jax.scipy.special.logsumexp(scores, axis=-1)
    o, lse = flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=ATOL, rtol=RTOL)


def test_fold_takes_strided_views():
    """flash_attention folds [B,H,S,D] -> [BH,S,D]; the projections'
    einsum results may be permuted views, which the fold makes
    contiguous."""
    rs = np.random.RandomState(3)
    x = [torch.from_numpy(rs.randn(2, 128, 4, 64).astype(np.float32))
         .permute(0, 2, 1, 3) for _ in range(3)]
    assert not x[0].is_contiguous()
    o = flash_attention(*x, causal=True)
    want, _ = flash_fwd_reference(*(t.reshape(8, 128, 64) for t in x),
                                  causal=True)
    np.testing.assert_allclose(o.reshape(8, 128, 64).numpy(), want.numpy(),
                               atol=ATOL, rtol=RTOL)


def _fake(device, shape):
    return types.SimpleNamespace(device=torch.device(device), shape=shape)


@pytest.mark.parametrize("q_shape,k_shape,want", [
    ((2, 4, 512, 64), (2, 4, 512, 64), True),
    ((2, 4, 100, 128), (2, 4, 100, 128), True),
    ((2, 4, 512, 32), (2, 4, 512, 32), False),   # head dim
    ((2, 4, 512, 64), (2, 4, 256, 64), False),   # cross-attention
])
def test_availability_rule_on_cuda(q_shape, k_shape, want):
    """The port's rule — CUDA, Sq == Sk, a supported head dim — replaces
    the TPU's BLK_Q / MIN_SEQ_FOR_FLASH gates."""
    assert flash_attention_available(_fake("cuda", q_shape),
                                     _fake("cuda", k_shape)) is want


def test_cpu_is_never_available():
    q = torch.zeros(1, 1, 512, 64)
    assert not flash_attention_available(q, q)


def test_other_devices_raise():
    q = torch.empty(2, 128, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_fwd(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,d,causal", [(512, 64, False), (200, 128, True)])
def test_kernel_matches_plain_version_on_card(cuda_card, dtype, s, d, causal):
    """On the card: the CUDA kernel against its plain version computed in
    f32 from the same inputs. bf16 o: 2e-2 (bf16 output rounding); f32:
    1e-4; lse 1e-3."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(16, s, d, generator=g, device="cuda").to(dtype)
               for _ in range(3))
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    ro, rl = flash_fwd_reference(q.float(), k.float(), v.float(), causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - ro).abs().max().item() <= tol
    assert (lse - rl).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_unsupported_input(cuda_card):
    q = torch.zeros(4, 128, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_fwd(q, q, q)
    q = torch.zeros(4, 64, 128, device="cuda",
                    dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q, q, q)
