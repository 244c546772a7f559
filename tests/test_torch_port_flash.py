"""PyTorch port, flash-attention forward (K1) against the JAX package.

The port's ``flash_fwd`` on CPU tensors runs its plain PyTorch version;
the JAX side runs the Pallas kernel ``_flash_fwd`` in interpret mode, as
the JAX package's own tests run it on the CPU. Inputs are made from a
seed with numpy and handed to both.

Tolerance: atol 1e-5, rtol 1e-5 — f32 on both sides; only the order of
the sums differs. Where the port's plain version takes bf16 inputs, its o
is rounded to bf16 once at the end: within half a bf16 ulp (rtol 2^-8) of
the f32 attention of the same (bf16) values.

The card's kernels are held against the plain version at the bf16
kernel's tile edges (S 1, 63, 65, 127, 129, 255); here the plain version
is held against the JAX package's einsum attention and logsumexp at those
lengths, which the Pallas kernel does not take (S % 128).
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
from flexflow_tpu_torch.ops.flash_attention import (FWD_ARGTYPES,
                                                    FlashAttention,
                                                    flash_attention,
                                                    flash_attention_available,
                                                    flash_fwd,
                                                    flash_fwd_reference,
                                                    fwd_launch_args)

ATOL = RTOL = 1e-5
BF16_RTOL = 2.0 ** -8  # half a bf16 ulp, relative
EDGE_LENGTHS = (1, 63, 65, 127, 129)


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


def _jax_attention_lse(q, k, v, causal):
    """The JAX package's einsum attention and the logsumexp of its scores,
    q, k, v ``[BH, S, D]`` numpy f32."""
    s, d = q.shape[1], q.shape[2]
    o = jax_sdpa(*(jnp.asarray(x)[:, None] for x in (q, k, v)),
                 causal=causal)[:, 0]
    scores = jnp.einsum("bqd,bkd->bqk", q, k) / jnp.sqrt(jnp.float32(d))
    if causal:
        mask = jnp.tril(jnp.ones((s, s), bool))
        scores = jnp.where(mask, scores, jnp.finfo(jnp.float32).min)
    return np.asarray(o), np.asarray(jax.scipy.special.logsumexp(scores,
                                                                 axis=-1))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_LENGTHS)
def test_plain_version_at_tile_edges_matches_jax_attention(s, causal, d):
    """The card checks' tile edges: the plain version (what the kernel is
    held to there) against the einsum attention and logsumexp, f32."""
    q, k, v = _qkv(3, s, d, seed=11 * s + d + causal)
    want_o, want_lse = _jax_attention_lse(q, k, v, causal)
    o, lse = flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert o.shape == (3, s, d) and lse.shape == (3, s)
    np.testing.assert_allclose(o.numpy(), want_o, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_LENGTHS)
def test_plain_version_in_bf16_rounds_o_once(s, causal, d):
    """bf16 inputs, as the kernel takes them: o comes out in bf16, within
    half an ulp of the f32 einsum attention of the same bf16 values; lse
    stays f32 (1e-5)."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(3, s, d, seed=13 * s + d + causal))
    want_o, want_lse = _jax_attention_lse(
        *(x.float().numpy() for x in (q, k, v)), causal)
    o, lse = flash_fwd(q, k, v, causal)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=1e-6,
                               rtol=BF16_RTOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_pallas_flash_fwd_head_dim_128(monkeypatch, s, causal):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
    q, k, v = _qkv(2, s, 128, seed=3 * s + causal)
    want_o, want_lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, True)
    o, lse = flash_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, 0, :],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
def test_function_saves_what_the_backward_reads(causal):
    """FlashAttention's forward saves (q, k, v, o, lse): o is what it
    returns and lse the forward's logsumexp."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(2, 40, 16, seed=21 + causal))
    out = FlashAttention.apply(q, k, v, causal)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    for a, b in zip(saved[:3], (q, k, v)):
        assert torch.equal(a, b)
    want_o, want_lse = flash_fwd_reference(q.detach(), k.detach(),
                                           v.detach(), causal)
    assert torch.equal(saved[3], out.detach())
    assert torch.equal(saved[3], want_o) and torch.equal(saved[4], want_lse)


def _fwd_tensors(dtype=torch.bfloat16, bh=2, s=96, d=64):
    g = torch.Generator().manual_seed(0)
    q, k, v, o = (torch.randn(bh, s, d, generator=g).to(dtype)
                  for _ in range(4))
    return dict(q=q, k=k, v=v, o=o, lse=torch.randn(bh, s, generator=g))


def test_launch_args_follow_the_entry_point():
    """``fwd_launch_args`` gives ``ff_flash_attn_fwd`` its arguments in
    order: q, k, v, o, lse, BH, S, D, bf16, causal and the stream; one per
    entry of ``FWD_ARGTYPES``."""
    x = _fwd_tensors()
    args = fwd_launch_args(*x.values(), causal=True, stream=7)
    assert len(args) == len(FWD_ARGTYPES) == 11
    assert args[:5] == tuple(x[n].data_ptr() for n in ("q", "k", "v", "o",
                                                       "lse"))
    assert args[5:] == (2, 96, 64, 1, 1, 7)
    x32 = _fwd_tensors(torch.float32, d=128)
    assert fwd_launch_args(*x32.values(), causal=False,
                           stream=0)[5:] == (2, 96, 128, 0, 0, 0)


@pytest.mark.parametrize("name,bad", [
    ("k", lambda x: x.float()),                  # dtype differs from q
    ("q", lambda x: x.double()),                 # no kernel dtype
    ("v", lambda x: x[:, :-1]),                  # shape differs from q
    ("k", lambda x: x[:1]),                      # batch*heads differ
    ("q", lambda x: x.reshape(2, 96, 2, 32)),    # not [BH, S, D]
    ("o", lambda x: x.transpose(-1, -2).contiguous().transpose(-1, -2)),
    ("o", lambda x: x.float()),                  # o in another dtype
    ("lse", lambda x: x.bfloat16()),             # lse must be f32
    ("lse", lambda x: x[:, :-1]),                # lse must be [BH, S]
    ("lse", lambda x: x.t().contiguous().t()),   # lse must be contiguous
], ids=["k-dtype", "q-dtype", "v-shape", "k-bh", "q-rank", "o-layout",
        "o-dtype", "lse-dtype", "lse-shape", "lse-layout"])
def test_launch_args_refuse_what_the_kernel_does_not_take(name, bad):
    x = _fwd_tensors()
    x[name] = bad(x[name])
    with pytest.raises(ValueError):
        fwd_launch_args(*x.values(), causal=False, stream=0)


def test_launch_args_refuse_unsupported_head_dim():
    x = _fwd_tensors(d=32)
    with pytest.raises(ValueError, match="head dim 32"):
        fwd_launch_args(*x.values(), causal=False, stream=0)


def test_launch_args_refuse_more_rows_than_the_grid_takes():
    """batch*heads lies on grid.y, at most 65535."""
    x = _fwd_tensors(bh=65536, s=1)
    with pytest.raises(ValueError, match="batch\\*heads 65536"):
        fwd_launch_args(*x.values(), causal=False, stream=0)


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


@pytest.mark.parametrize("q_shape,k_shape,capability,want", [
    ((2, 4, 512, 64), (2, 4, 512, 64), (9, 0), True),
    ((2, 4, 100, 128), (2, 4, 100, 128), (9, 0), True),
    ((2, 4, 512, 32), (2, 4, 512, 32), (9, 0), False),   # head dim
    ((2, 4, 512, 64), (2, 4, 256, 64), (9, 0), False),   # cross-attention
    ((8192, 8, 128, 64), (8192, 8, 128, 64), (9, 0), False),  # B*H > grid
    ((8191, 8, 128, 64), (8191, 8, 128, 64), (9, 0), True),
    ((2, 4, 512, 32), (2, 4, 512, 32), (8, 0), False),   # head dim, sm_80
])
def test_availability_rule_on_cuda(monkeypatch, q_shape, k_shape,
                                   capability, want):
    """The port's rule — CUDA, Sq == Sk, a supported head dim, batch x
    heads within the grid — replaces the TPU's BLK_Q / MIN_SEQ_FOR_FLASH
    gates. A shape the kernel does not take answers no on any card."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    assert flash_attention_available(_fake("cuda", q_shape),
                                     _fake("cuda", k_shape)) is want


@pytest.mark.parametrize("capability", [(8, 0), (8, 9)])
def test_availability_rule_raises_below_sm90(monkeypatch, capability):
    """A shape the kernel takes, on a card the sm_90a kernels cannot run
    on: the rule raises instead of giving the work to the einsum core,
    and so do the wrappers (`require_sm90`, before they launch) and the
    ring's block rule."""
    from flexflow_tpu_torch.ops.flash_attention import (
        FlashKernelDeviceError, require_sm90)
    from flexflow_tpu_torch.parallel.ring_attention import _use_flash

    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    name = f"sm_{capability[0]}{capability[1]}"
    q = _fake("cuda", (2, 4, 512, 64))
    with pytest.raises(FlashKernelDeviceError, match=f"sm_90a.*{name}"):
        flash_attention_available(q, q)
    with pytest.raises(FlashKernelDeviceError, match=name):
        require_sm90(torch.device("cuda"))

    class Blocks:  # the ring's [P, B, H, S, D] blocks; it asks of block 0
        device = torch.device("cuda")

        def __getitem__(self, i):
            return q

    with pytest.raises(FlashKernelDeviceError, match=name):
        _use_flash(Blocks(), interpret=False)


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGE_LENGTHS + (255,))
def test_kernel_at_tile_edges_on_card(cuda_card, s, causal, d):
    """On the card: the bf16 kernel at its tile edges (64-row warpgroups,
    64- or 128-row key tiles) against its plain version in f32 from the
    same inputs (o 2e-2, lse 1e-3, as above); a second launch gives the
    same bits."""
    g = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v = (torch.randn(4, s, d, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, causal)
    o2, lse2 = flash_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    ro, rl = flash_fwd_reference(q.float(), k.float(), v.float(), causal)
    assert (o.float() - ro).abs().max().item() <= 2e-2
    assert (lse - rl).abs().max().item() <= 1e-3
