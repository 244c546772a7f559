"""PyTorch port, flash-attention backward (K2/K3) against the JAX package.

The port's ``flash_bwd`` on CPU tensors runs its plain PyTorch version,
``flash_bwd_reference``; the JAX side runs the Pallas kernels
``_flash_bwd`` (K2) and ``_flash_bwd_blocked`` (K3) in interpret mode, as
the JAX package's own tests run them on the CPU. Inputs are made from a
seed with numpy and handed to both; o and lse come from the port's plain
forward, so both backwards start from the same saved tensors.

Tolerance: f32 on both sides, only the order of the sums differs:
atol 1e-5 of the output's max |value|, rtol 1e-5.

The plain version is also what the card's kernels are held to, at lengths
the Pallas kernels do not take (S not a multiple of 128): there it is held
against the JAX package's einsum-recompute path (``_xla_attention_lse``
through ``jax.vjp``) at the card checks' ragged lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ops.pallas_kernels import (_flash_bwd, _flash_bwd_blocked,
                                             _xla_attention_lse)
from flexflow_tpu_torch.ops.attention import scaled_dot_product_attention
from flexflow_tpu_torch.ops.flash_attention import (BWD_ARGTYPES,
                                                    FlashAttention,
                                                    bwd_launch_args,
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


@pytest.mark.parametrize("with_glse", [False, True], ids=["glse0", "glse"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [1, 65, 200, 1000])
def test_plain_backward_matches_jax_vjp(s, d, causal, with_glse):
    """The plain backward at ragged and tile-edge lengths against
    jax.vjp of the JAX package's einsum path that also returns the lse
    (``_xla_attention_lse``), with cotangents (dO, g_lse); both start from
    the same numpy inputs and the plain version takes the JAX forward's o
    and lse. f32 on both sides: atol 1e-5 of each output's max |value|,
    rtol 1e-5. At S 1 with g_lse 0, P is 1 and the JAX dq and dk are
    exactly 0, while the plain version's are dP - delta, 0 up to the order
    of two f32 sums (1e-6): an output that is exactly 0 on the JAX side is
    held to atol 1e-5 of the largest output's max."""
    rs = np.random.RandomState(100 + s + d + 2 * causal + with_glse)
    q, k, v, do = (rs.randn(2, s, d).astype(np.float32) for _ in range(4))
    glse = (rs.randn(2, s) if with_glse else np.zeros((2, s))).astype(
        np.float32)
    (o, lse), vjp = jax.vjp(lambda a, b, c: _xla_attention_lse(a, b, c, causal),
                            *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp((jnp.asarray(do), jnp.asarray(glse)))]
    t = torch.from_numpy
    got = flash_bwd_reference(t(q), t(k), t(v), t(np.array(o)),
                              t(np.array(lse)), t(do), causal,
                              t(glse) if with_glse else None)
    top = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, s, d)
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL,
                                   atol=TOL * (np.abs(w).max() or top))


def _bwd_tensors(dtype=torch.bfloat16, bh=2, s=96, d=64):
    """Valid CPU stand-ins for the kernel entry's tensors: q, k, v, o, lse,
    do, g_lse, dq, dk, dv and the delta scratch."""
    g = torch.Generator().manual_seed(3)
    panels = [torch.randn(bh, s, d, generator=g).to(dtype) for _ in range(8)]
    rows = [torch.randn(bh, s, generator=g) for _ in range(3)]
    q, k, v, o, do, dq, dk, dv = panels
    lse, glse, dlt = rows
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, glse=glse, dq=dq, dk=dk,
                dv=dv, dlt=dlt)


def test_launch_args_pass_o_in_place_of_delta():
    """``bwd_launch_args`` gives the kernel entry its arguments in order:
    q, k, v, dO, lse, then O (the kernels form delta from it), g_lse (None
    when zero), the delta scratch, the bf16 dO scratch (None outside K5),
    dq, dk, dv, BH, S, D, the dtypes (1 bf16, 0 f32), causal and the
    stream; one per entry of ``BWD_ARGTYPES``."""
    x = _bwd_tensors()
    args = bwd_launch_args(*x.values(), causal=True, stream=7)
    assert len(args) == len(BWD_ARGTYPES) == 18
    ptr = lambda n: x[n].data_ptr()
    assert args[:12] == (ptr("q"), ptr("k"), ptr("v"), ptr("do"), ptr("lse"),
                         ptr("o"), ptr("glse"), ptr("dlt"), None, ptr("dq"),
                         ptr("dk"), ptr("dv"))
    assert args[12:] == (2, 96, 64, 1, 1, 7)
    x["glse"] = None
    assert bwd_launch_args(*x.values(), causal=False, stream=0)[6] is None
    x32 = _bwd_tensors(torch.float32, d=128)
    assert bwd_launch_args(*x32.values(), causal=False,
                           stream=0)[12:17] == (2, 96, 128, 0, 0)


def _transposed(x):
    return x.transpose(-1, -2).contiguous().transpose(-1, -2)


@pytest.mark.parametrize("name,bad", [
    ("o", lambda x: x.float()),                  # dtype differs from q
    ("o", lambda x: x[:, :-1]),                  # shape differs from q
    ("o", _transposed),                          # not contiguous
    ("q", lambda x: x.double()),                 # no kernel dtype
    ("do", lambda x: x[:1]),                     # batch*heads differ
    ("dq", lambda x: x.reshape(2, 96, 2, 32)),   # not [BH, S, D]
    ("lse", lambda x: x.bfloat16()),             # rows must be f32
    ("lse", lambda x: x[:, :-1]),                # rows must be [BH, S]
    ("glse", lambda x: x.t().contiguous().t()),  # rows must be contiguous
    ("dlt", lambda x: x[:1]),                    # the scratch must be [BH, S]
], ids=["o-dtype", "o-shape", "o-layout", "q-dtype", "do-shape",
        "dq-rank", "lse-dtype", "lse-shape", "glse-layout", "dlt-shape"])
def test_launch_args_refuse_what_the_kernels_do_not_take(name, bad):
    """The checks the CUDA path runs before the launch: a wrong dtype, a
    wrong shape or a non-contiguous tensor raises ValueError."""
    x = _bwd_tensors()
    x[name] = bad(x[name])
    with pytest.raises(ValueError):
        bwd_launch_args(*x.values(), causal=False, stream=0)


def test_launch_args_refuse_unsupported_head_dim():
    x = _bwd_tensors(d=32)
    with pytest.raises(ValueError, match="head dim 32"):
        bwd_launch_args(*x.values(), causal=False, stream=0)


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
@pytest.mark.parametrize("s,d,causal", [
    (512, 64, False), (200, 128, True),
    # the bf16 kernels' tile edges: 64-row warpgroups and ring tiles
    (1, 64, False), (63, 64, True), (65, 128, False), (127, 128, True),
    (129, 64, True)])
def test_kernel_matches_plain_version_on_card(cuda_card, dtype, s, d, causal):
    """On the card: the CUDA backward against its plain version computed in
    f32 from the same inputs, with a random g_lse. bf16: 2e-2 of each
    output's max |value| (bf16 operands of the five products and bf16
    outputs); f32: 1e-4. Each output's max is floored at 1e-3 of the
    largest output's max (at S 1, dq and dk are 0 up to rounding). A
    second run gives the same bits."""
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(16, s, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    glse = torch.randn(16, s, generator=g, device="cuda")
    o, lse = flash_fwd(q, k, v, causal)
    before = flash_bwd.launches
    got = flash_bwd(q, k, v, o, lse, do, causal, glse)
    again = flash_bwd(q, k, v, o, lse, do, causal, glse)
    torch.cuda.synchronize()
    assert flash_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                               lse, do.float(), causal, glse)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    top = max(b.abs().max().item() for b in want)
    for a, b in zip(got, want):
        scale = max(b.abs().max().item(), 1e-3 * top)
        assert (a.float() - b).abs().max().item() <= tol * scale
