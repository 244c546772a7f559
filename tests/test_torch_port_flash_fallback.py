"""PyTorch port, a ``flash`` strategy choice the kernel cannot take.

The JAX package runs such an attention through its einsum core and
records why in the op's ``_kernel_fallback``
(``flexflow_tpu/ops/attention.py:203-210, 240-250``); the port does the
same, with the same words. Checked on fake CUDA tensors (an object with
a CUDA device and a shape; the card's compute capability monkeypatched),
where the kernel does not take: head dim 32 (also on a card below
sm_90), cross-attention (Sq != Sk), batch x heads 65536 (beyond the
kernels' grid). Each record is held against the reference's for the same
sequence length and head dim (the only parts of the shape its words
name), which the JAX package writes on the CPU with its Pallas kernels
off. A shape the kernel takes on a card below sm_90 is no such case: it
raises, whatever the strategy asked, unless the einsum core is pinned. On the card, a
model compiled under a ``dp_k:flash`` strategy file at head dim 32 runs
the einsum core, bit-equal to the same model pinned to it.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.ffconst as jconst
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.ops import OpRegistry as JRegistry
from flexflow_tpu.ops.base import OpContext as JContext
import flexflow_tpu_torch as P
import flexflow_tpu_torch.ffconst as pconst
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.ops import OpRegistry as PRegistry


def _fake_cuda(shape):
    return types.SimpleNamespace(device=torch.device("cuda"), shape=shape)


def _ops(embed, heads, sq, sk):
    shapes = [(1, sq, embed), (1, sk, embed), (1, sk, embed)]
    props = dict(embed_dim=embed, num_heads=heads, kernel_impl="flash")
    jl = JLayer(jconst.OperatorType.MULTIHEAD_ATTENTION, "attn", [])
    jl.properties.update(props)
    pl = PLayer(pconst.OperatorType.MULTIHEAD_ATTENTION, "attn", [])
    pl.properties.update(props)
    return JRegistry.create(jl, shapes), PRegistry.create(pl, shapes)


def _reference_record(monkeypatch, embed, heads, sq, sk):
    """The JAX package's ``_kernel_fallback`` after one forward of a
    batch-1 attention with ``kernel_impl="flash"``, its kernels off."""
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "off")
    jop, _ = _ops(embed, heads, sq, sk)
    d = embed // heads
    params = {"wq": jnp.zeros((heads, embed, d)),
              "wk": jnp.zeros((heads, embed, d)),
              "wv": jnp.zeros((heads, embed, d)),
              "wo": jnp.zeros((heads, d, embed)), "bo": jnp.zeros((embed,))}
    x = [jnp.zeros((1, s, embed)) for s in (sq, sk, sk)]
    jop.forward(params, x, JContext(training=False,
                                    compute_dtype=jnp.float32))
    return jop._kernel_fallback


@pytest.mark.parametrize("case,q_shape,k_shape,capability", [
    ("head dim 32", (2, 8, 128, 32), (2, 8, 128, 32), (9, 0)),
    ("cross-attention", (2, 4, 128, 64), (2, 4, 256, 64), (9, 0)),
    ("batch x heads 65536", (8192, 8, 128, 64), (8192, 8, 128, 64), (9, 0)),
    ("head dim 32 on sm_80", (2, 8, 128, 32), (2, 8, 128, 32), (8, 0)),
])
def test_use_flash_falls_back_as_the_reference(monkeypatch, case, q_shape,
                                               k_shape, capability):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: capability)
    b, h, sq, d = q_shape
    _, pop = _ops(h * d, h, sq, k_shape[2])
    assert pop._kernel_fallback is None
    assert pop._use_flash(_fake_cuda(q_shape), _fake_cuda(k_shape)) is False
    want = _reference_record(monkeypatch, h * d, h, sq, k_shape[2])
    assert want is not None and "einsum executed instead" in want
    assert pop._kernel_fallback == want


@pytest.mark.parametrize("kernel_impl", ["flash", None])
def test_use_flash_below_sm90_raises(monkeypatch, kernel_impl):
    """A shape the kernel takes on a card the sm_90a kernels cannot run
    on: the op raises, naming the card, instead of running the einsum
    core (which only a pinned ``einsum`` runs there)."""
    from flexflow_tpu_torch.ops.flash_attention import FlashKernelDeviceError

    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (8, 0))
    _, pop = _ops(512, 8, 128, 128)
    pop.kernel_impl = kernel_impl
    shape = (2, 8, 128, 64)
    with pytest.raises(FlashKernelDeviceError,
                       match="built for sm_90a; this card is sm_80"):
        pop._use_flash(_fake_cuda(shape), _fake_cuda(shape))
    assert pop._kernel_fallback is None
    pop.kernel_impl = "einsum"
    assert pop._use_flash(_fake_cuda(shape), _fake_cuda(shape)) is False


def test_use_flash_takes_the_kernel_where_it_can(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    _, pop = _ops(512, 8, 128, 128)
    shape = (2, 8, 128, 64)
    assert pop._use_flash(_fake_cuda(shape), _fake_cuda(shape)) is True
    assert pop._kernel_fallback is None
    pop.kernel_impl = None  # the availability rule records nothing
    assert pop._use_flash(_fake_cuda((2, 8, 128, 32)),
                          _fake_cuda((2, 8, 128, 32))) is False
    assert pop._kernel_fallback is None


def test_compile_clears_the_record(tmp_path):
    """A fresh compile starts a fresh record, as the reference's does."""
    from flexflow_tpu_torch.models import TransformerConfig, create_transformer
    ff = create_transformer(TransformerConfig(num_layers=1, hidden_size=64,
                                              num_heads=2, seq_length=8,
                                              batch_size=2), device="cpu")
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               comp_mode=P.CompMode.INFERENCE)
    (op,) = [n.op for n in ff.executor.nodes
             if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION]
    op._kernel_fallback = "stale"
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               comp_mode=P.CompMode.INFERENCE)
    (op,) = [n.op for n in ff.executor.nodes
             if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION]
    assert op._kernel_fallback is None


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs a CUDA card: the flash choice is refused "
                           "by the kernel's availability rule only there")
def test_flash_choice_at_head_dim_32_runs_einsum_on_the_card(tmp_path):
    """Self-attention, embed 256, 8 heads (head dim 32), S 128, compiled
    under a ``dp_k:flash`` strategy file: the output equals the same
    model's under ``dp_k:einsum``, bit for bit, K1 never launches, and
    the fallback is recorded."""
    from flexflow_tpu_torch.models import TransformerConfig, create_transformer
    from flexflow_tpu_torch.ops.flash_attention import flash_fwd

    cfg = TransformerConfig(num_layers=1, hidden_size=256, num_heads=8,
                            seq_length=128, batch_size=2)
    x = np.random.RandomState(0).randn(2, 128, 256).astype(np.float32)
    outs, ops = [], []
    for choice in ("dp_k:flash", "dp_k:einsum"):
        ff = create_transformer(cfg, device="cuda")
        path = tmp_path / f"{choice[-5:]}.json"
        path.write_text(json.dumps(dict(version=1, mesh={"data": 1}, ops={
            layer.name: dict(choice=(choice if layer.op_type
                                     == P.OperatorType.MULTIHEAD_ATTENTION
                                     else "dp"),
                             outputs=[None], params={})
            for layer in ff.layers
            if layer.op_type != P.OperatorType.INPUT})))
        ff.config.import_strategy_file = str(path)
        ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   comp_mode=P.CompMode.INFERENCE)
        before = flash_fwd.launches
        outs.append(ff.predict(x))
        assert flash_fwd.launches == before
        (op,) = [n.op for n in ff.executor.nodes
                 if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION]
        ops.append(op)
    assert np.array_equal(outs[0], outs[1])
    assert ops[0]._kernel_fallback == (
        "flash unavailable at runtime (seq=128, head_dim=32) — einsum "
        "executed instead")
    assert ops[1]._kernel_fallback is None
