"""PyTorch port, ring attention (sequence parallelism) against the JAX
package.

The port runs every position of a ``{"seq": n}`` ring in one process
(``LocalRing``); the JAX package runs its ``ring_attention`` under
``shard_map`` on ``make_mesh(4, {"seq": 4})`` over XLA's virtual CPU
devices. Inputs are made from a seed with numpy and handed to both. Both
inner blocks are covered: the einsum block (Pallas off on the JAX side,
the port's own rule on CPU tensors), and the flash block at S_loc 128
(the Pallas K5 in interpret mode on the JAX side; on the port's,
``interpret=True``: K5's plain versions).

Tolerances: the forward at the reference test's own (rtol 2e-4, atol
2e-5); the q/k/v gradients of sum(o^2) at rtol 2e-4 and atol 2e-5 of
each gradient's max |value| (f32 on both sides; the merges sum in other
orders). The 2-rank gloo ``ProcessGroupRing`` against ``LocalRing(2)``:
1e-6 (the same arithmetic in the same order; only the hop differs). The
model-level parity at ``test_torch_port_train.py``'s tolerances (loss
rtol 1e-4, parameters atol 2e-5 / rtol 1e-4), ``predict`` at the
reference test's.
"""

import warnings
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import make_mesh as j_make_mesh
from flexflow_tpu.ops.attention import MultiHeadAttention as JMHA
from flexflow_tpu.parallel.ring_attention import ring_attention as j_ring
import flexflow_tpu_torch as P
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import Mesh, local_ring_axis, make_mesh
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   compile_transformer,
                                                   create_transformer)
from flexflow_tpu_torch.ops import OpRegistry as PRegistry
from flexflow_tpu_torch.ops.flash_attention import flash_fwd
from flexflow_tpu_torch.optimizers import SGDOptimizer
import flexflow_tpu_torch.parallel.ring_attention as ring_mod
from flexflow_tpu_torch.parallel.ring_attention import (
    LocalRing, ProcessGroupRing, ring_attention, ring_attention_blocks)
from flexflow_tpu_torch.weights import from_jax_params

RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
# (inner block, B, H, S, D): S_loc = S / 4; the flash block at S_loc 128
INNER = [("einsum", 4, 2, 32, 8), ("flash", 2, 2, 512, 8)]


def _qkv(b, h, s, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, s, d).astype(np.float32) for _ in range(3)]


def _jax_ring(q, k, v, causal, monkeypatch, inner):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS",
                       "interpret" if inner == "flash" else "off")
    mesh = j_make_mesh(4, {"seq": 4})
    return jax.jit(lambda a, b, c: j_ring(a, b, c, mesh, causal=causal))(
        *(jnp.asarray(x) for x in (q, k, v)))


def _port_ring(q, k, v, causal, inner):
    return ring_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          make_mesh(4, {"seq": 4}), causal=causal,
                          interpret=inner == "flash")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("inner,b,h,s,d", INNER, ids=[i[0] for i in INNER])
def test_ring_matches_reference_ring(monkeypatch, inner, b, h, s, d, causal):
    q, k, v = _qkv(b, h, s, d, seed=s + causal)
    fwd0 = (flash_fwd.launches, flash_fwd.lse_launches)
    got = _port_ring(q, k, v, causal, inner)
    assert (flash_fwd.launches, flash_fwd.lse_launches) == fwd0  # CPU
    want = _jax_ring(q, k, v, causal, monkeypatch, inner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("inner,b,h,s,d", INNER, ids=[i[0] for i in INNER])
def test_ring_gradients_match_reference_ring(monkeypatch, inner, b, h, s, d,
                                             causal):
    """q/k/v gradients of sum(o^2) against ``jax.grad`` of the reference
    ring on the same mesh."""
    q, k, v = _qkv(b, h, s, d, seed=1 + s + causal)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = ring_attention(*t, make_mesh(4, {"seq": 4}), causal=causal,
                       interpret=inner == "flash")
    got = torch.autograd.grad((o ** 2).sum(), t)
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS",
                       "interpret" if inner == "flash" else "off")
    mesh = j_make_mesh(4, {"seq": 4})
    want = jax.grad(lambda a, b_, c: jnp.sum(
        j_ring(a, b_, c, mesh, causal=causal) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max())


def _gloo_worker(rank, store_path, world, out_path):
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        res = {}
        q, k, v = (torch.from_numpy(x) for x in _qkv(world, 2, 3 * 16, 8, 5))
        blocks = lambda x: x.reshape(world, 2, 3, 16, 8)[rank:rank + 1]
        for causal in (False, True):
            t = [blocks(x).clone().requires_grad_() for x in (q, k, v)]
            o = ring_attention_blocks(*t, ProcessGroupRing(), causal,
                                      interpret=True)
            res[causal] = (o.detach(),) + torch.autograd.grad(
                (o ** 2).sum(), t)
        torch.save(res, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_process_group_ring_matches_local_ring(tmp_path):
    """Two gloo ranks, one ring position each, hop by send/recv (and its
    gradient by the reverse hop), against ``LocalRing(2)`` holding both
    positions: o and the q/k/v gradients, causal and not. A FileStore
    under ``tmp_path`` (no fixed port) with a 60 s timeout."""
    import torch.multiprocessing as mp

    out = str(tmp_path / "out")
    mp.start_processes(_gloo_worker, args=(str(tmp_path / "store"), 2, out),
                       nprocs=2, start_method="spawn")
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 3 * 16, 8, 5))
    for causal in (False, True):
        t = [x.reshape(2, 2, 3, 16, 8).clone().requires_grad_()
             for x in (q, k, v)]
        o = ring_attention_blocks(*t, LocalRing(2), causal, interpret=True)
        want = (o.detach(),) + torch.autograd.grad((o ** 2).sum(), t)
        for rank in range(2):
            got = torch.load(f"{out}.{rank}")[causal]
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w[rank:rank + 1], rtol=1e-6,
                                           atol=1e-6)


class _OnePosition(LocalRing):
    """Ring position ``r`` of 4 alone, as one rank of a process group holds
    it (the hop leaves the blocks in place: only the launch plan is
    looked at)."""

    def __init__(self, r):
        super().__init__(4)
        self.positions = (r,)

    def hop(self, k, v):
        return k, v


@pytest.mark.parametrize("causal", [False, True])
def test_launch_plan(monkeypatch, causal):
    """K5 calls of one ring call: one a step that has an active position,
    over all of them (4 for 4 positions, causal or not; the causal steps
    drop the masked positions); a rank holding position r of a causal
    ring makes r + 1."""
    calls, real = [], ring_mod.flash_attention_lse

    def counted(q, k, v, blk_causal):
        calls.append((q.shape[0], blk_causal))
        return real(q, k, v, blk_causal)

    monkeypatch.setattr(ring_mod, "flash_attention_lse", counted)
    x = torch.zeros(4, 1, 2, 8, 8)
    ring_attention_blocks(x, x, x, LocalRing(4), causal, interpret=True)
    bh = 2  # B x H of a position
    assert calls == ([(4 * bh, True), (3 * bh, False), (2 * bh, False),
                      (1 * bh, False)] if causal
                     else [(4 * bh, False)] * 4)
    for r in range(4):
        calls.clear()
        ring_attention_blocks(x[:1], x[:1], x[:1], _OnePosition(r), causal,
                              interpret=True)
        assert len(calls) == (r + 1 if causal else 4)


def test_ring_of_one_is_plain_attention():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 64, 8, 9))
    for mesh in (make_mesh(1, {"seq": 1}), make_mesh(2, {"data": 1,
                                                          "seq": 2})):
        for causal in (False, True):
            ref = ring_attention(q, k, v, mesh, causal=causal)
            got = ring_attention(q, k, v, mesh, causal=causal,
                                 interpret=True)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


def test_meshes_one_process_refuses():
    """A mesh with any axis above 1 other than the ring's raises, naming
    the multi-GPU item; sizes must multiply to the device count."""
    with pytest.raises(ValueError, match="devices"):
        make_mesh(4, {"seq": 2})
    assert local_ring_axis(make_mesh(4, {"data": 1, "seq": 4})) == "seq"
    assert local_ring_axis(None) is None
    assert local_ring_axis(make_mesh(1, {"data": 1})) is None
    for axes in ({"data": 2, "seq": 2}, {"model": 2}, {"data": 4}):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            local_ring_axis(Mesh(axes))
    q = torch.zeros(2, 2, 8, 8)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ring_attention(q, q, q, make_mesh(4, {"data": 2, "seq": 2}))
    with pytest.raises(ValueError, match="does not split"):
        ring_attention(q, q, q, make_mesh(3, {"seq": 3}))


# ---- attention op and model ------------------------------------------------

QUEUE3 = dict(embed_dim=256, num_heads=4, dropout=0.1)


def _ops(**props):
    """The reference's and the port's MultiHeadAttention with ``props`` on
    [2, 128, 256] self-attention."""
    shapes = [(2, 128, 256)] * 3
    jl = JLayer(J.OperatorType.MULTIHEAD_ATTENTION, "attn", [],
                 data_type=J.DataType.FLOAT)
    jl.properties.update(props)
    pl = PLayer(P.OperatorType.MULTIHEAD_ATTENTION, "attn", [],
                data_type=P.DataType.FLOAT)
    pl.properties.update(props)
    return JMHA(jl, shapes), PRegistry.create(pl, shapes)


def test_selected_impl_follows_the_reference():
    """Queue 3's input: embed 256, 4 heads, S 128, dropout 0.1. Compiled
    for training, the reference picks the einsum core (dropout has no
    kernel path), and so must the port on the card; on a seq mesh both
    pick the ring."""
    jop, pop = _ops(**QUEUE3)
    assert jop.selected_impl({}, training=True) == "einsum"
    assert pop.selected_impl("cuda", training=True) == "einsum"
    assert pop.selected_impl("cuda") == "flash"  # inference: no dropout
    jop, pop = _ops(**QUEUE3, seq_parallel="seq")
    mesh = {"seq": 4}
    assert jop.selected_impl(mesh, training=True) == "ring"
    assert pop.selected_impl("cuda", mesh, training=True) == "ring"
    assert pop.selected_impl("cpu", mesh) == "ring"
    assert pop.selected_impl("cuda", {"seq": 1}, training=True) == "einsum"


def test_kernels_of_the_compiled_path():
    """Training on a seq mesh builds both flash sources (the ring's inner
    block is K5, in them); inference the forward's; a training path whose
    attention has dropout builds none."""
    cfg = TransformerConfig(num_layers=1, hidden_size=128, num_heads=2,
                            seq_length=256, batch_size=2, seq_parallel="seq")
    ff = create_transformer(cfg, device="cpu")
    ff.compile(SGDOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               mesh=make_mesh(4, {"seq": 4}))
    nodes = ff.executor.nodes
    assert ff._kernels_of_path(nodes, P.CompMode.TRAINING) == [
        "flash_attn_fwd", "flash_attn_bwd"]
    assert ff._kernels_of_path(nodes, P.CompMode.INFERENCE) == [
        "flash_attn_fwd"]
    cfg.seq_parallel, cfg.dropout = None, 0.1
    ff = create_transformer(cfg, device="cpu")
    ff.compile(SGDOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    assert ff._kernels_of_path(ff.executor.nodes, P.CompMode.TRAINING) == []


def test_compile_refuses_meshes_one_process_cannot_run():
    cfg = TransformerConfig(num_layers=1, hidden_size=64, num_heads=2,
                            seq_length=32, batch_size=2, seq_parallel="seq")
    for axes, n in (({"data": 2, "seq": 2}, 4), ({"model": 2}, 2)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
            compile_transformer(cfg, mesh=make_mesh(n, axes), device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        compile_transformer(cfg, mesh=j_make_mesh(4, {"seq": 4}),
                            device="cpu")


def test_dropout_is_not_applied_under_the_ring():
    """As in the reference: under the ring, attention dropout is dropped
    with a one-time warning, and training proceeds."""
    cfg = TransformerConfig(num_layers=1, hidden_size=64, num_heads=2,
                            seq_length=32, batch_size=2, dropout=0.1,
                            seq_parallel="seq")
    ff = compile_transformer(cfg, mesh=make_mesh(4, {"seq": 4}),
                             device="cpu")
    rs = np.random.RandomState(2)
    x = rs.randn(2, 32, 64).astype(np.float32)
    y = rs.randn(2, 32, 1).astype(np.float32)
    with pytest.warns(UserWarning, match="not applied under seq_parallel"):
        ff.fit(x, y, epochs=1, verbose=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ff.fit(x, y, epochs=1, verbose=False)
    assert np.isfinite(ff.epoch_losses).all()


B, S, E, HEADS = 4, 32, 16, 4


def _jax_block_model():
    """The reference test's model (``test_ring_flash_attention.py``'s
    ``test_transformer_block_with_ring_attention_trains``) on a
    ``{"seq": 4}`` mesh."""
    ff = J.FFModel(J.FFConfig(batch_size=B, only_data_parallel=True,
                              workers_per_node=1))
    t = ff.create_tensor((B, S, E))
    a = ff.multihead_attention(t, t, t, E, HEADS, causal=True,
                               seq_parallel="seq", name="attn")
    h = ff.add(a, t, name="res")
    h = ff.layer_norm(h, name="ln")
    ff.dense(h, 1, name="head")
    ff.compile(J.SGDOptimizer(lr=0.01),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [J.MetricsType.MEAN_SQUARED_ERROR],
               mesh=j_make_mesh(4, {"seq": 4}))
    return ff


def _port_block_model():
    ff = P.FFModel(P.FFConfig(batch_size=B), device="cpu")
    t = ff.create_tensor((B, S, E))
    a = ff.multihead_attention(t, t, t, E, HEADS, causal=True,
                               seq_parallel="seq", name="attn")
    h = ff.add(a, t, name="res")
    h = ff.layer_norm(h, name="ln")
    ff.dense(h, 1, name="head")
    ff.compile(SGDOptimizer(lr=0.01), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR],
               mesh=make_mesh(4, {"seq": 4}))
    return ff


def test_ring_model_trains_like_the_reference():
    """The reference's ring-attention training test as a two-package
    parity test: weights carried by ``weights.from_jax_params``, then
    ``predict``, 3 per-step losses and every parameter after them."""
    jff = _jax_block_model()
    pff = _port_block_model()
    assert jff.mesh.shape["seq"] == 4 and pff.mesh.shape == {"seq": 4}
    assert [n.op.selected_impl("cuda", pff.mesh.shape)
            for n in pff.executor.nodes if n.op.name == "attn"] == ["ring"]
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    rs = np.random.RandomState(0)
    x = rs.randn(B * 4, S, E).astype(np.float32)
    y = rs.randn(B * 4, S, 1).astype(np.float32)
    np.testing.assert_allclose(pff.predict(x[:B]), jff.predict(x[:B]),
                               rtol=RTOL, atol=ATOL)
    for _ in range(3):
        jff.fit(x[:B], y[:B], epochs=1, verbose=False)
        pff.fit(x[:B], y[:B], epochs=1, verbose=False)
        np.testing.assert_allclose(pff._last_loss, jff._last_loss,
                                   rtol=LOSS_RTOL)
    jp = jax.tree.map(np.asarray, jff.params)
    for layer, sub in jp.items():
        for name, want in sub.items():
            np.testing.assert_allclose(
                pff.params[layer][name].numpy(), want, atol=PARAM_ATOL,
                rtol=PARAM_RTOL, err_msg=f"{layer}/{name}")
    rep = pff.evaluate(x, y)
    assert np.isfinite(rep["loss"])


def test_seq_mesh_model_equals_the_unsharded_model():
    """On one device the ring computes the same attention as the plain
    core: a seq-parallel transformer on a ``{"seq": 4}`` mesh and the
    same weights without ``seq_parallel`` give the same ``predict`` and
    per-step losses (f32, sums in other orders)."""
    cfg = dict(num_layers=2, hidden_size=64, num_heads=2, seq_length=64,
               batch_size=2)
    ring = compile_transformer(TransformerConfig(seq_parallel="seq", **cfg),
                               mesh=make_mesh(4, {"seq": 4}), device="cpu")
    plain = compile_transformer(TransformerConfig(**cfg), device="cpu")
    for layer, sub in plain.params.items():
        for name, t in sub.items():
            ring.set_parameter(layer, t.numpy(), name)
    rs = np.random.RandomState(4)
    x = rs.randn(2, 64, 64).astype(np.float32)
    y = rs.randn(2, 64, 1).astype(np.float32)
    np.testing.assert_allclose(ring.predict(x), plain.predict(x), rtol=RTOL,
                               atol=ATOL)
    ring.fit(x, y, epochs=3, verbose=False)
    plain.fit(x, y, epochs=3, verbose=False)
    np.testing.assert_allclose(ring.epoch_losses, plain.epoch_losses,
                               rtol=LOSS_RTOL)


def test_served_rows_of_a_seq_parallel_model_equal_predict():
    """``serve()`` on a model compiled over a ``{"seq": 4}`` mesh: every
    bucket's executor runs the ring (its kernel choice says so) and a
    served batch equals ``predict`` on the same rows."""
    cfg = TransformerConfig(num_layers=1, hidden_size=64, num_heads=2,
                            seq_length=32, batch_size=4, seq_parallel="seq")
    ff = create_transformer(cfg, device="cpu")
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=P.CompMode.INFERENCE, mesh=make_mesh(4, {"seq": 4}))
    engine = ff.serve()
    assert all(set(rep["kernel_choices"].values()) == {"ring"}
               for rep in engine.bucket_report().values())
    x = np.random.RandomState(6).randn(4, 32, 64).astype(np.float32)
    reqs = [engine.submit([row]) for row in x]
    engine.pump()
    got = np.stack([r.wait(60) for r in reqs])
    np.testing.assert_allclose(got, ff.predict(x), rtol=1e-6, atol=1e-6)
