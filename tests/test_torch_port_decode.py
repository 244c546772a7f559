"""PyTorch port, KV-cache decode (``serve/kv_cache.py``) against the JAX
package.

The decoder LM at the reference's test size (vocab 256, hidden 64,
intermediate 128, 2 layers, 4 heads, 2 kv heads, batch 2, seq 16; kv heads
4 and 1 for grouped-query ratios 1 and 4) is built and compiled for
inference in both packages, the JAX model's parameters carried into the
port, and the same prompts, made from a numpy seed, go through both
packages' ``DecodeSession``. f32 on the CPU.

Tolerances: logits atol 2e-5 against the JAX session and against the
port's own ``predict`` (the reference's decode tolerance); greedy tokens
exactly, at a seed whose every argmax leads the runner-up by more than
1e-4 (asserted); the compiled decode step against its eager body bit for
bit.
"""

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.models.llama import (
    LlamaModelConfig as JLlamaModelConfig, create_llama as j_create_llama)
from flexflow_tpu.serve.kv_cache import DecodeSession as JDecodeSession
import flexflow_tpu_torch as P
from flexflow_tpu_torch.machine import make_mesh
from flexflow_tpu_torch.models import (LlamaModelConfig, TransformerConfig,
                                       create_llama, create_transformer)
from flexflow_tpu_torch.serve import DecodeSession, init_kv_cache
from flexflow_tpu_torch.weights import from_jax_params

ATOL = 2e-5
MARGIN = 1e-4
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, batch_size=2, seq_length=16)
GQA = {"rep2": 2, "rep1": 4, "rep4": 1}


def _compile(ff, const, mesh=None):
    ff.compile(None, const.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
               comp_mode=const.CompMode.INFERENCE, mesh=mesh)
    return ff


def _port(kv_heads=2, **extra):
    cfg = LlamaModelConfig(**dict(SMALL, num_key_value_heads=kv_heads,
                                  **extra))
    return _compile(create_llama(cfg, P.FFConfig(batch_size=2),
                                 device="cpu"), P), cfg


def _models(kv_heads=2):
    """(JAX model, port model, config): both compiled for INFERENCE, the
    port carrying the JAX model's parameters."""
    kw = dict(SMALL, num_key_value_heads=kv_heads)
    jff = _compile(j_create_llama(JLlamaModelConfig(**kw),
                                  J.FFConfig(batch_size=2,
                                             workers_per_node=1)), J)
    pff, cfg = _port(kv_heads)
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    return jff, pff, cfg


def _ids(cfg, seed=0, length=None):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size,
        (cfg.batch_size, length or cfg.seq_length)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return _models()


@pytest.mark.parametrize("kv", sorted(GQA))
def test_prefill_and_decode_match_jax_and_predict(kv):
    """prefill(8) then 8 one-token decode steps: every row's logits
    against the JAX session's and the port's own ``predict``; the eight
    decode steps run at eight positions through one compiled step."""
    jff, pff, cfg = _models(GQA[kv])
    ids = _ids(cfg)
    full = pff.predict(ids)
    js, ps = JDecodeSession(jff), DecodeSession(pff)
    want = [js.prefill([ids[:, :8]])]
    got = [ps.prefill([ids[:, :8]])]
    for t in range(8, 16):
        want.append(js.decode([ids[:, t:t + 1]]))
        got.append(ps.decode([ids[:, t:t + 1]]))
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, full, atol=ATOL)
    assert ps.pos == js.pos == 16
    assert {t: g.captures for t, g in ps.step_graphs.items()} == {8: 1, 1: 1}


def test_generate_matches_jax_tokens(pair):
    jff, pff, cfg = pair
    prompt = _ids(cfg, seed=7, length=4)
    got = DecodeSession(pff).generate(prompt, steps=5)
    want = JDecodeSession(jff).generate(prompt, steps=5)
    assert got.shape == (2, 9) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # every greedy choice wins by more than MARGIN: the logits of the
    # rows that chose tokens 4..8, fed the chosen tokens
    s = DecodeSession(pff)
    rows = [s.prefill([got[:, :4]])[:, -1]]
    rows += [s.decode([got[:, t:t + 1]])[:, 0] for t in range(4, 8)]
    top2 = np.sort(np.stack(rows, 1), axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > MARGIN
    np.testing.assert_array_equal(np.argmax(np.stack(rows, 1), -1),
                                  got[:, 4:])


def test_decoding_past_max_len_raises_before_any_write(pair):
    _, pff, cfg = pair
    s = DecodeSession(pff)
    s.prefill([_ids(cfg)[:, :16]])
    before = {n: {k: t.clone() for k, t in c.items()}
              for n, c in s.caches.items()}
    with pytest.raises(ValueError, match="past max_len"):
        s.decode([_ids(cfg)[:, :1]])
    assert s.pos == 16
    assert all(torch.equal(s.caches[n][k], t)
               for n, c in before.items() for k, t in c.items())
    short = DecodeSession(pff, max_len=8)
    with pytest.raises(ValueError, match="past max_len"):
        short.prefill([_ids(cfg)[:, :9]])
    assert short.pos == 0 and not short.step_graphs
    assert all(not t.any() for c in short.caches.values()
               for t in c.values())


def test_non_causal_model_refuses():
    cfg = TransformerConfig(num_layers=1, hidden_size=32, num_heads=2,
                            seq_length=8, batch_size=2, causal=False)
    ff = create_transformer(cfg, P.FFConfig(batch_size=2), device="cpu")
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=P.CompMode.INFERENCE)
    with pytest.raises(NotImplementedError, match="not causal"):
        init_kv_cache(ff)
    with pytest.raises(NotImplementedError, match="not causal"):
        DecodeSession(ff)


def test_report_lists_cached_einsum(pair):
    _, pff, cfg = pair
    s = DecodeSession(pff)
    s.prefill([_ids(cfg)[:, :3]])
    rep = s.report()
    assert rep == dict(batch=2, max_len=16, pos=3,
                       kernel_choices={"l0_attn": "cached_einsum",
                                       "l1_attn": "cached_einsum"})


def test_caches_are_distinct_buffers_in_the_compute_dtype(pair):
    _, pff, cfg = pair
    caches = init_kv_cache(pff)
    assert sorted(caches) == ["l0_attn", "l1_attn"]
    ts = [t for c in caches.values() for t in c.values()]
    assert len({t.data_ptr() for t in ts}) == 4
    assert {(tuple(t.shape), t.dtype) for t in ts} \
        == {((2, 2, 16, 16), pff.executor.compute_dtype)}


def test_compiled_decode_is_two_graphs_in_place_and_bit_equal_to_eager(
        pair):
    """prefill + 8 decodes through the compiled steps: two signatures in
    all, the caches the session's own buffers written in place (nothing
    copied back), and every block's logits and the final caches equal to
    the eager body's, run from a second session, bit for bit."""
    _, pff, cfg = pair
    ids = _ids(cfg, seed=3)
    comp, eager = DecodeSession(pff), DecodeSession(pff)
    bufs = {n: {k: (t, t.data_ptr()) for k, t in c.items()}
            for n, c in comp.caches.items()}
    blocks = [(0, 8)] + [(t, t + 1) for t in range(8, 16)]
    for a, b in blocks:
        got = comp._run([ids[:, a:b]], b - a)
        want = eager._run([ids[:, a:b]], b - a, eager=True)
        np.testing.assert_array_equal(got, want)
    assert {t: g.captures for t, g in comp.step_graphs.items()} \
        == {8: 1, 1: 1}
    assert all(g.copy_back_leaves == 0 for g in comp.step_graphs.values())
    assert all(comp.caches[n][k] is t and t.data_ptr() == ptr
               for n, c in bufs.items() for k, (t, ptr) in c.items())
    assert all(torch.equal(comp.caches[n][k], eager.caches[n][k])
               for n in bufs for k in ("k", "v"))
    assert not eager.step_graphs or all(
        g.captures == 0 for g in eager.step_graphs.values())


def test_decode_on_a_seq_mesh_raises():
    """The reference shards the cache's sequence over a ring axis; one
    device has no such layout."""
    cfg = LlamaModelConfig(**dict(SMALL, seq_parallel="seq"))
    ff = _compile(create_llama(cfg, P.FFConfig(batch_size=2), device="cpu"),
                  P, mesh=make_mesh(4, {"seq": 4}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        DecodeSession(ff)


def test_decode_drives_only_the_graph_executor(pair):
    from flexflow_tpu_torch.executor import GraphExecutor

    _, pff, _ = pair
    cls = pff.executor.__class__
    pff.executor.__class__ = type("Lowered", (GraphExecutor,), {})
    try:
        with pytest.raises(NotImplementedError, match="GraphExecutor"):
            DecodeSession(pff)
    finally:
        pff.executor.__class__ = cls


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode (run "
                    "with pytest -m cuda on the card)")


@pytest.mark.cuda
def test_replayed_decode_step_is_bit_equal_to_eager_on_card(cuda_card):
    """On the card: prefill, then one decode step that captures; then at
    two positions a replay against the eager body from the same caches
    and position, logits and caches bit for bit."""
    cfg = LlamaModelConfig(**dict(SMALL, hidden_size=256,
                                  intermediate_size=512,
                                  num_attention_heads=4,
                                  num_key_value_heads=2, seq_length=64))
    ff = _compile(create_llama(cfg, P.FFConfig(batch_size=2),
                               device="cuda"), P)
    ids = _ids(cfg, seed=1)
    s = DecodeSession(ff)
    s.prefill([ids[:, :40]])
    s.decode([ids[:, 40:41]])
    for t in (41, 57):
        while s.pos < t:
            s.decode([ids[:, s.pos:s.pos + 1]])
        saved = {n: {k: v.clone() for k, v in c.items()}
                 for n, c in s.caches.items()}
        replayed = s.decode([ids[:, t:t + 1]])
        after = {n: {k: v.clone() for k, v in c.items()}
                 for n, c in s.caches.items()}
        for n, c in saved.items():
            for k, v in c.items():
                s.caches[n][k].copy_(v)
        s.pos = t
        eager = s._run([ids[:, t:t + 1]], 1, eager=True)
        np.testing.assert_array_equal(replayed, eager)
        assert all(torch.equal(s.caches[n][k], after[n][k])
                   for n in after for k in ("k", "v"))
    assert {t: (g.captures, g.replays >= 2)
            for t, g in s.step_graphs.items()} == {40: (1, False),
                                                  1: (1, True)}
