"""PyTorch port, training the decoder LM (``create_llama``) against the
JAX package.

Both packages build the model at the reference's test size (vocab 256,
hidden 64, intermediate 128, 2 layers, 4 heads; kv heads 4, 2 and 1 for
grouped-query ratios 1, 2 and 4), compile it for training with the
token-level sparse CE loss over ``[B, S, V]`` logits, and the port
carries the JAX model's parameters (``from_jax_params``). Batches follow
``tests/test_llama.py``'s learnable pattern (next token = token + 1),
made from a seed with numpy. f32 on the CPU, on one device.

Tolerances (f32 on both sides, sums in different orders):
- losses: rtol 1e-4, and the reference's own training test's falls
  within 1e-3 after 80 SGD steps at lr 0.5 (each step's small rounding
  differences compound);
- parameters after 3 steps: atol 2e-5 and rtol 1e-4, as in
  ``test_torch_port_train.py`` (Adam at alpha 1e-4: a fifth of a step,
  so one flipped update fails);
- gradients of the flash path (S 128, causal; the port's flash core
  through the kernels' plain versions, the JAX package's Pallas kernels
  in interpret mode) against ``jax.grad``: 1e-5 of each leaf's largest
  |gradient|, as the kernels' plain versions are held to the Pallas
  kernels (``test_torch_port_flash_bwd.py``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.models.llama import (LlamaModelConfig as JLlamaModelConfig,
                                       create_llama as j_create_llama)
from flexflow_tpu.ops.base import OpContext as JContext
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models.llama import LlamaModelConfig, create_llama
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

STEPS = 3
LOSS_RTOL = 1e-4
LONG_RUN_RTOL = 1e-3
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
GRAD_RTOL = 1e-5
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, batch_size=2, seq_length=16)
GQA = {"rep1": 4, "rep2": 2, "rep4": 1}
# the flash path: the JAX package's Pallas kernels take S from 128
FLASH = dict(SMALL, seq_length=128)


def _aligned():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _optimizers(kind):
    if kind == "sgd":
        return JSGD(lr=0.1), SGDOptimizer(lr=0.1)
    return (JAdam(alpha=1e-4, state_dtype=jnp.bfloat16),
            AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16))


def _pair(opt="sgd", strategy=None, **cfg_kw):
    """(JAX model, port model), compiled for training on one device from
    one strategy file (None: none), the port carrying the JAX model's
    parameters."""
    kw = dict(SMALL, **cfg_kw)
    _aligned()
    jff = j_create_llama(JLlamaModelConfig(**kw), J.FFConfig(
        batch_size=kw["batch_size"], workers_per_node=1,
        import_strategy_file=strategy))
    pff = create_llama(LlamaModelConfig(**kw), P.FFConfig(
        batch_size=kw["batch_size"], import_strategy_file=strategy),
        device="cpu")
    jopt, popt = _optimizers(opt)
    jff.compile(jopt, J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    pff.compile(popt, P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    return jff, pff


def _batch(cfg, n=None, seed=1):
    """Ids and their next-token labels (``tests/test_llama.py``)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg["vocab_size"] - 1,
                     (n or cfg["batch_size"], cfg["seq_length"])
                     ).astype(np.int32)
    return ids, ((ids + 1) % cfg["vocab_size"]).astype(np.int32)


def _steps(jff, pff, ids, labels):
    losses = []
    for _ in range(STEPS):
        jff.fit(ids, labels, epochs=1, verbose=False)
        pff.fit(ids, labels, epochs=1, verbose=False)
        losses.append((jff._last_loss, pff._last_loss))
    return np.array(losses)


def _close_params(pff, jff):
    for op, sub in jff.params.items():
        for pn, w in sub.items():
            np.testing.assert_allclose(pff.params[op][pn].numpy(),
                                       np.asarray(w), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=f"{op}/{pn}")


@pytest.mark.parametrize("kv", sorted(GQA))
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_evaluate_and_steps_match_jax(opt, kv):
    jff, pff = _pair(opt, num_key_value_heads=GQA[kv])
    ids, labels = _batch(SMALL)
    want, got = (ff.evaluate(ids, labels)["loss"] for ff in (jff, pff))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    losses = _steps(jff, pff, ids, labels)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=LOSS_RTOL)
    _close_params(pff, jff)
    if opt == "sgd":
        assert losses[-1, 1] < losses[0, 1]


def test_trains_token_level_ce_in_both_packages():
    """``tests/test_llama.py::test_trains_token_level_ce`` in both
    packages from one state: 10 epochs of 8 batches at SGD lr 0.5."""
    cfg = dict(SMALL, batch_size=4)
    _aligned()
    jff = j_create_llama(JLlamaModelConfig(**cfg), J.FFConfig(
        batch_size=4, workers_per_node=1))
    pff = create_llama(LlamaModelConfig(**cfg), P.FFConfig(batch_size=4),
                       device="cpu")
    jff.compile(JSGD(lr=0.5), J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    pff.compile(SGDOptimizer(lr=0.5),
                P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    ids, labels = _batch(cfg, n=32)
    out = []
    for ff in (jff, pff):
        l0 = ff.evaluate(ids, labels)["loss"]
        ff.fit(ids, labels, epochs=10, verbose=False)
        l1 = ff.evaluate(ids, labels)["loss"]
        assert l1 < l0 * 0.9, (l0, l1)
        out.append((l0, l1))
    (jl0, jl1), (pl0, pl1) = out
    np.testing.assert_allclose(pl0, jl0, rtol=LOSS_RTOL)
    np.testing.assert_allclose(pl1, jl1, rtol=LONG_RUN_RTOL)


def _strategy(tmp_path, name, choice_of):
    probe = create_llama(LlamaModelConfig(**FLASH), device="cpu")
    ops = {layer.name: dict(choice=choice_of(layer), outputs=[None],
                            params={})
           for layer in probe.layers if layer.op_type.name != "INPUT"}
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(dict(version=1, mesh={"data": 1}, ops=ops)))
    return str(path)


def _jax_grads(jff, ids, labels):
    """``jax.grad`` of the JAX executor's training loss."""
    ex = jff.executor
    inputs = {ex.input_names[0]: jnp.asarray(ids)}

    def loss(params):
        ctx = JContext(training=True, compute_dtype=ex.compute_dtype,
                       mesh=ex.mesh)
        values, _, _ = ex.run_graph(params, jff.state, inputs, ctx)
        return ex._loss_value(values[ex.final_ref], jnp.asarray(labels))

    return jax.grad(loss)(jff.params)


def test_flash_gradients_match_jax_grad(tmp_path, monkeypatch):
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
    path = _strategy(tmp_path, "flash", lambda l: "dp_k:flash"
                     if l.op_type.name == "MULTIHEAD_ATTENTION" else "dp")
    jff, pff = _pair(strategy=path, seq_length=FLASH["seq_length"])
    attn = [n.op for n in pff.executor.nodes
            if n.op.op_type.name == "MULTIHEAD_ATTENTION"]
    assert {(op.kernel_impl, op.causal) for op in attn} == {("flash", True)}
    assert {n.op.kernel_impl for n in jff.executor.nodes
            if n.op.op_type.name == "MULTIHEAD_ATTENTION"} == {"flash"}
    ids, labels = _batch(FLASH)
    want = _jax_grads(jff, ids, labels)
    _, _, got = pff.executor.grads_of(pff.params, pff.state,
                                      pff._stage_inputs(ids),
                                      pff._stage_labels(labels))
    for op, sub in want.items():
        for pn, w in sub.items():
            w = np.asarray(w)
            gap = np.abs(got[op][pn].numpy() - w).max()
            assert gap <= GRAD_RTOL * np.abs(w).max(), (op, pn, gap)


def test_fused_remat_strategy_trains_like_jax(tmp_path, monkeypatch):
    """One strategy file in both packages: attention ``dp_k:flash_r``,
    RMSNorm ``dp_k:fused_r``, every other op ``dp_k:fused``; Adam with
    bf16 moments, 3 steps."""
    monkeypatch.setenv("FLEXFLOW_TPU_PALLAS", "interpret")

    def choice_of(layer):
        kind = layer.op_type.name
        if kind == "MULTIHEAD_ATTENTION":
            return "dp_k:flash_r"
        return "dp_k:fused_r" if kind == "RMSNORM" else "dp_k:fused"

    path = _strategy(tmp_path, "fused_remat", choice_of)
    jff, pff = _pair("adam", strategy=path, seq_length=FLASH["seq_length"])
    assert pff.remat_ops == jff.remat_ops
    assert pff.remat_ops == {"final_ln"} | {
        f"l{i}_{kind}" for i in range(SMALL["num_hidden_layers"])
        for kind in ("input_ln", "attn", "post_ln")}
    assert pff.kernel_choices == jff.executor.kernel_choices
    assert pff.executor.fused_update_ops == jff.executor.fused_update_ops
    ids, labels = _batch(FLASH)
    losses = _steps(jff, pff, ids, labels)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=LOSS_RTOL)
    _close_params(pff, jff)


# ---- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernels have no CPU mode "
                    "(run with pytest -m cuda on the card)")


@pytest.mark.cuda
def test_kernel_path_trains_like_the_plain_path_on_card(cuda_card, tmp_path):
    """A decoder at head dim 128 (hidden 256, 2 heads, 1 kv head, S 128,
    causal) through K1, K2 and K4 (``dp_k:flash`` attention, the rest
    ``dp_k:fused``) against the plain path (``dp_k:einsum``, plain Adam)
    from one seed: 3 steps, losses within 2e-2 (bf16 activations, the
    tolerance chip_smoke holds the BERT-proxy's paths to), and each
    kernel launched as the path says, a step."""
    from flexflow_tpu_torch.step_graph import read_launch_counts

    cfg = dict(SMALL, hidden_size=256, intermediate_size=512,
               num_attention_heads=2, num_key_value_heads=1, seq_length=128)

    def choice(kernels):
        def choice_of(layer):
            if layer.op_type.name == "MULTIHEAD_ATTENTION":
                return "dp_k:flash" if kernels else "dp_k:einsum"
            return "dp_k:fused" if kernels else "dp"
        return choice_of

    ids, labels = _batch(cfg)
    losses, launches = {}, {}
    for kernels in (True, False):
        probe = create_llama(LlamaModelConfig(**cfg), device="cuda")
        ops = {layer.name: dict(choice=choice(kernels)(layer),
                                outputs=[None], params={})
               for layer in probe.layers if layer.op_type.name != "INPUT"}
        path = tmp_path / f"{kernels}.json"
        path.write_text(json.dumps(dict(version=1, mesh={"data": 1},
                                        ops=ops)))
        ff = create_llama(LlamaModelConfig(**cfg), P.FFConfig(
            batch_size=cfg["batch_size"], import_strategy_file=str(path)),
            device="cuda")
        ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
                   P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        before = read_launch_counts()
        for _ in range(STEPS):
            ff.fit(ids, labels, epochs=1, verbose=False)
        torch.cuda.synchronize()
        launches[kernels] = {k: v - before[k]
                             for k, v in read_launch_counts().items()}
        losses[kernels] = np.array(ff.epoch_losses)
    layers = cfg["num_hidden_layers"]
    assert launches[True] == {
        "flash_fwd.launches": layers * STEPS, "flash_fwd.lse_launches": 0,
        "flash_bwd.launches": layers * STEPS, "flash_bwd.lse_launches": 0,
        "fused_adam_multi.launches": STEPS}, launches[True]
    assert not any(launches[False].values()), launches[False]
    assert np.isfinite(losses[True]).all()
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-2)
