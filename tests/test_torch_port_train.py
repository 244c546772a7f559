"""PyTorch port, the training slice against the JAX package.

The CPU ``bert_proxy`` configuration (2 layers, hidden 128, 4 heads, seq
128, batch 8; Adam alpha 1e-4 with bf16 moments, MSE avg-reduce loss, MSE
metric) is built and compiled for training in both packages, the JAX
model's parameters are carried into the port, and both take 3 ``fit``
steps on one seeded batch. Two paths:

- (a) no strategy file: the JAX package takes its flash kernels (Pallas,
  interpret mode) by its availability rule; the port, whose rule is blind
  to the CPU, takes the einsum core. Every parameter updates through the
  plain ``AdamOptimizer.update``.
- (b) a strategy file exported by the JAX package with attention choices
  ``dp_k:flash`` and every other ``dp_k:fused``: both packages pin the
  flash core and route every other op's leaves through the fused update;
  the port runs ``FlashAttention`` and the fused Adam through their plain
  versions (the CPU counterpart of interpret mode).

Tolerances (f32 compute on both sides; sums in different orders):
- per-step loss: rtol 1e-4;
- every parameter after 3 steps: atol 2e-5 (a fifth of alpha, so one
  flipped update fails) and rtol 1e-4;
- m and v after 3 steps: within 1 bf16 ulp of each leaf's largest |value|
  (a gradient that differs in its last f32 bits may round to the
  neighbouring bf16 value; where the moment sum cancels, that step is
  large against the small result, hence the leaf scale).
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.losses import LOSS_FNS as J_LOSS_FNS
from flexflow_tpu.metrics import Metrics as JMetrics
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.optimizers import AdamOptimizer as JAdam
import flexflow_tpu_torch as P
from flexflow_tpu_torch.losses import LOSS_FNS
from flexflow_tpu_torch.metrics import Metrics
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.weights import from_jax_opt_state, from_jax_params

SMALL = dict(num_layers=2, hidden_size=128, num_heads=4, seq_length=128,
             batch_size=8)
STEPS = 3
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


def _jax_model(**cfg_kw):
    ff = j_create_transformer(JTransformerConfig(**SMALL), J.FFConfig(
        batch_size=8, workers_per_node=1, **cfg_kw))
    ff.compile(JAdam(alpha=1e-4, state_dtype=jnp.bfloat16),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [J.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _port_model(jff, **cfg_kw):
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=8, **cfg_kw), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    from_jax_params(jax.tree.map(np.asarray, jff.params), ff)
    return ff


def _edit_choices(path, attn_choice, other_choice):
    """Rewrite every op's choice of a strategy file in place."""
    with open(path) as f:
        data = json.load(f)
    for name, op in data["ops"].items():
        op["choice"] = attn_choice if name.startswith("attn") else other_choice
    with open(path, "w") as f:
        json.dump(data, f)


def _batch():
    rs = np.random.RandomState(0)
    x = rs.randn(8, 128, 128).astype(np.float32)
    y = rs.randn(8, 128, 1).astype(np.float32)
    return x, y


def _train(jff, pff, x, y):
    """STEPS one-batch epochs in both packages -> per-step losses."""
    losses = []
    for _ in range(STEPS):
        jff.fit(x, y, epochs=1, verbose=False)
        pff.fit(x, y, epochs=1, verbose=False)
        losses.append((jff._last_loss, pff._last_loss))
    return losses


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both paths, trained STEPS steps in both packages: {"a": ..., "b":
    ...} of (jax_ff, port_ff, losses, strategy file or None). The Pallas
    interpret mode stays set while the module's tests run: JAX reads it
    when it traces."""
    path = str(tmp_path_factory.mktemp("strategy") / "strategy.json")
    x, y = _batch()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jff = _jax_model(export_strategy_file=path)
        pff = _port_model(jff)
        out["a"] = (jff, pff, _train(jff, pff, x, y), None)
        _edit_choices(path, "dp_k:flash", "dp_k:fused")
        jff = _jax_model(import_strategy_file=path)
        pff = _port_model(jff, import_strategy_file=path)
        fwd0, bwd0 = flash_fwd.launches, flash_bwd.launches
        out["b"] = (jff, pff, _train(jff, pff, x, y), path)
        # the CPU runs the plain versions: no kernel launch
        assert (flash_fwd.launches, flash_bwd.launches) == (fwd0, bwd0)
        yield out


def _bf16_leaf_ulps(a, b) -> float:
    b = np.asarray(b).astype(np.float64)
    a = np.asarray(a, dtype=np.float64)
    scale = max(float(np.abs(b).max()), 1e-38)
    return float(np.abs(a - b).max() / 2.0 ** (np.floor(np.log2(scale)) - 7))


@pytest.mark.parametrize("path", ["a", "b"])
def test_losses_match_per_step(trained, path):
    _, _, losses, _ = trained[path]
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert losses[-1][1] < losses[0][1]


@pytest.mark.parametrize("path", ["a", "b"])
def test_params_match_after_training(trained, path):
    jff, pff, _, _ = trained[path]
    jp = jax.tree.map(np.asarray, jff.params)
    assert set(jp) == set(pff.params)
    for layer, sub in jp.items():
        for name, want in sub.items():
            np.testing.assert_allclose(pff.get_parameter(layer, name), want,
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{layer}/{name}")


@pytest.mark.parametrize("path", ["a", "b"])
def test_moments_match_to_bf16_ulp(trained, path):
    jff, pff, _, _ = trained[path]
    assert int(pff.opt_state["t"]) == int(jff.opt_state["t"]) == STEPS
    for key in ("m", "v"):
        for layer, sub in jff.opt_state[key].items():
            for name, want in sub.items():
                got = pff.opt_state[key][layer][name]
                assert got.dtype == torch.bfloat16
                assert _bf16_leaf_ulps(got.float().numpy(), want) <= 1.0, \
                    f"{key}/{layer}/{name}"


def test_strategy_import_gives_the_reference_choices(trained):
    """Path (b): the port read the JAX package's exported, edited file and
    chose what the reference chose."""
    jff, pff, _, _ = trained["b"]
    assert pff.kernel_choices == jff.executor.kernel_choices
    assert pff.executor.fused_update_ops == jff.executor.fused_update_ops
    assert {n.op.name: n.op.kernel_impl for n in pff.executor.nodes
            if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION} \
        == {"attn_0": "flash", "attn_1": "flash"}
    assert trained["a"][1].kernel_choices is None


def test_strategy_without_kernel_suffix_on_attention(trained, tmp_path):
    """Attention choices without ``_k:`` are recorded as einsum, as the
    reference records them; on the CPU flash could not have run, so the op
    is not pinned."""
    src = trained["b"][3]
    path = str(tmp_path / "s.json")
    with open(src) as f:
        data = json.load(f)
    with open(path, "w") as f:
        json.dump(data, f)
    _edit_choices(path, "dp", "dp_k:fused")
    pff = create_transformer(TransformerConfig(**SMALL),
                             P.FFConfig(import_strategy_file=path),
                             device="cpu")
    pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert pff.kernel_choices["attn_0"] == "einsum"
    assert all(n.op.kernel_impl is None for n in pff.executor.nodes
               if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION)


def test_kernel_search_off_drops_the_choices(trained, tmp_path):
    path = trained["b"][3]
    pff = create_transformer(
        TransformerConfig(**SMALL),
        P.FFConfig(import_strategy_file=path, kernel_search="off"),
        device="cpu")
    pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert pff.kernel_choices is None
    assert pff.executor.fused_update_ops == set()


@pytest.mark.parametrize("mesh,choice,match", [
    ({"data": 2}, "dp", "multi-GPU slice"),
])
def test_strategy_import_refuses_what_later_slices_bring(trained, tmp_path,
                                                         mesh, choice, match):
    with open(trained["b"][3]) as f:
        data = json.load(f)
    data["mesh"] = mesh
    data["ops"]["ffn1_0"]["choice"] = choice
    path = tmp_path / "s.json"
    path.write_text(json.dumps(data))
    pff = create_transformer(TransformerConfig(**SMALL),
                             P.FFConfig(import_strategy_file=str(path)),
                             device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)


def test_strategy_import_trains_a_remat_choice(trained, tmp_path):
    """A ``_k:fused_r`` choice (refused until the port had remat) compiles,
    checkpoints that op, and trains bit-equal to ``_k:fused``."""
    with open(trained["b"][3]) as f:
        data = json.load(f)
    data["ops"]["ffn1_0"]["choice"] = "dp_k:fused_r"
    path = tmp_path / "s.json"
    path.write_text(json.dumps(data))
    x, y = _batch()
    models = []
    for file in (trained["b"][3], str(path)):
        pff = create_transformer(TransformerConfig(**SMALL),
                                 P.FFConfig(import_strategy_file=file),
                                 device="cpu")
        pff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                    P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        pff.fit(x, y, epochs=1, verbose=False)
        models.append(pff)
    plain, remat = models
    assert plain.remat_ops is None and remat.remat_ops == {"ffn1_0"}
    assert remat.kernel_choices == plain.kernel_choices
    assert remat.epoch_losses == plain.epoch_losses
    assert all(torch.equal(remat.params[op][pn], t)
               for op, sub in plain.params.items() for pn, t in sub.items())


def test_carried_state_continues_like_the_reference(trained):
    """Carry the JAX model's parameters and optimizer state after STEPS
    steps (t = 3, bf16 moments) into the port; one more step in each
    agrees, with bias correction at t = 4."""
    jff, pff, _, _ = trained["a"]
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    from_jax_opt_state(jax.tree.map(np.asarray, jff.opt_state), pff)
    assert pff.opt_state["t"].dtype == torch.int32
    m0 = pff.opt_state["m"]["ffn1_0"]["kernel"]
    want = np.asarray(jff.opt_state["m"]["ffn1_0"]["kernel"])
    assert np.array_equal(m0.view(torch.int16).numpy(), want.view(np.int16))
    x, y = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jff.fit(x, y, epochs=1, verbose=False)
    pff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_allclose(pff._last_loss, jff._last_loss, rtol=LOSS_RTOL)
    assert int(pff.opt_state["t"]) == STEPS + 1
    for layer, sub in jax.tree.map(np.asarray, jff.params).items():
        for name, want in sub.items():
            np.testing.assert_allclose(pff.get_parameter(layer, name), want,
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL)


def test_evaluate_matches_the_reference(trained):
    jff, pff, _, _ = trained["b"]
    x, y = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        want = jff.evaluate(x, y)
    got = pff.evaluate(x, y)
    assert set(got) == set(want) == {"loss", "mse_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL)


def test_fit_writes_the_registry(trained):
    _, pff, _, _ = trained["b"]
    reg = get_registry()
    before = reg.to_dict()["observations"].get(
        "train/step_latency_s", {}).get("count", 0)
    x, y = _batch()
    pff.fit(np.concatenate([x, x]), np.concatenate([y, y]), epochs=1,
            verbose=False)
    snap = reg.to_dict()
    assert snap["observations"]["train/step_latency_s"]["count"] == before + 2
    # CPU: no kernel launches to count, but the counters exist
    assert snap["counters"]["flash_bwd.launches"] == 0
    assert snap["counters"]["fused_adam.launches"] == 0
    assert len(pff.epoch_losses) == STEPS + 1


@pytest.mark.parametrize("loss_type", list(LOSS_FNS), ids=lambda t: t.name)
def test_losses_match_jax(loss_type):
    rs = np.random.RandomState(loss_type.value)
    name = loss_type.name
    if name == "CATEGORICAL_CROSSENTROPY":
        logits = rs.randn(6, 5).astype(np.float32)
        labels = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 6)]
    elif name == "SPARSE_CATEGORICAL_CROSSENTROPY":
        logits = rs.randn(4, 7, 5).astype(np.float32)
        labels = rs.randint(0, 5, (4, 7, 1)).astype(np.int32)
    else:
        logits = rs.randn(6, 3, 2).astype(np.float32)
        labels = rs.randn(6, 3, 2).astype(np.float32)
    jtype = J.LossType[name]
    want = float(J_LOSS_FNS[jtype](jnp.asarray(logits), jnp.asarray(labels)))
    got = LOSS_FNS[loss_type](torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


def test_sparse_ce_takes_flat_labels():
    rs = np.random.RandomState(1)
    logits = rs.randn(6, 5).astype(np.float32)
    labels = rs.randint(0, 5, (6,)).astype(np.int64)
    jtype = J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY
    want = float(J_LOSS_FNS[jtype](jnp.asarray(logits), jnp.asarray(labels)))
    got = LOSS_FNS[P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY](
        torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("metric", list(P.MetricsType), ids=lambda m: m.name)
@pytest.mark.parametrize("probs", [True, False])
def test_metrics_match_jax(metric, probs):
    """Per-batch sums of each metric, on probabilities (a softmax final op)
    and on logits."""
    rs = np.random.RandomState(metric.value)
    logits = rs.randn(8, 5).astype(np.float32)
    preds = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
             if probs else logits).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rs.randint(0, 5, 8)]
    sparse = onehot.argmax(-1)[:, None].astype(np.int32)
    for loss_name, labels in (("CATEGORICAL_CROSSENTROPY", onehot),
                              ("SPARSE_CATEGORICAL_CROSSENTROPY", sparse)):
        if metric.name == "CATEGORICAL_CROSSENTROPY" and labels is sparse:
            continue
        if metric.name == "SPARSE_CATEGORICAL_CROSSENTROPY" \
                and labels is onehot:
            continue
        want = JMetrics(J.LossType[loss_name], [J.MetricsType[metric.name]],
                        preds_are_probs=probs).compute(
            jnp.asarray(preds), jnp.asarray(labels))
        got = Metrics(P.LossType[loss_name], [metric],
                      preds_are_probs=probs).compute(
            torch.from_numpy(preds), torch.from_numpy(labels))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6)


def test_accuracy_on_a_single_output_matches_jax():
    rs = np.random.RandomState(3)
    preds = rs.rand(8, 1).astype(np.float32)
    labels = rs.randint(0, 2, (8, 1)).astype(np.float32)
    loss = "MEAN_SQUARED_ERROR_AVG_REDUCE"
    want = JMetrics(J.LossType[loss], [J.MetricsType.ACCURACY]).compute(
        jnp.asarray(preds), jnp.asarray(labels))
    got = Metrics(P.LossType[loss], [P.MetricsType.ACCURACY]).compute(
        torch.from_numpy(preds), torch.from_numpy(labels))
    assert int(got["accuracy"]) == int(want["accuracy"])


def _tiny(**cfg):
    return create_transformer(
        TransformerConfig(num_layers=1, hidden_size=64, num_heads=1,
                          seq_length=8, batch_size=2, **cfg),
        P.FFConfig(batch_size=2), device="cpu")


def test_training_needs_an_optimizer():
    with pytest.raises(ValueError, match="needs an optimizer"):
        _tiny().compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)


@pytest.mark.parametrize("kw,match", [
    (dict(trace_dir="/nonexistent"), "slice 6"),
    (dict(profile_steps="1:2"), "slice 6"),
])
def test_fit_refuses_what_slice_6_brings(kw, match, tmp_path, capsys):
    """What slice 6 was to bring (tracing) now runs, and nothing the run
    prints names the refusal (``match``) any more: a trace directory (the
    parameter's path, taken under ``tmp_path``) receives the run's
    artifacts, and a profile window without one warns and trains. The
    name and ids are the ones the refusal had."""
    ff = _tiny()
    ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    x = np.zeros((2, 8, 64), np.float32)
    if "trace_dir" in kw:
        kw = dict(trace_dir=str(tmp_path / kw["trace_dir"].lstrip("/")))
    assert ff.fit(x, np.zeros((2, 8, 1), np.float32), verbose=False,
                  **kw) > 0
    if "trace_dir" in kw:
        assert sorted(p.name.split(".", 1)[1]
                      for p in (tmp_path / "nonexistent").glob("fit_*")) == [
            "counters.json", "drift.json", "events.jsonl", "simtrace.json",
            "summary.json", "trace.json"]
    out = capsys.readouterr()
    assert match not in out.out + out.err
    if "trace_dir" not in kw:
        assert "profiling skipped" in out.err


@pytest.mark.parametrize("kw", [dict(checkpoint_every=1), dict(resume=True)])
def test_fit_checkpoint_flags_need_a_directory(kw):
    """A cadence or a resume with no checkpoint directory raises, as in
    the reference: training on while saving nothing, or starting afresh
    where a resume was asked, would be silent."""
    ff = _tiny()
    ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    x = np.zeros((2, 8, 64), np.float32)
    with pytest.raises(ValueError, match="no checkpoint directory"):
        ff.fit(x, np.zeros((2, 8, 1), np.float32), **kw)


def test_inference_model_does_not_train():
    ff = _tiny()
    ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               comp_mode=P.CompMode.INFERENCE)
    with pytest.raises(RuntimeError, match="forward-only"):
        ff.fit(np.zeros((2, 8, 64), np.float32),
               np.zeros((2, 8, 1), np.float32))


def test_attention_dropout_in_training_raises():
    """Attention-prob dropout trains (the einsum core, its mask drawn
    from the model's generator); a training forward given no generator
    raises, as the reference's ``ctx.next_rng`` does."""
    ff = _tiny(dropout=0.1)
    ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    x = np.random.RandomState(0).randn(2, 8, 64).astype(np.float32)
    y = np.zeros((2, 8, 1), np.float32)
    ff.fit(x, y, verbose=False)
    assert np.isfinite(ff._last_loss)
    with pytest.raises(ValueError, match="needs rng"):
        ff.executor.grads_of(ff.params, ff.state, ff._stage_inputs([x]),
                             ff._stage_labels(y), rng=None)


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.5])
def test_attention_dropout_statistics(rate):
    """The einsum core with dropout at ``rate``: with V the identity its
    output is the dropped probabilities. The share of zeros lies within 5
    binomial standard deviations of ``rate``, every kept probability is
    the undropped one over ``1 - rate`` (f32 rounding), one generator
    seed gives one mask, and rate 0 is the core without dropout."""
    from flexflow_tpu_torch.ops.attention import scaled_dot_product_attention
    b, h, s = 2, 4, 64
    rs = np.random.RandomState(3)
    q = torch.from_numpy(rs.randn(b, h, s, s).astype(np.float32))
    k = torch.from_numpy(rs.randn(b, h, s, s).astype(np.float32))
    v = torch.eye(s).expand(b, h, s, s)
    plain = scaled_dot_product_attention(q, k, v)
    got = [scaled_dot_product_attention(
        q, k, v, dropout_rate=rate,
        rng=torch.Generator().manual_seed(7)) for _ in range(2)]
    assert torch.equal(got[0], got[1])
    if rate == 0.0:
        assert torch.equal(got[0], plain)
        return
    zero = got[0] == 0
    n = zero.numel()
    assert abs(zero.float().mean().item() - rate) \
        <= 5 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(got[0][~zero], plain[~zero] / (1 - rate),
                               rtol=1e-6, atol=0)


def test_export_strategy_raises(tmp_path):
    """Strategy export landed with the search slice: it raises only where
    the file cannot be written, and otherwise writes the heuristic
    strategy of a compile without a search (mesh, one entry per op)."""
    bad = str(tmp_path / "missing" / "s.json")
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(export_strategy_file=bad),
                            device="cpu")
    with pytest.raises(FileNotFoundError):
        ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    with pytest.raises(FileNotFoundError):
        unity.export_strategy_file(bad, {}, {}, [])
    good = tmp_path / "s.json"
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(export_strategy_file=str(good)),
                            device="cpu")
    ff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    data = json.loads(good.read_text())
    assert data["mesh"] == {"data": 1} and "objective" not in data
    assert sorted(data["ops"]) == sorted(ff.get_layer_names())


def test_parse_args_reads_the_training_flags():
    argv = ["--import-strategy", "s.json", "--kernel-search", "off", "x"]
    p, j = P.FFConfig(), J.FFConfig()
    rest = p.parse_args(argv)
    j.parse_args(argv)
    assert (p.import_strategy_file, p.kernel_search) \
        == (j.import_strategy_file, j.kernel_search) == ("s.json", "off")
    assert rest == ["x"]
    assert P.FFConfig().parse_args(["--import", "t.json"]) == []
    with pytest.raises(ValueError, match="auto|off"):
        P.FFConfig().parse_args(["--kernel-search", "on"])


@pytest.mark.parametrize("choice,impl,remat", [
    (None, None, False), ("dp", None, False), ("dp_k:flash", "flash", False),
    ("dp_wus_ovl_k:fused", "fused", False), ("dp_k:fused_r", "fused", True),
    ("dp_r", None, True),
])
def test_choice_suffixes_read_as_the_reference_reads_them(choice, impl,
                                                          remat):
    from flexflow_tpu.search.unity import kernel_choice_of, remat_choice_of
    assert unity.kernel_choice_of(choice) == kernel_choice_of(choice) == impl
    assert unity.remat_choice_of(choice) == remat_choice_of(choice) == remat


def test_bf16_state_carries_bit_for_bit():
    """from_jax_opt_state keeps the bits of bf16 moments."""
    ff = _tiny()
    ff.compile(AdamOptimizer(state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    rs = np.random.RandomState(0)
    state = {k: {op: {n: rs.randn(*t.shape).astype(ml_dtypes.bfloat16)
                      for n, t in sub.items()}
                 for op, sub in ff.params.items()} for k in ("m", "v")}
    state["t"] = np.int32(9)
    from_jax_opt_state(state, ff)
    got = ff.opt_state["v"]["head"]["kernel"]
    assert np.array_equal(got.view(torch.int16).numpy(),
                          state["v"]["head"]["kernel"].view(np.int16))
    assert int(ff.opt_state["t"]) == 9
    state["m"]["head"]["kernel"] = state["m"]["head"]["kernel"].astype(
        np.float32)
    with pytest.raises(ValueError, match="dtype"):
        from_jax_opt_state(state, ff)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sm_90a kernels have no CPU mode "
                    "(run with python3 chip_smoke.py or pytest -m cuda on "
                    "the H100)")


@pytest.mark.cuda
def test_training_on_card_launches_the_kernels(cuda_card, tmp_path):
    """On the card, path (b) at a small width: each step launches the
    forward and backward kernels once per layer and the fused Adam once,
    and the loss falls."""
    cfg = TransformerConfig(num_layers=2, hidden_size=256, num_heads=4,
                            seq_length=128, batch_size=4)
    path = tmp_path / "s.json"
    path.write_text(json.dumps({"version": 1, "mesh": {"data": 1}, "ops": {
        n: {"choice": "dp_k:flash" if n.startswith("attn") else "dp_k:fused"}
        for n in ("ln1_0", "attn_0", "ln2_0", "ffn1_0", "ffn2_0", "ln1_1",
                  "attn_1", "ln2_1", "ffn1_1", "ffn2_1", "head")}}))
    ff = create_transformer(cfg, P.FFConfig(batch_size=4,
                                            import_strategy_file=str(path)))
    ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    from flexflow_tpu_torch.ops.fused_update import fused_adam_multi
    rs = np.random.RandomState(0)
    x = rs.randn(4, 128, 256).astype(np.float32)
    y = rs.randn(4, 128, 1).astype(np.float32)
    counts = (flash_fwd.launches, flash_bwd.launches,
              fused_adam_multi.launches)
    ff.fit(x, y, epochs=3, verbose=False)
    assert (flash_fwd.launches - counts[0], flash_bwd.launches - counts[1],
            fused_adam_multi.launches - counts[2]) == (6, 6, 3)
    assert all(np.isfinite(ff.epoch_losses))
    assert ff.epoch_losses[-1] < ff.epoch_losses[0]
