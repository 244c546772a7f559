"""PyTorch port, the serving slice against the JAX package.

One 2-layer BERT-proxy transformer (hidden 64, 2 heads, seq 128, batch 4)
is built and compiled for inference in both packages — the JAX side on
one device (``workers_per_node=1``) with its flash attention running the
Pallas kernel in interpret mode — and the JAX model's parameters are
carried into the port. Then ``predict`` and requests served through each
side's ``ServingEngine`` must agree.

Tolerance: atol 1e-4, rtol 1e-4 for port vs JAX — f32 on both sides
through 2 layers; the flash kernel's blocked softmax and the port's
einsum core sum in different orders. Port engine rows vs port ``predict``
rows: atol 1e-6 — the same ops on the same rows; only GEMM blocking over
a batch with a zero padding row may differ.
"""

import threading

import jax
import numpy as np
import pytest

import flexflow_tpu as J
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
import flexflow_tpu_torch as P
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.weights import from_jax_params

ATOL = RTOL = 1e-4
SMALL = dict(num_layers=2, hidden_size=64, num_heads=2, seq_length=128,
             batch_size=4)


def _compile(ff, const):
    ff.compile(None, const.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=const.CompMode.INFERENCE)
    return ff


@pytest.fixture(scope="module")
def models():
    """(jax_ff, port_ff, x): both compiled, the port carrying the JAX
    model's parameters. The Pallas interpret mode stays set while the
    module's tests run: JAX reads it when it traces."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jff = _compile(j_create_transformer(
            JTransformerConfig(**SMALL),
            J.FFConfig(batch_size=4, workers_per_node=1)), J)
        pff = _compile(create_transformer(
            TransformerConfig(**SMALL), P.FFConfig(batch_size=4),
            device="cpu"), P)
        from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
        x = np.random.RandomState(0).randn(4, 128, 64).astype(np.float32)
        yield jff, pff, x


def test_jax_reference_runs_the_pallas_flash_kernel(models):
    jff, _, _ = models
    attn = [n.op for n in jff.executor.nodes
            if n.op.op_type == J.OperatorType.MULTIHEAD_ATTENTION]
    assert len(attn) == 2
    assert all(op.selected_impl() == "flash" for op in attn)


def test_predict_matches_jax(models):
    jff, pff, x = models
    want = np.asarray(jff.predict(x))
    got = pff.predict(x)
    assert got.shape == want.shape == (4, 128, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_served_requests_match_jax_and_predict(models):
    """3 requests into the bucket-4 executor: one padding row."""
    jff, pff, x = models
    jeng, peng = jff.serve(), pff.serve()
    assert tuple(peng.scheduler.buckets) == tuple(jeng.scheduler.buckets) \
        == (1, 2, 4)
    reg = get_registry()
    padded = reg.get("serve/padded_rows")
    jreqs = [jeng.submit([x[i]]) for i in range(3)]
    preqs = [peng.submit([x[i]]) for i in range(3)]
    assert jeng.pump() == 3 and peng.pump() == 3
    assert reg.get("serve/padded_rows") == padded + 1
    jrows = np.stack([np.asarray(r.wait(10)) for r in jreqs])
    prows = np.stack([r.wait(10) for r in preqs])
    assert prows.shape == (3, 128, 1)
    np.testing.assert_allclose(prows, jrows, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(prows, pff.predict(x)[:3], atol=1e-6, rtol=0)


def test_background_engine_serves_client_threads(models):
    _, pff, x = models
    want = pff.predict(x)
    engine = pff.serve(max_wait_ms=1.0, start=True)
    results = {}

    def client(i):
        results[i] = engine.submit([x[i]]).wait(30)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        engine.stop()
    assert not any(t.is_alive() for t in threads)
    for i in range(4):
        np.testing.assert_allclose(results[i], want[i], atol=1e-6, rtol=0)


def test_bucket_report_records_the_attention_core(models):
    _, pff, _ = models
    report = pff.serve().bucket_report()
    assert sorted(report) == ["1", "2", "4"]
    for rep in report.values():
        assert rep["objective"] == "reused-training-strategy"
        # CPU: the availability rule picks the einsum core
        assert rep["kernel_choices"] == {"attn_0": "einsum",
                                         "attn_1": "einsum"}


def test_search_budget_raises(models):
    """The per-bucket latency search landed with the search slice: a
    budget no longer raises, and every bucket records the latency
    objective at its batch, with its predicted latency."""
    _, pff, _ = models
    report = pff.serve(search_budget=2).bucket_report()
    assert sorted(report) == ["1", "2", "4"]
    for b, rep in report.items():
        assert rep["objective"] == f"latency@batch{b}"
        assert rep["predicted_latency_s"] > 0
        assert rep["mesh"] == {"data": 1}


def test_training_compile_raises():
    """Training compiles now; without an optimizer it raises."""
    ff = create_transformer(TransformerConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="needs an optimizer"):
        ff.compile(None, P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])


def test_serve_workload_builds_on_cpu():
    from flexflow_tpu_torch.serve.loadgen import build_serve_model

    ff, make, cfg = build_serve_model("transformer", on_cpu=True,
                                      device="cpu")
    assert cfg["num_layers"] == 2 and cfg["batch_size"] == 8
    out = ff.predict(np.stack([make(i)[0] for i in range(8)]))
    assert out.shape == (8, 64, 1) and np.isfinite(out).all()
