"""PyTorch port: checkpoint and resume against the JAX package.

``flexflow_tpu_torch/ckpt`` and ``checkpoint.py`` write the reference's
formats (v2 per-shard, v1 single file), so:

- port writes, port resumes: v2 and v1 round-trip bit for bit (bf16 bits
  included, and the generator), and ``fit(resume=True)`` after an
  interrupted run equals the uninterrupted run bit for bit (losses and
  every leaf: parameters, m, v, t, BatchNorm statistics) for an MLP, a
  dropout MLP, a 2-layer BERT-proxy with ``dp_k:flash`` / ``dp_k:fused``
  strategy choices, and a small BatchNorm conv model, at a checkpoint
  inside an epoch too;
- cross-package: a checkpoint the JAX package saves (on one device, and
  on conftest's 8-device mesh with weight-update-sharded moments) loads
  into the port, and one the port saves loads into the JAX package; both
  then train on to the same losses (``LOSS_RTOL``) and parameters
  (``PARAM_ATOL``/``PARAM_RTOL``), as in ``test_torch_port_train.py``.
  Cross-package comparisons are never bitwise on the CPU (their sums
  round in different orders); the restored leaves themselves are;
- failure handling: crash atomicity, corruption caught at load and by
  ``verify_step_dir``, retain-N garbage collection, a writer error on the
  training thread, transient write errors retried, chunked shards, and
  resume without a directory or without a complete checkpoint refused.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.ckpt import save_sharded as j_save_sharded
from flexflow_tpu.machine import make_mesh as j_make_mesh
import flexflow_tpu_torch as P
from flexflow_tpu_torch.ckpt import (collect_garbage, latest_complete,
                                     list_steps, load_manifest, load_sharded,
                                     plan_resume, save_sharded,
                                     verify_step_dir, write_saved_strategy)
from flexflow_tpu_torch.ckpt import manifest as mf
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                   create_transformer)
from flexflow_tpu_torch.obs.registry import get_registry
from flexflow_tpu_torch.optimizers import AdamOptimizer

LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4


def blobs(n=256, d=16, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n)
    x = (centers[y] + rs.randn(n, d)).astype(np.float32)
    return x, y.astype(np.int32).reshape(-1, 1)


def port_mlp(state_dtype=torch.bfloat16, alpha=0.01, dropout=False):
    ff = P.FFModel(P.FFConfig(batch_size=64), device="cpu")
    t = ff.create_tensor((64, 16))
    h = ff.dense(t, 32, activation=ActiMode.AC_MODE_RELU, name="h1")
    if dropout:
        h = ff.dropout(h, 0.5, name="drop")
    ff.softmax(ff.dense(h, 4, name="out"))
    ff.compile(AdamOptimizer(alpha=alpha, state_dtype=state_dtype),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [P.MetricsType.ACCURACY])
    return ff


def jax_mlp(alpha=1e-4, mesh=None, wus=False):
    from flexflow_tpu.ffconst import ActiMode as JActi
    cfg = J.FFConfig(batch_size=64, workers_per_node=1 if mesh is None else 0)
    if wus:
        cfg.weight_update_sharding = "on"
    ff = J.FFModel(cfg)
    t = ff.create_tensor((64, 16))
    h = ff.dense(t, 32, activation=JActi.AC_MODE_RELU, name="h1")
    out = ff.dense(h, 4, name="out")
    ff.softmax(out)
    ff.compile(J.AdamOptimizer(alpha=alpha, state_dtype=jnp.bfloat16),
               J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [J.MetricsType.ACCURACY], mesh=mesh)
    return ff


def bits(t) -> np.ndarray:
    """The bits of a tensor or array (bf16 as uint16)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(f"uint{8 * t.element_size()}") \
            if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    if a.dtype.kind in "iub":
        return a
    return a.view(np.dtype(f"uint{8 * a.dtype.itemsize}"))


def leaves(ff):
    """{key: tensor} of every checkpointed leaf of a port model."""
    from flexflow_tpu_torch.ckpt.sharded import _capture_state
    from flexflow_tpu_torch.ckpt.tree import flatten_tree
    return {k: v for k, v in flatten_tree(_capture_state(ff))
            if isinstance(v, torch.Tensor)}


def assert_same_state(a, b):
    la, lb = leaves(a), leaves(b)
    assert set(la) == set(lb)
    for k in la:
        np.testing.assert_array_equal(bits(la[k]), bits(lb[k]),
                                      err_msg=f"bit mismatch at {k}")


# ---- port writes, port resumes ---------------------------------------------

@pytest.mark.parametrize("state_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_v2_roundtrip_bitwise_and_continuation(tmp_path, state_dtype):
    x, y = blobs()
    ff = port_mlp(state_dtype)
    ff.fit(x, y, epochs=2, verbose=False)
    save_sharded(str(tmp_path), ff)
    ff2 = port_mlp(state_dtype)
    assert load_sharded(str(tmp_path), ff2) == ff._iter == 8
    assert_same_state(ff, ff2)
    assert torch.equal(ff._generator.get_state(), ff2._generator.get_state())
    manifest = load_manifest(str(tmp_path))
    meta = manifest["leaves"]["opt_state/m/h1/kernel"]
    want = "bfloat16" if state_dtype else "float32"
    assert (meta["dtype"], meta["saved_dtype"]) == (
        want, "uint16" if state_dtype else "float32")
    assert manifest["leaves"]["opt_state/t"] == dict(
        shape=[], dtype="int32", saved_dtype="int32")
    assert manifest["rng"] == [] and manifest["mesh"] == {"data": 1}
    assert "__compute_params__" not in json.dumps(manifest["structure"])
    ff.fit(x, y, epochs=1, verbose=False)
    ff2.fit(x, y, epochs=1, verbose=False)
    assert ff._last_loss == ff2._last_loss
    assert_same_state(ff, ff2)


@pytest.mark.parametrize("state_dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_v1_roundtrip_bitwise(tmp_path, state_dtype):
    x, y = blobs()
    ff = port_mlp(state_dtype)
    ff.fit(x, y, epochs=2, verbose=False)
    stem = str(tmp_path / "ck")
    ff.save_checkpoint(stem)
    with open(stem + ".manifest.json") as f:
        manifest = json.load(f)
    assert manifest["version"] == 1 and manifest["rng"] == []
    assert manifest["dtypes"] == ({"opt_state/m/h1/kernel": "bfloat16",
                                   "opt_state/m/h1/bias": "bfloat16",
                                   "opt_state/m/out/kernel": "bfloat16",
                                   "opt_state/m/out/bias": "bfloat16",
                                   "opt_state/v/h1/kernel": "bfloat16",
                                   "opt_state/v/h1/bias": "bfloat16",
                                   "opt_state/v/out/kernel": "bfloat16",
                                   "opt_state/v/out/bias": "bfloat16"}
                                  if state_dtype else {})
    ff2 = port_mlp(state_dtype)
    assert ff2.load_checkpoint(stem) == 8
    assert_same_state(ff, ff2)
    # load_checkpoint auto-detects a v2 directory as well
    save_sharded(str(tmp_path / "v2"), ff)
    ff3 = port_mlp(state_dtype)
    assert ff3.load_checkpoint(str(tmp_path / "v2")) == 8
    assert_same_state(ff, ff3)


def _transformer_strategy(ff, path):
    """A one-device strategy file: attention ``dp_k:flash``, every other
    op ``dp_k:fused`` (``chip_smoke.py``'s training path (b))."""
    ops = {layer.name: dict(
        choice="dp_k:flash" if layer.op_type == P.OperatorType.
        MULTIHEAD_ATTENTION else "dp_k:fused", outputs=[None], params={})
        for layer in ff.layers if layer.op_type != P.OperatorType.INPUT}
    with open(path, "w") as f:
        json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f)


def build_bert(tmp_path):
    cfg = TransformerConfig(num_layers=2, hidden_size=64, num_heads=2,
                            seq_length=32, batch_size=4)
    ff = create_transformer(cfg, P.FFConfig(batch_size=4), device="cpu")
    path = str(tmp_path / "strategy.json")
    _transformer_strategy(ff, path)
    ff.config.import_strategy_file = path
    ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    assert ff.executor.fused_update_ops
    return ff


def build_bn_conv(tmp_path):
    ff = P.FFModel(P.FFConfig(batch_size=4), device="cpu")
    t = ff.create_tensor((4, 3, 8, 8))
    t = ff.conv2d(t, 6, 3, 3, 1, 1, 1, 1, name="c1")
    t = ff.batch_norm(t, relu=True, name="bn1")
    t = ff.pool2d(t, 2, 2, 2, 2, 0, 0, name="pool")
    t = ff.dense(ff.flat(t, name="flat"), 5, name="fc")
    ff.softmax(t, name="sm")
    ff.compile(AdamOptimizer(alpha=1e-3),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return ff


def _data(name):
    rs = np.random.RandomState(3)
    if name == "bert":
        return (rs.randn(12, 32, 64).astype(np.float32),
                rs.randn(12, 32, 1).astype(np.float32))
    if name == "bn_conv":
        return (rs.randn(12, 3, 8, 8).astype(np.float32),
                rs.randint(0, 5, (12, 1)).astype(np.int32))
    return blobs(n=192)


BUILDERS = {
    "mlp": lambda tmp: port_mlp(torch.bfloat16),
    "dropout_mlp": lambda tmp: port_mlp(torch.bfloat16, dropout=True),
    "bert": build_bert,
    "bn_conv": build_bn_conv,
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("every,keep", [(3, 3), (2, 4)],
                         ids=["epoch_edge", "mid_epoch"])
def test_fit_resume_bitwise_equals_uninterrupted(tmp_path, name, every,
                                                 keep):
    """Three batches an epoch, two epochs. The interrupted run saves
    every ``every`` steps and dies after its step-``keep`` save (its
    later step directories removed); a fresh model resumes and trains to
    the end: its losses and every leaf equal the uninterrupted run's."""
    build = BUILDERS[name]
    x, y = _data(name)
    a = build(tmp_path)
    a.fit(x, y, epochs=2, verbose=False)
    d = str(tmp_path / "ck")
    b = build(tmp_path)
    b.fit(x, y, epochs=2, verbose=False, checkpoint_dir=d,
          checkpoint_every=every)
    assert b.epoch_losses == a.epoch_losses  # saving moves nothing
    assert_same_state(a, b)
    for step, path, _ in list_steps(d):
        if step > keep:
            shutil.rmtree(path)
    c = build(tmp_path)
    assert c.fit(x, y, epochs=2, verbose=False, checkpoint_dir=d,
                 resume=True) > 0
    assert c._iter == a._iter == 6
    assert c.epoch_losses == a.epoch_losses[-len(c.epoch_losses):]
    assert len(c.epoch_losses) == 1
    assert_same_state(a, c)
    if name == "dropout_mlp":
        assert torch.equal(a._generator.get_state(),
                           c._generator.get_state())
    if name == "bn_conv":
        assert set(c.state["bn1"]) == {"mean", "var"}
        assert not torch.equal(c.state["bn1"]["mean"],
                               torch.zeros_like(c.state["bn1"]["mean"]))


def test_resume_skips_a_fully_covered_epoch(tmp_path, capsys):
    """A checkpoint covering the whole first epoch: the resumed fit
    reports only the epoch it ran, with the uninterrupted run's loss."""
    x, y = blobs(n=128)
    a = port_mlp()
    a.fit(x, y, epochs=2, verbose=False)
    d = str(tmp_path)
    port_mlp().fit(x, y, epochs=1, verbose=False, checkpoint_dir=d)
    c = port_mlp()
    c.fit(x, y, epochs=2, verbose=True, checkpoint_dir=d, resume=True)
    out = capsys.readouterr().out
    assert "epoch 0:" not in out and "epoch 1:" in out
    assert c.epoch_losses == a.epoch_losses[1:]


def test_dir_without_cadence_saves_the_final_state(tmp_path):
    x, y = blobs()
    ff = port_mlp()
    ff.fit(x, y, epochs=1, verbose=False, checkpoint_dir=str(tmp_path))
    assert latest_complete(str(tmp_path))[0] == 4
    assert get_registry().get("fit/goodput_effective") > 0


def test_config_flags_drive_fit(tmp_path):
    """The seven flags, parsed with the reference's checks, drive fit."""
    cfg = P.FFConfig()
    rest = cfg.parse_args(["--checkpoint-dir", str(tmp_path),
                           "--checkpoint-every", "2",
                           "--checkpoint-retain", "1", "--checkpoint-sync",
                           "--resume", "--grace-window", "5",
                           "--watchdog-timeout", "60", "--other"])
    assert rest == ["--other"]
    assert (cfg.checkpoint_dir, cfg.checkpoint_every, cfg.checkpoint_retain,
            cfg.checkpoint_async, cfg.resume, cfg.grace_window_s,
            cfg.watchdog_timeout_s) == (str(tmp_path), 2, 1, False, True,
                                        5.0, 60.0)
    for bad in (["--checkpoint-retain", "0"], ["--grace-window", "-1"],
                ["--watchdog-timeout", "-2"]):
        with pytest.raises(ValueError):
            P.FFConfig().parse_args(bad)
    x, y = blobs()
    ff = port_mlp()
    ff.config = cfg
    cfg.watchdog_timeout_s = 0.0  # no watchdog thread in a unit test
    ff.fit(x, y, epochs=1, verbose=False)  # resume of an empty dir: fresh
    assert [s for s, _, ok in list_steps(str(tmp_path)) if ok] == [4]


# ---- cross-package -------------------------------------------------------------

def _jax_leaves(jff):
    from flexflow_tpu.ckpt.sharded import _capture_state
    from flexflow_tpu.ckpt.tree import flatten_tree
    return {k: np.asarray(v) for k, v in flatten_tree(_capture_state(jff))
            if hasattr(v, "shape")}


def _assert_leaves_bitwise(jff, pff):
    jl, pl = _jax_leaves(jff), leaves(pff)
    assert set(jl) == set(pl)
    for k in jl:
        np.testing.assert_array_equal(bits(jl[k]), bits(pl[k]),
                                      err_msg=f"bit mismatch at {k}")


def _train_both(jff, pff, x, y, steps=3):
    """``steps`` one-batch fits in both packages: losses and parameters
    within the stated tolerances."""
    for i in range(steps):
        sl = slice(64 * i, 64 * (i + 1))
        jff.fit(x[sl], y[sl], epochs=1, verbose=False)
        pff.fit(x[sl], y[sl], epochs=1, verbose=False)
        np.testing.assert_allclose(pff._last_loss, jff._last_loss,
                                   rtol=LOSS_RTOL)
    for layer, sub in pff.params.items():
        for name, t in sub.items():
            np.testing.assert_allclose(
                t.numpy(), np.asarray(jff.params[layer][name]),
                atol=PARAM_ATOL, rtol=PARAM_RTOL, err_msg=f"{layer}/{name}")
    assert pff._iter == jff._iter


def _jax_trained(mesh=None, wus=False):
    x, y = blobs()
    jff = jax_mlp(mesh=mesh, wus=wus)
    jff.fit(x[:128], y[:128], epochs=1, verbose=False)  # 2 steps
    return jff, x, y


@pytest.mark.parametrize("fmt", ["v2", "v1"])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, fmt):
    jff, x, y = _jax_trained()
    if fmt == "v2":
        j_save_sharded(str(tmp_path), jff)
        path = str(tmp_path)
    else:
        path = str(tmp_path / "ck")
        jff.save_checkpoint(path)
    pff = port_mlp(alpha=1e-4)
    assert pff.load_checkpoint(path) == 2
    _assert_leaves_bitwise(jff, pff)
    _train_both(jff, pff, x, y)


def test_jax_8_device_wus_checkpoint_loads_on_one_device(tmp_path):
    """A checkpoint the JAX package saved over its 8-device mesh with
    data-sharded moments: each leaf is reassembled from 8 boxes (the
    elastic full scan) onto the port's one device."""
    jff, x, y = _jax_trained(mesh=j_make_mesh(8, {"data": 8}), wus=True)
    assert jff.opt_state["m"]["h1"]["kernel"].sharding.spec[0] == "data"
    j_save_sharded(str(tmp_path), jff)
    manifest = load_manifest(str(tmp_path))
    assert manifest["num_devices"] == 8
    plan = plan_resume(manifest, 1)
    assert (plan["action"], plan["topology"]) == ("research",
                                                  "device_change")
    with open(os.path.join(mf.resolve_step_dir(str(tmp_path)),
                           "index_host0000.json")) as f:
        boxes = [row["index"] for row in
                 json.load(f)["shards"]["opt_state/m/h1/kernel"]]
    assert len(boxes) == 8
    pff = port_mlp(alpha=1e-4)
    reg = get_registry()
    skipped0 = reg.get("ckpt/restore_skipped_bytes")
    assert load_sharded(str(tmp_path), pff) == 2
    assert reg.get("ckpt/restore_skipped_bytes") == skipped0
    _assert_leaves_bitwise(jff, pff)
    _train_both(jff, pff, x, y)


@pytest.mark.parametrize("fmt", ["v2", "v1"])
def test_port_checkpoint_resumes_in_the_jax_package(tmp_path, fmt):
    x, y = blobs()
    pff = port_mlp(alpha=1e-4)
    pff.fit(x[:128], y[:128], epochs=1, verbose=False)
    if fmt == "v2":
        save_sharded(str(tmp_path), pff)
        path = str(tmp_path)
    else:
        path = str(tmp_path / "ck")
        pff.save_checkpoint(path)
    jff = jax_mlp()
    assert jff.load_checkpoint(path) == 2
    assert str(np.asarray(jff.opt_state["m"]["h1"]["kernel"]).dtype) == \
        "bfloat16"
    _assert_leaves_bitwise(jff, pff)
    _train_both(jff, pff, x, y)


# ---- failure handling ---------------------------------------------------------

def _saved(tmp_path, epochs=1):
    x, y = blobs()
    ff = port_mlp()
    ff.fit(x, y, epochs=epochs, verbose=False)
    save_sharded(str(tmp_path), ff, step=ff._iter)
    return ff, x, y


def test_kill_during_shard_write_keeps_previous(tmp_path, monkeypatch):
    ff, x, y = _saved(tmp_path)
    ff.fit(x, y, epochs=1, verbose=False)

    def boom(*a, **k):
        raise OSError("simulated kill mid-shard-write")

    monkeypatch.setenv("FFS_CKPT_IO_RETRIES", "0")
    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        save_sharded(str(tmp_path), ff, step=ff._iter)
    monkeypatch.undo()
    assert latest_complete(str(tmp_path))[0] == 4
    assert load_sharded(str(tmp_path), port_mlp()) == 4
    sdir = os.path.join(str(tmp_path), mf.step_dir_name(8))
    assert not [f for f in os.listdir(sdir) if f.endswith(".tmp")]


def test_kill_before_manifest_keeps_previous(tmp_path, monkeypatch):
    ff, x, y = _saved(tmp_path)
    ff.fit(x, y, epochs=1, verbose=False)
    real = mf.atomic_write_json

    def no_commit(path, obj):
        if os.path.basename(path) == mf.MANIFEST_NAME:
            raise OSError("simulated kill before the manifest commit")
        return real(path, obj)

    monkeypatch.setenv("FFS_CKPT_IO_RETRIES", "0")
    monkeypatch.setattr(mf, "atomic_write_json", no_commit)
    with pytest.raises(OSError):
        save_sharded(str(tmp_path), ff, step=ff._iter)
    monkeypatch.undo()
    assert [(s, ok) for s, _, ok in list_steps(str(tmp_path))] == [
        (4, True), (8, False)]
    assert load_sharded(str(tmp_path), port_mlp()) == 4
    # a resume from there must not see the partial step
    c = port_mlp()
    c.fit(x, y, epochs=2, verbose=False, checkpoint_dir=str(tmp_path),
          resume=True)
    assert c._iter == 8


def test_v1_interrupted_save_keeps_previous(tmp_path, monkeypatch):
    x, y = blobs()
    ff = port_mlp()
    ff.fit(x, y, epochs=1, verbose=False)
    stem = str(tmp_path / "ck")
    ff.save_checkpoint(stem)
    w0 = ff.get_parameter("h1")
    ff.fit(x, y, epochs=1, verbose=False)
    monkeypatch.setattr(np, "savez", lambda *a, **k: (_ for _ in ()).throw(
        OSError("simulated preemption mid-npz")))
    with pytest.raises(OSError):
        ff.save_checkpoint(stem)
    monkeypatch.undo()
    ff2 = port_mlp()
    assert ff2.load_checkpoint(stem) == 4
    np.testing.assert_array_equal(bits(w0), bits(ff2.get_parameter("h1")))


def test_corrupt_shard_detected_on_load_and_verify(tmp_path):
    _saved(tmp_path)
    _, sdir = latest_complete(str(tmp_path))
    assert verify_step_dir(sdir)["complete"]
    p = os.path.join(sdir, "shards_host0000.npz")
    raw = bytearray(open(p, "rb").read())
    off = raw.find(b"params/h1/kernel::0.npy")
    raw[off + 200] ^= 0xFF
    open(p, "wb").write(bytes(raw))
    rep = verify_step_dir(sdir)
    assert not rep["complete"]
    assert any("corruption" in e for e in rep["errors"])
    with pytest.raises(ValueError, match="corruption"):
        load_sharded(str(tmp_path), port_mlp())


def test_corrupt_shard_fault_is_caught(tmp_path, monkeypatch):
    """``FFS_FAULT=corrupt_shard`` flips a byte after the CRC: the
    verifier and the loader both refuse the step."""
    x, y = blobs()
    monkeypatch.setenv("FFS_FAULT", "corrupt_shard:h1/kernel@step:4")
    ff = port_mlp()
    ff.fit(x, y, epochs=1, verbose=False, checkpoint_dir=str(tmp_path))
    monkeypatch.delenv("FFS_FAULT")
    _, sdir = latest_complete(str(tmp_path))
    assert not verify_step_dir(sdir)["complete"]
    with pytest.raises(ValueError, match="corruption"):
        load_sharded(str(tmp_path), port_mlp())


def test_missing_checkpoint_fails_fast(tmp_path):
    ff = port_mlp()
    with pytest.raises(FileNotFoundError, match="complete checkpoint"):
        load_sharded(str(tmp_path / "nowhere"), ff)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ff.load_checkpoint(str(tmp_path / "nowhere_v1"))


def test_resume_without_dir_rejected():
    x, y = blobs()
    with pytest.raises(ValueError, match="no checkpoint directory"):
        port_mlp().fit(x, y, epochs=1, resume=True, verbose=False)


def test_resume_of_partial_only_dir_fails_fast(tmp_path):
    os.makedirs(tmp_path / mf.step_dir_name(4))
    with pytest.raises(FileNotFoundError, match="complete checkpoint"):
        port_mlp().fit(*blobs(), epochs=1, verbose=False,
                       checkpoint_dir=str(tmp_path), resume=True)


def test_retain_gc_keeps_the_newest_and_never_deletes_the_last(tmp_path):
    x, y = blobs()
    port_mlp().fit(x, y, epochs=2, verbose=False,
                   checkpoint_dir=str(tmp_path), checkpoint_every=1)
    retain = P.FFConfig().checkpoint_retain  # 3
    assert [s for s, _, _ in list_steps(str(tmp_path))] == \
        list(range(9 - retain, 9))
    # a partial newer directory is left alone (it may be mid-write), a
    # retain of 0 still keeps the newest complete checkpoint
    os.makedirs(tmp_path / mf.step_dir_name(12))
    collect_garbage(str(tmp_path), 0)
    assert [(s, ok) for s, _, ok in list_steps(str(tmp_path))] == [
        (8, True), (12, False)]


def test_writer_error_surfaces_on_the_training_thread(tmp_path,
                                                      monkeypatch):
    from flexflow_tpu_torch.ckpt import sharded

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(sharded, "write_snapshot", fail)
    x, y = blobs()
    with pytest.raises(RuntimeError, match="asynchronous checkpoint write "
                                           "failed"):
        port_mlp().fit(x, y, epochs=1, verbose=False,
                       checkpoint_dir=str(tmp_path), checkpoint_every=2)


def test_transient_write_errors_are_retried(tmp_path, monkeypatch):
    monkeypatch.setenv("FFS_FAULT", "io_error:shards_host:2")
    monkeypatch.setenv("FFS_CKPT_IO_BACKOFF_S", "0")
    reg = get_registry()
    r0 = reg.get("ckpt/io_retries")
    ff, _, _ = _saved(tmp_path)
    assert reg.get("ckpt/io_retries") == r0 + 2
    assert verify_step_dir(latest_complete(str(tmp_path))[1])["complete"]


def test_chunked_shards_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("FFS_CKPT_CHUNK_BYTES", "256")
    ff, _, _ = _saved(tmp_path)
    _, sdir = latest_complete(str(tmp_path))
    with np.load(os.path.join(sdir, "shards_host0000.npz")) as npz:
        assert "params/h1/kernel::0::c0" in npz.files
    assert verify_step_dir(sdir)["complete"]
    ff2 = port_mlp()
    load_sharded(str(tmp_path), ff2)
    assert_same_state(ff, ff2)


def test_structure_mismatch_names_the_keys(tmp_path):
    _saved(tmp_path)
    other = P.FFModel(P.FFConfig(batch_size=64), device="cpu")
    t = other.create_tensor((64, 16))
    other.dense(t, 4, name="only")
    other.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_sharded(str(tmp_path), other)


def test_plan_resume_and_saved_strategy(tmp_path):
    _saved(tmp_path)
    manifest = load_manifest(str(tmp_path))
    assert plan_resume(manifest, 1)["action"] == "reuse"
    with pytest.raises(NotImplementedError, match="item 3"):
        plan_resume(manifest, 2)
    path = write_saved_strategy(manifest, str(tmp_path / "s.json"))
    with open(path) as f:
        assert set(json.load(f)["ops"]) >= {"h1", "out"}


def test_snapshot_is_taken_after_the_step_and_detached(tmp_path):
    """The snapshot holds copies: a later step does not move it."""
    from flexflow_tpu_torch.ckpt import snapshot
    x, y = blobs()
    ff = port_mlp()
    ff.fit(x, y, epochs=1, verbose=False)
    snap = snapshot(ff)
    before = snap.shards["params/h1/kernel"][0][1].copy()
    np.testing.assert_array_equal(before, ff.get_parameter("h1"))
    ff.fit(x, y, epochs=1, verbose=False)
    np.testing.assert_array_equal(snap.shards["params/h1/kernel"][0][1],
                                  before)
    assert snap.payload_bytes == sum(
        t.numel() * t.element_size() for t in leaves(ff).values())
