"""PyTorch port, ``fit_loader`` with ``dataloader.py`` and the sequence-
length buckets of the ``set_batch`` / ``forward`` / ``backward`` /
``update`` loop, against the JAX package.

- Loaders: ``create_data_loaders`` stages each array once (on the model's
  device; the CPU here), ``next_batch`` slices it and wraps at the end
  of an epoch, ``seek`` positions it and refuses a batch outside the
  epoch, integer inputs take the input's declared dtype, a process group
  of more than one rank is refused naming ROADMAP item 3, and the
  package root exports the reference's three names.
- ``fit_loader`` against ``fit`` on the same batches: the epoch losses
  and every leaf bit for bit (the same compiled step over other feeds);
  against the JAX package's ``fit_loader`` from carried weights: the
  epoch losses within rtol 1e-4 (f32 on both sides, sums in other
  orders).
- The cursor and resume (the reference's ``TestLoaderCursor``): the
  manifest's ``client_state["loader"]`` after one epoch, and a resumed
  run that fetches only the uncovered batches (the one-shot seek, also
  mid-epoch) and ends bit-identical to an uninterrupted run.
- Buckets (the reference's ``tests/test_seq_length.py``): a seq-64 model
  stepped at ``seq_length=32`` trains as a seq-32 model fed the
  truncated batch (loss rtol 1e-5, parameters 1e-5) and as the JAX
  package's bucket (loss rtol 1e-4); the bucket is the next power of two
  below the model's length, one executor for repeated lengths, which
  shares the parameters and runs fewer FLOPs; a model without a sequence
  ignores ``seq_length``; the reference's refusals (an input with the
  sequence extent on two dims, a parameter whose shape changes at the
  bucket) raise in both packages, and a rewritten graph runs full length.
"""

import os

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch import dataloader as pdl
from flexflow_tpu_torch.ckpt import load_manifest
from flexflow_tpu_torch.ffconst import ActiMode
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

LOSS_RTOL = 1e-4
BUCKET_RTOL = 1e-5


def _starts():
    starts = []
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        s = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = s
        starts.append(s)
    return starts


def _settle():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        a._next_guid[0] = b._next_guid[0] = max(a._next_guid[0],
                                                b._next_guid[0])


def blobs(n=256, d=16, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n)
    x = (centers[y] + rs.randn(n, d)).astype(np.float32)
    return x, y.astype(np.int32).reshape(-1, 1)


def port_mlp(batch=64):
    ff = P.FFModel(P.FFConfig(batch_size=batch), device="cpu")
    t = ff.create_tensor((batch, 16))
    h = ff.dense(t, 32, activation=ActiMode.AC_MODE_RELU, name="h1")
    ff.softmax(ff.dense(h, 4, name="out"))
    ff.compile(AdamOptimizer(alpha=0.01),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [P.MetricsType.ACCURACY])
    return ff


def jax_mlp(batch=64):
    from flexflow_tpu.ffconst import ActiMode as JActi
    ff = J.FFModel(J.FFConfig(batch_size=batch, workers_per_node=1))
    t = ff.create_tensor((batch, 16))
    h = ff.dense(t, 32, activation=JActi.AC_MODE_RELU, name="h1")
    ff.softmax(ff.dense(h, 4, name="out"))
    ff.compile(J.AdamOptimizer(alpha=0.01),
               J.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [J.MetricsType.ACCURACY])
    return ff


def _bits(t):
    return t.detach().numpy().view(np.uint32) if t.dtype == torch.float32 \
        else t.detach().numpy()


def _same_leaves(a, b):
    from flexflow_tpu_torch.ckpt.sharded import _capture_state
    from flexflow_tpu_torch.ckpt.tree import flatten_tree
    la = {k: v for k, v in flatten_tree(_capture_state(a))
          if isinstance(v, torch.Tensor)}
    lb = {k: v for k, v in flatten_tree(_capture_state(b))
          if isinstance(v, torch.Tensor)}
    assert set(la) == set(lb)
    for k in la:
        np.testing.assert_array_equal(_bits(la[k]), _bits(lb[k]),
                                      err_msg=k)


# ---- the loaders -----------------------------------------------------------

def test_package_root_exports_the_loaders():
    assert P.DataLoaderSet is pdl.DataLoaderSet
    assert P.SingleDataLoader is pdl.SingleDataLoader
    assert P.create_data_loaders is pdl.create_data_loaders
    assert {"DataLoaderSet", "SingleDataLoader",
            "create_data_loaders"} <= set(P.__all__)


def test_loader_stages_slices_wraps_and_seeks():
    x, y = blobs(n=200)  # 3 whole batches of 64, 8 samples dropped
    ff = port_mlp()
    loaders = P.create_data_loaders(ff, x, y)
    assert loaders.num_batches == 3
    inl, lab = loaders.input_loaders[0], loaders.label_loader
    assert inl.on_device and lab.on_device
    assert tuple(inl.data.shape) == (192, 16) and lab.data.dtype == torch.int32
    got = [loaders.next_batch() for _ in range(4)]
    np.testing.assert_array_equal(got[1][0]["input_0"].numpy(), x[64:128])
    np.testing.assert_array_equal(got[3][1].numpy(), y[:64])  # wrapped
    with pytest.raises(ValueError, match="seek"):
        inl.seek(loaders.num_batches)
    loaders.seek(2)
    assert inl.next_index == lab.next_index == 128
    np.testing.assert_array_equal(loaders.next_batch()[0]["input_0"].numpy(),
                                  x[128:192])
    loaders.reset()
    assert inl.next_index == 0
    with pytest.raises(ValueError, match="disagree"):
        P.create_data_loaders(ff, x, y[:128])


def test_integer_inputs_take_the_declared_dtype():
    ff = P.FFModel(P.FFConfig(batch_size=4), device="cpu")
    ids = ff.create_tensor((4, 3), P.DataType.INT32)
    e = ff.embedding(ids, 10, 8)
    ff.dense(ff.flat(e), 2)
    ff.compile(SGDOptimizer(lr=0.1), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    loaders = P.create_data_loaders(
        ff, np.arange(24, dtype=np.int64).reshape(8, 3) % 10,
        np.zeros((8, 2), np.float32))
    assert loaders.input_loaders[0].data.dtype == torch.int32
    ff.fit_loader(loaders, epochs=1, verbose=False)
    assert np.isfinite(ff._last_loss)


def test_a_process_group_of_two_ranks_is_refused(monkeypatch):
    ff = port_mlp()
    x, y = blobs()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        P.create_data_loaders(ff, x, y)


# ---- fit_loader ------------------------------------------------------------

def test_fit_loader_equals_fit_bit_for_bit():
    x, y = blobs()
    a, b = port_mlp(), port_mlp()
    with torch.no_grad():
        for op, sub in a.params.items():
            for pn, t in sub.items():
                b.params[op][pn].copy_(t)
    b._compute_params_dirty = True
    a.fit(x, y, epochs=2, verbose=False)
    b.fit_loader(P.create_data_loaders(b, x, y), epochs=2, verbose=False)
    assert a.epoch_losses == b.epoch_losses and len(a.epoch_losses) == 2
    assert a._iter == b._iter == 8
    _same_leaves(a, b)


def test_fit_loader_matches_the_references():
    from flexflow_tpu.dataloader import create_data_loaders as j_loaders
    x, y = blobs(seed=4)
    starts = _starts()
    jff = jax_mlp()
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    pff = port_mlp()
    _settle()
    from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
    jlosses, plosses = [], []
    for _ in range(2):
        jff.fit_loader(j_loaders(jff, x, y), epochs=1, verbose=False)
        pff.fit_loader(P.create_data_loaders(pff, x, y), epochs=1,
                       verbose=False)
        jlosses.append(float(jff._last_loss))
        plosses.append(pff._last_loss)
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)


def _counting(loaders):
    fetches = []
    orig = loaders.next_batch
    loaders.next_batch = lambda: (fetches.append(1), orig())[1]
    return fetches


def test_resume_seeks_to_the_cursor_and_is_bitwise(tmp_path):
    """One epoch (4 steps) with its final checkpoint: the manifest holds
    the cursor; a resumed run to 2 epochs fetches the 4 uncovered batches
    only and ends as the uninterrupted run, leaf for leaf."""
    x, y = blobs()
    cdir = str(tmp_path)
    ref = port_mlp()
    init = {op: {pn: t.clone() for pn, t in sub.items()}
            for op, sub in ref.params.items()}

    def fresh():
        ff = port_mlp()
        with torch.no_grad():
            for op, sub in init.items():
                for pn, t in sub.items():
                    ff.params[op][pn].copy_(t)
        ff._compute_params_dirty = True
        return ff

    ref.fit_loader(P.create_data_loaders(ref, x, y), epochs=2, verbose=False)
    first = fresh()
    first.fit_loader(P.create_data_loaders(first, x, y), epochs=1,
                     verbose=False, checkpoint_dir=cdir)
    cur = load_manifest(cdir)["client_state"]["loader"]
    assert cur == dict(iteration=4, epoch=1, batch=0, num_batches=4)
    resumed = fresh()
    loaders = P.create_data_loaders(resumed, x, y)
    fetches = _counting(loaders)
    resumed.fit_loader(loaders, epochs=2, verbose=False,
                       checkpoint_dir=cdir, resume=True)
    assert len(fetches) == 4
    assert resumed._last_loss == ref._last_loss
    _same_leaves(ref, resumed)


def test_mid_epoch_resume_seeks_to_the_batch(tmp_path):
    """Saves every 2 steps over 3-batch epochs; the run is cut after its
    step-2 save (the later checkpoints removed): the resumed run seeks to
    epoch 0, batch 2 once, fetches the 4 uncovered batches and ends as
    the uninterrupted run."""
    import shutil

    from flexflow_tpu_torch.ckpt.manifest import list_steps
    x, y = blobs(n=192)
    cdir = str(tmp_path / "ck")
    ref = port_mlp()
    init = {op: {pn: t.clone() for pn, t in sub.items()}
            for op, sub in ref.params.items()}

    def fresh():
        ff = port_mlp()
        with torch.no_grad():
            for op, sub in init.items():
                for pn, t in sub.items():
                    ff.params[op][pn].copy_(t)
        ff._compute_params_dirty = True
        return ff

    ref.fit_loader(P.create_data_loaders(ref, x, y), epochs=2, verbose=False)
    cut = fresh()
    cut.fit_loader(P.create_data_loaders(cut, x, y), epochs=2, verbose=False,
                   checkpoint_dir=cdir, checkpoint_every=2)
    for step, path, _ in list_steps(cdir):
        if step > 2:
            shutil.rmtree(path)
    assert load_manifest(cdir)["client_state"]["loader"] == dict(
        iteration=2, epoch=0, batch=2, num_batches=3)
    resumed = fresh()
    loaders = P.create_data_loaders(resumed, x, y)
    fetches = _counting(loaders)
    seeks = []
    orig_seek = loaders.seek
    loaders.seek = lambda b: (seeks.append(b), orig_seek(b))[1]
    resumed.fit_loader(loaders, epochs=2, verbose=False,
                       checkpoint_dir=cdir, resume=True)
    assert seeks == [2] and len(fetches) == 4
    assert resumed.epoch_losses == ref.epoch_losses
    _same_leaves(ref, resumed)


# ---- sequence-length buckets -----------------------------------------------

S_FULL = 64
S_ACTIVE = 32  # a power of two: the bucket is the active length


def _tcfg(cls, seq):
    return cls(num_layers=1, hidden_size=16, num_heads=2, seq_length=seq,
               batch_size=4)


def _port_transformer(seq, weights=None):
    ff = create_transformer(_tcfg(TransformerConfig, seq),
                            P.FFConfig(batch_size=4, only_data_parallel=True),
                            device="cpu")
    ff.compile(SGDOptimizer(lr=0.1), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    if weights is not None:
        from_jax_params(weights, ff)
    return ff


def _jax_transformer(seq):
    ff = j_create_transformer(_tcfg(JTransformerConfig, seq), J.FFConfig(
        batch_size=4, only_data_parallel=True, workers_per_node=1))
    ff.compile(J.SGDOptimizer(lr=0.1),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [J.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _seq_batch():
    rs = np.random.RandomState(0)
    return (rs.randn(4, S_FULL, 16).astype(np.float32),
            rs.randn(4, S_FULL, 1).astype(np.float32))


def _loop(ff, x, y, seq_length=None):
    ff.set_batch(x, y)
    ff.forward(seq_length=seq_length)
    ff.zero_gradients()
    ff.backward()
    ff.update()
    return float(ff._last_loss)


def test_short_seq_trains_as_the_truncated_model_and_the_reference():
    starts = _starts()
    jff = _jax_transformer(S_FULL)
    weights = jax.tree.map(np.asarray, jff.params)
    PLayer._next_guid[0], PTensor._next_guid[0] = starts
    ff = _port_transformer(S_FULL, weights)
    _settle()
    ref = _port_transformer(S_ACTIVE, weights)
    x, y = _seq_batch()
    want_j = _loop(jff, x, y, S_ACTIVE)
    got = _loop(ff, x, y, S_ACTIVE)
    want = _loop(ref, x[:, :S_ACTIVE], y[:, :S_ACTIVE])
    assert got == pytest.approx(want, rel=BUCKET_RTOL)
    np.testing.assert_allclose(got, want_j, rtol=LOSS_RTOL)
    for name, sub in ref.params.items():
        for pn, t in sub.items():
            np.testing.assert_allclose(ff.params[name][pn].numpy(),
                                       t.numpy(), rtol=BUCKET_RTOL,
                                       atol=1e-6, err_msg=f"{name}.{pn}")
    # a second step, full length, after the bucket's: both packages
    np.testing.assert_allclose(_loop(ff, x, y), _loop(jff, x, y),
                               rtol=LOSS_RTOL)


def test_bucket_is_a_bounded_power_of_two_sharing_the_state():
    ff = _port_transformer(S_FULL)
    assert ff._seq_bucket(20) == 32
    assert ff._seq_bucket(32) == 32
    assert ff._seq_bucket(33) is None  # the power of two is the full length
    assert ff._seq_bucket(64) is None
    assert ff._seq_bucket(None) is None
    x, y = _seq_batch()
    for length in (17, 20, 25):
        _loop(ff, x, y, length)
    assert list(ff._seq_execs) == [32]
    bucket = ff._seq_execs[32]
    full = sum(n.op.flops() for n in ff.executor.nodes)
    assert sum(n.op.flops() for n in bucket.nodes) < 0.6 * full
    # one parameter tree: the bucket's step trained the model's leaves
    assert bucket.step_graphs["train_step"].captures == 1
    assert ff._iter == 3


def test_a_model_without_a_sequence_ignores_seq_length():
    ff = P.FFModel(P.FFConfig(batch_size=8, only_data_parallel=True),
                   device="cpu")
    t = ff.create_tensor((8, 16))
    ff.dense(t, 4)
    ff.compile(SGDOptimizer(lr=0.1), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    rs = np.random.RandomState(1)
    _loop(ff, rs.randn(8, 16).astype(np.float32),
          rs.randn(8, 4).astype(np.float32), seq_length=7)
    assert ff._declared_seq() is None and not ff._seq_execs


def _refusal_pair(kind):
    """The same refused graph in both packages: ``"two_dims"`` an [B,S,S]
    input beside the sequence; ``"param_shape"`` a [B, S] input a dense
    reads whole, whose kernel would change shape at the bucket."""
    out = []
    for pkg in (J, P):
        kw = dict(workers_per_node=1) if pkg is J else {}
        ff = pkg.FFModel(pkg.FFConfig(batch_size=2, **kw),
                         **({} if pkg is J else dict(device="cpu")))
        a = ff.create_tensor((2, 32, 8), name="a")
        h = ff.multihead_attention(a, a, a, 8, 2, name="att")
        if kind == "two_dims":
            m = ff.create_tensor((2, 32, 32), name="m")
            h = ff.add(h, ff.dense(m, 8, name="mask_proj"), name="sum")
        else:
            b = ff.create_tensor((2, 32), name="b")
            side = ff.reshape(ff.dense(b, 1, name="side"), (2, 1, 1),
                              name="side_r")
            ff.add(ff.dense(h, 1, name="head"), side, name="sum")
        if kind == "two_dims":
            ff.dense(h, 1, name="head")
        opt = (J.SGDOptimizer if pkg is J else SGDOptimizer)(lr=0.1)
        ff.compile(opt, pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
        out.append(ff)
    return out


@pytest.mark.parametrize("kind", ["two_dims", "param_shape"])
def test_bucket_refusals_match_the_reference(kind):
    rs = np.random.RandomState(2)
    for ff in _refusal_pair(kind):
        xs = [rs.randn(*t.shape).astype(np.float32)
              for t in ff.input_tensors]
        ff.set_batch(xs, rs.randn(2, 32, 1).astype(np.float32))
        ff.forward(seq_length=8)
        with pytest.raises(NotImplementedError,
                           match=("more than one dim" if kind == "two_dims"
                                  else "changes parameter shape")):
            ff.update()


def test_a_rewritten_graph_runs_full_length():
    ff = _port_transformer(S_FULL)
    ff.search_info = {"rewritten_nodes": list(ff.executor.nodes)}
    assert ff._seq_bucket(20) is None
    x, y = _seq_batch()
    _loop(ff, x, y, 20)
    assert not ff._seq_execs
