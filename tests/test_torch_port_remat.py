"""PyTorch port, per-op rematerialization (``_r`` choices) against the
JAX package.

An op whose strategy choice carries ``_r`` runs its forward under a
non-reentrant ``torch.utils.checkpoint`` in training, the counterpart of
the reference's per-op ``jax.checkpoint``. The cases:

- (a) the choice helpers and ``executed_remat_ops`` read a choice as the
  JAX package reads it;
- (b) remat changes no value: the reference's MLP fixture
  (``tests/test_remat.py``: 4 x dense 64 -> 2048, relu, dense -> 64,
  batch 16, SGD lr 0.01, MSE) with its ``up*`` layers ``dp_r`` trains 3
  seeded steps bit-equal to the same strategy without ``_r``;
- (c) the port's remat against the JAX package's from one strategy file
  (loss rtol 1e-4, parameters atol 2e-5 and rtol 1e-4: f32 on both
  sides, sums in different orders, as in ``test_torch_port_train.py``);
- (d) ``_k:flash_r`` attention (x [4, 256, 32], 4 heads, then a dense;
  the port's flash core through the kernels' plain versions, the JAX
  package's Pallas kernel in interpret mode) against the einsum core
  after one step, within 2e-5, the bound of ``tests/test_remat.py``'s
  ``test_remat_composes_with_flash_kernel``;
- (e) what autograd keeps for the backward (``saved_bytes_by_op``, by
  storage through saved-tensor hooks): an ``_r`` op keeps its inputs and
  nothing of its interior, every other op keeps what it kept;
- (f) ``--remat-search off`` and ``FFS_NO_REMAT`` run an ``_r`` file
  bit-identically to the file without ``_r``;
- (g) an ``_r`` choice on an op whose forward draws random numbers
  (attention dropout) is refused at compile, in the native gate's words;
- (h) a memory-capped search picks the same ``_r`` choices in both
  packages, and the port compiles and trains the result (it raised
  before it had remat), bit-equal to the same choices without ``_r``;
- (i) on the card (``cuda``-marked): the captured remat step bit-equal
  to the eager remat step and to the step without remat, K1 twice a
  layer in a replay (the forward and the recompute).
"""

import json

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as J
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.optimizers import SGDOptimizer as JSGD
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models.llama import LlamaModelConfig, create_llama
from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.tensor import Tensor as PTensor
from flexflow_tpu_torch.weights import from_jax_params

STEPS = 3
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
FLASH_ATOL = 2e-5
BATCH = 16  # the reference fixture's
# a decoder small enough for the CPU: what (e), (f) and (i) train
LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, batch_size=4, seq_length=16)


def _aligned():
    """Start both packages' layer and tensor counters at one value, so
    that ops named after their guids get the same names in both."""
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _write_strategy(ff, path, choice_of):
    """A one-device strategy file over ``ff``'s layers, each op's choice
    ``choice_of(layer)``."""
    ops = {layer.name: dict(choice=choice_of(layer), outputs=[None],
                            params={})
           for layer in ff.layers if layer.op_type.name != "INPUT"}
    with open(path, "w") as f:
        json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f)
    return str(path)


def _bits_equal_params(a, b):
    return all(torch.equal(a[op][pn], b[op][pn]) for op in a for pn in a[op])


def _close_params(got, want):
    for op, sub in want.items():
        for pn, w in sub.items():
            np.testing.assert_allclose(got[op][pn].detach().numpy(),
                                       np.asarray(w), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=f"{op}/{pn}")


# ---- (a) the choice helpers ----------------------------------------------------

@pytest.mark.parametrize("choice", ["dp_k:flash_r", "dp_k:fused_r", "dp_r",
                                    "dp_k:flash", "dp_wus_ovl_k:fused_r",
                                    "dp", None])
def test_choice_helpers_match_jax(choice):
    assert unity.remat_choice_of(choice) == junity.remat_choice_of(choice)
    assert unity.kernel_choice_of(choice) == junity.kernel_choice_of(choice)

    class _Op:
        def __init__(self, guid, name):
            self.guid, self.name = guid, name

    class _Node:
        def __init__(self, guid, name):
            self.op = _Op(guid, name)

    class _St:
        def __init__(self, c):
            self.choice = c

    nodes = [_Node(1, "a"), _Node(2, "b")]
    strategy = {1: _St(choice), 2: _St("dp")}
    got = unity.executed_remat_ops(nodes, strategy)
    assert got == junity.executed_remat_ops(nodes, strategy)
    assert got == ({"a"} if choice and choice.endswith("_r") else set())


# ---- (b), (c) the reference's MLP fixture --------------------------------------

def _mlp(pkg, path, device_kw):
    """The reference fixture (``tests/test_remat.py`` ``_mlp``) on one
    device, through the strategy file at ``path`` (None: none)."""
    cfg = pkg.FFConfig(batch_size=BATCH, seed=42, import_strategy_file=path)
    if pkg is J:
        cfg.workers_per_node = 1
    ff = pkg.FFModel(cfg, **device_kw)
    t = ff.create_tensor((BATCH, 64), name="x")
    for i in range(4):
        t = ff.dense(t, 2048, name=f"up{i}")
        t = ff.relu(t, name=f"relu{i}")
        t = ff.dense(t, 64, name=f"down{i}")
    opt = (JSGD if pkg is J else SGDOptimizer)(lr=0.01)
    ff.compile(opt, pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    return ff


def _mlp_batch():
    rs = np.random.RandomState(0)
    return (rs.randn(BATCH, 64).astype(np.float32),
            rs.randn(BATCH, 64).astype(np.float32))


@pytest.fixture(scope="module")
def mlp_runs(tmp_path_factory):
    """The fixture trained STEPS steps three ways from the JAX model's
    initial weights: the port without and with ``_r`` on ``up*``, and
    the JAX package with ``_r``. -> {name: (model, losses)}."""
    tmp = tmp_path_factory.mktemp("remat_mlp")
    probe = _mlp(P, None, dict(device="cpu"))
    plain = _write_strategy(probe, tmp / "plain.json", lambda l: "dp")
    remat = _write_strategy(
        probe, tmp / "remat.json",
        lambda l: "dp_r" if l.name.startswith("up") else "dp")
    jff = _mlp(J, remat, {})
    init = jax.tree.map(np.asarray, jff.params)
    x, y = _mlp_batch()
    out = {}
    for name, pkg, path in (("port_plain", P, plain), ("port_remat", P, remat),
                            ("jax_remat", J, remat)):
        ff = jff if pkg is J else _mlp(P, path, dict(device="cpu"))
        if pkg is P:
            from_jax_params(init, ff)
        losses = []
        for _ in range(STEPS):
            ff.fit([x], y, epochs=1, verbose=False)
            losses.append(ff._last_loss)
        out[name] = (ff, losses)
    return out


def test_remat_ops_are_the_up_layers(mlp_runs):
    want = {f"up{i}" for i in range(4)}
    assert mlp_runs["port_remat"][0].remat_ops == want
    assert mlp_runs["port_remat"][0].executor.remat_ops == want
    assert mlp_runs["jax_remat"][0].remat_ops == want
    assert mlp_runs["port_plain"][0].remat_ops is None


def test_remat_is_bit_equal_to_plain(mlp_runs):
    (pff, plosses), (rff, rlosses) = (mlp_runs["port_plain"],
                                      mlp_runs["port_remat"])
    assert rlosses == plosses
    assert _bits_equal_params(rff.params, pff.params)


def test_port_remat_matches_jax_remat(mlp_runs):
    (rff, rlosses), (jff, jlosses) = (mlp_runs["port_remat"],
                                      mlp_runs["jax_remat"])
    np.testing.assert_allclose(rlosses, jlosses, rtol=LOSS_RTOL)
    _close_params(rff.params, jax.tree.map(np.asarray, jff.params))


# ---- (d) flash + remat against the einsum core ---------------------------------

def _attn_model(pkg, path, device_kw):
    """The reference's flash-remat fixture: x [4, 256, 32], a 4-head
    self-attention named attn, a dense named fc."""
    cfg = pkg.FFConfig(batch_size=4, seed=42, import_strategy_file=path)
    if pkg is J:
        cfg.workers_per_node = 1
    ff = pkg.FFModel(cfg, **device_kw)
    x = ff.create_tensor((4, 256, 32), name="x")
    t = ff.multihead_attention(x, x, x, 32, 4, name="attn")
    ff.dense(t, 32, name="fc")
    opt = (JSGD if pkg is J else SGDOptimizer)(lr=0.01)
    ff.compile(opt, pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    return ff


@pytest.fixture(scope="module")
def flash_runs(tmp_path_factory):
    """One step from the JAX model's weights, each package on the einsum
    core (``dp_k:einsum``) and on the flash core with remat
    (``dp_k:flash_r``) -> {(package, core): leaves as numpy}."""
    tmp = tmp_path_factory.mktemp("remat_flash")
    probe = _attn_model(P, None, dict(device="cpu"))
    files = {core: _write_strategy(
        probe, tmp / f"{core}.json",
        lambda l, c=core: f"dp_k:{c}" if l.name == "attn" else "dp")
        for core in ("einsum", "flash_r")}
    rs = np.random.RandomState(0)
    x = rs.randn(4, 256, 32).astype(np.float32)
    y = rs.randn(4, 256, 32).astype(np.float32)
    out = {}
    init = None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        for core, path in files.items():
            jff = _attn_model(J, path, {})
            leaves = jax.tree.map(np.asarray, jff.params)
            # one seed, one graph: both JAX models start from one state
            init = init or leaves
            assert jax.tree.all(jax.tree.map(np.array_equal, leaves, init))
            pff = _attn_model(P, path, dict(device="cpu"))
            from_jax_params(init, pff)
            attn = next(n.op for n in pff.executor.nodes
                        if n.op.name == "attn")
            assert attn.kernel_impl == core.split("_")[0]
            assert pff.remat_ops == ({"attn"} if core == "flash_r" else None)
            for pkg, ff in (("jax", jff), ("port", pff)):
                ff.fit([x], y, epochs=1, verbose=False)
                out[(pkg, core)] = {
                    f"{op}/{pn}": np.asarray(
                        a.detach().numpy() if isinstance(a, torch.Tensor)
                        else a, dtype=np.float64)
                    for op, sub in ff.params.items() for pn, a in sub.items()}
    return out


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_flash_remat_is_within_2e5_of_the_einsum_core(flash_runs, pkg):
    want = flash_runs[("port", "einsum")]
    got = flash_runs[(pkg, "flash_r")]
    assert set(got) == set(want)
    diffs = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    assert max(diffs.values()) < FLASH_ATOL, diffs


# ---- (e), (f) the decoder: what autograd keeps, and the off switch --------------

def _llama(path, **cfg_kw):
    cfg = LlamaModelConfig(**LLAMA)
    ff = create_llama(cfg, P.FFConfig(batch_size=cfg.batch_size,
                                      import_strategy_file=path, **cfg_kw),
                      device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-2, state_dtype=torch.bfloat16),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return ff


def _llama_choice(remat):
    """Attention ``dp_k:flash``, everything else ``dp_k:fused``; with
    ``remat``, ``_r`` on every attention and every RMSNorm."""
    r = "_r" if remat else ""

    def choice_of(layer):
        kind = layer.op_type.name
        if kind == "MULTIHEAD_ATTENTION":
            return "dp_k:flash" + r
        return "dp_k:fused" + (r if kind == "RMSNORM" else "")

    return choice_of


@pytest.fixture(scope="module")
def llama_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("remat_llama")
    probe = create_llama(LlamaModelConfig(**LLAMA), device="cpu")
    return {name: _write_strategy(probe, tmp / f"{name}.json",
                                  _llama_choice(name == "remat"))
            for name in ("plain", "remat")}


def _llama_batch(seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 255, (LLAMA["batch_size"], LLAMA["seq_length"])
                     ).astype(np.int32)
    return ids, ((ids + 1) % 256).astype(np.int32)


def test_remat_keeps_only_the_inputs_of_its_ops(llama_files):
    ids, labels = _llama_batch()
    saved = {}
    for name, path in llama_files.items():
        ff = _llama(path)
        saved[name] = ff.executor.saved_bytes_by_op(
            ff.params, ff.state, ff._stage_inputs(ids),
            ff._stage_labels(labels))
    remat = _llama(llama_files["remat"]).remat_ops
    b, s, e = LLAMA["batch_size"], LLAMA["seq_length"], LLAMA["hidden_size"]
    h, d = LLAMA["num_attention_heads"], e // LLAMA["num_attention_heads"]
    assert remat == {n for n in saved["plain"]
                     if n.endswith(("_ln", "_attn"))}
    for op, nbytes in saved["plain"].items():
        if op not in remat:
            assert saved["remat"][op] == nbytes, op
            continue
        # a checkpoint keeps its one input activation ([B, S, E] f32: an
        # attention's q, k and v are one tensor) and no interior
        assert saved["remat"][op] == b * s * e * 4, op
        assert nbytes > saved["remat"][op], op
        if op.endswith("_attn"):
            # the flash core's own saves: q, k and v after the GQA repeat,
            # o [B*H, S, D] f32 and lse [B*H, S] f32
            core = 4 * b * h * s * d * 4 + b * h * s * 4
            assert nbytes - saved["remat"][op] >= core, op
    assert sum(saved["remat"].values()) < sum(saved["plain"].values())


@pytest.mark.parametrize("name", ["plain", "remat"])
def test_the_reckoning_leaves_no_graph_behind(llama_files, name,
                                              monkeypatch):
    """Nothing ``saved_bytes_by_op`` saw saved outlives the call (a saved
    output kept with its grad_fn would hold its own graph alive)."""
    import weakref

    import torch.autograd.graph as graph

    packed = []

    class Spy(graph.saved_tensors_hooks):
        def __init__(self, pack, unpack):
            def spy(t):
                packed.append(weakref.ref(t))
                return pack(t)
            super().__init__(spy, unpack)

    monkeypatch.setattr(graph, "saved_tensors_hooks", Spy)
    ff = _llama(llama_files[name])
    params = {t.untyped_storage().data_ptr()
              for sub in ff.params.values() for t in sub.values()}
    ids, labels = _llama_batch()
    ff.executor.saved_bytes_by_op(ff.params, ff.state, ff._stage_inputs(ids),
                                  ff._stage_labels(labels))
    assert packed
    assert not [r for r in packed if r() is not None
                and r().untyped_storage().data_ptr() not in params]


@pytest.mark.parametrize("switch", ["flag", "env"])
def test_the_off_switch_is_bit_identical_to_no_remat(llama_files, switch,
                                                     monkeypatch):
    kw = {}
    if switch == "flag":
        kw["remat_search"] = "off"
    else:
        monkeypatch.setenv("FFS_NO_REMAT", "1")
    off = _llama(llama_files["remat"], **kw)
    plain = _llama(llama_files["plain"])
    assert off.remat_ops is None and off.executor.remat_ops is None
    assert off.kernel_choices == plain.kernel_choices
    ids, labels = _llama_batch()
    for ff in (off, plain):
        for _ in range(STEPS):
            ff.fit(ids, labels, epochs=1, verbose=False)
    assert off.epoch_losses == plain.epoch_losses
    assert _bits_equal_params(off.params, plain.params)
    # with the switch on, remat is bit-equal too
    monkeypatch.delenv("FFS_NO_REMAT", raising=False)
    on = _llama(llama_files["remat"])
    assert on.remat_ops
    for _ in range(STEPS):
        on.fit(ids, labels, epochs=1, verbose=False)
    assert on.epoch_losses == plain.epoch_losses
    assert _bits_equal_params(on.params, plain.params)


# ---- (g) the refusal --------------------------------------------------------------

def test_remat_of_attention_dropout_is_refused_in_the_gates_words(tmp_path):
    def build(path=None, **kw):
        ff = P.FFModel(P.FFConfig(batch_size=4, import_strategy_file=path,
                                  **kw), device="cpu")
        x = ff.create_tensor((4, 128, 64), name="x")
        t = ff.multihead_attention(x, x, x, 64, 4, dropout=0.1,
                                   name="attn_drop")
        ff.dense(t, 64, name="fc")
        return ff

    path = _write_strategy(build(), tmp_path / "s.json",
                           lambda l: "dp_r" if l.name == "attn_drop"
                           else "dp")
    with pytest.raises(ValueError, match=r"'attn_drop'.*dropout_interior"):
        build(path).compile(SGDOptimizer(),
                            P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    # the native gate rejects the same twin for the same reason
    ff = build(search_budget=2, search_trace=True)
    ff.compile(SGDOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    ops = {o["name"]: o for o in ff.search_info["search_trace"]["ops"]}
    assert [r["reason"] for r in ops["attn_drop"]["remat_rejections"]] \
        == ["dropout_interior"]


# ---- (h) the memory-capped search ------------------------------------------------

CAPPED_BATCH = 8192  # activations of tens of MiB: the threshold is in MiB


def _capped_mlp(pkg, **cfg_kw):
    """Two up (64 -> 2048) / down (-> 64) pairs at a batch whose up
    outputs (64 MiB each) dominate the memory: the gate admits an ``_r``
    twin for each up, rejects one for each down."""
    cfg = pkg.FFConfig(batch_size=CAPPED_BATCH, seed=42, search_budget=2,
                       **cfg_kw)
    if pkg is J:
        cfg.workers_per_node = 1
    ff = pkg.FFModel(cfg, **({} if pkg is J else dict(device="cpu")))
    t = ff.create_tensor((CAPPED_BATCH, 64), name="x")
    for i in range(2):
        t = ff.dense(t, 2048, name=f"up{i}")
        t = ff.dense(t, 64, name=f"down{i}")
    ff.compile((JSGD if pkg is J else SGDOptimizer)(lr=0.01),
               pkg.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    return ff


def test_a_memory_capped_search_picks_remat_and_trains(tmp_path,
                                                       monkeypatch):
    # no calibration rows: both packages aim at the threshold as given
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(tmp_path / "none.json"))
    _aligned()
    free = _capped_mlp(P)
    assert free.remat_ops is None
    cap = int(free.search_info["predicted_memory"] * 0.4) >> 20
    files = {}
    for pkg, name in ((J, "jax"), (P, "port")):
        _aligned()
        files[name] = tmp_path / f"{name}.json"
        ff = _capped_mlp(pkg, memory_search=True, memory_threshold_mb=cap,
                         export_strategy_file=str(files[name]))
        if pkg is P:
            port = ff
    assert json.loads(files["port"].read_text()) \
        == json.loads(files["jax"].read_text())
    assert port.remat_ops == {"up0", "up1"}
    assert port.search_info["predicted_memory"] <= cap << 20
    # the port trains it, bit-equal to the same choices without "_r"
    data = json.loads(files["port"].read_text())
    for op in data["ops"].values():
        op["choice"] = op["choice"].removesuffix("_r")
    plain_path = tmp_path / "plain.json"
    plain_path.write_text(json.dumps(data))
    _aligned()
    plain = _capped_mlp(P, import_strategy_file=str(plain_path))
    assert plain.remat_ops is None
    from_jax_params({op: {pn: t.numpy() for pn, t in sub.items()}
                     for op, sub in port.params.items()}, plain)
    rs = np.random.RandomState(0)
    x = rs.randn(CAPPED_BATCH, 64).astype(np.float32)
    y = rs.randn(CAPPED_BATCH, 64).astype(np.float32)
    for ff in (port, plain):
        ff.fit([x], y, epochs=1, verbose=False)
    assert np.isfinite(port._last_loss)
    assert port.epoch_losses == plain.epoch_losses
    assert _bits_equal_params(port.params, plain.params)


# ---- (i) on the card --------------------------------------------------------------

@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the sm_90a kernels "
                    "have no CPU mode (run with pytest -m cuda on the card)")


@pytest.mark.cuda
def test_captured_remat_step_is_bit_equal_on_card(cuda_card, tmp_path):
    from flexflow_tpu_torch.step_graph import (flatten, read_launch_counts,
                                               unflatten)

    def clone(tree):
        leaves, spec = flatten(tree)
        return unflatten(spec, [t.clone() for t in leaves])

    cfg = LlamaModelConfig(vocab_size=256, hidden_size=256,
                           intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=2, num_key_value_heads=1,
                           batch_size=2, seq_length=128)
    probe = create_llama(cfg, device="cuda")
    paths = {name: _write_strategy(probe, tmp_path / f"{name}.json",
                                   _llama_choice(name == "remat"))
             for name in ("plain", "remat")}
    models = {}
    for name, path in paths.items():
        ff = create_llama(cfg, P.FFConfig(batch_size=2,
                                          import_strategy_file=path),
                          device="cuda")
        ff.compile(AdamOptimizer(alpha=1e-3, state_dtype=torch.bfloat16),
                   P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        models[name] = ff
    rff, pff = models["remat"], models["plain"]
    assert rff.remat_ops and pff.remat_ops is None
    ex = rff.executor
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 255, (2, 128)).astype(np.int32)
    inputs = rff._stage_inputs(ids)
    labels = rff._stage_labels((ids + 1) % 256)
    eager = ex._train_step_fn()
    ep, eo, es = (clone(t) for t in (rff.params, rff.opt_state, rff.state))
    step = ex.make_train_step()
    p, o, s = rff.params, rff.opt_state, rff.state
    layers = cfg.num_hidden_layers
    # K1 twice a layer (the forward and the recompute), K2 once, K4 once
    want = {"flash_fwd.launches": 2 * layers, "flash_fwd.lse_launches": 0,
            "flash_bwd.launches": layers, "flash_bwd.lse_launches": 0,
            "fused_adam_multi.launches": 1}
    for _ in range(3):
        ep, eo, es, eloss, _ = eager(ep, eo, es, inputs, labels)
        before = read_launch_counts()
        p, o, s, loss, _ = step(p, o, s, inputs, labels)
        got = {k: v - before[k] for k, v in read_launch_counts().items()}
        assert got == want, got
        assert torch.equal(loss, eloss)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        flatten((p, o, s))[0], flatten((ep, eo, es))[0]))
    assert ex.step_graphs["train_step"].launches_a_replay() == want
    # and remat changed no value: the plain model's compiled steps
    pstep = pff.executor.make_train_step()
    pp, po, ps = pff.params, pff.opt_state, pff.state
    for _ in range(3):
        pp, po, ps, ploss, _ = pstep(pp, po, ps, pff._stage_inputs(ids),
                                     labels)
    torch.cuda.synchronize()
    assert torch.equal(ploss, loss)
    assert _bits_equal_params(pp, p)
