"""PyTorch port, checkpoints across ranks, against the JAX package's
sharded checkpoints on the 8-virtual-device CPU mesh (``tests/conftest.py``).

As ``tests/test_torch_port_wus.py`` does, the port runs every case in one
spawned world of 8 gloo ranks over a FileStore under the test's temporary
directory, rank r at JAX's device r; the JAX side runs in this process. No
module-level import here touches JAX. At its end the world shrinks: ranks
0-3 leave the 8-rank group and join a group of 4 (the elastic case), the
others stop.

Models: the regression MLP of ``tests/test_wus.py`` (64 -> 256 -> relu ->
64, batch 16) and a 1-layer BERT-proxy (hidden 64, 4 heads, S 16, batch
16), both under Adam with bf16 moments, each on ``{"data": 8}`` (mesh
given) and ``{"data": 4, "model": 2}`` (the MLP's mesh given, its leaves
replicated on 'model'; the BERT-proxy's from a strategy file: attention
head-parallel, ffn1 column- and ffn2 row-parallel on 'model'). Weight-
update sharding engages under "auto" on all four (data degree 4 or more).

Cases:
- (a) the JAX package saves each after 2 steps; the 8 ranks load it
  rank-locally: each rank's piece of every leaf equals the JAX array's box
  bit for bit, and some bytes were skipped;
- (b) the 8 ranks train each 2 steps and save; the JAX package loads the
  checkpoint on 8 devices (the same mesh or strategy file) and on one,
  bit for bit against the port's pieces, and per leaf the saved boxes are
  the ones the JAX package writes for the same strategy;
- (c) ``fit(checkpoint_dir=, checkpoint_every=, resume=)`` on
  ``{"data": 8}``, weight-update sharding off, on and overlapped: the
  resumed run equals the uninterrupted one bit for bit (losses and every
  leaf of every rank), and a v1 save over the ranks loads back bit for bit
  (``tests/test_checkpoint.py:119``'s anchor);
- (d) elastic (``tests/test_checkpoint.py:193``'s anchor): the
  classifier MLP trained on ``{"data": 4, "model": 2}`` (h1 column-, out
  row-parallel) and saved by 8 ranks, resumed by 4 after a search in
  their group: ``plan_resume`` equals the JAX package's, the gathered
  parameters and Adam's moments are bit-identical, predictions agree at
  rtol 1e-6, atol 1e-7.
"""

import json
import os
import traceback

import numpy as np
import pytest
import torch

BATCH = 16
STEPS = 2
MESHES = {"d8": {"data": 8}, "d4m2": {"data": 4, "model": 2}}
MODELS = ("mlp", "bert")
BERT = dict(num_layers=1, hidden_size=64, num_heads=4, seq_length=16)
# (weight_update_sharding, overlap_bucket_mb) of the resumed fits
RESUME_MODES = (("off", "off"), ("on", "off"), ("on", "1"))
PRED_RTOL, PRED_ATOL = 1e-6, 1e-7


def _bert_strategy():
    """The BERT-proxy's strategy file on ``{"data": 4, "model": 2}``."""
    dp3 = ["data", None, None]
    ops = {"head": dict(choice="dp", outputs=[dp3], params={})}
    for i in range(BERT["num_layers"]):
        for n in (f"ln1_{i}", f"ln2_{i}", f"res1_{i}", f"res2_{i}"):
            ops[n] = dict(choice="dp", outputs=[dp3], params={})
        ops[f"attn_{i}"] = dict(
            choice="dp_head", outputs=[dp3],
            params={w: ["model", None, None]
                    for w in ("wq", "wk", "wv", "wo")})
        ops[f"ffn1_{i}"] = dict(choice="dp_col",
                                outputs=[["data", None, "model"]],
                                params=dict(kernel=[None, "model"],
                                            bias=["model"]))
        ops[f"ffn2_{i}"] = dict(choice="dp_row", outputs=[dp3],
                                params=dict(kernel=["model", None]))
    return dict(version=1, mesh=MESHES["d4m2"], ops=ops)


def _classifier_strategy():
    """(d)'s classifier on ``{"data": 4, "model": 2}``."""
    return dict(version=1, mesh=MESHES["d4m2"], ops=dict(
        h1=dict(choice="dp_col", outputs=[["data", "model"]],
                params=dict(kernel=[None, "model"], bias=["model"])),
        out=dict(choice="dp_row", outputs=[["data", None]],
                 params=dict(kernel=["model", None])),
        sm=dict(choice="dp", outputs=[["data", None]], params={})))


def _data(model):
    rs = np.random.RandomState(3)
    if model == "mlp":
        return (rs.randn(STEPS * BATCH, 64).astype(np.float32),
                rs.randn(STEPS * BATCH, 64).astype(np.float32))
    s, h = BERT["seq_length"], BERT["hidden_size"]
    return (rs.randn(STEPS * BATCH, s, h).astype(np.float32),
            rs.randn(STEPS * BATCH, s, 1).astype(np.float32))


def _blobs(n=128, d=16, classes=4):
    rs = np.random.RandomState(0)
    centers = rs.randn(classes, d) * 3
    y = rs.randint(0, classes, n)
    return ((centers[y] + rs.randn(n, d)).astype(np.float32),
            y.astype(np.int32).reshape(-1, 1))


# ---- the port's side: one spawned rank ----------------------------------

def _port_model(model, mesh, root, wus="auto", ovl="auto"):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    kw = dict(batch_size=BATCH, seed=42, weight_update_sharding=wus,
              overlap_bucket_mb=ovl)
    axes = make_mesh(8, MESHES[mesh])
    if model == "mlp":
        ff = P.FFModel(P.FFConfig(**kw), device="cpu")
        x = ff.create_tensor((BATCH, 64), name="x")
        t = ff.dense(x, 256, name="d0")
        t = ff.relu(t)
        ff.dense(t, 64, name="d1")
    else:
        if mesh == "d4m2":
            kw["import_strategy_file"] = os.path.join(root, "bert.json")
            axes = None
        ff = create_transformer(TransformerConfig(batch_size=BATCH, **BERT),
                                P.FFConfig(**kw), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-2, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [], mesh=axes)
    return ff


def _port_classifier(root, budget=0):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.ffconst import ActiMode
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    cfg = P.FFConfig(batch_size=64, search_budget=budget,
                     enable_parameter_parallel=True)
    if not budget:
        cfg.import_strategy_file = os.path.join(root, "classifier.json")
    ff = P.FFModel(cfg, device="cpu")
    t = ff.create_tensor((64, 16), name="x")
    h = ff.dense(t, 32, activation=ActiMode.AC_MODE_RELU, name="h1")
    ff.softmax(ff.dense(h, 4, name="out"), name="sm")
    ff.compile(AdamOptimizer(alpha=0.01),
               P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
               [P.MetricsType.ACCURACY])
    return ff


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _pieces(ff):
    """{leaf key: (this rank's box, its bits)} of the saved state."""
    from flexflow_tpu_torch.ckpt.sharded import (_capture_state, _rank_boxes,
                                                 flatten_tree)
    boxes = _rank_boxes(ff)
    return {k: (boxes[k][2], _bits(v))
            for k, v in flatten_tree(_capture_state(ff)) if k in boxes}


def _moments(ff):
    """{slot/op/param: bits} of Adam's m and v put together whole over
    the ranks by each leaf's master spec (collectives)."""
    ex = ff.executor
    return {f"{slot}/{op}/{pn}": _bits(ex.whole_leaf(op, pn, t))
            for slot in ("m", "v")
            for op, leaves in ff.opt_state[slot].items()
            for pn, t in leaves.items()}


def _restore_bytes():
    from flexflow_tpu_torch.obs.registry import get_registry
    reg = get_registry()
    return (reg.get("ckpt/restore_read_bytes"),
            reg.get("ckpt/restore_skipped_bytes"))


def _case_load_jax(payload):
    """(a) each JAX checkpoint loaded rank-locally."""
    from flexflow_tpu_torch.ckpt import load_sharded
    out = {}
    for (model, mesh), path in payload["jax_dirs"].items():
        ff = _port_model(model, mesh, payload["root"])
        r0, s0 = _restore_bytes()
        it = load_sharded(path, ff)
        r1, s1 = _restore_bytes()
        out[(model, mesh)] = dict(it=it, pieces=_pieces(ff), read=r1 - r0,
                                  skipped=s1 - s0)
    return out


def _case_save(payload):
    """(b) each model trained and saved by the 8 ranks."""
    from flexflow_tpu_torch.ckpt import save_sharded
    out = {}
    for model in MODELS:
        x, y = _data(model)
        for mesh in MESHES:
            ff = _port_model(model, mesh, payload["root"])
            ff.fit(x, y, epochs=1, verbose=False)
            save_sharded(os.path.join(payload["root"],
                                      f"port_{model}_{mesh}"), ff)
            out[(model, mesh)] = dict(pieces=_pieces(ff), it=ff._iter)
    return out


def _same(a, b):
    return set(a) == set(b) and all(
        a[k][0] == b[k][0] and a[k][1].dtype == b[k][1].dtype
        and np.array_equal(a[k][1], b[k][1]) for k in a)


def _case_resume(payload):
    """(c) fit interrupted and resumed against uninterrupted, and a v1
    round trip, under each of RESUME_MODES on {"data": 8}."""
    root = payload["root"]
    x, y = _data("mlp")
    out = {}
    for wus, ovl in RESUME_MODES:
        tag = f"{wus}_{ovl}"
        ref = _port_model("mlp", "d8", root, wus, ovl)
        ref.fit(x, y, epochs=3, verbose=False)
        ck = os.path.join(root, f"fit_{tag}")
        first = _port_model("mlp", "d8", root, wus, ovl)
        first.fit(x, y, epochs=1, verbose=False, checkpoint_dir=ck,
                  checkpoint_every=1)
        second = _port_model("mlp", "d8", root, wus, ovl)
        second.fit(x, y, epochs=3, verbose=False, checkpoint_dir=ck,
                   resume=True)
        stem = os.path.join(root, f"v1_{tag}")
        ref.save_checkpoint(stem)
        v1 = _port_model("mlp", "d8", root, wus, ovl)
        it = v1.load_checkpoint(stem)
        out[(wus, ovl)] = dict(
            wus=ref.executor.weight_update_sharding,
            overlap=ref.executor.grad_overlap,
            ref_losses=list(ref.epoch_losses),
            resumed_losses=list(second.epoch_losses),
            resumed_same=_same(_pieces(ref), _pieces(second)),
            v1_iter=it, v1_same=_same(_pieces(ref), _pieces(v1)),
            shard_elems=sum(t.numel() for s in ref.params.values()
                            for t in s.values()))
    return out


def _case_elastic(payload, rank):
    """(d) 8 ranks train and save the classifier; then ranks 0-3 form a
    group of 4, plan, search, restore and predict."""
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.ckpt import load_manifest, plan_resume, \
        save_sharded
    from flexflow_tpu_torch.parallel import comm

    root = payload["root"]
    x, y = _blobs()
    ff = _port_classifier(root)
    ff.fit(x, y, epochs=2, verbose=False)
    ck = os.path.join(root, "elastic")
    save_sharded(ck, ff)
    names = ("h1", "out")
    before = dict(params={n: ff.get_parameter(n) for n in names},
                  moments=_moments(ff),
                  predict=ff.predict(x[:64]), mesh=dict(ff.mesh.shape),
                  boxes={k: b for k, (b, _) in _pieces(ff).items()})
    dist.barrier()
    dist.destroy_process_group()
    comm._COMMS.clear()
    if rank >= 4:
        return dict(before=before)
    distributed.initialize(
        store=dist.FileStore(os.path.join(root, "store4"), 4),
        world_size=4, rank=rank, backend="gloo", timeout_s=120)
    plan = plan_resume(load_manifest(ck), distributed.process_count())
    ff4 = _port_classifier(root, budget=2)
    it = ff4.load_checkpoint(ck)
    return dict(before=before, plan=plan, it=it, mesh=dict(ff4.mesh.shape),
                params={n: ff4.get_parameter(n) for n in names},
                moments=_moments(ff4), predict=ff4.predict(x[:64]),
                boxes={k: b for k, (b, _) in _pieces(ff4).items()})


CASES = {"a": _case_load_jax, "b": _case_save, "c": _case_resume}


def _rank_main(rank, world, root):
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.multihost_dryrun import exit_rank
    # one thread a rank: the world's ranks share the host's cores
    torch.set_num_threads(1)
    distributed.initialize(
        store=dist.FileStore(os.path.join(root, f"store{world}"), world),
        world_size=world, rank=rank, backend="gloo", timeout_s=120)
    res, code = {}, 1
    try:
        payload = torch.load(os.path.join(root, "payload.pt"),
                             weights_only=False)
        for name, case in CASES.items():
            try:
                res[name] = case(payload)
            except Exception:
                res[name] = dict(error=traceback.format_exc())
        try:
            res["d"] = _case_elastic(payload, rank)
        except Exception:
            res["d"] = dict(error=traceback.format_exc())
        torch.save(res, os.path.join(root, f"out{world}.{rank}"))
        code = 0
    except BaseException:
        traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        exit_rank(code)


def _spawn(root, world):
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(world, root), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(root, f"out{world}.{r}"),
                       weights_only=False) for r in range(world)]


# ---- the JAX side --------------------------------------------------------

def _jax_model(model, mesh, root):
    """The JAX twin of ``_port_model``; ``mesh`` None: one device."""
    import jax.numpy as jnp

    import flexflow_tpu as J
    from flexflow_tpu.machine import make_mesh
    from flexflow_tpu.models.transformer import (
        TransformerConfig as JTransformerConfig,
        create_transformer as j_create_transformer)
    from flexflow_tpu.optimizers import AdamOptimizer as JAdam

    cfg = J.FFConfig(batch_size=BATCH, seed=42)
    axes = make_mesh(8, MESHES[mesh]) if mesh else None
    if mesh is None:
        cfg.workers_per_node = 1
    if model == "mlp":
        ff = J.FFModel(cfg)
        x = ff.create_tensor((BATCH, 64), name="x")
        t = ff.dense(x, 256, name="d0")
        t = ff.relu(t)
        ff.dense(t, 64, name="d1")
    else:
        if mesh == "d4m2":
            cfg.import_strategy_file = os.path.join(root, "bert.json")
            axes = None
        ff = j_create_transformer(JTransformerConfig(batch_size=BATCH,
                                                     **BERT), cfg)
    ff.compile(JAdam(alpha=1e-2, state_dtype=jnp.bfloat16),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [], mesh=axes)
    return ff


def _jax_state(ff):
    """{leaf key: bits} of the JAX model's saved state."""
    from flexflow_tpu.ckpt.sharded import _capture_state
    from flexflow_tpu.ckpt.tree import flatten_tree
    out = {}
    for k, v in flatten_tree(_capture_state(ff)):
        if hasattr(v, "shape"):
            a = np.asarray(v)
            out[k] = a.view(np.uint16) if a.dtype.kind not in "fiub" else a
    return out


def _saved_boxes(path):
    """{leaf key: sorted boxes} over every index of a checkpoint."""
    from flexflow_tpu_torch.ckpt import latest_complete, load_manifest
    step_dir = latest_complete(path)[1]
    out = {}
    for name in load_manifest(path)["index_files"]:
        with open(os.path.join(step_dir, name)) as f:
            for k, rows in json.load(f)["shards"].items():
                out.setdefault(k, []).extend(r["index"] for r in rows)
    return {k: sorted(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX saves, the 8-rank world, then the JAX loads of the port's
    saves: {"jax": ..., "ranks": [...], "jax_loads": ...}."""
    from flexflow_tpu.ckpt import load_manifest as j_load_manifest
    from flexflow_tpu.ckpt import load_sharded as j_load_sharded
    from flexflow_tpu.ckpt import plan_resume as j_plan_resume
    from flexflow_tpu.ckpt import save_sharded as j_save_sharded

    root = str(tmp_path_factory.mktemp("ckpt_ranks"))
    for name, body in (("bert.json", _bert_strategy()),
                       ("classifier.json", _classifier_strategy())):
        with open(os.path.join(root, name), "w") as f:
            json.dump(body, f)
    jax_dirs, jax = {}, {}
    for model in MODELS:
        x, y = _data(model)
        for mesh in MESHES:
            jff = _jax_model(model, mesh, root)
            jff.fit(x, y, epochs=1, verbose=False)
            path = os.path.join(root, f"jax_{model}_{mesh}")
            j_save_sharded(path, jff)
            jax_dirs[(model, mesh)] = path
            jax[(model, mesh)] = dict(
                state=_jax_state(jff), boxes=_saved_boxes(path),
                wus=bool(jff.wus_enabled), it=int(jff._iter))
    torch.save(dict(root=root, jax_dirs=jax_dirs),
               os.path.join(root, "payload.pt"))
    ranks = _spawn(root, 8)
    loads = {}
    for model in MODELS:
        for mesh in MESHES:
            path = os.path.join(root, f"port_{model}_{mesh}")
            for where in (mesh, None):
                jff = _jax_model(model, where, root)
                j_load_sharded(path, jff)
                loads[(model, mesh, where)] = _jax_state(jff)
            loads[(model, mesh, "boxes")] = _saved_boxes(path)
    elastic = os.path.join(root, "elastic")
    loads["plan"] = j_plan_resume(j_load_manifest(elastic), 4)
    return dict(jax=jax, ranks=ranks, jax_loads=loads)


def _case(runs, name):
    for r, res in enumerate(runs["ranks"]):
        if isinstance(res.get(name), dict) and "error" in res[name]:
            pytest.fail(f"rank {r}: {res[name]['error']}")
    return [res[name] for res in runs["ranks"]]


def _whole(per_rank, key, shape_of):
    """The whole leaf ``key`` put together from every rank's piece."""
    box0, bits0 = per_rank[0][key]
    out = np.zeros(shape_of, bits0.dtype)
    for pieces in per_rank:
        box, bits = pieces[key]
        out[tuple(slice(s, e) for s, e in box)] = bits
    return out


# ---- the tests -----------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_jax_checkpoint_loads_rank_locally(runs, model, mesh):
    """(a) Each rank's piece of every leaf is the JAX array's box, bit for
    bit; each rank read only its boxes (the others' skipped)."""
    got = [r[(model, mesh)] for r in _case(runs, "a")]
    want = runs["jax"][(model, mesh)]
    assert want["wus"]
    for r, res in enumerate(got):
        assert res["it"] == want["it"] == STEPS
        assert set(res["pieces"]) == set(want["state"])
        for key, (box, bits) in res["pieces"].items():
            whole = want["state"][key]
            cut = whole[tuple(slice(s, e) for s, e in box)]
            assert bits.dtype == cut.dtype and np.array_equal(bits, cut), \
                (r, key, box)
        assert res["skipped"] > 0 and res["read"] > 0, r
    # the WUS leaves are cut: a rank holds less than the whole state
    sizes = [sum(b.size for _, b in res["pieces"].values()) for res in got]
    assert max(sizes) < sum(a.size for a in want["state"].values())


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_port_checkpoint_loads_in_the_jax_package(runs, model, mesh):
    """(b) The 8 ranks' save loads in the JAX package on 8 devices and on
    one, bit for bit against the ranks' pieces put together; per leaf
    its boxes are the ones the JAX package wrote for the same strategy."""
    per_rank = [r[(model, mesh)]["pieces"] for r in _case(runs, "b")]
    loads = runs["jax_loads"]
    for where in (mesh, None):
        state = loads[(model, mesh, where)]
        assert set(state) == set(per_rank[0])
        for key, arr in state.items():
            whole = _whole(per_rank, key, arr.shape)
            assert whole.dtype == arr.dtype and np.array_equal(whole, arr), \
                (where, key)
    assert loads[(model, mesh, "boxes")] == \
        runs["jax"][(model, mesh)]["boxes"]


@pytest.mark.parametrize("mode", RESUME_MODES)
def test_fit_resume_is_the_uninterrupted_run(runs, mode):
    """(c) The resumed fit's losses are the uninterrupted run's tail and
    every rank's every leaf its bits; a v1 save over the ranks restores
    bit for bit."""
    got = [r[mode] for r in _case(runs, "c")]
    c0 = got[0]
    assert c0["wus"] == (mode[0] == "on")
    assert c0["overlap"] == (mode[1] == "1")
    for res in got:
        assert res["resumed_losses"] == res["ref_losses"][1:]
        assert res["resumed_same"] and res["v1_same"]
        assert res["v1_iter"] == 3 * STEPS
        assert res["ref_losses"] == c0["ref_losses"]
    if c0["wus"]:
        # each rank holds an eighth of the parameters (every leaf divides)
        assert c0["shard_elems"] * 8 == 64 * 256 + 256 + 256 * 64 + 64


def test_elastic_resume_onto_fewer_ranks(runs):
    """(d) 8 ranks on {"data": 4, "model": 2} save; 4 ranks re-search,
    plan as the JAX package plans, restore the parameters and Adam's
    moments bit for bit onto their own boxes and predict within 1e-6."""
    got = _case(runs, "d")
    before = got[0]["before"]
    assert before["mesh"] == MESHES["d4m2"]
    # the saving strategy cut h1 on 'model', its moments too, and the
    # two steps left them nonzero
    assert before["boxes"]["params/h1/kernel"][1] == [0, 16]
    assert before["boxes"]["opt_state/m/h1/kernel"][1] == [0, 16]
    assert all(np.any(w != 0) for w in before["moments"].values())
    want_plan = runs["jax_loads"]["plan"]
    assert want_plan["action"] == "research"
    for r, res in enumerate(got[:4]):
        assert res["plan"] == want_plan, r
        assert res["it"] == 4
        assert int(np.prod(list(res["mesh"].values()))) == 4
        for name, w in before["params"].items():
            np.testing.assert_array_equal(
                res["params"][name].view(np.uint32), w.view(np.uint32))
        # m and v re-cut onto the 4 ranks' boxes, bit for bit
        assert set(res["moments"]) == set(before["moments"])
        for key, w in before["moments"].items():
            np.testing.assert_array_equal(
                res["moments"][key].view(np.uint32), w.view(np.uint32),
                err_msg=f"rank {r} {key}")
        assert res["boxes"]["opt_state/m/h1/kernel"] != \
            before["boxes"]["opt_state/m/h1/kernel"]
        np.testing.assert_allclose(res["predict"], before["predict"],
                                   rtol=PRED_RTOL, atol=PRED_ATOL)
    for res in got[4:]:
        assert "plan" not in res
