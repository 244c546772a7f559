"""PyTorch port, weight-update sharding (WUS) and the comms-compute overlap
over a process group, against the JAX package's run on the 8-virtual-device
CPU mesh (``tests/conftest.py``).

Mirrors ``tests/test_wus.py`` (flags and "auto", the sharded state, parity,
``evaluate`` / ``predict``, ``set_parameter`` / ``get_parameter``),
``tests/test_overlap.py`` (``TestFlagAndAuto``, ``TestBucketedParity``,
``TestPerOpWusGranularity``, ``TestFflint::test_bucketed_census_is_clean``,
``TestSearchedOverlapWiring``) and ``tests/test_kernel_search.py``'s
``test_fused_update_bitwise_on_8way_mesh`` (the ``_k:fused`` update, K4's
plain version on the CPU, over the shards).

As ``tests/test_torch_port_mesh.py`` does, the port runs every case in one
spawned world of 8 gloo ranks over a FileStore under the test's temporary
directory, rank r at JAX's device r; the JAX side runs in this process
and hands its initial parameters across by name (``weights.from_jax_params``
cuts each rank's shard). No module-level import here touches JAX.

Cases:
- the MLP of ``tests/test_wus.py`` (64 -> 512 -> relu -> 64, batch 16,
  Adam alpha 1e-2, MSE) on ``{"data": 8}`` and ``{"data": 2, "model":
  4}``, WUS off, on, and on with 1-MB overlap buckets;
- the 2-layer BERT-proxy (hidden 256, 4 heads, S 64) at batch 64 and 16,
  compiled with a search budget on the ``cpu-sim`` machine of 8 devices
  (parameter parallelism on, substitutions and pipelines off) by both
  packages: the searched ``{"data": 8}`` (``dp``, ``dp_wus_ovl``,
  ``dp_wus_ovl_k:fused``) and ``{"data": 4, "model": 2}`` (``sample2``
  and ``rep`` beside them), each package executing its own search; and
  the JAX package's exported strategy file imported by the port with WUS
  off, on, and on with the overlap off.

Bounds, the mesh tests' (f32 compute on both sides; the sums run in other
orders): per-step loss rtol 1e-4; every parameter after 3 steps atol 2e-5
and rtol 1e-4. The overlap against none, and the fused update against the
plain one, bit for bit.
"""

import json
import os
import traceback

import numpy as np
import pytest
import torch

STEPS = 3
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-4
BATCH = 16
BERT = dict(num_layers=2, hidden_size=256, num_heads=4, seq_length=64)
BERT_BATCHES = (64, 16)
# the search of both packages: parameter parallelism on, graph rewrites
# and pipelines off
SEARCH_CFG = dict(search_budget=2, enable_parameter_parallel=True,
                  enable_substitution=False, enable_pipeline_parallel=False)
MLP_MESHES = {"d8": {"data": 8}, "d2m4": {"data": 2, "model": 4}}
# (weight_update_sharding, overlap_bucket_mb) of the MLP runs
MLP_MODES = (("off", "off"), ("on", "off"), ("on", "1"))


def _mlp_data():
    rs = np.random.RandomState(0)
    return (rs.randn(STEPS * BATCH, 64).astype(np.float32),
            rs.randn(STEPS * BATCH, 64).astype(np.float32))


def _bert_batch(batch):
    rs = np.random.RandomState(1)
    return (rs.randn(batch, BERT["seq_length"],
                     BERT["hidden_size"]).astype(np.float32),
            rs.randn(batch, BERT["seq_length"], 1).astype(np.float32))


# ---- the port's side: one spawned rank ----------------------------------

def _port_mlp(mesh_axes, wus="auto", overlap="auto", optimizer=None,
              comp_mode=None, width=64, hidden=512):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    ff = P.FFModel(P.FFConfig(batch_size=BATCH, seed=42,
                              weight_update_sharding=wus,
                              overlap_bucket_mb=overlap), device="cpu")
    x = ff.create_tensor((BATCH, width), name="x")
    if hidden:
        t = ff.dense(x, hidden, name="d0")
        t = ff.relu(t)
        ff.dense(t, width, name="d1")
    else:
        ff.dense(x, width, name="tiny")
    kw = {} if comp_mode is None else dict(comp_mode=comp_mode)
    ff.compile(optimizer or AdamOptimizer(alpha=1e-2),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               mesh=make_mesh(8, mesh_axes), **kw)
    return ff


def _train(ff, x, y):
    out = []
    for s in range(STEPS):
        ff.fit(x[s * BATCH:(s + 1) * BATCH], y[s * BATCH:(s + 1) * BATCH],
               epochs=1, verbose=False)
        out.append(ff._last_loss)
    return out


def _state_elems(ff):
    """{op/param: (whole elements, master, m, v elements on this rank,
    whether WUS shards it)}."""
    ex = ff.executor
    out = {}
    for op, sub in ff.params.items():
        for pn, t in sub.items():
            whole = ex.whole_shape(op, pn, t)
            out[f"{op}/{pn}"] = (
                int(np.prod(whole)), t.numel(),
                ff.opt_state["m"][op][pn].numel(),
                ff.opt_state["v"][op][pn].numel(),
                ex.wus_spec(op, pn, whole) is not None)
    return out


def _record(ff):
    """The last step's collectives: (kind, axes, bytes)."""
    return list(ff.executor.comm.step_record)


def _case_flags(payload):
    """The resolved flags of every "auto" / "on" / "off" pairing."""
    from flexflow_tpu_torch.ffconst import CompMode
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    out = {}
    for name, (mesh, wus, ovl) in dict(
            auto8=("d8", "auto", "auto"), auto2=("d2m4", "auto", "auto"),
            on2=("d2m4", "on", "auto"), off8=("d8", "off", "auto"),
            mb1=("d8", "on", "1"), ovl_off=("d8", "on", "off"),
            ovl_0=("d8", "on", "0"), wus_off_ovl4=("d8", "off", "4")).items():
        ex = _port_mlp(MLP_MESHES[mesh], wus, ovl).executor
        out[name] = dict(wus=ex.weight_update_sharding,
                         overlap=ex.grad_overlap,
                         bucket=ex.overlap_bucket_bytes, wus_ops=ex.wus_ops)
    ff = _port_mlp(MLP_MESHES["d8"], "on", optimizer=SGDOptimizer(),
                   comp_mode=CompMode.INFERENCE)
    out["inference"] = dict(wus=ff.executor.weight_update_sharding,
                            compute_copy=ff.executor.keeps_compute_copy)
    return out


def _case_mlp(payload):
    """Each MLP mesh under MLP_MODES: losses, whole parameters, the
    rank's state elements, the step's collectives; and under WUS
    ``evaluate``, ``predict``, a parameter round trip and a refused
    save."""
    from flexflow_tpu_torch.weights import from_jax_params, to_jax_params
    out = {}
    x, y = payload["data"]
    for mesh, init in payload["init"].items():
        for wus, ovl in MLP_MODES:
            ff = _port_mlp(MLP_MESHES[mesh], wus, ovl)
            from_jax_params(init, ff)
            losses = _train(ff, x, y)
            run = dict(losses=losses, params=to_jax_params(ff),
                       elems=_state_elems(ff), record=_record(ff),
                       overlap=list(ff.executor.overlap_record),
                       wus=ff.executor.weight_update_sharding)
            if (wus, ovl) == ("on", "1"):
                run["evaluate"] = ff.evaluate(x[:BATCH], y[:BATCH])["loss"]
                run["predict"] = ff.predict(x[:BATCH])
                w = np.arange(64 * 512, dtype=np.float32).reshape(64, 512)
                ff.set_parameter("d0", w)
                run["roundtrip"] = bool(np.array_equal(
                    ff.get_parameter("d0"), w))
                try:
                    ff.save_checkpoint(payload["root"] + f"/ck{mesh}")
                    run["save"] = "saved"
                except NotImplementedError as e:
                    run["save"] = str(e)
            out[(mesh, wus, ovl)] = run
    # a leaf no dim of which the data degree divides stays replicated
    tiny = _port_mlp(MLP_MESHES["d8"], "on", width=12, hidden=0)
    tiny.fit(np.zeros((BATCH, 12), np.float32),
             np.zeros((BATCH, 12), np.float32), epochs=1, verbose=False)
    out["tiny"] = dict(elems=_state_elems(tiny), loss=tiny._last_loss)
    return out


def _case_fused(payload):
    """The ``_k:fused`` update (K4's plain version on the CPU) against the
    plain one over the WUS shards: every parameter and state leaf after
    3 steps, bit for bit, for Adam, SGD and SGD with momentum."""
    from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
    mk = {"adam": lambda: AdamOptimizer(alpha=1e-2),
          "sgd": lambda: SGDOptimizer(lr=0.01),
          "sgd_momentum": lambda: SGDOptimizer(lr=0.01, momentum=0.9)}
    x, y = payload["data"]
    out = {}
    for name, opt in mk.items():
        leaves = []
        for fused in (False, True):
            ff = _port_mlp(MLP_MESHES["d8"], "on", optimizer=opt())
            if fused:
                ff.executor.kernel_choices = {"d0": "fused", "d1": "fused"}
                ff.executor.fused_update_ops = {"d0", "d1"}
            _train(ff, x, y)
            leaves.append([t.clone() for t in _flat((ff.params,
                                                     ff.opt_state))])
        out[name] = (len(leaves[0]), all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(*leaves)))
    return out


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [t for sub in tree for t in _flat(sub)]


def _port_bert(batch, **cfg_kw):
    import flexflow_tpu_torch as P
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    ff = create_transformer(TransformerConfig(batch_size=batch, **BERT),
                            P.FFConfig(batch_size=batch, **cfg_kw),
                            device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    return ff


def _bert_run(ff, batch, init):
    from flexflow_tpu_torch.weights import from_jax_params, to_jax_params
    from_jax_params(init, ff)
    x, y = _bert_batch(batch)
    losses = []
    for _ in range(STEPS):
        ff.fit(x, y, epochs=1, verbose=False)
        losses.append(ff._last_loss)
    ex = ff.executor
    return dict(losses=losses, params=to_jax_params(ff),
                wus=ex.weight_update_sharding, overlap=ex.grad_overlap,
                bucket=ex.overlap_bucket_bytes,
                wus_ops=sorted(ex.wus_ops) if ex.wus_ops is not None
                else None,
                overlap_record=list(ex.overlap_record), record=_record(ff),
                elems=_state_elems(ff))


def _case_bert(payload):
    """Per batch: the port's own search in the group (its strategy, the
    resolved flags, 3 steps from the JAX package's initial parameters),
    then the JAX package's exported file imported with WUS on and the
    overlap at 1 MB, on with the overlap off, and off; rank 0 lints the
    searched run's step census."""
    from flexflow_tpu_torch.search import unity
    out = {}
    for batch in BERT_BATCHES:
        p = payload[batch]
        ff = _port_bert(batch, **SEARCH_CFG)
        run = _bert_run(ff, batch, p["init"])
        run["strategy"] = json.loads(json.dumps(unity.strategy_json(
            dict(ff.mesh.shape), ff.strategy, ff.executor.nodes)))
        run["searched_bucket"] = (ff.search_info.get("overlap")
                                  or {}).get("bucket_mb")
        if batch == BERT_BATCHES[0] and ff.executor.comm.rank == 0:
            from flexflow_tpu_torch.analysis import lint_model
            from flexflow_tpu_torch.analysis.passes.collectives import \
                CollectiveInferencePass
            rep = lint_model(ff, hlo=True,
                             passes=[CollectiveInferencePass()])
            run["lint"] = dict(
                status=rep.passes["collective-inference"],
                ffl2=[d.format() for d in rep.errors
                      if d.rule.startswith("FFL2")])
        out[(batch, "searched")] = run
        for name, kw in (("file_ovl", dict(weight_update_sharding="on",
                                           overlap_bucket_mb="1")),
                         ("file_sync", dict(weight_update_sharding="on",
                                            overlap_bucket_mb="off")),
                         ("file_off", dict(weight_update_sharding="off",
                                           overlap_bucket_mb="off"))):
            ff = _port_bert(batch, import_strategy_file=p["strategy"], **kw)
            out[(batch, name)] = _bert_run(ff, batch, p["init"])
    return out


CASES = {"flags": _case_flags, "mlp": _case_mlp, "fused": _case_fused,
         "bert": _case_bert}


def _rank_main(rank, world, root, names):
    import torch.distributed as dist

    from flexflow_tpu_torch import distributed
    # one thread a rank: the world's ranks share the host's cores
    torch.set_num_threads(1)
    distributed.initialize(
        store=dist.FileStore(os.path.join(root, f"store{world}"), world),
        world_size=world, rank=rank, backend="gloo", timeout_s=120)
    try:
        payload = torch.load(os.path.join(root, "payload.pt"),
                             weights_only=False)
        res = {}
        for name in names:
            try:
                res[name] = CASES[name](payload.get(name))
            except Exception:
                res[name] = dict(error=traceback.format_exc())
        torch.save(res, os.path.join(root, f"out{world}.{rank}"))
    finally:
        dist.destroy_process_group()


def _spawn(root, world, names):
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(world, root, names), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(root, f"out{world}.{r}"),
                       weights_only=False) for r in range(world)]


# ---- the JAX side --------------------------------------------------------

def _host(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _jax_mlp(mesh_axes, wus):
    from flexflow_tpu.config import FFConfig
    from flexflow_tpu.ffconst import LossType
    from flexflow_tpu.machine import make_mesh
    from flexflow_tpu.model import FFModel
    from flexflow_tpu.optimizers import AdamOptimizer

    cfg = FFConfig(batch_size=BATCH, seed=42)
    cfg.weight_update_sharding = wus
    ff = FFModel(cfg)
    x = ff.create_tensor((BATCH, 64), name="x")
    t = ff.dense(x, 512, name="d0")
    t = ff.relu(t)
    ff.dense(t, 64, name="d1")
    ff.compile(AdamOptimizer(alpha=1e-2),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               mesh=make_mesh(8, mesh_axes))
    return ff


def _jax_train(ff, x, y):
    out = []
    for s in range(STEPS):
        ff.set_batch(x[s * BATCH:(s + 1) * BATCH],
                     y[s * BATCH:(s + 1) * BATCH])
        ff.forward()
        ff.backward()
        ff.update()
        out.append(float(ff._last_loss))
    return out


def _jax_bert(batch, path):
    """The JAX package's searched compile, its strategy exported to
    ``path``: (model, its initial parameters)."""
    import jax.numpy as jnp

    import flexflow_tpu as J
    from flexflow_tpu.models.transformer import (
        TransformerConfig as JTransformerConfig,
        create_transformer as j_create_transformer)
    from flexflow_tpu.optimizers import AdamOptimizer as JAdam

    cfg = J.FFConfig(batch_size=batch)
    for k, v in SEARCH_CFG.items():
        setattr(cfg, k, v)
    cfg.export_strategy_file = path
    ff = j_create_transformer(JTransformerConfig(batch_size=batch, **BERT),
                              cfg)
    ff.compile(JAdam(alpha=1e-4, state_dtype=jnp.bfloat16),
               J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [J.MetricsType.MEAN_SQUARED_ERROR])
    return ff, _host(ff.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case in both packages: (jax results, [rank results])."""
    root = str(tmp_path_factory.mktemp("wus"))
    jres, payload = {}, {}
    x, y = _mlp_data()
    init, jres["mlp"] = {}, {}
    for mesh, axes in MLP_MESHES.items():
        for wus in ("on", "off"):
            jff = _jax_mlp(axes, wus)
            init.setdefault(mesh, _host(jff.params))
            jres["mlp"][(mesh, wus)] = dict(
                losses=_jax_train(jff, x, y), params=_host(jff.params),
                wus=jff.executor.weight_update_sharding)
    payload["mlp"] = dict(init=init, data=(x, y), root=root)
    payload["fused"] = dict(data=(x, y))
    jres["bert"], payload["bert"] = {}, {}
    for batch in BERT_BATCHES:
        path = os.path.join(root, f"bert{batch}.json")
        jff, jinit = _jax_bert(batch, path)
        bx, by = _bert_batch(batch)
        losses = []
        for _ in range(STEPS):
            jff.fit(bx, by, epochs=1, verbose=False)
            losses.append(float(jff._last_loss))
        jex = jff.executor
        jres["bert"][batch] = dict(
            losses=losses, params=_host(jff.params),
            strategy=json.loads(open(path).read()),
            wus=jff.wus_enabled, overlap=jff.overlap_enabled,
            bucket=jex.overlap_bucket_bytes,
            wus_ops=sorted(jex.wus_ops) if jex.wus_ops is not None
            else None)
        payload["bert"][batch] = dict(init=jinit, strategy=path)
    torch.save(payload, os.path.join(root, "payload.pt"))
    return jres, _spawn(root, 8, list(CASES))


def _port(ranks, case):
    for r in ranks:
        if isinstance(r[case], dict) and "error" in r[case]:
            pytest.fail(r[case]["error"])
    return ranks[0][case]


def _check_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _check_params(got, want):
    assert set(got) == set(want)
    for layer, sub in want.items():
        assert set(got[layer]) == set(sub), layer
        for name, w in sub.items():
            np.testing.assert_allclose(got[layer][name], np.asarray(w),
                                       atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                       err_msg=f"{layer}/{name}")


def _bitwise(a, b):
    assert a["losses"] == b["losses"]
    for layer, sub in a["params"].items():
        for name, v in sub.items():
            np.testing.assert_array_equal(v, b["params"][layer][name])


def _check_elems(elems, degree):
    """Every sharded leaf's master and moments at a 1/degree share of
    the whole; every other leaf whole (these meshes shard no parameter
    on 'model' where WUS is on)."""
    for leaf, (whole, master, m, v, sharded) in elems.items():
        want = whole // degree if sharded else whole
        assert master == m == v == want, (leaf, whole, master, m, v)


# ---- the tests -----------------------------------------------------------

def test_flags_and_auto_resolve_as_the_jax_package(runs):
    """``"auto"`` engages WUS at a data degree of 4 or more on a strategy
    not searched, ``"on"`` above 1, ``"off"`` and inference never; the
    overlap follows WUS at 4 MB under ``"auto"``, N forces N-MB buckets,
    ``"off"`` / ``"0"`` disable it and it needs WUS (the JAX package's
    ``test_wus.py`` / ``test_overlap.py`` ``TestFlagAndAuto``)."""
    _, ranks = runs
    got = _port(ranks, "flags")
    assert all(r["flags"] == got for r in ranks)
    assert got["auto8"] == dict(wus=True, overlap=True, bucket=4_000_000,
                                wus_ops=None)
    assert not got["auto2"]["wus"] and not got["auto2"]["overlap"]
    assert got["on2"]["wus"] and not got["off8"]["wus"]
    assert got["mb1"]["overlap"] and got["mb1"]["bucket"] == 1_000_000
    assert not got["ovl_off"]["overlap"] and not got["ovl_0"]["overlap"]
    assert not got["wus_off_ovl4"]["overlap"]
    assert got["inference"] == dict(wus=False, compute_copy=False)


@pytest.mark.parametrize("mesh", sorted(MLP_MESHES))
def test_mlp_matches_the_jax_wus_run(runs, mesh):
    """WUS on (and with 1-MB overlap buckets) against the JAX package's
    WUS run and against the port's WUS-off run: per-step losses and the
    whole parameters after 3 steps, the same on every rank."""
    jres, ranks = runs
    got = _port(ranks, "mlp")
    want = jres["mlp"][(mesh, "on")]
    assert want["wus"] and got[(mesh, "on", "off")]["wus"]
    for ovl in ("off", "1"):
        run = got[(mesh, "on", ovl)]
        _check_losses(run["losses"], want["losses"])
        _check_params(run["params"], want["params"])
        off = got[(mesh, "off", "off")]
        _check_losses(run["losses"], off["losses"])
        _check_params(run["params"], off["params"])
        for r in ranks[1:]:
            _bitwise(r["mlp"][(mesh, "on", ovl)], run)


@pytest.mark.parametrize("mesh", sorted(MLP_MESHES))
def test_overlap_is_the_sync_bit_for_bit(runs, mesh):
    """The bucketed asynchronous reduce-scatters against the synchronous
    ones: identical losses and parameters, the same collectives (each
    leaf one reduce-scatter of the same size), issued by bucket."""
    _, ranks = runs
    for r in ranks:
        run = r["mlp"]
        if "error" in run:
            pytest.fail(run["error"])
        _bitwise(run[(mesh, "on", "off")], run[(mesh, "on", "1")])
    got = _port(ranks, "mlp")
    sync, ovl = got[(mesh, "on", "off")], got[(mesh, "on", "1")]
    assert sorted(sync["record"]) == sorted(ovl["record"])
    assert sync["overlap"] == []
    # the MLP's 66,112 f32 gradient elements fill less than 1 MB: one
    # bucket of its 4 leaves, each leaf's reduce-scatter issued from it
    assert [(e["bucket"], e["leaves"], e["bytes"]) for e in ovl["overlap"]] \
        == [(0, 4, 66112 * 4)]
    assert sum(k == "reduce-scatter" for k, _, _ in ovl["record"]) == 4


@pytest.mark.parametrize("mesh,degree", [("d8", 8), ("d2m4", 2)])
def test_master_and_moments_hold_the_rank_shard(runs, mesh, degree):
    """Each rank's f32 master and Adam moments of every leaf WUS shards
    at the whole leaf's elements over the data degree (every leaf of the
    MLP divides), whole without WUS; the step's record: reduce-scatters
    and all-gathers over 'data', no all-reduce of a parameter."""
    _, ranks = runs
    got = _port(ranks, "mlp")
    on, off = got[(mesh, "on", "off")], got[(mesh, "off", "off")]
    assert all(e[4] for e in on["elems"].values())
    _check_elems(on["elems"], degree)
    assert not any(e[4] for e in off["elems"].values())
    _check_elems(off["elems"], 1)
    kinds = {}
    for kind, axes, nbytes in on["record"]:
        kinds.setdefault((kind, axes), []).append(nbytes)
    assert len(kinds[("reduce-scatter", ("data",))]) == 4
    assert len(kinds[("all-gather", ("data",))]) == 4
    # the all-reduces left are the loss's (4 bytes) alone
    assert kinds[("all-reduce", ("data",))] == [4]


def test_indivisible_leaves_stay_replicated(runs):
    """A 12 -> 12 dense on 8 data ranks: no dim divides, so its leaves
    stay whole and it trains."""
    _, ranks = runs
    tiny = _port(ranks, "mlp")["tiny"]
    assert not any(e[4] for e in tiny["elems"].values())
    _check_elems(tiny["elems"], 1)
    assert np.isfinite(tiny["loss"])


def test_evaluate_predict_and_parameters_gather_the_shards(runs):
    """``evaluate`` and ``predict`` read the gathered working copy;
    ``set_parameter`` cuts each rank's shard and ``get_parameter``
    gathers it back; a save over the ranks is refused, naming its
    item."""
    jres, ranks = runs
    got = _port(ranks, "mlp")[("d8", "on", "1")]
    assert np.isfinite(got["evaluate"])
    assert got["predict"].shape == (BATCH, 64)
    assert np.isfinite(got["predict"]).all()
    assert got["roundtrip"]
    assert "Queue 1 item 3" in got["save"]


def test_fused_update_is_the_plain_one_on_shards(runs):
    """``_k:fused`` on both dense layers (the CPU runs K4's plain
    version for Adam) against the plain update, over the WUS shards:
    every parameter and state leaf bit for bit (``tests/
    test_kernel_search.py``'s 8-way mesh case)."""
    _, ranks = runs
    for r in ranks:
        if "error" in r["fused"]:
            pytest.fail(r["fused"]["error"])
        for name, (n, same) in r["fused"].items():
            assert n > 0 and same, name


@pytest.mark.parametrize("batch", BERT_BATCHES)
def test_searched_bert_proxy_matches_the_jax_package(runs, batch):
    """The port's search in the 8-rank group picks the JAX package's
    strategy (its exported file, op by op), resolves WUS per op from the
    ``_wus`` choices and the overlap at the searched bucket size, and its
    3 steps match the JAX package's within the bounds."""
    jres, ranks = runs
    got = _port(ranks, "bert")[(batch, "searched")]
    want = jres["bert"][batch]
    assert got["strategy"]["mesh"] == want["strategy"]["mesh"]
    assert {n: o["choice"] for n, o in got["strategy"]["ops"].items()} == \
        {n: o["choice"] for n, o in want["strategy"]["ops"].items()}
    assert got["strategy"]["ops"] == want["strategy"]["ops"]
    assert got["wus"] == want["wus"] is True
    assert got["overlap"] == want["overlap"] is True
    assert got["wus_ops"] == want["wus_ops"] and got["wus_ops"]
    assert got["bucket"] == want["bucket"] == \
        int(got["searched_bucket"] * 1e6)
    _check_losses(got["losses"], want["losses"])
    _check_params(got["params"], want["params"])
    for r in ranks[1:]:
        _bitwise(r["bert"][(batch, "searched")], got)


@pytest.mark.parametrize("batch", BERT_BATCHES)
def test_bert_proxy_file_runs_wus_off_on_and_overlapped(runs, batch):
    """The JAX package's strategy file imported: WUS on with 1-MB
    overlap buckets bit-equal to WUS on without the overlap, both within
    the bounds of the WUS-off run and of the JAX package's searched run;
    some bucket's reduce-scatters were issued while the backward still
    had gradients to make."""
    jres, ranks = runs
    got = _port(ranks, "bert")
    ovl, sync = got[(batch, "file_ovl")], got[(batch, "file_sync")]
    off = got[(batch, "file_off")]
    assert ovl["wus"] and ovl["overlap"] and ovl["bucket"] == 1_000_000
    assert sync["wus"] and not sync["overlap"] and not off["wus"]
    for r in ranks:
        _bitwise(r["bert"][(batch, "file_ovl")], r["bert"][(batch,
                                                            "file_sync")])
    for run in (ovl, sync):
        _check_losses(run["losses"], off["losses"])
        _check_params(run["params"], off["params"])
        _check_losses(run["losses"], jres["bert"][batch]["losses"])
        _check_params(run["params"], jres["bert"][batch]["params"])
    assert len(ovl["overlap_record"]) > 1
    assert any(e["pending"] > 0 for e in ovl["overlap_record"])
    buckets = ovl["overlap_record"]
    assert [e["bucket"] for e in buckets] == list(range(len(buckets)))
    assert sum(e["leaves"] for e in buckets) == sum(
        k == "reduce-scatter" for k, _, _ in ovl["record"])


def test_searched_bucketed_census_is_clean(runs):
    """The searched ``{"data": 8}`` step's census (reduce-scatters and
    all-gathers over 'data' beside the all-reduces of the ``dp`` ops)
    diffs FFL2xx-clean against the priced and inferred collectives
    (``tests/test_overlap.py`` ``TestFflint``)."""
    _, ranks = runs
    got = _port(ranks, "bert")[(BERT_BATCHES[0], "searched")]
    kinds = {(k, a) for k, a, _ in got["record"]}
    assert ("reduce-scatter", ("data",)) in kinds
    assert ("all-gather", ("data",)) in kinds
    assert got["lint"]["status"] == "ok" and not got["lint"]["ffl2"], \
        got["lint"]


def test_wus_ops_gate_the_specs_and_the_replay():
    """Per-op granularity (``TestPerOpWusGranularity``): a ``wus_ops``
    set leaves the other ops' leaves whole, and the simulator replay
    carries ``_wus_ovl`` on those ops alone; forced "on" keeps it
    global. Planned over 8 devices in this process
    (``analysis.orchestrator.plan_model``)."""
    import flexflow_tpu_torch as P
    import flexflow_tpu_torch.search.native as native
    from flexflow_tpu_torch.analysis.orchestrator import plan_model
    from flexflow_tpu_torch.optimizers import AdamOptimizer
    from flexflow_tpu_torch.search import validate

    ff = P.FFModel(P.FFConfig(batch_size=BATCH, weight_update_sharding="on",
                              overlap_bucket_mb="1"), device="cpu")
    x = ff.create_tensor((BATCH, 64), name="x")
    t = ff.dense(x, 512, name="d0")
    t = ff.relu(t)
    ff.dense(t, 64, name="d1")
    plan_model(ff, 8, AdamOptimizer(alpha=1e-2),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    ex = ff.executor
    assert ex.wus_ops is None and ex.weight_update_sharding
    assert ex.wus_spec("d1", "kernel", (512, 64)) is not None
    ex.wus_ops = {"d0"}
    assert ex.wus_spec("d0", "kernel", (64, 512)) is not None
    assert ex.wus_spec("d1", "kernel", (512, 64)) is None
    specs = ex.wus_param_specs()
    assert "d0" in specs and "d1" not in specs
    if not native.available():
        pytest.skip("native search unavailable")
    captured = {}
    real = native.native_simulate

    def spy(req):
        captured.update(req["assignment"])
        return real(req)

    native.native_simulate = spy
    try:
        validate.simulate_strategy(ff)
    finally:
        native.native_simulate = real
    by_name = {n.op.name: str(n.op.guid) for n in ex.nodes}
    assert captured[by_name["d0"]].endswith("_wus_ovl")
    assert "_wus" not in captured[by_name["d1"]]
