"""PyTorch port, the learned cost model and the calibration file.

``flexflow_tpu_torch/costmodel``, the learned table in ``search/unity.py``
and ``search/validate.py``, the analytic twin of ``obs/simtrace.py``, and
the readers of the port's calibration file (``search/profile.py``
``calibration_path``), against the JAX package on the CPU, the same
inputs to both:
- the corpus of ``tests/fixtures/costmodel`` (rows, classes, features)
  is the same in both packages, and a schema-v4 row is refused by both;
- the trained model (classes, coefficients, hull, held-out error) and
  its native table are the same; the port's platform gate refuses a
  ``"gpu"`` table for a CPU search, and any table without a device;
- with one learned table, both ``graph_optimize``s return the same
  strategy JSON, ``predicted_time``, ``cost_model`` and
  ``learned_cost_classes`` at 1 and 4 devices; ``FFS_NO_LEARNED_COSTS``
  returns the table-less search bit for bit;
- the replay of one compiled strategy (``simulate_strategy``), learned
  and analytic, and a traced fit's simtrace (learned sources, analytic
  twin) equal the reference's;
- ``_memory_correction``, ``load_op_corrections`` and
  ``load_collective_corrections`` read one ``FFS_CALIBRATION_FILE`` as
  the reference does, a memory-capped search divides its threshold
  alike, and the port's defaults open ``CALIBRATION_GPU.json``, never
  ``CALIBRATION.json``.

Tolerances: coefficients, held-out errors and predictions rel 1e-12 (the
same numpy operations on the same rows); JSON structures, strategy files
and simulator responses exact.
"""

import builtins
import glob
import json
import os

import numpy as np
import pytest

import flexflow_tpu as J
import flexflow_tpu.costmodel as jcm
import flexflow_tpu.machine as jmachine
import flexflow_tpu.search.profile as jprofile
import flexflow_tpu.search.validate as jvalidate
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.machine import MachineSpec as JMachineSpec
from flexflow_tpu.models.mlp import create_mlp as j_create_mlp
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.costmodel as pcm
import flexflow_tpu_torch.machine as pmachine
import flexflow_tpu_torch.search.profile as pprofile
import flexflow_tpu_torch.search.validate as pvalidate
from flexflow_tpu_torch.costmodel import corpus as pcorpus
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.machine import MachineSpec
from flexflow_tpu_torch.models import (TransformerConfig, create_mlp,
                                       create_transformer)
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.tensor import Tensor as PTensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "costmodel")
SMALL = dict(num_layers=2, hidden_size=32, num_heads=2, seq_length=8,
             batch_size=4)
MLP = dict(batch_size=8, in_dim=64, hidden_dims=(128, 128), out_dim=10)
REL = 1e-12


def _dumps(x):
    return json.dumps(x, sort_keys=True)


def _aligned():
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start


def _pair(model, **cfg):
    """(JAX model, port model) of ``model``, uncompiled, guids aligned."""
    _aligned()
    if model == "transformer":
        jff = j_create_transformer(JTransformerConfig(**SMALL),
                                   J.FFConfig(batch_size=4, **cfg))
        pff = create_transformer(TransformerConfig(**SMALL),
                                 P.FFConfig(batch_size=4, **cfg),
                                 device="cpu")
    else:
        jff = j_create_mlp(**MLP, ff_config=J.FFConfig(batch_size=8, **cfg))
        pff = create_mlp(**MLP, ff_config=P.FFConfig(batch_size=8, **cfg),
                         device="cpu")
    return jff, pff


def _graph(ff):
    nodes, _, tensor_ref = ff._materialize_nodes()
    return nodes, ff._select_final_ref(nodes, tensor_ref)


@pytest.fixture(scope="module")
def corpora():
    return jcm.build_corpus([FIXTURES]), pcm.build_corpus([FIXTURES])


@pytest.fixture(scope="module")
def models(corpora):
    jc, pc = corpora
    return jcm.train_model(jc), pcm.train_model(pc)


@pytest.fixture(scope="module")
def table_file(models, tmp_path_factory):
    """The port's model trained on the fixtures, its hull opened wide so
    that the small graphs here fall inside it (the wiring under test is
    the table's, not the fixtures' coverage)."""
    _, pm = models
    wide = pcm.CostModel.from_json(pm.to_json())
    for cm in wide.classes.values():
        cm.fmin = np.full(4, -100.0)
        cm.fmax = np.full(4, 100.0)
    path = str(tmp_path_factory.mktemp("costmodel") / "COSTMODEL_GPU.json")
    wide.save(path)
    return path


# ---- corpus ----------------------------------------------------------------------

def test_corpus_rows_and_classes_match(corpora):
    jc, pc = corpora
    assert len(pc["rows"]) == len(jc["rows"]) == 100
    assert _dumps(pc) == _dumps(jc)
    assert pc["classes"]["LINEAR"] == 41
    assert pcm.CORPUS_SCHEMA_VERSION == jcm.CORPUS_SCHEMA_VERSION == 3
    assert tuple(pcm.FEATURE_NAMES) == tuple(jcm.FEATURE_NAMES)


def test_features_and_keys_match(corpora):
    import flexflow_tpu.costmodel.corpus as jcorpus
    _, pc = corpora
    for row in pc["rows"]:
        np.testing.assert_array_equal(pcm.featurize(row),
                                      jcm.featurize(row))
        assert pcorpus.row_key(row) == jcorpus.row_key(row)
        assert pcorpus.row_class(row) == jcorpus.row_class(row)
        assert pcorpus.row_impl(row) == jcorpus.row_impl(row)


@pytest.mark.parametrize("where", ["artifact", "row"])
def test_a_v4_row_is_refused_by_both(tmp_path, where):
    src = json.load(open(glob.glob(os.path.join(FIXTURES, "*.json"))[0]))
    if where == "artifact":
        src["corpus_schema"] = 4
    else:
        src["per_op"][0]["schema"] = 4
    (tmp_path / "x_r00_host00.simtrace.json").write_text(json.dumps(src))
    with pytest.raises(jcm.CorpusSchemaError):
        jcm.build_corpus([str(tmp_path)])
    with pytest.raises(pcm.CorpusSchemaError, match="schema v4"):
        pcm.build_corpus([str(tmp_path)])


def test_corpus_round_trips(corpora, tmp_path):
    _, pc = corpora
    path = str(tmp_path / "COSTMODEL_CORPUS_GPU.json")
    pcm.save_corpus(path, pc)
    assert _dumps(pcm.load_corpus(path)) == _dumps(pc)


# ---- model -----------------------------------------------------------------------

def test_trained_models_match(models):
    jm, pm = models
    assert sorted(pm.classes) == sorted(jm.classes) == [
        "CONV2D", "EW_ADD", "LAYERNORM", "LINEAR", "MULTIHEAD_ATTENTION"]
    assert pm.platform == jm.platform == "cpu"
    assert pm.corpus_rows == jm.corpus_rows
    for name, want in jm.classes.items():
        got = pm.classes[name]
        for attr in ("coef_fwd", "coef_bwd", "fmin", "fmax"):
            np.testing.assert_allclose(getattr(got, attr),
                                       getattr(want, attr), rtol=REL)
        assert (got.n_train, got.n_test) == (want.n_train, want.n_test)
        assert got.err_fwd == pytest.approx(want.err_fwd, rel=REL)
        assert got.err_bwd == pytest.approx(want.err_bwd, rel=REL)
    assert _dumps(pm.to_json()) == _dumps(jm.to_json())
    assert _dumps(pm.native_table()) == _dumps(jm.native_table())


def test_predictions_match(corpora, models):
    _, pc = corpora
    jm, pm = models
    for row in pc["rows"]:
        for bwd in (False, True):
            t, c = pm.predict(row, bwd=bwd)
            wt, wc = jm.predict(row, bwd=bwd)
            assert (t is None) == (wt is None)
            if t is not None:
                assert t == pytest.approx(wt, rel=REL)
                assert c == pytest.approx(wc, rel=REL)
        assert pm.in_hull(row) == jm.in_hull(row)


def test_model_round_trips(models, tmp_path):
    _, pm = models
    path = str(tmp_path / "m.json")
    pm.save(path)
    assert _dumps(pcm.CostModel.load(path).to_json()) == _dumps(pm.to_json())
    # the file rounds coefficients to 8 digits: both packages read the
    # port's file into one table
    assert _dumps(pcm.load_model(path).native_table()) == _dumps(
        jcm.load_model(path).native_table())


def test_platform_gate(models, tmp_path, monkeypatch):
    """A table trained on the CPU prices a CPU search only; a "gpu" table
    never prices a search on the CPU; without a device only a table of
    platform "unknown" loads."""
    monkeypatch.delenv("FFS_NO_LEARNED_COSTS", raising=False)
    _, pm = models
    cpu = str(tmp_path / "cpu.json")
    pm.save(cpu)
    gpu = pcm.CostModel.from_json(dict(pm.to_json(), platform="gpu"))
    gpath = str(tmp_path / "gpu.json")
    gpu.save(gpath)
    assert pcm.load_native_table(cpu, device="cpu") is not None
    assert pcm.load_native_table(gpath, device="cpu") is None
    assert pcm.load_native_table(gpath, platform="gpu") is not None
    assert pcm.load_native_table(cpu) is None
    assert pcm.load_native_table(gpath) is None
    # the reference's gate on the same files
    assert jcm.load_native_table(cpu, platform="cpu") is not None
    assert jcm.load_native_table(gpath, platform="cpu") is None
    monkeypatch.setenv("FFS_NO_LEARNED_COSTS", "1")
    assert pcm.load_native_table(cpu, device="cpu") is None
    assert pcm.load_native_table(gpath, platform="gpu") is None


def test_default_model_path(monkeypatch, tmp_path):
    monkeypatch.delenv("FFS_COSTMODEL_FILE", raising=False)
    assert pcm.default_model_path() == os.path.join(REPO,
                                                    "COSTMODEL_GPU.json")
    monkeypatch.setenv("FFS_COSTMODEL_FILE", str(tmp_path / "x.json"))
    assert pcm.default_model_path() == str(tmp_path / "x.json")
    assert pcm.load_model() is None


# ---- search ----------------------------------------------------------------------

def _search(model, n, monkeypatch, table=None, off=False):
    """Both packages' graph_optimize of ``model`` at ``n`` devices under
    ``table`` -> [(strategy JSON, predicted time, cost_model, classes,
    request's machine)] for (JAX, port)."""
    if table:
        monkeypatch.setenv("FFS_COSTMODEL_FILE", table)
    else:
        monkeypatch.setenv("FFS_COSTMODEL_FILE", os.devnull)
    if off:
        monkeypatch.setenv("FFS_NO_LEARNED_COSTS", "1")
    else:
        monkeypatch.delenv("FFS_NO_LEARNED_COSTS", raising=False)
    jff, pff = _pair(model)
    out = []
    for ff, mod, spec, kw in ((jff, junity, JMachineSpec, {}),
                              (pff, unity, MachineSpec, dict(device="cpu"))):
        cfg = ff.config
        cfg.search_budget = 2
        cfg.opt_state_factor = 2.0
        nodes, final = _graph(ff)
        mesh, st, info = mod.graph_optimize(
            nodes, spec(chip="cpu-sim", chips_per_slice=n), cfg, n,
            batch=MLP["batch_size"] if model == "mlp" else 4,
            final_ref=final, **kw)
        out.append((mod.strategy_json(mesh, st,
                                      info.get("rewritten_nodes", nodes),
                                      objective=info["objective"]),
                    info["predicted_time"], info["cost_model"],
                    info.get("learned_cost_classes")))
    return out


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("model", ["transformer", "mlp"])
def test_graph_optimize_under_one_table_matches(model, n, table_file,
                                                monkeypatch):
    (want, want_t, want_cm, want_cls), (got, got_t, got_cm, got_cls) = \
        _search(model, n, monkeypatch, table=table_file)
    assert _dumps(got) == _dumps(want)
    assert got_t == want_t
    assert got_cm == want_cm == "learned"
    assert got_cls == want_cls and "LINEAR" in got_cls
    if model == "mlp":
        # classes whose type the graph lacks never count
        assert got_cls == ["LINEAR"]


def test_the_request_carries_the_table(table_file, monkeypatch):
    monkeypatch.setenv("FFS_COSTMODEL_FILE", table_file)
    monkeypatch.delenv("FFS_NO_LEARNED_COSTS", raising=False)
    seen = []
    import flexflow_tpu_torch.search.native as pnative
    real = pnative.native_optimize
    monkeypatch.setattr(pnative, "native_optimize",
                        lambda req: seen.append(req) or real(req))
    _, pff = _pair("mlp")
    pff.config.search_budget = 2
    nodes, final = _graph(pff)
    unity.graph_optimize(nodes, MachineSpec(chip="cpu-sim"), pff.config, 1,
                         batch=8, final_ref=final, device="cpu")
    table = pcm.load_native_table(table_file, device="cpu")
    assert _dumps(seen[0]["machine"]["learned"]) == _dumps(table)
    want = junity.machine_to_json(JMachineSpec(chip="cpu-sim"), 1,
                                  learned=table)
    assert _dumps(unity.machine_to_json(MachineSpec(chip="cpu-sim"), 1,
                                        learned=table)) == _dumps(want)


@pytest.mark.parametrize("model", ["transformer", "mlp"])
def test_no_learned_costs_is_the_tableless_search(model, table_file,
                                                  monkeypatch):
    base = _search(model, 4, monkeypatch)
    off = _search(model, 4, monkeypatch, table=table_file, off=True)

    def by_position(s):  # two builds name their unnamed layers apart
        return _dumps(dict(s, ops=list(s["ops"].values())))

    for (s0, t0, cm0, cls0), (s1, t1, cm1, cls1) in zip(base, off):
        assert by_position(s1) == by_position(s0) and t1 == t0
        assert cm0 == cm1 == "analytic" and cls0 is cls1 is None
    assert _dumps(base[1][0]) == _dumps(base[0][0])


def test_a_gpu_table_never_prices_a_cpu_compile(models, tmp_path,
                                                monkeypatch):
    _, pm = models
    gpu = pcm.CostModel.from_json(dict(pm.to_json(), platform="gpu"))
    path = str(tmp_path / "COSTMODEL_GPU.json")
    gpu.save(path)
    monkeypatch.setenv("FFS_COSTMODEL_FILE", path)
    monkeypatch.delenv("FFS_NO_LEARNED_COSTS", raising=False)
    pff = create_mlp(**MLP, ff_config=P.FFConfig(batch_size=8,
                                                  search_budget=2),
                     device="cpu")
    pff.compile(AdamOptimizer(alpha=1e-3),
                P.LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    assert pff.search_info["cost_model"] == "analytic"
    assert "learned_cost_classes" not in pff.search_info


def test_a_pinned_attention_core_is_its_own_measurement():
    """The measured-op cache keys a pinned core apart: a corpus of flash
    and einsum fits of one shape keeps two attention times."""
    _, pff = _pair("transformer")
    nodes, _ = _graph(pff)
    attn = next(n.op for n in nodes
                if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION)
    keys = []
    for impl in (None, "flash", "einsum"):
        attn.kernel_impl = impl
        keys.append(pprofile.op_cost_key(attn, "cpu"))
    attn.kernel_impl = None
    assert len(set(keys)) == 3
    assert pprofile.op_cost_key(attn, "cpu") == keys[0]


# ---- the replay and the simtrace ---------------------------------------------------

@pytest.fixture(scope="module")
def learned_pair(table_file, tmp_path_factory):
    """Both packages' transformer compiled with ``search_budget=2`` under
    the learned table, then one traced 2-step ``fit`` each from the same
    weights (the JAX package's Pallas kernels in interpret mode)."""
    import jax

    from flexflow_tpu_torch.weights import from_jax_params
    tmp = tmp_path_factory.mktemp("learned")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FFS_COSTMODEL_FILE", table_file)
        mp.delenv("FFS_NO_LEARNED_COSTS", raising=False)
        mp.setenv("FLEXFLOW_TPU_PALLAS", "interpret")
        jff, pff = _pair("transformer", search_budget=2)
        jff.config.workers_per_node = 1
        jff.compile(J.AdamOptimizer(alpha=1e-3),
                    J.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    [J.MetricsType.MEAN_SQUARED_ERROR])
        pff.compile(AdamOptimizer(alpha=1e-3),
                    P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                    [P.MetricsType.MEAN_SQUARED_ERROR])
        from_jax_params(jax.tree.map(np.asarray, jff.params), pff)
        rs = np.random.RandomState(0)
        x = rs.randn(8, SMALL["seq_length"],
                     SMALL["hidden_size"]).astype(np.float32)
        y = rs.randn(8, SMALL["seq_length"], 1).astype(np.float32)
        jff.fit(x, y, epochs=1, verbose=False, trace_dir=str(tmp / "jax"))
        pff.fit(x, y, epochs=1, verbose=False, trace_dir=str(tmp / "port"))
        yield jff, pff, tmp


def test_learned_search_info_matches(learned_pair):
    jff, pff, _ = learned_pair
    for key in ("cost_model", "learned_cost_classes", "predicted_time",
                "memory_correction"):
        assert pff.search_info[key] == jff.search_info[key], key
    assert pff.search_info["cost_model"] == "learned"
    assert {g: s.choice for g, s in pff.strategy.items()} == {
        g: s.choice for g, s in jff.strategy.items()}


def test_replay_prices_with_the_searchs_table(learned_pair, table_file,
                                              monkeypatch):
    jff, pff, _ = learned_pair
    monkeypatch.setenv("FFS_COSTMODEL_FILE", table_file)
    monkeypatch.delenv("FFS_NO_LEARNED_COSTS", raising=False)
    for learned in ("auto", False):
        want = jvalidate.simulate_strategy(jff, learned=learned)
        got = pvalidate.simulate_strategy(pff, learned=learned)
        assert _dumps(got) == _dumps(want)
        srcs = set(got["cost_sources"].values())
        assert ("learned" in srcs) == (learned == "auto")
        assert got["iteration_time"] > 0
    table = pcm.load_native_table(table_file, device="cpu")
    assert _dumps(pvalidate.simulate_strategy(pff, learned=table)) == \
        _dumps(pvalidate.simulate_strategy(pff))


def _simtrace(d):
    paths = glob.glob(os.path.join(str(d), "fit_*.simtrace.json"))
    assert len(paths) == 1, paths
    return json.load(open(paths[0]))


def test_simtrace_carries_learned_sources_and_the_analytic_twin(
        learned_pair):
    jff, pff, tmp = learned_pair
    want, got = _simtrace(tmp / "jax"), _simtrace(tmp / "port")
    assert got["cost_sources"] == want["cost_sources"]
    assert got["cost_sources"].get("learned", 0) >= 1
    assert got["predicted"] == want["predicted"]
    assert got["predicted_analytic"] == want["predicted_analytic"]
    assert got["predicted_analytic"]["step_s"] != got["predicted"]["step_s"]
    assert got["search_predicted_s"] == want["search_predicted_s"]
    assert len(got["per_op"]) == len(want["per_op"])
    for g, w in zip(got["per_op"], want["per_op"]):
        # measured seconds are each package's own timings (none here)
        g, w = dict(g), dict(w)
        assert g.pop("measured") == w.pop("measured") == dict(
            fwd_s=None, bwd_s=None, source=None)
        assert _dumps(g) == _dumps(w)


# ---- the calibration file ----------------------------------------------------------

CAL = dict(
    platform="gpu", device="NVIDIA H100 80GB HBM3",
    results=[dict(model="bert_proxy", mem_ratio=1.31),
             dict(model="resnet", mem_ratio=1.12),
             dict(model="alexnet", mem_ratio=2.4),
             dict(model="mlp", mem_ratio=None),
             dict(model="fit", source="drift_report", ratio=0.5)],
    op_corrections=dict(gpu={"LINEAR": dict(factor=1.7, weight=0.6)},
                        cpu={"LINEAR": dict(factor=300.0, weight=1.0)}),
    collective_corrections=dict(gpu={"all-reduce": dict(factor=1.25),
                                     "all-gather": 1.5},
                                tpu={"all-reduce": dict(factor=0.9)}))


@pytest.fixture
def cal_file(tmp_path, monkeypatch):
    path = tmp_path / "CALIBRATION_GPU.json"
    path.write_text(json.dumps(CAL))
    monkeypatch.setenv("FFS_CALIBRATION_FILE", str(path))
    return str(path)


def test_calibration_readers_match_the_reference(cal_file):
    assert unity._memory_correction() == junity._memory_correction() == 1.31
    for platform in ("gpu", "cpu", "tpu"):
        assert pprofile.load_op_corrections(platform=platform) == \
            jprofile.load_op_corrections(path=cal_file, platform=platform)
        assert pmachine.load_collective_corrections(platform) == \
            jmachine.load_collective_corrections(platform, path=cal_file)
    assert pmachine.load_collective_corrections("gpu") == {
        "all-reduce": 1.25, "all-gather": 1.5}


def test_a_memory_capped_search_divides_its_threshold_alike(cal_file,
                                                            monkeypatch):
    monkeypatch.setenv("FFS_COSTMODEL_FILE", os.devnull)
    seen = {}
    import flexflow_tpu.search.native as jnative
    import flexflow_tpu_torch.search.native as pnative
    for mod, key in ((jnative, "jax"), (pnative, "port")):
        real = mod.native_optimize
        monkeypatch.setattr(
            mod, "native_optimize",
            lambda req, real=real, key=key: (seen.__setitem__(key, req)
                                             or real(req)))
    jff, pff = _pair("mlp")
    infos = []
    for ff, mod, spec, kw in ((jff, junity, JMachineSpec, {}),
                              (pff, unity, MachineSpec, dict(device="cpu"))):
        cfg = ff.config
        cfg.search_budget = 2
        cfg.memory_search = True
        cfg.memory_threshold_mb = 64
        nodes, final = _graph(ff)
        infos.append(mod.graph_optimize(
            nodes, spec(chip="cpu-sim", chips_per_slice=4), cfg, 4,
            batch=8, final_ref=final, **kw)[2])
    want = 64 * (1 << 20) / 1.31
    assert seen["port"]["config"]["memory_threshold"] == \
        seen["jax"]["config"]["memory_threshold"] == pytest.approx(want,
                                                                   rel=REL)
    assert infos[1]["memory_correction"] == infos[0]["memory_correction"] \
        == 1.31
    assert infos[1]["predicted_memory"] == infos[0]["predicted_memory"]


def test_defaults_open_the_ports_file_never_calibration_json(monkeypatch):
    monkeypatch.delenv("FFS_CALIBRATION_FILE", raising=False)
    opened = []
    real = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.path.basename(str(path)))
        return real(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    unity._memory_correction()
    pprofile.load_op_corrections(platform="gpu")
    pmachine.load_collective_corrections("gpu")
    assert pprofile.calibration_path() == os.path.join(
        REPO, "CALIBRATION_GPU.json")
    assert "CALIBRATION.json" not in opened
    assert set(opened) <= {"CALIBRATION_GPU.json"}


def test_a_cpu_spec_never_takes_collective_corrections(cal_file):
    cal = json.load(open(cal_file))
    cal["collective_corrections"]["cpu"] = {"all-reduce": 3.0}
    with open(cal_file, "w") as f:
        json.dump(cal, f)
    spec = pmachine.detect_machine_spec(device="cpu")
    assert spec.collective_corrections is None
