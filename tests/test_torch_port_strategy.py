"""PyTorch port, strategies and the machine model against the JAX package.

``ParallelTensorShape``, ``MachineSpec`` (``_factor_torus``, ``from_file``,
``effective_dcn``), machine detection, the heuristic strategies,
``apply_strategy``, repeated-block detection, the search flags, and
strategy files that cross between the packages both ways, at 1, 4 and 8
devices: a file either package exports imports into the other with the
same choices and specs. A multi-device strategy imports, and compiling
it raises, naming the ROADMAP item that brings it.

The transformer is 2 layers, hidden 256, 4 heads, S 128, batch 8; the
multi-device searches run on the JAX package's ``"cpu-sim"`` machine, or
on a machine file with a TPU v5e's figures under the ``"cpu-sim"`` name,
where the search picks a 'pipe' mesh. Every comparison is exact: the same
JSON, specs and numbers (the same native core on the same request).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import flexflow_tpu as J
import flexflow_tpu.config as jconfig
import flexflow_tpu.machine as jmachine
from flexflow_tpu.layer import Layer as JLayer
from flexflow_tpu.models.transformer import (
    TransformerConfig as JTransformerConfig,
    create_transformer as j_create_transformer)
from flexflow_tpu.parallel import pipeline_detect as jpipe
from flexflow_tpu.parallel import strategy as jstrategy
from flexflow_tpu.search import unity as junity
from flexflow_tpu.tensor import ParallelDim as JParallelDim
from flexflow_tpu.tensor import ParallelTensorShape as JParallelTensorShape
from flexflow_tpu.tensor import Tensor as JTensor
import flexflow_tpu_torch as P
import flexflow_tpu_torch.config as pconfig
import flexflow_tpu_torch.machine as pmachine
from flexflow_tpu_torch.layer import Layer as PLayer
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.optimizers import AdamOptimizer
from flexflow_tpu_torch.parallel import pipeline_detect as ppipe
from flexflow_tpu_torch.parallel import strategy as pstrategy
from flexflow_tpu_torch.search import unity
from flexflow_tpu_torch.tensor import ParallelDim, ParallelTensorShape
from flexflow_tpu_torch.tensor import Tensor as PTensor

SMALL = dict(num_layers=2, hidden_size=256, num_heads=4, seq_length=128,
             batch_size=8)
# a TPU v5e's figures (the JAX package's table) under the "cpu-sim" name:
# both packages read the file, and the search there picks a 'pipe' mesh
V5E_LIKE = dict(chip="cpu-sim", flops=197e12, hbm_bw=0.82e12, hbm_cap=16e9,
                ici_bw=45e9)


def _pair(**cfg):
    for a, b in ((JLayer, PLayer), (JTensor, PTensor)):
        start = max(a._next_guid[0], b._next_guid[0])
        a._next_guid[0] = b._next_guid[0] = start
    jff = j_create_transformer(JTransformerConfig(**SMALL),
                               J.FFConfig(batch_size=8, **cfg))
    pff = create_transformer(TransformerConfig(**SMALL),
                             P.FFConfig(batch_size=8, **cfg), device="cpu")
    return jff, pff


def _graph(ff):
    nodes, _, tensor_ref = ff._materialize_nodes()
    return nodes, ff._select_final_ref(nodes, tensor_ref)


def _as_lists(x):
    """Specs (tuples or PartitionSpecs, nested) -> plain lists."""
    if x is None or isinstance(x, str):
        return x
    return [_as_lists(e) for e in x]


def _machine_file(tmp_path, n, **figures):
    path = tmp_path / f"machine{n}.json"
    path.write_text(json.dumps(dict(figures, chips_per_slice=n)))
    return str(path)


def _search(ff, mod, spec, n, training=True):
    nodes, final = _graph(ff)
    cfg = ff.config
    cfg.search_budget = 2
    cfg.opt_state_factor = 2.0 if training else 0.0
    cfg.computation_mode = (type(cfg.computation_mode).TRAINING if training
                            else type(cfg.computation_mode).INFERENCE)
    mesh, st, info = mod.graph_optimize(nodes, spec, cfg, n, batch=8,
                                        final_ref=final)
    return nodes, mesh, st, info


# ---- tensors and the machine ---------------------------------------------------

@pytest.mark.parametrize("dims", [
    [(8, 2, ("data",)), (128, 1, ()), (256, 4, ("model",))],
    [(4, 4, ("data",), True), (16, 4, ("data", "model")), (32, 1, ())],
    [(6, 1, ())],
])
def test_parallel_tensor_shape_matches_jax(dims):
    def build(dim_cls, shape_cls):
        return shape_cls(tuple(dim_cls(*d) for d in dims))
    j = build(JParallelDim, JParallelTensorShape)
    p = build(ParallelDim, ParallelTensorShape)
    assert _as_lists(p.partition_spec()) == _as_lists(j.partition_spec())
    for attr in ("sizes", "degrees", "num_replica", "total_degree"):
        assert getattr(p, attr) == getattr(j, attr), attr
    for fn in ("num_elements", "shard_bytes", "global_bytes"):
        assert getattr(p, fn)() == getattr(j, fn)(), fn
    assert ParallelTensorShape.make((8, 4), degrees=(2, 1)).degrees == (2, 1)
    with pytest.raises(ValueError, match="divisible"):
        ParallelDim(6, 4)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 12, 16, 32, 64])
def test_factor_torus_matches_jax(n):
    for dims in (1, 2, 3):
        assert pmachine._factor_torus(n, dims) \
            == jmachine._factor_torus(n, dims)


@pytest.mark.parametrize("fmt", ["json", "key_value"])
def test_machine_file_matches_jax(tmp_path, fmt):
    """``from_file`` in both formats, with the original FlexFlow's GB/s and
    ms keys and an explicit slice fabric: the same machine JSON, and the
    same effective DCN ring."""
    path = tmp_path / "machine.cfg"
    if fmt == "json":
        path.write_text(json.dumps(dict(
            chip="cpu-sim", chips_per_slice=4, num_slices=3,
            nvlink_bandwidth=300, nic_latency=0.02, min_op_time=2e-6,
            dcn_links=[[0, 1, 12.5e9], [1, 2, 50e9]])))
    else:
        path.write_text("chip = cpu-sim\nchips_per_slice = 4\n"
                        "num_nodes = 3  # slices\nnvlink_bandwidth = 300\n"
                        "nic_latency = 0.02\ntorus = 2 2\n"
                        "dcn_link = 0 1 12.5e9\ndcn_link = 2 0 50e9\n")
    j = jmachine.MachineSpec.from_file(str(path))
    p = pmachine.MachineSpec.from_file(str(path))
    assert p.effective_dcn() == j.effective_dcn()
    for comm in (1.0, 0.5):
        assert unity.machine_to_json(p, p.num_devices, comm) \
            == junity.machine_to_json(j, j.num_devices, comm)


def test_h100_entry_is_a_flat_switched_node():
    spec = pmachine.MachineSpec(chip="h100-sxm", chips_per_slice=8,
                                num_slices=2)
    m = unity.machine_to_json(spec, 16, comm_bytes_factor=0.5)
    assert m["torus"] == [8] and m["num_slices"] == 2
    assert (m["flops"], m["hbm_bw"], m["hbm_cap"]) == (989e12, 3.35e12, 80e9)
    assert m["ici_bw"] == 225e9 and m["dcn_bw"] == 50e9
    entry = pmachine.CHIP_SPECS["h100-sxm"]
    assert (m["mxu_efficiency"], m["min_op_time"]) \
        == (entry["mxu_efficiency"], entry["min_op_time"])
    with pytest.raises(ValueError, match="unknown chip"):
        pmachine.MachineSpec(chip="tpu-v5e")


@pytest.mark.parametrize("name,chip", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"),
    ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA H100 PCIe", None),
])
def test_detect_machine_spec(monkeypatch, name, chip):
    assert pmachine.detect_machine_spec(device="cpu").chip == "cpu-sim"
    props = type("Props", (), dict(total_memory=80 * 2 ** 30))()
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    if chip is None:
        with pytest.raises(pmachine.UnknownDeviceError,
                           match="--machine-model-file"):
            pmachine.detect_machine_spec(device="cuda:0")
        return
    spec = pmachine.detect_machine_spec(device="cuda:0")
    assert (spec.chip, spec.num_devices, spec.torus) == (chip, 8, (8,))
    spec = pmachine.detect_machine_spec(1, device="cuda:0")
    assert spec.num_devices == 1


# ---- heuristic strategies and apply_strategy ---------------------------------------

@pytest.mark.parametrize("axes", [{"data": 2, "model": 2}, {"data": 4},
                                  {"seq": 4}, {"data": 1}])
def test_heuristic_strategies_match_jax(axes):
    jff, pff = _pair()
    (jn, _), (pn, _) = _graph(jff), _graph(pff)
    n = int(np.prod(list(axes.values())))
    jmesh = jmachine.make_mesh(n, axes)
    pmesh = pmachine.make_mesh(n, axes)
    want = jstrategy.tensor_parallel_overrides(
        jn, jmesh, jstrategy.data_parallel_strategy(jn, jmesh))
    got = pstrategy.tensor_parallel_overrides(
        pn, pmesh, pstrategy.data_parallel_strategy(pn, pmesh))
    assert sorted(got) == sorted(want)
    for g in want:
        assert _as_lists(got[g].output_specs) \
            == _as_lists(want[g].output_specs)
        assert {k: _as_lists(v) for k, v in got[g].param_specs.items()} \
            == {k: _as_lists(v) for k, v in want[g].param_specs.items()}


def test_apply_strategy_pins_and_refuses(monkeypatch):
    _, pff = _pair()
    nodes, _ = _graph(pff)
    mesh = pmachine.make_mesh(1, {"data": 1})
    st = pstrategy.data_parallel_strategy(nodes, mesh)
    attn = [n for n in nodes if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION]
    st[attn[0].guid].choice = "rep_k:flash"
    st[attn[1].guid].choice = "rep_k:einsum"
    st[attn[1].guid].output_specs = [("data",)]
    pstrategy.apply_strategy(nodes, st, mesh)
    assert [n.op.kernel_impl for n in attn] == ["flash", "einsum"]
    assert attn[1].output_specs == [("data",)]
    # still refused, each naming its item: a pipe axis (item 10), an
    # expert axis (item 3's rest); a _wus choice over a group of the
    # mesh's size runs (tests/test_torch_port_wus.py)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pstrategy.apply_strategy(nodes, st, pmachine.make_mesh(
            4, {"data": 2, "pipe": 2}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        pstrategy.apply_strategy(nodes, st, pmachine.make_mesh(
            2, {"expert": 2}))
    from flexflow_tpu_torch import distributed
    mesh2 = pmachine.make_mesh(2, {"data": 2})
    with pytest.raises(NotImplementedError, match="process group"):
        pstrategy.apply_strategy(nodes, st, mesh2)
    st[attn[1].guid].choice = "dp_wus_k:einsum"
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    assert pstrategy.apply_strategy(nodes, st, mesh2)[
        attn[1].op.name] == "einsum"


def _attention_pair(choices):
    """Fresh nodes of the small transformer on a one-device mesh, with
    the two attention ops' choices set to ``choices``."""
    _, pff = _pair()
    nodes, _ = _graph(pff)
    mesh = pmachine.make_mesh(1, {"data": 1})
    st = pstrategy.data_parallel_strategy(nodes, mesh)
    attn = [n for n in nodes
            if n.op.op_type == P.OperatorType.MULTIHEAD_ATTENTION]
    for n, choice in zip(attn, choices):
        st[n.guid].choice = choice
    return nodes, st, mesh, attn


@pytest.mark.parametrize("kernels,device,training,pins,report", [
    # the serving rule: rep keeps the availability rule (flash on the card)
    ("chosen", "cuda", False, ["flash", None], ["flash", "flash"]),
    # a compile whose kernel dimension ran: rep is pinned to einsum where
    # flash would have run
    ("all", "cuda", True, ["flash", "einsum"], ["flash", "einsum"]),
    ("all", "cuda", False, ["flash", "einsum"], ["flash", "einsum"]),
    # on the CPU flash cannot run by availability: nothing to pin
    ("all", "cpu", True, ["flash", None], ["flash", "einsum"]),
    ("off", "cuda", True, [None, None], None),
])
def test_apply_strategy_kernel_rule(kernels, device, training, pins, report):
    """``apply_strategy`` alone turns choices into kernels: the pins it
    leaves on the attention ops and the {op name -> impl} it reports."""
    nodes, st, mesh, attn = _attention_pair(["rep_k:flash", "rep"])
    got = pstrategy.apply_strategy(nodes, st, mesh, kernels=kernels,
                                   training=training, device=device)
    assert [n.op.kernel_impl for n in attn] == pins
    if report is None:
        assert got is None
    else:
        assert [got[n.op.name] for n in attn] == report
    with pytest.raises(ValueError, match="kernels="):
        pstrategy.apply_strategy(nodes, st, mesh, kernels="auto")


@pytest.mark.parametrize("budget", [0, 2])
def test_compile_lays_out_one_device_on_a_multi_gpu_host(monkeypatch,
                                                         budget):
    """A host with 8 visible cards: a compile prices and lays out the one
    device the port executes on, unless ``workers_per_node`` asks for
    more (capped at the visible cards), with and without a search."""
    from flexflow_tpu_torch.model import devices_to_run

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cuda = torch.device("cuda", 0)
    assert devices_to_run(P.FFConfig(), cuda) == 1
    assert devices_to_run(P.FFConfig(workers_per_node=4), cuda) == 4
    assert devices_to_run(P.FFConfig(workers_per_node=16), cuda) == 8
    assert devices_to_run(P.FFConfig(workers_per_node=4),
                          torch.device("cpu")) == 1
    _, pff = _pair(search_budget=budget)
    pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert pff.mesh.size == 1
    assert (pff.search_info is not None) == (budget > 0)


@pytest.mark.parametrize("model", ["transformer", "mlp"])
def test_repeated_blocks_match_jax(model):
    if model == "transformer":
        jff, pff = _pair()
    else:
        from flexflow_tpu.models.mlp import create_mlp as j_create_mlp
        from flexflow_tpu_torch.models import create_mlp
        kw = dict(batch_size=8, in_dim=64, hidden_dims=(128, 128, 128),
                  out_dim=10)
        jff, pff = j_create_mlp(**kw), create_mlp(**kw, device="cpu")
    (jn, _), (pn, _) = _graph(jff), _graph(pff)
    want, got = jpipe.detect_repeated_blocks(jn), ppipe.detect_repeated_blocks(pn)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ppipe.pipeline_meta_json(pn, got) \
        == jpipe.pipeline_meta_json(jn, want)


# ---- flags ---------------------------------------------------------------------

SEARCH_ARGV = [
    "--budget", "7", "--alpha", "0.2", "--only-data-parallel",
    "--enable-attribute-parallel", "--enable-sample-parallel",
    "--disable-pipeline-parallel", "--pipeline-microbatches", "auto",
    "--pipeline-schedule", "gpipe", "--pipeline-replicated-queue",
    "--substitution-json", "r.json", "--disable-substitution",
    "--search-trace", "--memory-search", "--memory-threshold", "900",
    "-ll:fsize", "8000", "--export-strategy", "e.json",
    "--import-strategy", "i.json", "--machine-model-version", "1",
    "--machine-model-file", "m.cfg", "--overlap", "--disable-fusion",
    "--overlap-bucket-mb", "16", "--remat-search", "off",
    "--weight-update-sharding", "on", "--kernel-search", "off", "app"]


def test_search_flags_parse_like_the_reference():
    p, j = pconfig.FFConfig(), jconfig.FFConfig()
    assert p.parse_args(SEARCH_ARGV) == ["app"]
    j.parse_args(SEARCH_ARGV)
    for f in dataclasses.fields(jconfig.FFConfig):
        jv, pv = getattr(j, f.name), getattr(p, f.name)
        if f.name == "computation_mode":
            jv, pv = jv.name, pv.name
        assert pv == jv, f.name
    assert p.pipeline_microbatches == 0 and p.search_budget == 7


@pytest.mark.parametrize("flag", ["--search-measure-ops", "--profiling"])
def test_measurement_flags_name_their_item(flag):
    """The measurement flags (ROADMAP.md Queue 1 item 11's, ported) parse
    as the reference parses them."""
    p, j = pconfig.FFConfig(), jconfig.FFConfig()
    assert p.parse_args([flag, "--measured-cache", "m.json"]) == []
    j.parse_args([flag, "--measured-cache", "m.json"])
    for field in ("search_measure_ops", "profiling", "measured_cache_file"):
        assert getattr(p, field) == getattr(j, field), field
    assert (p.search_measure_ops or p.profiling) is True


@pytest.mark.parametrize("flag,value", [
    ("--pipeline-schedule", "1f1b"), ("--weight-update-sharding", "yes"),
    ("--remat-search", "on"), ("--overlap-bucket-mb", "big")])
def test_bad_flag_values_raise_like_the_reference(flag, value):
    with pytest.raises(ValueError):
        jconfig.FFConfig().parse_args([flag, value])
    with pytest.raises(ValueError, match=flag):
        pconfig.FFConfig().parse_args([flag, value])


# ---- strategy files across the packages -------------------------------------------

CROSS_CASES = [(1, "cpu-sim", True), (4, "cpu-sim", True),
               (8, "cpu-sim", False), (4, "v5e-like", True),
               (8, "v5e-like", True)]


def _spec_pair(tmp_path, n, machine):
    if machine == "cpu-sim":
        return (jmachine.MachineSpec(chip="cpu-sim", chips_per_slice=n),
                pmachine.MachineSpec(chip="cpu-sim", chips_per_slice=n))
    path = _machine_file(tmp_path, n, **V5E_LIKE)
    return (jmachine.MachineSpec.from_file(path),
            pmachine.MachineSpec.from_file(path))


@pytest.mark.parametrize("n,machine,training", CROSS_CASES)
def test_strategy_files_cross_both_ways(tmp_path, n, machine, training):
    """Each package searches, exports, and the other imports: the same
    mesh, choices and specs (the imported strategy written out again is
    the file). The 'pipe' meshes keep their pipeline block in ``info``."""
    jff, pff = _pair()
    jspec, pspec = _spec_pair(tmp_path, n, machine)
    jn, jmesh, jst, jinfo = _search(jff, junity, jspec, n, training)
    pn, pmesh, pst, pinfo = _search(pff, unity, pspec, n, training)
    assert pmesh == jmesh
    if machine == "v5e-like":
        assert pmesh.get("pipe", 1) == 2
        assert {k: v for k, v in pinfo["pipeline"].items() if k != "blocks"} \
            == {k: v for k, v in jinfo["pipeline"].items() if k != "blocks"}
        assert dataclasses.asdict(pinfo["pipeline"]["blocks"]) \
            == dataclasses.asdict(jinfo["pipeline"]["blocks"])
    jfile, pfile = tmp_path / "jax.json", tmp_path / "port.json"
    junity.export_strategy_file(str(jfile), jmesh, jst, jn,
                                objective=jinfo["objective"])
    unity.export_strategy_file(str(pfile), pmesh, pst, pn,
                               objective=pinfo["objective"])
    want = json.loads(jfile.read_text())
    assert json.loads(pfile.read_text()) == want
    # JAX file -> port, port file -> JAX
    mesh, st = unity.import_strategy_file(str(jfile), pn)
    assert unity.strategy_json(mesh, st, pn, want["objective"]) == want
    mesh, st = junity.import_strategy_file(str(pfile), jn)
    assert json.loads(json.dumps(junity.strategy_json(
        mesh, st, jn, want["objective"]))) == want


def test_multi_device_import_raises_at_execution(tmp_path):
    """A 4-device file imports; compiling it without a process group of
    4 ranks raises, naming the multi-GPU item; on one device a remat
    choice compiles into a remat op."""
    jff, pff = _pair()
    jn, jmesh, jst, jinfo = _search(
        jff, junity, jmachine.MachineSpec(chip="cpu-sim", chips_per_slice=4),
        4)
    path = tmp_path / "s.json"
    junity.export_strategy_file(str(path), jmesh, jst, jn)
    mesh, st = unity.import_strategy_file(str(path), _graph(pff)[0])
    assert mesh == {"data": 4} and len(st) == len(jst)
    pff.config.import_strategy_file = str(path)
    # no process group of 4 ranks to run it over
    with pytest.raises(NotImplementedError,
                       match="process group of 4 ranks.*Queue 1 item 3"):
        pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    data = json.loads(path.read_text())
    data["mesh"] = {"data": 1}
    data["ops"]["ffn1_0"]["choice"] = "dp_r"
    path.write_text(json.dumps(data))
    pff = _pair(import_strategy_file=str(path))[1]
    pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert pff.remat_ops == pff.executor.remat_ops == {"ffn1_0"}


def test_compile_takes_the_machine_model(tmp_path, monkeypatch):
    """``compile(machine_spec=...)`` and ``--machine-model-file`` give the
    search its machine: an H100 spec prices with the bf16 comm factor, a
    file's figures reach the request."""
    import flexflow_tpu_torch.search.native as native
    seen = []
    real = native.native_optimize
    monkeypatch.setattr(native, "native_optimize",
                        lambda req: seen.append(req) or real(req))
    pff = _pair(search_budget=2)[1]
    pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                machine_spec=pmachine.MachineSpec(chip="h100-sxm"))
    assert seen[-1]["machine"]["comm_bytes_factor"] == 0.5
    assert seen[-1]["machine"]["flops"] == 989e12
    assert pff.machine_spec.chip == "h100-sxm"
    assert pff.mesh.shape == {"data": 1} and pff.search_objective == "step_time"
    path = _machine_file(tmp_path, 1, **V5E_LIKE)
    pff = _pair(search_budget=2, machine_model_file=path,
                machine_model_version=1)[1]
    pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
    assert seen[-1]["machine"]["hbm_bw"] == 0.82e12
    pff = _pair(machine_model_version=1)[1]
    with pytest.raises(ValueError, match="--machine-model-file"):
        pff.compile(AdamOptimizer(), P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE)
