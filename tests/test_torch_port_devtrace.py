"""PyTorch port, device-trace attribution (``flexflow_tpu_torch/obs/devtrace``).

Mirrors ``tests/test_devtrace.py`` where the port has a counterpart:
- the profile-window parser and the interval maths, held against the JAX
  package's functions on the same specs and intervals (exact: the same
  float operations);
- the classifier of CUDA device events and the per-kernel labels, on
  the names the port's kernels, cuBLAS, cuDNN and NCCL carry on sm_90;
- ``attribute_steps`` over a synthetic torch.profiler Chrome trace
  written here (Kineto's categories: ``kernel``, ``gpu_memcpy``,
  ``gpu_memset``, ``user_annotation``), with kernel, memcpy and NCCL
  events and a known clock shift, against hand-computed buckets
  (pytest.approx's default 1e-6 relative);
- a profiled ``fit`` of the 2-layer BERT-proxy on the CPU (hidden 32,
  2 heads, S 8, batch 4, numpy seeds): the artifact, its zero device
  events and its note, the lanes, the step metrics and the registry;
  and a window step that captures a CUDA graph refused by name.
"""

import glob
import json
import os

import numpy as np
import pytest

from flexflow_tpu.obs import devtrace as jdev
import flexflow_tpu_torch as P
from flexflow_tpu_torch.models import TransformerConfig, create_transformer
from flexflow_tpu_torch.obs import devtrace as pdev
from flexflow_tpu_torch.obs.tracer import StepTracer
from flexflow_tpu_torch.optimizers import AdamOptimizer

SMALL = dict(num_layers=2, hidden_size=32, num_heads=2, seq_length=8,
             batch_size=4)

K1 = ("void (anonymous namespace)::flash_fwd_bf16<64, 128, 2, 3, "
      "__nv_bfloat16>(FwdParams)")
K2_DQ = ("void (anonymous namespace)::flash_bwd_dq_bf16<64, 64, 2, false>"
         "(BwdParams)")
K2_DKDV = ("void (anonymous namespace)::flash_bwd_dkdv_bf16<64, 64, 2>"
           "(BwdParams)")
K4 = ("void (anonymous namespace)::fused_adam<__nv_bfloat16, "
      "__nv_bfloat16>(AdamArgs)")
GEMM = "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT"
XMMA = ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
        "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas")
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
CUTLASS = "cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16>"
NCCL_AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"
COPY = ("void at::native::elementwise_kernel<128, 2, "
        "direct_copy_kernel_cuda>(int, Func)")
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>"
OTHER = ("void at::native::vectorized_elementwise_kernel<4, "
         "AddFunctor<float>>(int, AddFunctor<float>, Array<char*, 3>)")


def _blobs(n=16, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, SMALL["seq_length"], SMALL["hidden_size"])
    y = rs.randn(n, SMALL["seq_length"], 1)
    return x.astype(np.float32), y.astype(np.float32)


def _model(**cfg):
    ff = create_transformer(TransformerConfig(**SMALL),
                            P.FFConfig(batch_size=4, **cfg), device="cpu")
    ff.compile(AdamOptimizer(alpha=1e-3),
               P.LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [P.MetricsType.MEAN_SQUARED_ERROR])
    return ff


# ---- the window parser ----------------------------------------------------

@pytest.mark.parametrize("spec", ["2:4", "0:1", "3", None, "", " 5:9 "])
def test_parse_profile_steps_matches_the_reference(spec):
    assert pdev.parse_profile_steps(spec) == jdev.parse_profile_steps(spec)


@pytest.mark.parametrize("bad", ["4:2", "-1:2", "a:b", "2:2"])
def test_parse_profile_steps_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        jdev.parse_profile_steps(bad)
    with pytest.raises(ValueError, match="profile-steps"):
        pdev.parse_profile_steps(bad)


def test_config_checks_the_window_when_parsed():
    cfg = P.FFConfig()
    rest = cfg.parse_args(["--profile-steps", "2:4", "--trace-dir", "/t",
                           "--profiling", "--search-measure-ops",
                           "--measured-cache", "/c.json", "--other"])
    assert rest == ["--other"]
    assert (cfg.profile_steps, cfg.trace_dir, cfg.profiling,
            cfg.search_measure_ops, cfg.measured_cache_file) == (
        "2:4", "/t", True, True, "/c.json")
    with pytest.raises(ValueError, match="profile-steps"):
        P.FFConfig().parse_args(["--profile-steps", "4:2"])


# ---- interval maths against the reference ---------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_interval_maths_match_the_reference(seed):
    rs = np.random.RandomState(seed)

    def intervals(n):
        s = rs.uniform(0, 100, n)
        return [(float(a), float(a + d))
                for a, d in zip(s, rs.uniform(-5, 20, n))]

    a, b = intervals(12), intervals(9)
    ma, mb = pdev.merge_intervals(a), pdev.merge_intervals(b)
    assert ma == jdev.merge_intervals(a)
    assert mb == jdev.merge_intervals(b)
    assert pdev.interval_total(ma) == jdev.interval_total(ma)
    assert pdev.intersect_total(ma, mb) == jdev.intersect_total(ma, mb)
    assert pdev.intersect_total(mb, ma) == jdev.intersect_total(mb, ma)


def test_interval_maths_cases():
    assert pdev.merge_intervals([(3, 5), (1, 2), (4, 7)]) == [(1, 2), (3, 7)]
    assert pdev.merge_intervals([(1, 1), (2, 1)]) == []
    a = pdev.merge_intervals([(0, 10)])
    b = pdev.merge_intervals([(2, 4), (8, 12)])
    assert pdev.intersect_total(a, b) == 4


# ---- the classifier -------------------------------------------------------

@pytest.mark.parametrize("name,kind", [
    (NCCL_AR, "all-reduce"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)",
     "all-gather"),
    ("ncclKernel_ReduceScatter_RING_SIMPLE_Sum_bf16(ncclWorkElem)",
     "reduce-scatter"),
    ("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)",
     "collective-permute"),
    ("ncclDevKernel_AllToAll(ncclDevKernelArgsStorage)", "all-to-all"),
])
def test_nccl_kernels_are_collectives(name, kind):
    assert pdev.classify_kernel(dict(name=name, cat="kernel")) == (
        "collective", kind)


@pytest.mark.parametrize("name,cat", [
    ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
    ("Memset (Device)", "gpu_memset"),
])
def test_copies_and_sets_are_host_transfers(name, cat):
    assert pdev.classify_kernel(dict(name=name, cat=cat)) == ("host", None)
    assert pdev.kernel_kind(name) == "memcpy"


@pytest.mark.parametrize("name,label", [
    (K1, "flash_attn_fwd"), (K2_DQ, "flash_attn_bwd"),
    (K2_DKDV, "flash_attn_bwd"), (K4, "fused_adam"), (GEMM, "gemm"),
    (XMMA, "gemm"), (CUTLASS, "gemm"), (CONV, "conv"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "conv"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>",
     "conv"),
    (COPY, "concat/copies"), (CAT, "concat/copies"), (OTHER, "other"),
    (NCCL_AR, "other"),
])
def test_kernel_labels(name, label):
    assert pdev.kernel_kind(name) == label
    if "nccl" not in name:
        assert pdev.classify_kernel(dict(name=name, cat="kernel")) == (
            "compute", None)


def test_labels_are_the_kinds_list():
    assert pdev.KERNEL_KINDS == (
        "flash_attn_fwd", "flash_attn_bwd", "fused_adam", "conv", "gemm",
        "memcpy", "concat/copies", "other")


# ---- a synthetic torch.profiler trace --------------------------------------

# Kineto's clock for the trace; the host tracer's origin sits SHIFT µs
# later on its own timeline
SHIFT = 12345.0


def _x(name, cat, ts, dur, **kw):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=7,
                **kw)


def synthetic_trace():
    """Two steps, each 1000 µs. Step 2 [1000, 2000): K1 [1100, 1300),
    GEMM [1300, 1600), an all-reduce [1500, 1800) (100 µs of it under
    the GEMM), a memcpy [1850, 1900), a memset [1900, 1950), K4
    [1950, 2050) clipped at the boundary. Step 3 [2000, 3000): K2's two
    kernels [2100, 2400) and [2400, 2500), a copy kernel [2600, 2650).
    Host ops, runtime calls and the device-side annotation copy are
    noise the parser drops."""
    ev = [
        dict(ph="M", name="process_name", pid=1, args=dict(name="python")),
        _x("ff_step#2", "user_annotation", 1000.0, 1000.0),
        _x("ff_step#3", "user_annotation", 2000.0, 1000.0),
        _x("ff_step#2", "gpu_user_annotation", 1100.0, 950.0),
        _x("aten::mm", "cpu_op", 1010.0, 30.0),
        _x("cudaGraphLaunch", "cuda_runtime", 1020.0, 10.0),
        _x(K1, "kernel", 1100.0, 200.0),
        _x(GEMM, "kernel", 1300.0, 300.0),
        _x(NCCL_AR, "kernel", 1500.0, 300.0),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1850.0, 50.0),
        _x("Memset (Device)", "gpu_memset", 1900.0, 50.0),
        _x(K4, "kernel", 1950.0, 100.0),
        _x(K2_DQ, "kernel", 2100.0, 300.0),
        _x(K2_DKDV, "kernel", 2400.0, 100.0),
        _x(COPY, "kernel", 2600.0, 50.0),
    ]
    return dict(traceEvents=ev)


def test_device_events_and_windows():
    trace = synthetic_trace()
    events = pdev.extract_device_events(trace)
    assert len(events) == 9
    assert pdev.extract_step_windows(trace) == {2: (1000.0, 2000.0),
                                                3: (2000.0, 3000.0)}


def test_step_buckets_by_hand():
    trace = synthetic_trace()
    rows = pdev.attribute_steps(pdev.extract_device_events(trace),
                                pdev.extract_step_windows(trace))
    s2, s3 = rows
    # compute: K1 + GEMM [1100, 1600) u K4 [1950, 2000) = 550 µs
    assert s2["compute_s"] == pytest.approx(550e-6)
    assert s2["comms_s"] == pytest.approx(300e-6)
    assert s2["overlapped_comms_s"] == pytest.approx(100e-6)
    assert s2["exposed_comms_s"] == pytest.approx(200e-6)
    assert s2["host_s"] == pytest.approx(100e-6)
    # busy: [1100, 1800) u [1850, 2000) = 850 µs of 1000
    assert s2["busy_s"] == pytest.approx(850e-6)
    assert s2["idle_s"] == pytest.approx(150e-6)
    assert s2["per_kind"]["all-reduce"] == pytest.approx(dict(
        time_s=300e-6, count=1, overlapped_s=100e-6, exposed_s=200e-6))
    assert s2["per_label"]["flash_attn_fwd"] == pytest.approx(
        dict(time_s=200e-6, count=1))
    assert s2["per_label"]["fused_adam"] == pytest.approx(
        dict(time_s=50e-6, count=1))
    assert s2["per_label"]["memcpy"] == pytest.approx(
        dict(time_s=100e-6, count=2))
    assert s2["launches"]["flash_fwd.launches"] == 1
    assert s2["launches"]["fused_adam_multi.launches"] == 1
    assert s2["launches"]["flash_bwd.launches"] == 0
    # step 3: K2's two kernels are one launch; the copy is compute; K4's
    # last 50 µs spill into it (counted where it started, in step 2)
    assert s3["compute_s"] == pytest.approx(500e-6)
    assert s3["comms_s"] == 0.0 and s3["host_s"] == 0.0
    assert s3["idle_s"] == pytest.approx(500e-6)
    assert s3["per_label"]["flash_attn_bwd"] == pytest.approx(
        dict(time_s=400e-6, count=2))
    assert s3["per_label"]["fused_adam"] == pytest.approx(
        dict(time_s=50e-6, count=0))
    assert s3["launches"]["flash_bwd.launches"] == 1
    assert s3["launches"]["fused_adam_multi.launches"] == 0
    for row in rows:  # on one stream the buckets tile the window
        assert row["compute_s"] + row["comms_s"] - row[
            "overlapped_comms_s"] + row["host_s"] + row["idle_s"] \
            == pytest.approx(row["wall_s"])


def test_a_kernel_counts_in_the_step_that_launched_it():
    """A kernel linked (``args.correlation``) to a launch inside step 2's
    host window counts there, in its launches and its label's events,
    even where its device start lies before that window or after it
    closed; its time stays clipped to the windows it overlaps. A kernel
    the trace links to no launch counts where it starts."""
    corr = lambda n: dict(correlation=n)
    trace = dict(traceEvents=[
        _x("ff_step#2", "user_annotation", 1000.0, 1000.0),
        _x("ff_step#3", "user_annotation", 2000.0, 1000.0),
        _x("cudaGraphLaunch", "cuda_runtime", 1020.0, 10.0, args=corr(7)),
        _x("cudaLaunchKernel", "cuda_runtime", 1900.0, 5.0, args=corr(8)),
        _x("cudaLaunchKernel", "cuda_runtime", 2100.0, 5.0, args=corr(9)),
        # launched in step 2, started before its window (the device
        # clock's conversion), 60 of its 100 µs inside it
        _x(K1, "kernel", 960.0, 100.0, args=corr(7)),
        # launched in step 2, started after its window closed
        _x(K1, "kernel", 2050.0, 100.0, args=corr(8)),
        # launched in step 3, inside it
        _x(K1, "kernel", 2200.0, 100.0, args=corr(9)),
        # no launch in the trace: where it starts, step 3
        _x(K4, "kernel", 2400.0, 100.0),
    ])
    events = pdev.extract_device_events(trace)
    assert [e["launch_ts"] for e in events] == [1020.0, 1900.0, 2100.0,
                                                None]
    s2, s3 = pdev.attribute_steps(events, pdev.extract_step_windows(trace))
    assert s2["launches"]["flash_fwd.launches"] == 2
    assert s3["launches"]["flash_fwd.launches"] == 1
    assert s3["launches"]["fused_adam_multi.launches"] == 1
    assert s2["per_label"]["flash_attn_fwd"] == pytest.approx(
        dict(time_s=60e-6, count=2))
    assert s3["per_label"]["flash_attn_fwd"] == pytest.approx(
        dict(time_s=200e-6, count=1))
    assert s2["compute_s"] == pytest.approx(60e-6)
    assert s3["compute_s"] == pytest.approx(300e-6)


def test_launch_calls_by_step_count_calls_beside_their_device_events():
    """Each step's kernel-launching runtime calls (a memcpy call is not
    one), the device events linked to them, and the calls the trace
    links no device event to (a dropped device record)."""
    corr = lambda n: dict(correlation=n)
    trace = dict(traceEvents=[
        _x("ff_step#2", "user_annotation", 1000.0, 1000.0),
        _x("ff_step#3", "user_annotation", 2000.0, 1000.0),
        _x("cudaGraphLaunch", "cuda_runtime", 1020.0, 10.0, args=corr(7)),
        _x("cudaMemcpyAsync", "cuda_runtime", 1500.0, 5.0, args=corr(6)),
        _x("cudaLaunchKernel", "cuda_runtime", 1900.0, 5.0, args=corr(8)),
        _x("cuLaunchKernel", "cuda_driver", 2100.0, 5.0, args=corr(9)),
        _x("cudaLaunchKernel", "cuda_runtime", 2300.0, 5.0, args=corr(10)),
        # the graph's two kernels, one after step 2's window closed
        _x(K1, "kernel", 1100.0, 100.0, args=corr(7)),
        _x(K1, "kernel", 2050.0, 100.0, args=corr(7)),
        _x("Memcpy DtoH", "gpu_memcpy", 1510.0, 5.0, args=corr(6)),
        _x(K1, "kernel", 1950.0, 10.0, args=corr(8)),
        _x(K4, "kernel", 2200.0, 100.0, args=corr(9)),
        # correlation 10's kernel is missing from the trace
    ])
    calls = pdev.extract_launch_calls(trace)
    assert [c["name"] for c in calls] == [
        "cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel",
        "cudaLaunchKernel"]
    got = pdev.launch_calls_by_step(calls, pdev.extract_device_events(trace),
                                    pdev.extract_step_windows(trace))
    assert got == {
        2: dict(calls=2, device_events=3, calls_without_device_event=0),
        3: dict(calls=2, device_events=1, calls_without_device_event=1)}


def test_aggregate_and_report(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(synthetic_trace()))
    rep = pdev.attribution_report([str(path)])
    assert rep["steps"] == 2 and rep["device_events"] == 9
    assert rep["totals"]["compute_s"] == pytest.approx(1050e-6)
    assert rep["collectives"]["all-reduce"]["per_step_s"] == pytest.approx(
        150e-6)
    assert rep["labels"]["flash_attn_bwd"]["time_s"] == pytest.approx(
        400e-6)
    assert rep["launches"] == {"flash_fwd.launches": 1,
                               "flash_fwd.lse_launches": 0,
                               "flash_bwd.launches": 1,
                               "flash_bwd.lse_launches": 0,
                               "fused_adam_multi.launches": 1}


def test_reference_annotation_form_is_read():
    """The JAX package's ``ff_step`` + ``args.step_num`` form windows a
    trace too."""
    trace = dict(traceEvents=[_x("ff_step", "user_annotation", 5.0, 10.0,
                                 args=dict(step_num=4))])
    assert pdev.extract_step_windows(trace) == {4: (5.0, 15.0)}


def test_clock_shift_and_lanes(tmp_path):
    """The capture's lanes land on the tracer's timeline: the shift is
    the host bracket of each annotated step less its profiler start."""
    tracer = StepTracer(str(tmp_path), host_id=0, run_name="fit")
    cap = pdev.DeviceTraceCapture(tracer, (2, 4))
    origin = tracer._origin
    for step, ts in ((2, 1000.0), (3, 2000.0)):
        t0 = origin + (ts + SHIFT) / 1e6
        cap.host_steps[step] = (t0, t0 + 1e-3)
    windows = pdev.extract_step_windows(synthetic_trace())
    assert cap._clock_shift_us(windows) == pytest.approx(SHIFT)
    # finalize over the synthetic file: the K1 lane event moves by SHIFT
    os.makedirs(cap.profile_dir)
    with open(os.path.join(cap.profile_dir, "trace.json"), "w") as f:
        json.dump(synthetic_trace(), f)
    cap.trace_paths = pdev.locate_profile_traces(cap.profile_dir)
    cap.state = "done"
    rep = cap.finalize(None, tracer)
    assert rep["clock_shift_us"] == pytest.approx(SHIFT)
    k1 = [e for e in tracer._extra_events if e["name"] == K1]
    assert k1[0]["ts"] == pytest.approx(1100.0 + SHIFT)
    assert k1[0]["tid"] == pdev.TID_COMPUTE
    assert k1[0]["args"]["label"] == "flash_attn_fwd"
    ar = [e for e in tracer._extra_events if e["name"] == NCCL_AR]
    assert ar[0]["tid"] == pdev.TID_COMMS
    assert ar[0]["args"]["kind"] == "all-reduce"
    counters = [e for e in tracer._extra_events
                if e["name"] == "step_attribution"]
    assert [c["ts"] for c in counters] == pytest.approx(
        [1000.0 + SHIFT, 2000.0 + SHIFT])
    dv = json.load(open(glob.glob(str(tmp_path / "*.devtrace.json"))[0]))
    assert dv["steps"] == 2 and dv["device_events"] == 9


def test_a_capturing_step_is_refused_by_name(tmp_path):
    """A window step during which the train step's graph was captured is
    named and left out of the attribution."""
    tracer = StepTracer(str(tmp_path), host_id=0, run_name="fit")
    n = {"captures": 0}
    cap = pdev.DeviceTraceCapture(tracer, (0, 2),
                                  capture_count=lambda: n["captures"])
    for i in range(2):
        with cap.step(i):
            if i == 0:
                n["captures"] += 1
    assert cap.state == "done"
    assert list(cap.refused_steps) == [0]
    assert "captured the CUDA graph" in cap.refused_steps[0]
    rep = cap.finalize(None, tracer)
    assert rep["refused_steps"] == {"0": cap.refused_steps[0]}
    assert [r["step"] for r in rep["per_step"]] == [1]


def test_the_session_starts_one_step_before_the_window(tmp_path):
    """The session is recording when the window's first step begins; the
    step before it is neither annotated nor attributed. A window that
    opens on the first step run starts with it."""
    tracer = StepTracer(str(tmp_path), host_id=0, run_name="fit")
    cap = pdev.DeviceTraceCapture(tracer, (2, 4))
    states = []
    for i in range(5):
        with cap.step(i):
            states.append(cap.state)
    assert states == ["idle", "capturing", "capturing", "capturing", "done"]
    assert sorted(cap.host_steps) == [2, 3]
    rep = cap.finalize(None, tracer)
    assert [r["step"] for r in rep["per_step"]] == [2, 3]
    first = pdev.DeviceTraceCapture(
        StepTracer(str(tmp_path / "b"), host_id=0, run_name="fit"), (0, 1))
    with first.step(0):
        assert first.state == "capturing"
    assert sorted(first.host_steps) == [0] and first.state == "done"


# ---- a profiled fit on the CPU ---------------------------------------------

@pytest.fixture(scope="module")
def profiled_run(tmp_path_factory):
    td = str(tmp_path_factory.mktemp("devtrace"))
    x, y = _blobs()
    ff = _model()
    ff.fit(x, y, epochs=2, verbose=False, trace_dir=td, profile_steps="2:4")
    return td, ff


def _one(td, pattern):
    paths = glob.glob(os.path.join(td, pattern))
    assert len(paths) == 1, f"{pattern}: {paths}"
    return paths[0]


def test_devtrace_artifact_on_the_cpu(profiled_run):
    td, _ = profiled_run
    dv = json.load(open(_one(td, "fit_*.devtrace.json")))
    assert dv["window"] == [2, 4] and dv["steps"] == 2
    assert dv["header"]["platform"] == "cpu"
    assert dv["device_events"] == 0
    assert "CPU" in dv["note"]
    for row in dv["per_step"]:
        assert row["compute_s"] == 0.0 and row["wall_s"] > 0
        assert row["idle_s"] == pytest.approx(row["wall_s"])
    assert os.path.isdir(dv["profile_dir"])
    assert dv["trace_files"]


def test_lanes_and_counters_in_trace(profiled_run):
    td, _ = profiled_run
    trace = json.load(open(_one(td, "fit_*.trace.json")))
    events = trace["traceEvents"]
    lanes = {e["args"]["name"] for e in events
             if e.get("name") == "thread_name"}
    assert {"train_loop", "device:compute", "device:comms",
            "device:host"} <= lanes
    counters = [e for e in events if e.get("name") == "step_attribution"]
    assert len(counters) == 2
    assert "exposed_comms_ms" in counters[0]["args"]


def test_step_metrics_in_drift(profiled_run):
    td, ff = profiled_run
    sm = json.load(open(_one(td, "fit_*.drift.json")))["step_metrics"]
    assert sm["steps"] == 8
    assert 0 < sm["goodput"] <= 1.0
    assert sm["mfu"] > 0 and sm["mfu_chip"] == "cpu-sim"
    assert sm["model_flops_per_step"] == pytest.approx(
        3.0 * sum(n.op.flops() for n in ff.executor.nodes))
    assert sm["step_time_p50"] <= sm["step_time_p99"]


def test_registry_histograms(profiled_run):
    td, _ = profiled_run
    counters = json.load(open(_one(td, "fit_*.counters.json")))
    st = counters["observations"]["fit/step_time_s"]
    assert st["count"] >= 7
    assert "fit/devtrace_exposed_comms_s" in counters["observations"]
    assert counters["gauges"]["fit/goodput"] > 0
    assert counters["header"]["kind"] == "counters"


def test_profile_without_trace_dir_degrades(capsys):
    x, y = _blobs(8)
    ff = _model()
    ff.fit(x, y, epochs=1, verbose=False, profile_steps="0:1")
    assert "profiling skipped" in capsys.readouterr().err


def test_capture_reads_the_models_train_step_captures(tmp_path):
    """On the CPU the fit passes no capture counter: nothing is refused."""
    ff = _model()
    tracer = StepTracer(str(tmp_path), host_id=0, run_name="fit",
                        device=ff.device)
    cap = ff._make_capture(tracer, "0:1")
    assert isinstance(cap, pdev.DeviceTraceCapture)
    assert cap.capture_count is None and cap.window == (0, 1)
