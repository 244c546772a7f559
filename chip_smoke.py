#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flexflow_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Imports nothing of JAX or of the JAX
package. Phases:

1. card    — prints ``nvidia-smi``'s name and power limit; needs CUDA.
2. build   — builds every kernel of the port from ``flexflow_tpu_torch/csrc``.
3. kernels — holds each kernel against its plain PyTorch version on the card,
             at the serving shape and at a ragged length, causal and not,
             head dims 64 and 128, bf16 and f32; times the kernel, the plain
             version and the library call that computes the same function.
4. serve   — builds the BERT-proxy transformer at full width
             (``TransformerConfig()``: 12 layers, hidden 1024, 16 heads, seq
             512, batch 8) with random weights from a seed, compiles it for
             inference and answers requests through the continuous-batching
             ``ServingEngine``: every bucket warmed (set-up), then 32
             requests closed-loop at concurrency 4, the main path, over
             which the kernel launches are counted. Checks the results, that
             the kernel ran 12 times per batch of the closed loop, that a
             full batch through the engine equals ``predict``, and that
             ``predict`` agrees with the same model run with the einsum
             attention core; breaks one batch-8 forward's device time down
             by kernel kind (torch.profiler). Then the same model in f32
             compute (``allow_mixed_precision=False``, the f32 kernel)
             against the einsum core.
5. report  — one JSON line ``{"kernels": [...]}``, then the final line
             ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero without printing the final line.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

# Published dense peaks of the H100 SXM (NVIDIA data sheet), at its full
# 700 W power limit: device-memory bytes/s, bf16 tensor-core FLOP/s and
# f32 (non-tensor) FLOP/s.
H100_SXM_PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}

# (bh, s, d, dtype name, causal); the first is the serving shape: batch 8
# x 16 heads, seq 512, head dim 64
KERNEL_CASES = [
    (128, 512, 64, "bfloat16", False),
    (128, 512, 64, "bfloat16", True),
    (128, 200, 64, "bfloat16", False),
    (128, 200, 64, "bfloat16", True),
    (64, 512, 128, "bfloat16", False),
    (64, 300, 128, "bfloat16", True),
    (16, 256, 64, "float32", False),
    (16, 200, 128, "float32", True),
]
# o: the kernel stores o in bf16, so it differs from the f32 plain version
# by bf16 output rounding (half an ulp is <= 7.8e-3 for |o| < 4) plus the
# bf16 rounding of P before P @ V; lse is f32 on both sides from the same
# inputs and differs only by summation order.
TOL = {"bfloat16": {"o": 2e-2, "lse": 1e-3},
       "float32": {"o": 1e-4, "lse": 1e-4}}
# full model, flash core vs einsum core: both keep activations in bf16
# between ops and round P to bf16; they differ in where P is normalized and
# in summation order, a few bf16 ulps per layer over 12 layers.
MODEL_RTOL = 2e-2
# the same in f32 compute: only the order of the sums differs
MODEL_F32_RTOL = 1e-4
SERVE_REQUESTS, SERVE_CONCURRENCY = 32, 4


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps=30, warmup=5):
    """Median over ``reps`` runs of one call, in ms, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def flash_bound(bh, s, d, itemsize, causal, peaks):
    """Least time (s) the card could take for one call, and what bounds
    it: q, k, v read once and o, lse written once; 4*D FLOPs per visible
    (query, key) pair, on the tensor cores for bf16."""
    nbytes = 4 * bh * s * d * itemsize + bh * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * pairs * d
    rate = peaks["bf16"] if itemsize == 2 else peaks["f32"]
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        print(f"[card] note: bounds use the H100 SXM peaks; this card is "
              f"{name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    from flexflow_tpu_torch import cuda_build

    t0 = time.perf_counter()
    cuda_build.build("flash_attn_fwd")
    secs = time.perf_counter() - t0
    print(f"[build] flash_attn_fwd built in {secs:.2f} s")
    for line in cuda_build.build_log("flash_attn_fwd").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def phase_kernels():
    """Kernel vs plain version on the card; returns the serving-shape
    entry of the kernels line (launches filled in later)."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_fwd,
                                                        flash_fwd_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entry = None
    for bh, s, d, dname, causal in KERNEL_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_fwd_reference(q.float(), k.float(), v.float(),
                                             causal)
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
              f"non-finite kernel output at {(bh, s, d, dname, causal)}")
        err_o = (o.float() - ref_o).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = TOL[dname]
        print(f"[kernels] flash_attn_fwd BH={bh} S={s} D={d} {dname} "
              f"causal={causal}: o max_abs_err {err_o:.3e} (tol {tol['o']}), "
              f"lse max_abs_err {err_lse:.3e} (tol {tol['lse']})")
        check(err_o <= tol["o"] and err_lse <= tol["lse"],
              f"kernel disagrees with its plain version at "
              f"{(bh, s, d, dname, causal)}")
        if entry is None:  # the serving shape
            b, h = 8, bh // 8
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                q.view(b, h, s, d), k.view(b, h, s, d), v.view(b, h, s, d),
                is_causal=causal)
            ms = time_ms(lambda: flash_fwd(q, k, v, causal))
            plain_ms = time_ms(lambda: flash_fwd_reference(q, k, v, causal))
            library_ms = time_ms(lib)
            bound_s, bound_by = flash_bound(bh, s, d, q.element_size(),
                                            causal, H100_SXM_PEAKS)
            entry = dict(
                name="flash_attn_fwd", route="cuda",
                source="flexflow_tpu_torch/csrc/flash_attn_fwd.cu",
                replaces="flexflow_tpu/ops/pallas_kernels.py:70 (_flash_fwd)",
                shape=f"BH={bh} S={s} D={d} {dname} causal={causal}",
                launches=None, max_abs_err=err_o, lse_max_abs_err=err_lse,
                ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3, bound_us=bound_s * 1e6,
                bound_by=bound_by)
            print(f"[kernels] serving shape: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, "
                  f"bound {bound_s * 1e6:.2f} us ({bound_by})")
    return entry


def phase_serve():
    """Drive the serving path at full width; returns the kernel launches
    counted during it."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.obs.registry import get_registry
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.ops.flash_attention import flash_fwd
    from flexflow_tpu_torch.serve.loadgen import (build_serve_model,
                                                  run_closed_loop,
                                                  warm_buckets)

    t0 = time.perf_counter()
    ff, make_request, cfg = build_serve_model("transformer", on_cpu=False,
                                              device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] model {cfg} built and compiled in "
          f"{time.perf_counter() - t0:.2f} s; compute dtype "
          f"{ff.executor.compute_dtype}")
    attn = [n.op for n in ff.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    check(len(attn) == cfg["num_layers"], "expected one attention op per layer")
    engine = ff.serve()
    buckets = tuple(engine.scheduler.buckets)
    check(buckets == (1, 2, 4, 8), f"unexpected buckets {buckets}")
    for b, rep in engine.bucket_report().items():
        check(set(rep["kernel_choices"].values()) == {"flash"},
              f"bucket {b} does not run the flash kernel: {rep}")

    served = []
    submit = engine.submit

    def tracked_submit(inputs):
        req = submit(inputs)
        served.append(req)
        return req

    engine.submit = tracked_submit
    reg = get_registry()
    try:
        # warming every bucket is set-up; the counts start after it
        warmed = warm_buckets(engine, make_request)
        torch.cuda.synchronize()
        reg.reset()
        flash_fwd.launches = 0
        engine.start()
        stats = run_closed_loop(engine, make_request, SERVE_REQUESTS,
                                concurrency=SERVE_CONCURRENCY)
    finally:
        engine.stop()
    torch.cuda.synchronize()
    launches = flash_fwd.launches
    counters = reg.to_dict()["counters"]
    batches = int(counters.get("serve/batches", 0))
    engine.submit = submit

    check(not stats["errors"], f"closed loop errors: {stats['errors'][:3]}")
    check(counters.get("serve/batch_errors", 0) == 0,
          f"serve/batch_errors = {counters.get('serve/batch_errors')}")
    check(counters.get("serve/request_errors", 0) == 0,
          f"serve/request_errors = {counters.get('serve/request_errors')}")
    check(stats["num_measured"] == SERVE_REQUESTS,
          f"served {stats['num_measured']} of {SERVE_REQUESTS} requests")
    check(len(served) == warmed + SERVE_REQUESTS,
          f"tracked {len(served)} requests, expected "
          f"{warmed + SERVE_REQUESTS}")
    for req in served:
        out = req.wait(60)
        check(out.shape == (cfg["seq_length"], 1),
              f"request {req.id}: result shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"request {req.id}: non-finite")
    check(launches == cfg["num_layers"] * batches and batches > 0,
          f"kernel launches {launches} != {cfg['num_layers']} x {batches} "
          f"served batches")
    print(f"[serve] {warmed} warmup requests, then {stats['num_measured']} "
          f"closed-loop requests in {batches} batches; kernel launches "
          f"{launches} = {cfg['num_layers']} x {batches}")
    print(f"[serve] closed loop (concurrency {SERVE_CONCURRENCY}): p50 "
          f"{stats['p50_s'] * 1e3:.3f} ms, p99 {stats['p99_s'] * 1e3:.3f} ms, "
          f"{stats['throughput_rps']:.2f} requests/s over "
          f"{stats['wall_s']:.3f} s")
    obs = reg.to_dict()["observations"]
    for b in buckets:
        o = obs.get(f"serve/bucket{b}/batch_latency_s")
        if o:
            print(f"[serve] closed loop, bucket {b}: {int(o['count'])} "
                  f"batches, batch latency p50 {o['p50'] * 1e3:.3f} ms, p99 "
                  f"{o['p99'] * 1e3:.3f} ms")

    # a full batch through the engine equals predict on the same samples
    batch = [make_request(i)[0] for i in range(cfg["batch_size"])]
    reqs = [engine.submit([x]) for x in batch]
    engine.pump()
    got = np.stack([r.wait(60) for r in reqs])
    want = ff.predict(np.stack(batch))
    check(np.array_equal(got, want),
          f"engine full batch != predict: max diff "
          f"{np.abs(got - want).max()}")
    print("[serve] full batch through the engine equals predict exactly")

    # predict with the flash core vs the einsum core, same weights, same card
    for op in attn:
        op.kernel_impl = "einsum"
    try:
        plain = ff.predict(np.stack(batch))
    finally:
        for op in attn:
            op.kernel_impl = None
    err = float(np.abs(want - plain).max())
    scale = float(np.abs(plain).max())
    print(f"[serve] predict flash core vs einsum core: max_abs_err {err:.4e}, "
          f"max |output| {scale:.4e}, ratio {err / scale:.3e} "
          f"(tol {MODEL_RTOL})")
    check(np.isfinite(want).all() and err <= MODEL_RTOL * scale,
          "flash-core predict disagrees with the einsum core")
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_forward(ff, np.stack(batch))
    return launches


def profile_forward(ff, x):
    """Where the time of one full-batch predict goes on the device: kernel
    time by kind from torch.profiler's kernel events, against the wall
    time of the same (profiled) forward."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ff.predict(x)  # ends in a device-to-host copy: synchronous
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ff.predict(x)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_kind = {"flash_attn_fwd": 0.0, "gemm": 0.0, "memcpy": 0.0,
               "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        kind = ("flash_attn_fwd" if "flash_fwd" in name else
                "gemm" if any(t in name for t in ("gemm", "nvjet", "xmma",
                                                  "cutlass", "sm90")) else
                "memcpy" if "memcpy" in name or "memset" in name else
                "other")
        by_kind[kind] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_kind.values())
    print(f"[profile] batch-8 predict: wall {statistics.median(walls) * 1e3:.3f}"
          f" ms (median of 5, unprofiled); profiled forward {prof_wall_ms:.3f}"
          f" ms with device busy {busy:.3f} ms "
          f"({100 * busy / prof_wall_ms:.1f}%); "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
                      for k, v in by_kind.items()))
    if busy <= 0:
        print("[profile] torch.profiler recorded no kernel: the breakdown is "
              "not measured")


def check_f32_model():
    """The f32 route on the card (allow_mixed_precision=False): the full
    model with the f32 kernel against the einsum core."""
    import numpy as np
    from flexflow_tpu_torch import CompMode, FFConfig, LossType
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    cfg = TransformerConfig()
    ff = create_transformer(cfg, FFConfig(batch_size=cfg.batch_size,
                                          allow_mixed_precision=False),
                            device="cuda")
    ff.compile(None, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=CompMode.INFERENCE)
    x = np.random.RandomState(1).randn(cfg.batch_size, cfg.seq_length,
                                       cfg.hidden_size).astype(np.float32)
    flash = ff.predict(x)
    attn = [n.op for n in ff.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    for op in attn:
        op.kernel_impl = "einsum"
    plain = ff.predict(x)
    err = float(np.abs(flash - plain).max())
    scale = float(np.abs(plain).max())
    print(f"[f32] predict (compute dtype {ff.executor.compute_dtype}) flash "
          f"core vs einsum core: max_abs_err {err:.4e}, max |output| "
          f"{scale:.4e}, ratio {err / scale:.3e} (tol {MODEL_F32_RTOL})")
    check(np.isfinite(flash).all() and err <= MODEL_F32_RTOL * scale,
          "f32 flash-core predict disagrees with the einsum core")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import flexflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the port package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 1
    try:
        name = phase_card()
        phase_build()
        entry = phase_kernels()
        entry["launches"] = phase_serve()
        check_f32_model()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
