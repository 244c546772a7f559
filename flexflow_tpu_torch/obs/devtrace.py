"""Device-trace attribution: where a step's time goes on the device.

The port's counterpart of ``flexflow_tpu/obs/devtrace.py``, with the
same artifact (``.devtrace.json``), fields and Perfetto lanes. A
windowed ``torch.profiler`` session (CPU and CUDA activities) runs over
a range of training steps (``fit(profile_steps="A:B")`` /
``--profile-steps``); each step inside it is a
``torch.profiler.record_function`` annotation named
``ff_step#<step>``, and the session's Chrome trace
(``export_chrome_trace``) lands in ``<stem>.torchprof/``. A stdlib-only
parser then classifies the trace's device events and runs interval
arithmetic per step:

- ``compute_s``          union of kernel time inside the step
- ``comms_s``            union of NCCL collective kernels
- ``overlapped_comms_s`` comms time hidden under compute
- ``exposed_comms_s``    comms the step waits on
- ``host_s``             memcpy and memset time (the reference's infeed
                         and outfeed: transfers, not compute)
- ``idle_s``             the step's window less the union of the above

Beside the reference's buckets each step row carries ``per_label``
(device seconds and events by kernel label: the port's kernels, convs,
GEMMs, copies, other; ``kernel_kind``) and ``launches`` (kernel events
of each registered launch counter, ``step_graph.launch_counters``: one
event a launch, so these equal the wrappers' counters over the same
steps). Times are clipped to the step's window; an event is counted in
the step whose host window holds the runtime call that launched it (the
``cuda_runtime`` event of its ``args.correlation``: ``cudaLaunchKernel``,
or the ``cudaGraphLaunch`` of a replayed step), and in the step it
starts in where the trace links no launch. The device timestamps are
converted to the host's timebase by the profiler and can land a
kernel's start outside the window of the step that launched it; the
launch's host time cannot. The step window is the annotation's host
span; a traced step fences on its loss (``device_wait``), so the
step's kernels end inside it. A step inside the window that captured a CUDA graph ran the eager
warm-up and the capture, not the replay the other steps run: it is
left out of the attribution and named in ``refused_steps``. The session
starts one step before the window where there is one: a session
can record no device event for its first milliseconds (4-6 ms on an
H100, late in a process that had run many sessions), which would drop
the window's first kernels; that step is neither annotated nor
attributed.

On a model the caller put on the CPU the session records CPU activity
only: ``device_events`` is 0 and the report says so in ``note``.

``record_step_metrics`` adds the step-time histogram, goodput and MFU:
model FLOPs a step over the step's p50 over ``machine_spec.flops`` (on
``"h100-sxm"`` the bf16 dense Tensor Core peak, 989e12).
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

# the step marker the capture wraps around each training step:
# ``ff_step#<step>`` (or the reference's ``ff_step`` with args.step_num)
STEP_ANNOTATION = "ff_step"

# Kineto's categories of device events: kernels, and the copies and sets
# that are transfers rather than compute
KERNEL_CATEGORY = "kernel"
HOST_CATEGORIES = ("gpu_memcpy", "gpu_memset")
# the host-side runtime calls a device event's ``args.correlation`` links
# it to (the launch that enqueued it)
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# of those, the calls that launch kernels (a replayed step's graph, an
# eager kernel, a Triton kernel through the driver)
_LAUNCH_CALL_RE = re.compile(
    r"^(cudaGraphLaunch|cudaLaunchKernel|cuLaunchKernel)")

# NCCL kernel names -> the census vocabulary of obs/inspect.py
_NCCL_RE = re.compile(
    r"nccl(?:Dev)?Kernel_(AllReduce|AllGather|ReduceScatter|AllToAll|"
    r"SendRecv|Send|Recv|Broadcast|Reduce)")
_NCCL_KINDS = {"AllReduce": "all-reduce", "AllGather": "all-gather",
               "ReduceScatter": "reduce-scatter", "AllToAll": "all-to-all",
               "SendRecv": "collective-permute",
               "Send": "collective-permute", "Recv": "collective-permute",
               "Broadcast": "collective-broadcast", "Reduce": "all-reduce"}

# the per-kernel labels of a device event (kernel_kind)
KERNEL_KINDS = ("flash_attn_fwd", "flash_attn_bwd", "fused_adam", "conv",
                "gemm", "memcpy", "concat/copies", "other")

# Perfetto lane tids for device events injected into the StepTracer
# trace (tid 0 is the host train_loop): one lane per bucket
TID_COMPUTE, TID_COMMS, TID_HOST = 64, 65, 66
LANE_THREADS = {TID_COMPUTE: "device:compute", TID_COMMS: "device:comms",
                TID_HOST: "device:host"}


def parse_profile_steps(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """``"A:B"`` -> capture steps A..B-1 (half-open, python-slice
    convention); bare ``"N"`` -> just step N. None/"" -> no capture."""
    if not spec:
        return None
    s = str(spec).strip()
    try:
        if ":" in s:
            a, b = s.split(":", 1)
            start, stop = int(a), int(b)
        else:
            start, stop = int(s), int(s) + 1
    except ValueError:
        raise ValueError(
            f"--profile-steps expects 'A:B' or 'N', got {spec!r}")
    if start < 0 or stop <= start:
        raise ValueError(
            f"--profile-steps window must satisfy 0 <= A < B, got {spec!r}")
    return start, stop


# ---------------------------------------------------------------------------
# classification + interval arithmetic (stdlib only)


def kernel_kind(name: str) -> str:
    """A device event's label: the port's kernels; cuDNN's convolutions
    and their NCHW<->NHWC layout transforms (before the GEMMs: cuDNN's
    implicit-GEMM kernels carry GEMM names); GEMMs (cuBLAS's ``nvjet``
    and ``sm90_xmma`` kernels, CUTLASS's); memcpy and memset; concat's
    batched copy and the copy kernels (casts, contiguous copies);
    other."""
    name = name.lower()
    return ("flash_attn_fwd" if "flash_fwd" in name else
            "flash_attn_bwd" if "flash_bwd" in name else
            "fused_adam" if "fused_adam" in name else
            "conv" if any(t in name for t in ("conv", "fprop", "dgrad",
                                              "wgrad", "cudnn", "nchwtonhwc",
                                              "nhwctonchw")) else
            "gemm" if any(t in name for t in ("gemm", "nvjet", "xmma",
                                              "cutlass", "sm90")) else
            "memcpy" if "memcpy" in name or "memset" in name else
            "concat/copies" if "catarray" in name or "copy" in name else
            "other")


def classify_kernel(event: Dict[str, Any]) -> Tuple[str, Optional[str]]:
    """Bucket one CUDA device event (a Chrome-trace dict with ``name``
    and ``cat``): ``("collective", kind)`` for NCCL kernels,
    ``("host", None)`` for memcpy and memset, ``("compute", None)`` for
    every other kernel."""
    m = _NCCL_RE.search(event.get("name") or "")
    if m:
        return "collective", _NCCL_KINDS[m.group(1)]
    if event.get("cat") in HOST_CATEGORIES:
        return "host", None
    return "compute", None


def device_events(prof) -> list:
    """A ``torch.profiler.profile``'s device events (kernels, copies,
    sets), as ``FunctionEvent``s."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def merge_intervals(iv: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of half-open intervals, sorted and coalesced."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def interval_total(merged: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in merged)


def intersect_total(a: List[Tuple[float, float]],
                    b: List[Tuple[float, float]]) -> float:
    """Total overlap between two MERGED interval lists (two-pointer)."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s = max(a[i][0], b[j][0])
        e = min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---------------------------------------------------------------------------
# Chrome-trace parsing


def load_chrome_trace(path: str) -> Dict[str, Any]:
    """Load a Chrome-trace JSON, gzipped or plain."""
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return json.load(f)
    with open(path) as f:
        return json.load(f)


def locate_profile_traces(profile_dir: str) -> List[str]:
    """The Chrome-trace files a capture exported into its directory."""
    return sorted(glob.glob(os.path.join(profile_dir, "*.json"))
                  + glob.glob(os.path.join(profile_dir, "*.json.gz")))


def _correlation(e: Dict[str, Any]) -> Optional[int]:
    try:
        return int((e.get("args") or {})["correlation"])
    except (KeyError, TypeError, ValueError):
        return None


def extract_device_events(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Device events of a torch.profiler Chrome trace: Kineto's
    ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` complete events. Host
    ops, runtime calls and annotations are dropped. Returns rows
    ``{name, ts, dur, bucket, kind, label, launch_ts}`` (µs):
    ``launch_ts`` is the host start of the runtime call that enqueued
    the event (``cudaLaunchKernel``, ``cudaGraphLaunch``,
    ``cudaMemcpyAsync``, ...: the ``cuda_runtime`` or ``cuda_driver``
    event of the same ``args.correlation``), None where the trace links
    none."""
    launch_at: Dict[int, float] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
            corr = _correlation(e)
            if corr is not None:
                launch_at[corr] = float(e.get("ts", 0.0))
    out: List[Dict[str, Any]] = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat != KERNEL_CATEGORY and cat not in HOST_CATEGORIES:
            continue
        name = e.get("name") or ""
        bucket, kind = classify_kernel(e)
        corr = _correlation(e)
        out.append(dict(name=name, ts=float(e.get("ts", 0.0)),
                        dur=float(e.get("dur", 0.0)), bucket=bucket,
                        kind=kind, label=kernel_kind(name),
                        launch_ts=launch_at.get(corr), correlation=corr))
    return out


def extract_launch_calls(trace: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The kernel-launching runtime calls of a trace (``cudaGraphLaunch``,
    ``cudaLaunchKernel``, ``cuLaunchKernel`` and their variants): rows
    ``{name, ts, correlation}`` (µs, host start)."""
    return [dict(name=e["name"], ts=float(e.get("ts", 0.0)),
                 correlation=_correlation(e))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES
            and _LAUNCH_CALL_RE.match(e.get("name") or "")]


def launch_calls_by_step(calls: List[Dict[str, Any]],
                         device_events: List[Dict[str, Any]],
                         step_windows: Dict[int, Tuple[float, float]]
                         ) -> Dict[int, Dict[str, int]]:
    """Per step: the launch calls its host window holds (``calls``), the
    device events linked to them (``device_events``), and the calls the
    trace links no device event to (``calls_without_device_event``):
    beside the step's kernel counts by name, a device event the
    profiler dropped shows as fewer device events than the calls made,
    where one counted in another step shows as a call outside it."""
    linked: Dict[int, int] = {}
    for ev in device_events:
        if ev.get("correlation") is not None:
            linked[ev["correlation"]] = linked.get(ev["correlation"], 0) + 1
    out = {}
    for step, (t0, t1) in sorted(step_windows.items()):
        mine = [c for c in calls if t0 <= c["ts"] < t1]
        out[step] = dict(
            calls=len(mine),
            device_events=sum(linked.get(c["correlation"], 0)
                              for c in mine),
            calls_without_device_event=sum(
                not linked.get(c["correlation"]) for c in mine))
    return out


def _annotation_step(e: Dict[str, Any], annotation: str) -> Optional[int]:
    name = e.get("name") or ""
    try:
        if name == annotation:
            return int((e.get("args") or {}).get("step_num"))
        if name.startswith(annotation + "#"):
            return int(name[len(annotation) + 1:])
    except (TypeError, ValueError):
        return None
    return None


def extract_step_windows(trace: Dict[str, Any],
                         annotation: str = STEP_ANNOTATION
                         ) -> Dict[int, Tuple[float, float]]:
    """``{step_index: (ts, end)}`` (µs, profiler timebase) from the host
    annotations the capture wrapped around each step (the device-side
    copies Kineto adds, ``gpu_user_annotation``, are not windows)."""
    out: Dict[int, Tuple[float, float]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or e.get("cat") == "gpu_user_annotation":
            continue
        step = _annotation_step(e, annotation)
        if step is None:
            continue
        t0 = float(e.get("ts", 0.0))
        t1 = t0 + float(e.get("dur", 0.0))
        if step in out:  # same step re-entered: span the union
            t0 = min(t0, out[step][0])
            t1 = max(t1, out[step][1])
        out[step] = (t0, t1)
    return out


def _launch_tests():
    """(counter key, test of a kernel name) of every registered launch
    counter."""
    import flexflow_tpu_torch.ops.flash_attention  # noqa: F401
    import flexflow_tpu_torch.ops.fused_update  # noqa: F401
    from flexflow_tpu_torch.step_graph import launch_counters

    return [(f"{fn.__name__}.{attr}", test)
            for fn, attr, test in launch_counters()]


def _owning_step(ev: Dict[str, Any],
                 step_windows: Dict[int, Tuple[float, float]]
                 ) -> Optional[int]:
    """The step whose host window holds the event's launch (its
    ``launch_ts``), or, where the trace links no launch, its start."""
    at = ev.get("launch_ts")
    at = ev["ts"] if at is None else at
    for step, (t0, t1) in step_windows.items():
        if t0 <= at < t1:
            return step
    return None


def attribute_steps(device_events: List[Dict[str, Any]],
                    step_windows: Dict[int, Tuple[float, float]]
                    ) -> List[Dict[str, Any]]:
    """Per-step interval accounting over the device events (see the
    module docstring). Times in seconds."""
    tests = _launch_tests()
    rows: List[Dict[str, Any]] = []
    owner = [_owning_step(ev, step_windows) for ev in device_events]
    for step in sorted(step_windows):
        t0, t1 = step_windows[step]
        compute_iv: List[Tuple[float, float]] = []
        comms_iv: List[Tuple[float, float]] = []
        host_iv: List[Tuple[float, float]] = []
        kind_iv: Dict[str, List[Tuple[float, float]]] = {}
        kind_count: Dict[str, int] = {}
        per_label: Dict[str, Dict[str, float]] = {}
        launches = {key: 0 for key, _ in tests}
        for ev, own in zip(device_events, owner):
            # time clipped to the window; events and launches counted in
            # the step that launched them
            owned = own == step
            if owned:
                lab = per_label.setdefault(ev.get("label") or "other",
                                           dict(time_s=0.0, count=0))
                lab["count"] += 1
                for key, test in tests:
                    if test(ev["name"]):
                        launches[key] += 1
            s = max(ev["ts"], t0)
            e = min(ev["ts"] + ev["dur"], t1)
            if e <= s:
                continue
            if ev["bucket"] == "collective":
                comms_iv.append((s, e))
                kind_iv.setdefault(ev["kind"], []).append((s, e))
                kind_count[ev["kind"]] = kind_count.get(ev["kind"], 0) + 1
            elif ev["bucket"] == "host":
                host_iv.append((s, e))
            else:
                compute_iv.append((s, e))
            lab = per_label.setdefault(ev.get("label") or "other",
                                       dict(time_s=0.0, count=0))
            lab["time_s"] += (e - s) / 1e6
        compute_u = merge_intervals(compute_iv)
        comms_u = merge_intervals(comms_iv)
        compute_s = interval_total(compute_u) / 1e6
        comms_s = interval_total(comms_u) / 1e6
        overlapped_s = intersect_total(comms_u, compute_u) / 1e6
        host_s = interval_total(merge_intervals(host_iv)) / 1e6
        busy_s = interval_total(
            merge_intervals(compute_iv + comms_iv + host_iv)) / 1e6
        wall_s = (t1 - t0) / 1e6
        rows.append(dict(
            step=step,
            wall_s=wall_s,
            compute_s=compute_s,
            comms_s=comms_s,
            overlapped_comms_s=overlapped_s,
            exposed_comms_s=comms_s - overlapped_s,
            host_s=host_s,
            idle_s=max(wall_s - busy_s, 0.0),
            busy_s=busy_s,
            per_kind={k: _kind_entry(v, kind_count[k], compute_u)
                      for k, v in kind_iv.items()},
            per_label=per_label,
            launches=launches,
        ))
    return rows


def _kind_entry(iv, count, compute_u):
    u = merge_intervals(iv)
    t = interval_total(u) / 1e6
    hidden = intersect_total(u, compute_u) / 1e6
    return dict(time_s=t, count=count, overlapped_s=hidden,
                exposed_s=t - hidden)


def aggregate_attribution(per_step: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Roll per-step rows up into run totals, a per-collective-kind
    summary (``{kind: {time_s, count, per_step_s, ...}}``), and the
    per-label and launch totals."""
    n = len(per_step)
    totals = dict(compute_s=0.0, comms_s=0.0, overlapped_comms_s=0.0,
                  exposed_comms_s=0.0, host_s=0.0, idle_s=0.0, wall_s=0.0,
                  busy_s=0.0)
    coll: Dict[str, Dict[str, float]] = {}
    labels: Dict[str, Dict[str, float]] = {}
    launches: Dict[str, int] = {}
    for row in per_step:
        for k in totals:
            totals[k] += row.get(k, 0.0)
        for kind, e in row["per_kind"].items():
            c = coll.setdefault(kind, dict(time_s=0.0, count=0,
                                           overlapped_s=0.0, exposed_s=0.0))
            c["time_s"] += e["time_s"]
            c["count"] += e["count"]
            c["overlapped_s"] += e.get("overlapped_s", 0.0)
            c["exposed_s"] += e.get("exposed_s", e["time_s"])
        for lab, e in (row.get("per_label") or {}).items():
            t = labels.setdefault(lab, dict(time_s=0.0, count=0))
            t["time_s"] += e["time_s"]
            t["count"] += e["count"]
        for key, v in (row.get("launches") or {}).items():
            launches[key] = launches.get(key, 0) + v
    for c in coll.values():
        c["per_step_s"] = c["time_s"] / n if n else 0.0
        c["exposed_per_step_s"] = c["exposed_s"] / n if n else 0.0
        c["overlapped_per_step_s"] = c["overlapped_s"] / n if n else 0.0
    for t in labels.values():
        t["per_step_s"] = t["time_s"] / n if n else 0.0
    return dict(steps=n, totals=totals, collectives=coll, labels=labels,
                launches=launches)


def _parse_traces(trace_paths: List[str],
                  annotation: str = STEP_ANNOTATION):
    """(device_events, step_windows, launch_calls) pooled over a capture's
    Chrome-trace files (an unreadable file is skipped: a half-written
    profile must not kill the report)."""
    events: List[Dict[str, Any]] = []
    windows: Dict[int, Tuple[float, float]] = {}
    calls: List[Dict[str, Any]] = []
    for p in trace_paths:
        try:
            trace = load_chrome_trace(p)
        except (OSError, ValueError):
            continue
        events += extract_device_events(trace)
        windows.update(extract_step_windows(trace, annotation))
        calls += extract_launch_calls(trace)
    return events, windows, calls


def attribution_report(trace_paths: List[str],
                       annotation: str = STEP_ANNOTATION) -> Dict[str, Any]:
    """Parse + attribute one capture's Chrome-trace files.

    Returns ``{per_step, steps, totals, collectives, labels, launches,
    device_events}``."""
    events, windows, _ = _parse_traces(trace_paths, annotation)
    per_step = attribute_steps(events, windows)
    return dict(per_step=per_step, device_events=len(events),
                **aggregate_attribution(per_step))


# ---------------------------------------------------------------------------
# capture


class NullCapture:
    """Inert capture: the no-profile-window fast path."""

    active = False
    captured = False
    _NULL = contextlib.nullcontext()

    def step(self, step_index: int):
        return self._NULL

    def finalize(self, ff, tracer):
        return None


NULL_CAPTURE = NullCapture()


class _CaptureStep:
    """Per-step context: starts the profiler session one step before the
    window opens, wraps each window step in its ``ff_step#<step>``
    annotation, and stops the session when the window closes, recording
    the host perf_counter bracket of every annotated step for the clock
    correlation of the Perfetto lanes."""

    __slots__ = ("cap", "idx", "_ann", "_t0", "_captures")

    def __init__(self, cap, idx):
        self.cap = cap
        self.idx = idx
        self._ann = None

    def __enter__(self):
        cap = self.cap
        # one step early: the window's first step begins with the
        # session already recording
        if cap.state == "idle" and self.idx >= cap.window[0] - 1:
            cap._start()
        if cap.state == "capturing" and self.idx >= cap.window[0]:
            try:
                import torch
                self._ann = torch.profiler.record_function(
                    f"{STEP_ANNOTATION}#{self.idx}")
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._captures = (cap.capture_count() if cap.capture_count
                          else None)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        cap = self.cap
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
            cap.host_steps[self.idx] = (self._t0, t1)
            if (self._captures is not None
                    and cap.capture_count() != self._captures):
                cap.refused_steps[self.idx] = (
                    "captured the CUDA graph of its step: its device "
                    "events are the eager warm-up and the capture, not a "
                    "replay; open the window after the first step")
        if cap.state == "capturing" and self.idx + 1 >= cap.window[1]:
            cap._stop()
        return False


class DeviceTraceCapture:
    """One windowed ``torch.profiler`` session around a step range.

    Wrap each training step in ``capture.step(i)``; the session starts
    when step ``window[0] - 1`` begins (``window[0]`` when it is the first
    step run) and stops after step ``window[1]-1`` completes; only the
    window's steps are annotated and attributed. ``finalize`` parses the exported trace, writes the
    ``.devtrace.json`` attribution artifact, feeds the counter registry,
    and injects rebased device lanes + per-step attribution counter
    tracks into the StepTracer's Perfetto output. ``capture_count``
    (a callable, the model's train-step captures) names the steps that
    captured a CUDA graph. ``session`` is the stopped
    ``torch.profiler.profile``, for a caller that reads its in-memory
    events (``device_events``); it lives as long as the capture. Every
    profiler interaction degrades to a warning: observability must never
    kill the run it watches."""

    active = True

    def __init__(self, tracer, window: Tuple[int, int], device=None,
                 capture_count=None):
        self.tracer = tracer
        self.window = window
        self.device = device if device is not None else getattr(
            tracer, "device", None)
        self.capture_count = capture_count
        self.profile_dir = os.path.join(tracer.trace_dir,
                                        tracer.file_stem + ".torchprof")
        self.state = "idle"  # -> capturing -> done | failed
        self.host_steps: Dict[int, Tuple[float, float]] = {}
        self.refused_steps: Dict[int, str] = {}
        self.trace_paths: List[str] = []
        self.session = None

    @property
    def on_card(self) -> bool:
        return self.device is not None and str(self.device).startswith(
            "cuda")

    @property
    def captured(self) -> bool:
        return self.state == "done" and bool(self.trace_paths)

    def step(self, step_index: int):
        if self.state in ("done", "failed"):
            return NullCapture._NULL
        return _CaptureStep(self, step_index)

    def _start(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.on_card:
                torch.cuda.synchronize(self.device)
                acts.append(ProfilerActivity.CUDA)
            self.session = profile(activities=acts)
            self.session.start()
            self.state = "capturing"
        except Exception as e:
            import sys
            print(f"[obs] device-trace capture failed to start ({e!r}); "
                  "profiling disabled for this run", file=sys.stderr)
            self.state = "failed"

    def _stop(self) -> None:
        try:
            if self.on_card:
                import torch
                torch.cuda.synchronize(self.device)
            self.session.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, "trace.json")
            self.session.export_chrome_trace(path)
            self.state = "done"
            self.trace_paths = locate_profile_traces(self.profile_dir)
            if not self.trace_paths:
                import sys
                print(f"[obs] profiler session left no Chrome trace under "
                      f"{self.profile_dir}", file=sys.stderr)
        except Exception as e:
            import sys
            print(f"[obs] device-trace capture failed to stop ({e!r})",
                  file=sys.stderr)
            self.state = "failed"

    # ---- post-run ----------------------------------------------------------
    def _clock_shift_us(self, step_windows) -> float:
        """Profiler-timebase -> tracer-timeline shift, averaged over
        every step seen by both clocks (the host perf_counter bracket
        recorded around each annotation vs the annotation's own span in
        the profile)."""
        origin = getattr(self.tracer, "_origin", None)
        if origin is None:
            return 0.0
        shifts = [
            (t0 - origin) * 1e6 - step_windows[idx][0]
            for idx, (t0, _) in self.host_steps.items()
            if idx in step_windows]
        return sum(shifts) / len(shifts) if shifts else 0.0

    def finalize(self, ff, tracer) -> Optional[Dict[str, Any]]:
        """Parse + attribute, emit the artifact, merge Perfetto lanes.
        Returns the attribution report (None when nothing was captured).
        Must run BEFORE ``tracer.export()`` so the device lanes land in
        the exported trace."""
        if self.state == "capturing":  # run ended inside the window
            self._stop()
        if not self.captured:
            return None
        events, all_windows, calls = _parse_traces(self.trace_paths)
        windows = {s: w for s, w in all_windows.items()
                   if s not in self.refused_steps}
        per_step = attribute_steps(events, windows)
        report = dict(
            window=list(self.window),
            profile_dir=self.profile_dir,
            trace_files=[os.path.relpath(p, tracer.trace_dir)
                         for p in self.trace_paths],
            per_step=per_step,
            device_events=len(events),
            # events linked to their launch, and those of them whose
            # device start lies in another step's window (or none)
            launch_linked=sum(ev["launch_ts"] is not None for ev in events),
            moved_by_launch=sum(
                _owning_step(ev, windows)
                != _owning_step(dict(ev, launch_ts=None), windows)
                for ev in events),
            # the least device start after its launch's host start (µs):
            # below 0, the profiler's clocks place a kernel before the
            # call that launched it
            launch_to_start_min_us=min(
                (ev["ts"] - ev["launch_ts"] for ev in events
                 if ev["launch_ts"] is not None), default=None),
            launch_calls={str(k): v for k, v in launch_calls_by_step(
                calls, events, windows).items()},
            refused_steps={str(k): v for k, v in
                           sorted(self.refused_steps.items())},
            **aggregate_attribution(per_step),
        )
        if not events:
            report["note"] = (
                "no device events: the model runs on the CPU, where the "
                "session records CPU activity only" if not self.on_card
                else "the profiler recorded no device event on the card")
        from flexflow_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        run = tracer.run_name
        for row in per_step:
            reg.observe(f"{run}/devtrace_compute_s", row["compute_s"])
            reg.observe(f"{run}/devtrace_exposed_comms_s",
                        row["exposed_comms_s"])
        tot = report["totals"]
        if tot["wall_s"] > 0:
            reg.gauge(f"{run}/devtrace_exposed_comms_frac",
                      tot["exposed_comms_s"] / tot["wall_s"])
            reg.gauge(f"{run}/devtrace_compute_frac",
                      tot["compute_s"] / tot["wall_s"])
            reg.gauge(f"{run}/devtrace_busy_frac",
                      tot["busy_s"] / tot["wall_s"])
        # Perfetto lanes: device spans + per-step attribution counters,
        # rebased from the profiler timebase onto the tracer timeline
        shift = self._clock_shift_us(all_windows)
        report["clock_shift_us"] = shift
        lane_events: List[Dict[str, Any]] = []
        tid_of = {"compute": TID_COMPUTE, "collective": TID_COMMS,
                  "host": TID_HOST}
        for ev in events:
            ce = dict(name=ev["name"], ph="X", tid=tid_of[ev["bucket"]],
                      ts=round(ev["ts"] + shift, 3),
                      dur=round(ev["dur"], 3), cat="devtrace")
            args = dict(label=ev["label"])
            if ev["kind"]:
                args["kind"] = ev["kind"]
            ce["args"] = args
            lane_events.append(ce)
        for row in per_step:
            t0 = windows[row["step"]][0] + shift
            lane_events.append(dict(
                name="step_attribution", ph="C", tid=0,
                ts=round(t0, 3), cat="devtrace",
                args=dict(compute_ms=round(row["compute_s"] * 1e3, 4),
                          overlapped_comms_ms=round(
                              row["overlapped_comms_s"] * 1e3, 4),
                          exposed_comms_ms=round(
                              row["exposed_comms_s"] * 1e3, 4))))
        tracer.add_trace_events(lane_events, dict(LANE_THREADS))
        from flexflow_tpu_torch.obs.artifacts import write_artifact
        stem = os.path.join(tracer.trace_dir, tracer.file_stem)
        write_artifact(stem + ".devtrace.json", report,
                       host_id=tracer.host_id, kind="devtrace",
                       device=self.device,
                       header_extra=dict(run_name=tracer.run_name,
                                         run_seq=tracer.run_seq))
        return report


def make_capture(tracer, profile_steps: Optional[str],
                 capture_count=None):
    """A DeviceTraceCapture over the parsed window, or the shared no-op.

    Needs an ACTIVE tracer (the artifacts land in its trace dir and the
    lanes merge into its Perfetto output): a profile window without a
    trace dir warns and degrades rather than raising mid-fit."""
    window = parse_profile_steps(profile_steps)
    if window is None:
        return NULL_CAPTURE
    if not getattr(tracer, "active", False):
        import sys
        print("[obs] --profile-steps needs --trace-dir (device-trace "
              "artifacts land in the trace dir); profiling skipped",
              file=sys.stderr)
        return NULL_CAPTURE
    return DeviceTraceCapture(tracer, window, capture_count=capture_count)


# ---------------------------------------------------------------------------
# goodput / MFU step metrics (registry + drift report surface)


def train_step_flops(ff) -> float:
    """Model FLOPs of one training step: the ops' analytic forward FLOPs
    x3 for forward and backward, the drift predictor's convention."""
    return 3.0 * sum(float(n.op.flops()) for n in ff.executor.nodes)


def record_step_metrics(ff, tracer, registry=None) -> Dict[str, Any]:
    """Step-time histogram + goodput + MFU into the counter registry.

    - ``<run>/step_time_s`` observations of the steps after the first
      (which carries the step's capture; it goes to
      ``<run>/compile_time_s``)
    - ``<run>/goodput`` gauge: time inside steps / the traced run's wall
      time
    - ``<run>/mfu`` gauge: model FLOPs a step / the step's p50 /
      ``machine_spec.flops`` of the one device the port runs on (every
      ring position of a sequence mesh runs on it)
    Returns the same numbers as a dict for the drift report."""
    from flexflow_tpu_torch.obs.registry import get_registry, percentile
    if registry is None:
        registry = get_registry()
    run = tracer.run_name
    ds = tracer.step_durations_s()
    steady = ds[1:]
    out: Dict[str, Any] = dict(steps=len(ds))
    if ds:
        out["compile_time_s"] = ds[0]
        registry.gauge(f"{run}/compile_time_s", ds[0])
    for d in steady:
        registry.observe(f"{run}/step_time_s", d)
    if steady:
        s = sorted(steady)
        out["step_time_p50"] = percentile(s, 0.50)
        out["step_time_p99"] = percentile(s, 0.99)
    wall = tracer.run_wall_s()
    if wall and ds:
        out["goodput"] = min(sum(ds) / wall, 1.0)
        registry.gauge(f"{run}/goodput", out["goodput"])
    spec = getattr(ff, "machine_spec", None)
    step_s = out.get("step_time_p50")
    if spec is not None and step_s:
        flops = train_step_flops(ff)
        out["model_flops_per_step"] = flops
        out["mfu"] = flops / step_s / float(spec.flops)
        out["mfu_peak_flops"] = float(spec.flops)
        out["mfu_chip"] = spec.chip
        registry.gauge(f"{run}/mfu", out["mfu"])
    return out
