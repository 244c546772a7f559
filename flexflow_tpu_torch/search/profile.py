"""Per-op timing on the device, feeding the search's measured-cost channel.

The port's counterpart of ``flexflow_tpu/search/profile.py``: the
original FlexFlow's ``measure_operator_cost``. Each materialized op's
forward, and its forward plus backward, are timed standalone on the
model's device, in its compute dtype and execution layout; results are
keyed by ``op_cost_key`` (the op's ``param_key``, layout, dtype, and
the platform and device kind of the device it ran on), so repeated
compiles and runs hit the cache, and a measurement taken on the CPU,
or a cached row of another device, never prices a search on a card.

The search reads the table as ``"<guid>:fwd"`` / ``"<guid>:bwd"``
seconds of the unsharded op (``native/ffs_strategy.hpp`` node_cost
divides by the sharding's work division), plus the runtime constants
``__step_overhead__`` and ``__update_bw__``.

Timing on the card: the port's step is a CUDA-graph replay (no launch
overhead), so an op is timed as ``n`` back-to-back calls captured into
one CUDA graph, at two lengths, each replay between two CUDA events
after a warm-up; the slope of the two cancels the replay's constant
cost. Backward is the slope of forward plus ``torch.autograd.grad``
minus the forward's, never an assumed 2x. A model on the CPU (tests) is
timed on the host clock, as the JAX package times its CPU backend; a
model on the card never is: a failed timing there raises, and so does a
standalone forward that fails with a device error (a kernel that does
not build or launch); only an op that cannot run standalone is skipped.
Every entry point's ``device`` means the card when it is None, and the
CPU only when named; a machine spec and the device it prices must match
(``machine.check_spec_device``), so no host time is read against a
card's peaks.

Iterations share nothing from the cache: every iteration takes the next
of K copies of the parameters and inputs, K sized so the set is at
least twice the device's L2 (the JAX package sizes its parameter
rotation by the TPU's VMEM and keeps inputs fixed; an H100's 50 MB L2
holds a whole BERT-proxy activation, which a bandwidth-bound op would
then read faster than HBM). Within an iteration values move as in the
step. A loop-carried dependence (one element of the previous output
added, times 1e-12, into one element of the first float input) chains
the iterations as the reference's input perturbation does; the
dependence loop alone is timed as well and subtracted, with the bytes
it moves over the machine's HBM rate (``machine_spec.hbm_bw``: no
literal figure here).

Drift corrections (``load_op_corrections``) are the per-op-type
factors of the model's platform bucket in the port's calibration file
(``calibration_path``: ``FFS_CALIBRATION_FILE``, else the repo root's
``CALIBRATION_GPU.json``, which ``python -m
flexflow_tpu_torch.scripts.calibrate --ingest-drift`` writes). The port
never reads the JAX package's ``CALIBRATION.json``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.machine import check_spec_device, resolve_device
from flexflow_tpu_torch.obs.artifacts import atomic_write_text, device_identity
from flexflow_tpu_torch.ops.base import OpContext

# process-wide cache: op_cost_key -> (fwd_s, bwd_s)
_CACHE: Dict[str, Tuple[float, float]] = {}

# host-clock slope timing (a model on the CPU): the long run grows until
# its extra wall time dominates the host's noise
_SHORT_ITERS = 4
_LONG_ITERS = 36
_MAX_ITERS = 1 << 15
_MIN_DELTA_S = 0.15
# device slope timing (CUDA events around graph replays): the events'
# resolution is about a microsecond, so a few milliseconds suffice
_MIN_DELTA_DEVICE_S = 5e-3
_MAX_DEVICE_ITERS = 4096
# the rotation's floor when the device reports no L2 (the CPU)
_HOST_CACHE_BYTES = 32 << 20
# elements of each optimizer-update triad leaf (64 MB in f32)
_TRIAD_ELEMS = 16 << 20
# the dependence's scale: far below every dtype's resolution of O(1)
_DEP_SCALE = 1e-12


class OpNotMeasurable(RuntimeError):
    """The op's forward cannot run standalone (it needs cross-op state)."""


def op_cost_key(op, device=None, layout: Optional[str] = None,
                dtype: Optional[torch.dtype] = None) -> str:
    """Structural identity of an op config on a device: two ops with the
    same type, shapes and properties share one measurement. The
    execution layout and dtype are part of it (an NHWC and an NCHW conv
    are different programs), and so are the platform and device kind of
    ``device`` (the card when None; the CPU only by name), so that a CPU
    measurement or another card's never prices this card's search. A
    kernel the strategy pinned (``kernel_impl``: attention's flash or
    einsum core) is part of it too: one core's time never stands for the
    other's."""
    platform, kind = device_identity(resolve_device(device))
    layout = layout or getattr(op, "exec_layout", "NCHW")
    parts = (op.param_key(), layout, platform, kind,
             str(dtype if dtype is not None else torch.float32))
    pinned = getattr(op, "kernel_impl", None)
    if pinned is not None:
        parts += (pinned,)
    raw = repr(parts)
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def op_io_bytes(op, dtype_size: float = 4.0) -> float:
    """Bytes one forward pass of the op must move: inputs + outputs +
    parameters, at ``dtype_size`` bytes/element (each operand once: a
    lower bound). The denominator of the op's arithmetic intensity in
    the roofline report (``obs/roofline.py``)."""
    elems = sum(float(np.prod(s)) for s in op.input_shapes)
    elems += sum(float(np.prod(s)) for s in op.output_shapes)
    elems += float(op.params_elems())
    return dtype_size * elems


def _example_inputs(op, rs: np.random.RandomState, device, dtype,
                    layout: str) -> List[torch.Tensor]:
    """Random inputs on ``device``: embedding ids in range, every other
    input uniform in [0.05, 1) in ``dtype``, 4-D inputs of an NHWC op in
    channels-last memory (the executor's layout, ``layout.to_layout``)."""
    nhwc = layout == "NHWC"
    out = []
    for shp in op.input_shapes:
        if op.op_type == OperatorType.EMBEDDING:
            vocab = getattr(op, "num_entries", None) or 2
            a = torch.as_tensor(rs.randint(0, max(1, int(vocab)), size=shp),
                                dtype=torch.int64, device=device)
        else:
            a = torch.as_tensor(rs.uniform(0.05, 1.0, size=shp)
                                .astype(np.float32), device=device).to(dtype)
            if nhwc and a.dim() == 4:
                a = a.contiguous(memory_format=torch.channels_last)
        out.append(a)
    return out


def _params_in(params, dtype):
    """The compute copy of the parameters: float leaves in ``dtype``."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in params.items()}


def _cache_bytes(device) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        return int(getattr(props, "L2_cache_size", 0) or (50 << 20))
    return _HOST_CACHE_BYTES


def _tensor_bytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _rotation(params, inputs, device) -> int:
    """K copies of the parameters and inputs, K sized so the set is at
    least twice the device's cache (at most 8, at least 2)."""
    b = _tensor_bytes(list(params.values()) + list(inputs))
    if b <= 0:
        return 1
    return int(min(8, max(2, math.ceil(2.0 * _cache_bytes(device) / b))))


def _first_float(xs) -> Optional[torch.Tensor]:
    return next((x for x in xs if x.is_floating_point()), None)


def _depend(xs, acc) -> None:
    """The loop-carried dependence: one element of the previous output
    into one element of the first float input (a no-op when there is
    none)."""
    x = _first_float(xs)
    if x is None or acc is None:
        return
    with torch.no_grad():
        x[(0,) * x.dim()].add_(acc.to(x.dtype), alpha=_DEP_SCALE)


def _dep_of(outs) -> Optional[torch.Tensor]:
    """One element of the first float output (a view: no kernel)."""
    o = _first_float(outs)
    return None if o is None else o[(0,) * o.dim()]


# ---- timing engines ------------------------------------------------------

def _median(xs: List[float]) -> float:
    return statistics.median(xs)


def _host_loop_time(run: Callable[[int], None], n: int, repeats: int,
                    warmup: int) -> float:
    """Median host wall time of ``run(n)`` (CPU tensors: synchronous)."""
    for _ in range(warmup):
        run(n)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run(n)
        ts.append(time.perf_counter() - t0)
    return _median(ts)


def _host_slope(iteration: Callable[[int], None], repeats: int,
                warmup: int) -> float:
    """Per-iteration host time from two loop lengths (the CPU)."""
    def run(n):
        for i in range(n):
            iteration(i)

    t_short = _host_loop_time(run, _SHORT_ITERS, repeats, warmup)
    n_long = _LONG_ITERS
    while True:
        t_long = _host_loop_time(run, n_long, repeats, 0)
        if t_long - t_short >= _MIN_DELTA_S or n_long >= _MAX_ITERS:
            break
        n_long *= 4
    return max((t_long - t_short) / (n_long - _SHORT_ITERS), 1e-9)


class _GraphLoop:
    """``n`` iterations of a step captured into one CUDA graph, replayed
    between two CUDA events; each replay adds its kernel nodes to the
    launch counters (``step_graph.register_launch_counter``), as the
    compiled steps' replays do."""

    def __init__(self, iteration, n, device, stream, generator):
        from flexflow_tpu_torch.step_graph import (collector_paused,
                                                   kernel_node_names,
                                                   launch_counters)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None and hasattr(self.graph,
                                             "register_generator_state"):
            self.graph.register_generator_state(generator)
        with collector_paused(), torch.cuda.graph(
                self.graph, stream=stream,
                capture_error_mode="thread_local"):
            for i in range(n):
                iteration(i)
        names = kernel_node_names(self.graph)
        self.graph.instantiate()
        self.launches = [(fn, attr, sum(1 for nm in names if test(nm)))
                         for fn, attr, test in launch_counters()]
        self.device = device

    def time_s(self, repeats: int) -> float:
        ts = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.graph.replay()
            end.record()
            end.synchronize()
            for fn, attr, k in self.launches:
                setattr(fn, attr, getattr(fn, attr) + k)
            ts.append(start.elapsed_time(end) / 1e3)
        return _median(ts)


def _device_slope(iteration: Callable[[int], None], device, repeats: int,
                  warmup: int, generator=None) -> float:
    """Per-iteration device time from two CUDA-graph lengths (the card).
    The warm-up runs eagerly on a side stream first, as PyTorch's capture
    recipe asks (cuBLAS workspaces, kernels' first-use attributes)."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for i in range(max(warmup, 1) + 1):
            iteration(i)
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    short = _GraphLoop(iteration, _SHORT_ITERS, device, side, generator)
    for _ in range(max(warmup, 1)):
        short.time_s(1)
    t_short = short.time_s(max(repeats, 3))
    n_long = _LONG_ITERS
    while True:
        loop = _GraphLoop(iteration, n_long, device, side, generator)
        loop.time_s(1)
        t_long = loop.time_s(max(repeats, 3))
        del loop
        if t_long - t_short >= _MIN_DELTA_DEVICE_S \
                or n_long >= _MAX_DEVICE_ITERS:
            break
        n_long *= 4
    return max((t_long - t_short) / (n_long - _SHORT_ITERS), 1e-9)


def _slope(iteration, device, repeats, warmup, generator=None) -> float:
    if torch.device(device).type == "cuda":
        return _device_slope(iteration, device, repeats, warmup, generator)
    return _host_slope(iteration, repeats, warmup)


def _artifact_time(device, dtype, repeats: int, warmup: int) -> float:
    """Per-iteration time of the dependence alone on ``device``: the
    measurement artifact an op's loop pays and the step does not."""
    platform, kind = device_identity(device)
    key = f"__artifact__{platform}:{kind}:{dtype}"
    if key in _CACHE:
        return _CACHE[key][0]
    xs = [torch.ones(8, dtype=dtype, device=device)]
    outs = [torch.ones(8, dtype=dtype, device=device)]
    dep = _dep_of(outs)

    def iteration(i):
        _depend(xs, dep)

    t = _slope(iteration, device, repeats, warmup)
    _CACHE[key] = (t, 0.0)
    return t


def _artifact_bytes(dtype_size: float) -> Tuple[float, float]:
    """Bytes the timing loop moves that the step would not: (forward
    loop, backward-minus-forward loop). The dependence reads one output
    element and rewrites one input element in each loop; the backward
    loop adds nothing of its own."""
    return 2.0 * dtype_size, 0.0


def _run_op(op, params, inputs, ctx, state):
    if getattr(op, "param_sources", None) is not None:
        raise OpNotMeasurable(f"{op.name}: a fused node reads several "
                              f"ops' parameters")
    if state is not None:
        outs, _ = op.forward_with_state(params, inputs, ctx, state)
        return outs
    return op.forward(params, inputs, ctx)


def measure_op(op, hbm_bw: float, device=None,
               dtype: Optional[torch.dtype] = None,
               layout: Optional[str] = None, repeats: int = 3,
               warmup: int = 1,
               include_bwd: bool = True) -> Tuple[float, float]:
    """Time one op's forward and backward on ``device`` (the card when
    None; the CPU only by name) in ``dtype`` (the
    model's compute dtype; f32 by default) and ``layout`` (the node's
    execution layout). Returns (fwd_seconds, bwd_seconds); see the module
    docstring for the method. ``hbm_bw`` is the machine's memory rate
    (``machine_spec.hbm_bw``), for the artifact-bytes correction. Raises
    ``OpNotMeasurable`` when the op's forward cannot run standalone (the
    caller skips it), and any other error of the timing itself.
    ``include_bwd=False`` skips the backward and returns 2x the forward
    for it, cached under a key of its own."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    layout = layout or getattr(op, "exec_layout", "NCHW")
    base = op_cost_key(op, device, layout, dtype)
    key = base + ("" if include_bwd else ":fwdonly")
    if key in _CACHE:
        return _CACHE[key]
    if not include_bwd and base in _CACHE:
        return _CACHE[base]
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    ctx = OpContext(training=True, compute_dtype=dtype, rng=gen, device=dev)
    rs = np.random.RandomState(0)
    init = torch.Generator(device=dev)
    init.manual_seed(0)
    try:
        params = _params_in(op.init_params(init), dtype)
        inputs = _example_inputs(op, rs, dev, dtype, layout)
        state = op.init_state(dev) if hasattr(op, "init_state") else None
        outs = _run_op(op, params, inputs, ctx, state)
    except OpNotMeasurable:
        raise
    except Exception as e:
        # on the card a failed build or launch is the device's fault, not
        # the op's: it raises rather than leave the op to the analytic
        # estimate
        if dev.type == "cuda" and isinstance(e, (RuntimeError, OSError)):
            raise
        raise OpNotMeasurable(f"{op.name}: {type(e).__name__}: {e}") from e
    k = _rotation(params, inputs, dev)
    p_copies = [{n: v.clone() for n, v in params.items()} for _ in range(k)]
    x_copies = [[x.clone() for x in inputs] for _ in range(k)]
    dep = [_dep_of(outs)]
    del outs

    def fwd_iter(i):
        xs = x_copies[i % k]
        _depend(xs, dep[0])
        with torch.no_grad():
            o = _run_op(op, p_copies[i % k], xs, ctx, state)
        dep[0] = _dep_of(o)

    dsize = float(torch.empty((), dtype=dtype).element_size())
    art_fwd_b, art_bwd_b = _artifact_bytes(dsize)
    art_s = _artifact_time(dev, dtype, repeats, warmup)
    raw_fwd = _slope(fwd_iter, dev, repeats, warmup, gen)
    t_fwd = max(raw_fwd - art_s - art_fwd_b / hbm_bw, 0.25 * raw_fwd)
    t_bwd = 2.0 * t_fwd
    diff_p = [{n: v.requires_grad_(True) if v.is_floating_point() else v
               for n, v in ps.items()} for ps in p_copies]
    has_grads = bool(any(v.is_floating_point() for v in params.values())
                     or _first_float(inputs) is not None)
    if include_bwd and has_grads:
        for xs in x_copies:
            for x in xs:
                if x.is_floating_point():
                    x.requires_grad_(True)
        ones: Dict[Tuple, torch.Tensor] = {}

        def both_iter(i):
            xs = x_copies[i % k]
            ps = diff_p[i % k]
            _depend(xs, dep[0])
            o = _run_op(op, ps, xs, ctx, state)
            fo = [t for t in o if t.is_floating_point() and t.requires_grad]
            wrt = ([v for v in ps.values() if v.requires_grad]
                   + [x for x in xs if x.requires_grad])
            if fo and wrt:
                grads = [ones.setdefault((tuple(t.shape), t.dtype),
                                         torch.ones_like(t)) for t in fo]
                torch.autograd.grad(fo, wrt, grad_outputs=grads,
                                    allow_unused=True)
            dep[0] = _dep_of([t.detach() for t in o])

        try:
            raw_both = _slope(both_iter, dev, repeats, warmup, gen)
        except Exception:
            if dev.type == "cuda":
                raise
            raw_both = None  # a non-differentiable op keeps 2x forward
        if raw_both is not None:
            t_bwd = max(raw_both - raw_fwd - art_bwd_b / hbm_bw,
                        0.1 * t_fwd)
    _CACHE[key] = (t_fwd, t_bwd)
    return _CACHE[key]


def measure_runtime_constants(device=None) -> Dict[str, float]:
    """The per-step runtime constants the per-op sum cannot see, on
    ``device`` (the card when None; the CPU only by name):

    - ``__step_overhead__``: the cost of one compiled step's launch. On
      the card, the slope of a chain of replays of a one-kernel CUDA
      graph between two CUDA events (what a replayed step pays); on the
      CPU, the slope of a chain of trivial eager calls on the host clock.
    - ``__update_bw__``: the bytes/s of an optimizer-update triad
      ``p.sub_(g, alpha=lr)`` over 64 MB leaves (read p, read g, write
      p); on the card n triads captured in a graph, timed with events.

    The native simulator reads both keys from the measured table."""
    device = resolve_device(device)
    platform, kind = device_identity(device)
    key = f"__runtime__{platform}:{kind}"
    if key in _CACHE:
        oh, bw = _CACHE[key]
        return {"__step_overhead__": oh, "__update_bw__": bw}
    dev = torch.device(device)
    x = torch.ones((8, 8), device=dev)
    p = torch.zeros((_TRIAD_ELEMS,), device=dev)
    g = torch.ones((_TRIAD_ELEMS,), device=dev)

    def triad(i):
        p.sub_(g, alpha=0.01)

    if dev.type == "cuda":
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            x.add_(1.0)
        torch.cuda.current_stream(dev).wait_stream(side)
        from flexflow_tpu_torch.step_graph import collector_paused
        with collector_paused(), torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            x.add_(1.0)

        def chain_time(n):
            ts = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(n):
                    graph.replay()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            return _median(ts)

        chain_time(4)
        n_small, n_big = 4, 64
        t_small = chain_time(n_small)
        while True:
            t_big = chain_time(n_big)
            if t_big - t_small >= _MIN_DELTA_DEVICE_S \
                    or n_big >= _MAX_DEVICE_ITERS:
                break
            n_big *= 4
        overhead = max((t_big - t_small) / (n_big - n_small), 1e-9)
        per_call = _device_slope(triad, dev, 3, 1)
    else:
        def chain(i):
            x.add_(1.0)

        overhead = max(_host_slope(chain, 3, 1), 1e-7)
        per_call = max(_host_slope(triad, 3, 1) - overhead, 1e-9)
    bw = 3.0 * 4.0 * _TRIAD_ELEMS / per_call
    _CACHE[key] = (overhead, bw)
    return {"__step_overhead__": overhead, "__update_bw__": bw}


# the port's calibration file at the repo root (the JAX package's is
# CALIBRATION.json, which the port never opens)
CALIBRATION_FILE = "CALIBRATION_GPU.json"


def calibration_path(path: Optional[str] = None) -> str:
    """The calibration file every reader and writer of the port uses:
    ``path``, else ``FFS_CALIBRATION_FILE``, else the repo root's
    ``CALIBRATION_GPU.json``. Its format is the JAX package's:
    ``platform``, ``device``, ``results[]``, and ``op_corrections`` and
    ``collective_corrections`` keyed by platform."""
    return path or os.environ.get("FFS_CALIBRATION_FILE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), CALIBRATION_FILE)


def read_calibration(path: Optional[str] = None) -> Dict:
    """The calibration file's contents ({} when absent or unreadable)."""
    try:
        with open(calibration_path(path)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def load_op_corrections(path: Optional[str] = None,
                        platform: Optional[str] = None
                        ) -> Dict[str, Dict[str, float]]:
    """Drift-derived per-op-type correction factors of the calibration
    file (``calibration_path``), keyed platform-first ({platform: {op
    type: {"factor": ..}}}): the bucket of ``platform`` ("gpu", "cpu",
    ...), so a correction derived on one platform never scales another's
    measurements. {} when no file or bucket exists."""
    corr = read_calibration(path).get("op_corrections", {})
    if not isinstance(corr, dict) or platform is None:
        return {}
    bucket = corr.get(platform, {})
    return bucket if isinstance(bucket, dict) else {}


def apply_drift_corrections(measured: Dict[str, float], nodes,
                            corrections: Optional[Dict] = None,
                            platform: Optional[str] = None
                            ) -> Dict[str, float]:
    """Scale each op's measured fwd/bwd seconds by its op type's
    drift-correction factor. ``corrections`` defaults to the bucket of
    ``platform`` in the calibration file."""
    if corrections is None:
        corrections = load_op_corrections(platform=platform)
    if not corrections:
        return measured
    out = dict(measured)
    for node in nodes:
        entry = corrections.get(node.op.op_type.name)
        if not entry:
            continue
        factor = float(entry.get("factor", 1.0))
        if factor <= 0:
            continue
        # the op type's factor scales every core's rows of the op
        for leg in ("fwd", "bwd", "fwd:flash", "bwd:flash"):
            key = f"{node.op.guid}:{leg}"
            if key in out:
                out[key] *= factor
    return out


def node_layout(node) -> str:
    """The execution layout of a node: NHWC when the layout pass gave it
    a channels-last input, else NCHW."""
    return ("NHWC" if "NHWC" in (getattr(node, "input_layouts", None) or ())
            else "NCHW")


def _flash_runs(op, device) -> bool:
    """Whether ``op`` is an attention op whose training forward the flash
    kernel runs on ``device`` once pinned to it: a CUDA device and a
    shape the kernel takes (``MultiHeadAttention.selected_impl``)."""
    if (op.op_type != OperatorType.MULTIHEAD_ATTENTION
            or torch.device(device).type != "cuda"):
        return False
    saved = op.kernel_impl
    op.kernel_impl = "flash"
    try:
        return op.selected_impl(device, None, training=True) == "flash"
    finally:
        op.kernel_impl = saved


def executed_impl(ff, op, choice: Optional[str] = None) -> Optional[str]:
    """Kernel impl that runs ``op`` in the compiled model ``ff``: the
    ``_k:`` suffix of its strategy choice when the search picked one,
    else the executor's recorded kernel choice, else (attention only)
    the impl ``forward`` dispatches on ``ff``'s device. None for ops with
    no registered kernel alternatives."""
    from flexflow_tpu_torch.search.unity import kernel_choice_of
    if choice is None:
        choice = getattr((ff.strategy or {}).get(op.guid), "choice", None)
    k = kernel_choice_of(choice)
    if k is not None:
        return k
    kc = getattr(ff.executor, "kernel_choices", None) or {}
    if op.name in kc:
        return kc[op.name]
    if hasattr(op, "selected_impl"):
        try:
            return op.selected_impl(ff.device, dict(ff.mesh.shape),
                                    training=True)
        except Exception:
            return None
    return None


def executed_rows(measured: Dict[str, float], guid: int,
                  impl: Optional[str]) -> Tuple[Optional[float],
                                                Optional[float]]:
    """(fwd, bwd) seconds of the core that runs op ``guid``: a core timed
    on its own rows ("<guid>:fwd:flash") is read there; the plain rows
    price the default lowering. (None, None) where the table has
    neither."""
    leg = f":{impl}" if impl and f"{guid}:fwd:{impl}" in measured else ""
    return measured.get(f"{guid}:fwd{leg}"), measured.get(f"{guid}:bwd{leg}")


def microbenchmark(nodes, machine_spec=None, device=None,
                   dtype: Optional[torch.dtype] = None, repeats: int = 3,
                   warmup: int = 1, cache_file: Optional[str] = None,
                   hbm_bw: Optional[float] = None, verbose: bool = False,
                   drift_corrections: bool = True) -> Dict[str, float]:
    """Measure every op of an OpNode list on ``device`` (the card when
    None; the CPU only by name) in ``dtype``; returns the search's
    measured table {"<guid>:fwd": s, "<guid>:bwd": s} plus the runtime
    constants. An attention op the flash kernel takes on ``device`` is
    timed under each core: its einsum lowering as "<guid>:fwd"/":bwd"
    (the native core reads those rows as the default lowering's price)
    and the kernel as "<guid>:fwd:flash"/":bwd:flash" (the ``_k:flash``
    twin's rows, ``native/ffs_strategy.hpp``); the CPU runs no kernel,
    so there the op has the plain rows only, as in the JAX package.

    An op whose forward cannot run standalone is skipped: the search
    keeps its analytic estimate. ``cache_file`` persists measurements
    across processes, keyed by ``op_cost_key``, written atomically.
    ``hbm_bw`` defaults to ``machine_spec.hbm_bw``; one of the two is
    required, and a ``machine_spec`` must describe ``device``
    (``machine.check_spec_device``). ``drift_corrections``
    (``FFS_NO_DRIFT_CORRECTIONS=1`` turns it off) scales the table by the
    platform's calibration-file factors on the way out; the cache keeps
    the raw times."""
    if hbm_bw is None:
        if machine_spec is None:
            raise ValueError("microbenchmark needs the machine's HBM rate: "
                             "pass machine_spec or hbm_bw")
        hbm_bw = float(machine_spec.hbm_bw)
    device = resolve_device(device)
    if machine_spec is not None:
        check_spec_device(machine_spec, device)
    disk: Dict[str, List[float]] = {}
    if cache_file and os.path.exists(cache_file):
        try:
            with open(cache_file) as f:
                disk = json.load(f)
        except (OSError, ValueError):
            disk = {}
    for k, v in disk.items():
        if k not in _CACHE and isinstance(v, list) and len(v) == 2:
            _CACHE[k] = (float(v[0]), float(v[1]))

    dtype = dtype or torch.float32
    measured: Dict[str, float] = {}
    dirty = False
    for node in nodes:
        op = node.op
        layout = node_layout(node)
        # an attention op the flash kernel takes on this device is timed
        # under each core: "<guid>:fwd" is the einsum lowering (the native
        # core's default impl for attention), "<guid>:fwd:flash" the
        # kernel; any other op under the kernel it runs
        legs = ((("einsum", ""), ("flash", ":flash"))
                if _flash_runs(op, device) else ((None, ""),))
        for pin, suffix in legs:
            saved = getattr(op, "kernel_impl", None)
            if pin is not None:
                op.kernel_impl = pin
            try:
                key = op_cost_key(op, device, layout, dtype)
                if key not in _CACHE:
                    measure_op(op, hbm_bw, device=device, dtype=dtype,
                               layout=layout, repeats=repeats,
                               warmup=warmup)
                    dirty = True
            except OpNotMeasurable as e:
                if verbose:
                    print(f"[profile] skip {op.name}{suffix}: {e}")
                continue
            finally:
                if pin is not None:
                    op.kernel_impl = saved
            fwd_s, bwd_s = _CACHE[key]
            measured[f"{op.guid}:fwd{suffix}"] = fwd_s
            measured[f"{op.guid}:bwd{suffix}"] = bwd_s
            if verbose:
                print(f"[profile] {op.name}{suffix}: fwd {fwd_s * 1e6:.1f}us"
                      f" bwd {bwd_s * 1e6:.1f}us")
    n_cached = len(_CACHE)
    measured.update(measure_runtime_constants(device))
    dirty = dirty or len(_CACHE) != n_cached
    if cache_file and dirty:
        try:
            atomic_write_text(cache_file, json.dumps(
                {k: list(v) for k, v in _CACHE.items()}))
        except OSError:
            pass
    if drift_corrections and not os.environ.get("FFS_NO_DRIFT_CORRECTIONS"):
        measured = apply_drift_corrections(
            measured, nodes, platform=device_identity(device)[0])
    return measured
