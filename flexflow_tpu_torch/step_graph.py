"""Compiled steps: one step function as one CUDA-graph replay over static
buffers.

PyTorch counterpart of the JAX executor's jitted steps
(``flexflow_tpu/executor.py``: ``make_train_step``, ``make_eval_step``,
``make_forward``). Where the JAX package traces a step into one XLA
program, the port records the step's kernels into a
``torch.cuda.CUDAGraph`` once and replays it: a step costs the host one
graph launch instead of one launch for every operation.

A ``StepGraph`` wraps a body ``body(carry, feeds, rng) -> (new carry,
outputs)``, a bound method of its owner (the executor), where every
argument and result is a tree (dicts, lists and tuples) of tensors:

* ``carry``: the caller's state: parameters, optimizer state, op state.
  The tensors of the first call are the graph's static buffers. With
  ``donate=True`` (the train step; the counterpart of ``donate_argnums``)
  they hold the new values after each call: a new tensor the body
  returned is written back with ``copy_``, and a tensor it updated in
  place (the fused Adam leaves) is left as it is; a call with other
  tensors first copies their values in. With ``donate=False`` (eval,
  forward) the carry is only read; a call with other tensors drops the
  graph that read the old ones and captures anew.
* ``feeds``: the batch, copied into static buffers before each replay.
  Host arrays (numpy or CPU tensors) go through a pinned buffer and one
  asynchronous copy to the card; the pinned buffer is refilled only once
  its last copy has run. One capture for each set of shapes, dtypes and
  sides (host or card), as ``jit`` retraces on a new shape.
* outputs: the capture's own tensors. They are overwritten by the next
  call of this graph, or of another graph that shares its memory pool
  (the graphs of one executor): read or copy them before.

On CUDA the first call for a signature runs the body eagerly on a side
stream: that is the call's step, and the warm-up that PyTorch's capture
recipe asks for (cuBLAS handles and workspaces, the kernels' first-use
attributes, the fused Adam leaf table). Then it captures the body, and
every later call replays the graph. Python's cyclic garbage collector
is paused during the capture: a collection there can destroy a dead
object that still holds another CUDA graph (a model freed earlier,
caught in a reference cycle), which CUDA refuses inside a capture and
which invalidates it; PyTorch's own capture no longer collects first,
and collecting before every capture costs the per-op profile seconds.
A capture that fails raises with its
cause: nothing falls back to the eager body on CUDA. On the CPU there is
nothing to capture: every call runs the same body eagerly over the same
static buffers and static outputs, so an aliasing mistake that a replay
would make shows in the CPU tests too. A step made with ``capture=False``
runs that eager path on the card as well: the executor's steps over a
process group of more than one rank, whose collectives (gloo's host
copies among them) a capture cannot hold.

The kernel wrappers count their launches in Python, which a replay does
not run, and count nothing while a capture records them (a capture
launches nothing). So each wrapper registers its counter here
(``register_launch_counter``) with a test of the name of the one kernel
that each of its launches runs once; a capture reads the names of its
graph's kernel nodes through libcuda, and every replay adds, to
each counter, the nodes of its kernel (a remat op's recompute is
captured into the backward: its kernels are nodes of the graph and count
again). Work a kernel needs once a capture
has ended is registered here too (``register_capture_hook``). The
registry keeps this module free of the ops.

A ``StepGraph`` holds its body, and so its owner, weakly: the executor
that owns the compiled steps is freed as soon as its last reference
goes, and its graphs, their memory and the tables they read with it.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.obs.registry import get_registry

# (wrapper, counter attribute, test of a kernel's name) of every kernel
# wrapper that counts its launches
_COUNTERS: List[Tuple[Any, str, Callable[[str], bool]]] = []
# hook(discard) -> objects the graph holds, run once each capture has
# ended (discard=True: the capture failed)
_CAPTURE_HOOKS: List[Callable[[bool], list]] = []


def register_launch_counter(wrapper, attr: str,
                            is_kernel: Callable[[str], bool]) -> None:
    """``wrapper.<attr>`` counts the launches of a kernel wrapper;
    ``is_kernel(name)`` is true for the name, mangled or demangled, of
    the one kernel that each of its launches runs once."""
    _COUNTERS.append((wrapper, attr, is_kernel))


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector paused around a CUDA-graph
    capture (the module docstring says why)."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def register_capture_hook(hook: Callable[[bool], list]) -> None:
    """``hook(discard)`` runs once every capture has ended, outside it;
    the graph holds what it returns for as long as the graph lives.
    With ``discard`` the capture failed."""
    _CAPTURE_HOOKS.append(hook)


def launch_counters() -> List[Tuple[Any, str, Callable[[str], bool]]]:
    return list(_COUNTERS)


def read_launch_counts() -> Dict[str, int]:
    """{"<wrapper>.<attr>": count} of every registered counter."""
    return {f"{fn.__name__}.{attr}": getattr(fn, attr)
            for fn, attr, _ in _COUNTERS}


_LEAF = "leaf"


def _spec(tree, leaves: List[torch.Tensor]):
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_spec(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree), None, tuple(_spec(v, leaves) for v in tree))
    return ("const", tree)


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """A tree's tensor leaves in order (dicts by sorted key, as JAX orders
    a pytree), and its structure (comparable with ``==``; non-tensor
    leaves are part of it)."""
    leaves: List[torch.Tensor] = []
    return leaves, _spec(tree, leaves)


def _build(spec, it):
    if spec == _LEAF:
        return next(it)
    kind, keys, children = spec[0], spec[1], spec[-1]
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(keys, children)}
    if kind in (list, tuple):
        return kind(_build(c, it) for c in children)
    return spec[1]


def unflatten(spec, leaves: List[torch.Tensor]):
    """The tree of structure ``spec`` over ``leaves`` (``flatten``'s
    inverse). (No closure over itself: a call leaves no reference cycle
    that would keep the leaves alive until the collector runs.)"""
    return _build(spec, iter(leaves))


def _host_arrays_as_tensors(tree):
    """numpy arrays in a tree -> CPU tensors over the same memory."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    if isinstance(tree, dict):
        return {k: _host_arrays_as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_arrays_as_tensors(v) for v in tree)
    return tree


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


_NODE_KERNEL, _NODE_GRAPH = 0, 5  # CUgraphNodeType


def kernel_node_names(graph: "torch.cuda.CUDAGraph") -> List[str]:
    """The kernel names (mangled) of a captured graph's kernel nodes, one
    a node, child graphs included, read through libcuda. The
    graph must have been made with ``keep_graph=True``."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        rc = getattr(cu, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name} failed: CUresult {rc}")

    names: List[str] = []

    def walk(g):
        n = ctypes.c_size_t(0)
        call("cuGraphGetNodes", g, None, ctypes.byref(n))
        nodes = (ctypes.c_void_p * n.value)()
        call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
        for node in nodes:
            node = ctypes.c_void_p(node)
            kind = ctypes.c_int(-1)
            call("cuGraphNodeGetType", node, ctypes.byref(kind))
            if kind.value == _NODE_GRAPH:
                child = ctypes.c_void_p()
                call("cuGraphChildGraphNodeGetGraph", node,
                     ctypes.byref(child))
                walk(child)
            elif kind.value == _NODE_KERNEL:
                p = _KernelNodeParams()
                call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(p))
                name = ctypes.c_char_p()
                if p.func:
                    call("cuFuncGetName", ctypes.byref(name),
                         ctypes.c_void_p(p.func))
                else:
                    call("cuKernelGetName", ctypes.byref(name),
                         ctypes.c_void_p(p.kern))
                names.append(name.value.decode())

    walk(ctypes.c_void_p(graph.raw_cuda_graph()))
    return names


class _Entry:
    """One signature's static buffers, outputs and graph."""

    def __init__(self, carry, carry_spec, feed_leaves, feed_spec,
                 device: torch.device):
        self.carry: List[torch.Tensor] = carry
        self.carry_spec = carry_spec
        # what the carry was when the entry was made (donate=False: a
        # call with other tensors needs another graph)
        self.carry_id = [(t.data_ptr(), t.shape, t.dtype) for t in carry]
        self.feeds = [torch.empty(t.shape, dtype=t.dtype, device=device)
                      for t in feed_leaves]
        self.feed_spec = feed_spec
        # host feeds on the card: a pinned buffer each, and an event
        # recorded after the copies out of them
        host = [device.type == "cuda" and t.device.type == "cpu"
                for t in feed_leaves]
        self.pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       if h else None for t, h in zip(feed_leaves, host)]
        self.copied = torch.cuda.Event() if any(host) else None
        self.outs: Optional[List[torch.Tensor]] = None
        self.out_spec = None
        self.graph = None
        # (wrapper, attr, the graph's nodes of its kernel): a replay's
        # launches
        self.launches: List[Tuple[Any, str, int]] = []
        self.held: list = []  # what the capture hooks handed the graph


class StepGraph:
    """A step function compiled to a CUDA graph over static buffers (see
    the module docstring). ``name`` keys the registry counter
    ``executor.<name>_jits``, which counts captures (on the CPU, the
    static buffers' set-up); ``pool`` is the memory pool the graphs
    share (``torch.cuda.graph_pool_handle()``). Captures run in the
    "thread_local" mode: other threads may use the card meanwhile."""

    def __init__(self, body: Callable, device: torch.device, name: str, *,
                 donate: bool, pool=None, capture: bool = True):
        self._body = weakref.WeakMethod(body)
        self.device = torch.device(device)
        # False: every call runs the body eagerly, on the card too
        self.capture = capture
        self.name = name
        self.donate = donate
        self.pool = pool
        self._entries: Dict[tuple, _Entry] = {}
        self._stream: Optional[torch.cuda.Stream] = None
        # captures made (CPU: signatures set up) and replays run
        self.captures = 0
        self.replays = 0
        # the last body run's copy-back: leaves written back, their bytes
        self.copy_back_leaves = 0
        self.copy_back_bytes = 0

    def launches_a_replay(self) -> Dict[str, int]:
        """{"<wrapper>.<attr>": kernel nodes} of the latest capture's
        graph: what each of its replays adds to the counters."""
        e = list(self._entries.values())[-1] if self._entries else None
        return {f"{fn.__name__}.{attr}": n
                for fn, attr, n in (e.launches if e else [])}

    def __call__(self, carry, feeds, rng=None):
        """-> (carry trees after the step, outputs)."""
        feeds = _host_arrays_as_tensors(feeds)
        carry_leaves, carry_spec = flatten(carry)
        feed_leaves, feed_spec = flatten(feeds)
        key = (carry_spec, feed_spec,
               tuple((tuple(t.shape), t.dtype, t.device.type)
                     for t in feed_leaves))
        e = self._entries.get(key)
        if e is not None and not self.donate and e.carry_id != [
                (t.data_ptr(), t.shape, t.dtype) for t in carry_leaves]:
            del self._entries[key]  # its graph read other tensors
            e = None
        if e is None:
            e = _Entry(carry_leaves, carry_spec, feed_leaves, feed_spec,
                       self.device)
            self._entries[key] = e
            self.captures += 1
            get_registry().inc(f"executor.{self.name}_jits")
            if self.device.type == "cuda" and self.capture:
                return self._warm_and_capture(key, e, feed_leaves, rng)
        self._take_carry(e, carry_leaves)
        self._take_feeds(e, feed_leaves)
        if e.graph is None:
            return self._run_eager(e, rng)
        e.graph.replay()
        self.replays += 1
        for fn, attr, n in e.launches:
            setattr(fn, attr, getattr(fn, attr) + n)
        return (unflatten(e.carry_spec, e.carry),
                unflatten(e.out_spec, e.outs))

    # ---- the CPU's path (and every step's body) -------------------------
    def _take_carry(self, e: _Entry, carry_leaves) -> None:
        """A donated carry of other tensors: their values into the static
        buffers."""
        if not self.donate:
            return
        with torch.no_grad():
            for s, g in zip(e.carry, carry_leaves):
                if g is not s:
                    if g.shape != s.shape or g.dtype != s.dtype:
                        raise ValueError(
                            f"{self.name}: carried tensor {tuple(g.shape)} "
                            f"{g.dtype} where the step's buffer is "
                            f"{tuple(s.shape)} {s.dtype}")
                    s.copy_(g)

    def _take_feeds(self, e: _Entry, feed_leaves) -> None:
        """The call's batch into the static feeds, on the current stream:
        host arrays on the card through their pinned buffers."""
        if e.copied is not None:
            e.copied.synchronize()  # the pinned buffers' last copies ran
        with torch.no_grad():
            for s, pin, g in zip(e.feeds, e.pinned, feed_leaves):
                if pin is not None:
                    pin.copy_(g)
                    s.copy_(pin, non_blocking=True)
                elif g is not s:
                    s.copy_(g)
        if e.copied is not None:
            e.copied.record()

    def _step(self, e: _Entry, rng):
        """The body over the static buffers, the new carry written back
        into them -> the body's outputs."""
        body = self._body()
        if body is None:
            raise ReferenceError(f"{self.name}: the executor that owned "
                                 f"this compiled step is gone")
        new_carry, outs = body(unflatten(e.carry_spec, e.carry),
                               unflatten(e.feed_spec, e.feeds), rng)
        if self.donate:
            new_leaves, spec = flatten(new_carry)
            if spec != e.carry_spec:
                raise ValueError(f"{self.name}: the step returned a carry "
                                 f"of another structure than it was given")
            copied = [(s, n) for s, n in zip(e.carry, new_leaves)
                      if n is not s]
            with torch.no_grad():
                for s, n in copied:
                    s.copy_(n)
            self.copy_back_leaves = len(copied)
            self.copy_back_bytes = sum(n.numel() * n.element_size()
                                       for _, n in copied)
        return outs

    def _run_eager(self, e: _Entry, rng):
        out_leaves, out_spec = flatten(self._step(e, rng))
        with torch.no_grad():
            if e.outs is None:
                e.outs = [torch.empty_like(o) for o in out_leaves]
                e.out_spec = out_spec
            for s, o in zip(e.outs, out_leaves):
                s.copy_(o)
        return (unflatten(e.carry_spec, e.carry),
                unflatten(e.out_spec, e.outs))

    # ---- CUDA ------------------------------------------------------------
    def _warm_and_capture(self, key, e: _Entry, feed_leaves, rng):
        """The first call of a signature on CUDA: the step, eagerly on a
        side stream, then the capture, and the graph's kernel nodes
        counted. Returns the eager step's results."""
        cur = torch.cuda.current_stream(self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._take_feeds(e, feed_leaves)
            outs = self._step(e, rng)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if rng is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"{self.name}: this PyTorch cannot register a "
                    f"generator with a CUDA graph "
                    f"(CUDAGraph.register_generator_state)")
            graph.register_generator_state(rng)
        try:
            with collector_paused(), torch.cuda.graph(
                    graph, pool=self.pool, stream=side,
                    capture_error_mode="thread_local"):
                captured = self._step(e, rng)
        except Exception as exc:
            for hook in _CAPTURE_HOOKS:
                hook(True)
            del self._entries[key]
            raise RuntimeError(f"{self.name}: CUDA graph capture failed: "
                               f"{exc}") from exc
        for hook in _CAPTURE_HOOKS:
            e.held.extend(hook(False))
        try:
            names = kernel_node_names(graph)
            graph.instantiate()
        except Exception as exc:
            del self._entries[key]
            raise RuntimeError(f"{self.name}: the captured CUDA graph "
                               f"could not be read or instantiated: "
                               f"{exc}") from exc
        e.launches = [(fn, attr, sum(1 for n in names if is_kernel(n)))
                      for fn, attr, is_kernel in _COUNTERS]
        e.outs, e.out_spec = flatten(captured)
        e.graph = graph
        return unflatten(e.carry_spec, e.carry), outs
