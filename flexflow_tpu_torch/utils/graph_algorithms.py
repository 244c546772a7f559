"""Generic graph algorithms used by the search and tooling.

The port's own copy of ``flexflow_tpu/utils/graph_algorithms.py`` (the
original FlexFlow's ``dominators.h``: topo_sort and post-dominators, which
find sequence-split nodes; ``disjoint_set.h``: union-find; and
``basic_graph.h``-style reversed views). Pure Python on plain adjacency
dicts: {node: iterable of successors}.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Set, TypeVar

T = TypeVar("T", bound=Hashable)

Adj = Dict[T, Iterable[T]]


def topo_sort(adj: Adj) -> List[T]:
    """Topological order; raises ValueError on cycles (dominators.h analog)."""
    indeg: Dict[T, int] = {u: 0 for u in adj}
    for u, vs in adj.items():
        for v in vs:
            indeg[v] = indeg.get(v, 0) + 1
            indeg.setdefault(u, indeg.get(u, 0))
    ready = [u for u, d in sorted(indeg.items(), key=lambda kv: repr(kv[0]))
             if d == 0]
    out: List[T] = []
    while ready:
        u = ready.pop()
        out.append(u)
        for v in adj.get(u, ()):  # noqa: B020
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    if len(out) != len(indeg):
        raise ValueError("graph has a cycle")
    return out


def reversed_graph(adj: Adj) -> Adj:
    out: Dict[T, List[T]] = {u: [] for u in adj}
    for u, vs in adj.items():
        for v in vs:
            out.setdefault(v, []).append(u)
            out.setdefault(u, out.get(u, []))
    return out


def dominators(adj: Adj, root: T) -> Dict[T, Set[T]]:
    """dom(v) = nodes on every path root→v (iterative dataflow,
    dominators.h semantics). Unreachable nodes are omitted."""
    order = [u for u in topo_sort(adj)]
    reach = _reachable(adj, root)
    order = [u for u in order if u in reach]
    dom: Dict[T, Set[T]] = {root: {root}}
    preds = reversed_graph(adj)
    changed = True
    while changed:
        changed = False
        for v in order:
            if v == root:
                continue
            ps = [p for p in preds.get(v, []) if p in dom]
            if not ps:
                continue
            new = set.intersection(*(dom[p] for p in ps)) | {v}
            if dom.get(v) != new:
                dom[v] = new
                changed = True
    return dom


def post_dominators(adj: Adj, sink: T) -> Dict[T, Set[T]]:
    """pdom(v) = nodes on every path v→sink — the reference uses these to
    pick sequence-split bottlenecks (graph.h:170 DP decomposition)."""
    return dominators(reversed_graph(adj), sink)


def immediate_post_dominator(adj: Adj, node: T, sink: T) -> Optional[T]:
    pdom = post_dominators(adj, sink)
    cands = pdom.get(node, set()) - {node}
    if not cands:
        return None
    # the ipdom is the *closest* candidate: the one every other candidate
    # post-dominates (all others lie beyond it on the way to the sink)
    for c in cands:
        if all(o in pdom.get(c, set()) or o == c for o in cands):
            return c
    return None


def _reachable(adj: Adj, root: T) -> Set[T]:
    seen = {root}
    stack = [root]
    while stack:
        u = stack.pop()
        for v in adj.get(u, ()):
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return seen


class DisjointSet:
    """Union-find with path compression (disjoint_set.h analog)."""

    def __init__(self):
        self._parent: Dict[T, T] = {}

    def find(self, x: T) -> T:
        p = self._parent.setdefault(x, x)
        if p != x:
            p = self._parent[x] = self.find(p)
        return p

    def union(self, a: T, b: T) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self._parent[rb] = ra

    def same(self, a: T, b: T) -> bool:
        return self.find(a) == self.find(b)


def hash_combine(seed: int, value: Hashable) -> int:
    """Deterministic 64-bit hash_combine (hash_utils.h analog; avoids
    Python's per-process hash randomization for strategy cache keys)."""
    import zlib

    v = zlib.crc32(repr(value).encode()) & 0xFFFFFFFF
    seed ^= (v + 0x9E3779B97F4A7C15 + ((seed << 6) & (2**64 - 1)) + (seed >> 2))
    return seed & (2**64 - 1)
