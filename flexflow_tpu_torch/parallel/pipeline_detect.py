"""Repeated-block detection for pipeline parallelism.

The port's copy of ``flexflow_tpu/parallel/pipeline_detect.py``: finds
the maximal run of structurally identical, shape-preserving,
single-tensor-boundary blocks in a materialized op graph, the "repeated
blocks" a GPipe pipeline distributes over the 'pipe' mesh axis. A block
may span several single-cut segments (a transformer layer is an attention
half and an FFN half), so detection looks for the longest periodic run of
segment signatures. The search ships the result with every request while
pipeline search is on (``search/unity.py`` ``graph_optimize``), so that the
native core can price 'pipe' meshes; executing them is ROADMAP.md Queue 1
item 10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class PipelineBlocks:
    """head / blocks / tail partition of a node list (indices into it)."""
    head: List[int]
    blocks: List[List[int]]          # each: node indices of one block
    tail: List[int]
    # ref of the tensor entering block 0: ("op", guid, out_idx) or
    # ("input", name); and ("op", guid, out_idx) leaving the last block
    body_in: Tuple
    body_out: Tuple

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)


def _analyze(nodes):
    produced_at = {}
    for i, node in enumerate(nodes):
        for oi in range(len(node.op.output_shapes)):
            produced_at[(node.op.guid, oi)] = i
    last_use: Dict[Tuple, int] = {}
    input_last: Dict[str, int] = {}
    for j, node in enumerate(nodes):
        for ref in node.input_refs:
            if ref[0] == "input":
                input_last[ref[1]] = j
            else:
                last_use[(ref[1], ref[2])] = j
    return produced_at, last_use, input_last


def _cut_points(nodes, produced_at, last_use, input_last) -> List[int]:
    """Positions p where exactly ONE op-produced tensor crosses between
    nodes[:p] and nodes[p:] and no graph input is consumed at/after p."""
    n = len(nodes)
    in_last = max(input_last.values()) if input_last else -1
    cuts = []
    for p in range(1, n):
        if in_last >= p:
            continue
        crossing = sum(1 for t, lu in last_use.items()
                       if produced_at.get(t, 1 << 30) < p <= lu)
        if crossing == 1:
            cuts.append(p)
    return cuts


def _boundary_tensor(nodes, produced_at, p) -> Optional[Tuple]:
    """The single op tensor crossing cut position p (as an ('op',g,i) ref),
    or for p == 0 the sole graph input ref, else None."""
    if p == 0:
        names = {ref[1] for node in nodes for ref in node.input_refs
                 if ref[0] == "input"}
        return ("input", names.pop()) if len(names) == 1 else None
    found = None
    for j in range(p, len(nodes)):
        for ref in nodes[j].input_refs:
            if ref[0] == "op" and produced_at.get((ref[1], ref[2]),
                                                  1 << 30) < p:
                if found is not None and found != ref:
                    return None
                found = ("op", ref[1], ref[2])
    return found


def _block_signature(nodes, seg: List[int], boundary_in) -> Tuple:
    """Structural signature: op types, attrs, shapes, relative wiring.
    External refs must all equal the block's boundary-in ref."""
    local = {}
    for rel, i in enumerate(seg):
        for oi in range(len(nodes[i].op.output_shapes)):
            local[(nodes[i].op.guid, oi)] = (rel, oi)
    from flexflow_tpu_torch.search.unity import _node_attrs, _param_shapes
    sig = []
    for i in seg:
        op = nodes[i].op
        wiring = []
        for ref in nodes[i].input_refs:
            key = (ref[1], ref[2]) if ref[0] == "op" else None
            if key is not None and key in local:
                wiring.append(("l",) + local[key])
            elif boundary_in is not None and tuple(ref) == tuple(boundary_in):
                wiring.append(("in",))
            else:
                return ()  # reaches past the block boundary
        sig.append((
            op.op_type.name,
            tuple(wiring),
            tuple(map(tuple, op.output_shapes)),
            tuple(sorted((k, tuple(v))
                         for k, v in _param_shapes(op).items())),
            tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                         for k, v in _node_attrs(op).items())),
        ))
    return tuple(sig)


def detect_repeated_blocks(nodes, min_blocks: int = 2,
                           allow_stateful: bool = False
                           ) -> Optional[PipelineBlocks]:
    """Longest run of >= min_blocks consecutive identical blocks, where a
    block is a periodic group of single-cut segments. Blocks must be
    shape-preserving (boundary-in shape == boundary-out shape) and
    stateless (no op with init_state, no dropout, no auxiliary-loss op). ``allow_stateful``
    drops the statelessness requirement — fflint's FFL107 rule uses it to
    tell "repeated but unpipelineable (stateful/dropout body)" apart from
    "no repeated structure at all"; the runtime never sets it."""
    if len(nodes) < 2:
        return None
    produced_at, last_use, input_last = _analyze(nodes)
    cuts = _cut_points(nodes, produced_at, last_use, input_last)
    bounds = [0] + cuts + [len(nodes)]
    nseg = len(bounds) - 1
    if nseg < min_blocks:
        return None
    segments = [list(range(bounds[s], bounds[s + 1])) for s in range(nseg)]

    def stateless(seg):
        # op state (BN running stats), per-op rng (dropout) and auxiliary
        # losses (MoE load balancing) cannot ride a pipeline stage
        if allow_stateful:
            return True
        from flexflow_tpu_torch.ffconst import OperatorType
        aux_types = {OperatorType.EXPERTS, OperatorType.AGGREGATE,
                     OperatorType.AGGREGATE_SPEC, OperatorType.GROUP_BY,
                     OperatorType.DROPOUT}
        for i in seg:
            op = nodes[i].op
            if hasattr(op, "init_state"):
                return False
            if op.op_type in aux_types:
                return False
            if getattr(op, "dropout", 0.0):
                return False
        return True

    def block_of(s, P):
        return [i for seg in segments[s:s + P] for i in seg]

    best = None  # (num_blocks, covered_nodes, s0, P)
    for P in range(1, nseg // min_blocks + 1):
        for s0 in range(0, nseg - min_blocks * P + 1):
            bin0 = _boundary_tensor(nodes, produced_at, bounds[s0])
            if bin0 is None:
                continue
            blk0 = block_of(s0, P)
            sig0 = _block_signature(nodes, blk0, bin0)
            if not sig0 or not stateless(blk0):
                continue
            m = 1
            while s0 + (m + 1) * P <= nseg:
                s = s0 + m * P
                b_in = _boundary_tensor(nodes, produced_at, bounds[s])
                blk = block_of(s, P)
                if (b_in is None or not stateless(blk)
                        or _block_signature(nodes, blk, b_in) != sig0):
                    break
                m += 1
            if m < min_blocks:
                continue
            covered = sum(len(segments[s0 + i]) for i in range(m * P))
            cand = (m, covered, -s0, P)
            if best is None or cand > best:
                best = cand
    if best is None:
        return None
    m, _, neg_s0, P = best
    s0 = -neg_s0
    blocks = [block_of(s0 + i * P, P) for i in range(m)]
    body_in = _boundary_tensor(nodes, produced_at, bounds[s0])
    last = blocks[-1][-1]
    out_ref = _boundary_tensor(nodes, produced_at, bounds[s0 + m * P]) \
        if s0 + m * P < nseg else None
    body_out = out_ref if (out_ref and out_ref[0] == "op"
                           and out_ref[1] == nodes[last].op.guid) \
        else ("op", nodes[last].op.guid, 0)
    # shape preservation: in == out shape
    if body_in[0] == "op":
        in_pos = produced_at.get((body_in[1], body_in[2]))
        if in_pos is None:
            return None
        in_shape = nodes[in_pos].op.output_shapes[body_in[2]]
    else:
        first = blocks[0][0]
        slot = next((k for k, r in enumerate(nodes[first].input_refs)
                     if tuple(r) == tuple(body_in)), None)
        if slot is None:
            return None
        in_shape = nodes[first].op.input_shapes[slot]
    out_shape = nodes[last].op.output_shapes[body_out[2]]
    if tuple(in_shape) != tuple(out_shape):
        return None
    head = [i for seg in segments[:s0] for i in seg]
    tail = [i for seg in segments[s0 + m * P:] for i in seg]
    return PipelineBlocks(head=head, blocks=blocks, tail=tail,
                          body_in=tuple(body_in), body_out=tuple(body_out))


def pipeline_meta_json(nodes, blocks: PipelineBlocks) -> Dict:
    """Request payload for the native search's GPipe cost model."""
    body = [nodes[i].op.guid for blk in blocks.blocks for i in blk]
    last = blocks.blocks[-1][-1]
    shp = nodes[last].op.output_shapes[blocks.body_out[2]]
    out_bytes = math.prod(shp) * nodes[last].op.dtype.size
    return dict(
        num_blocks=blocks.num_blocks,
        body=body,
        head=[nodes[i].op.guid for i in blocks.head],
        tail=[nodes[i].op.guid for i in blocks.tail],
        block_out_bytes=out_bytes,
        batch=int(shp[0]) if shp else 0,
    )
