"""How an op runs on its rank's shards over a process group.

The JAX package constrains each op's output to its spec and lets GSPMD
partition the op. The port has no partitioner: before an op runs, the
executor brings its inputs and parameters to a layout the op can compute
on locally, and after it, brings each output to the output's spec
(``parallel/comm.py`` ``MeshComm.reshard``). The layout is chosen per op
type at compile time (``rule_of``):

- an op with a sharded rule of its own (``forward_sharded``: Linear's
  column and row parallelism, attention's head parallelism, the
  embedding's sharded tables) computes on its shards and issues its own
  collectives;
- ``"elementwise"`` (the elementwise kinds, Dropout, Repartition /
  Combine / Replicate): every input is resharded to the output's spec
  and the op runs on that block, whatever the spec;
- ``"per_sample"`` (ops that treat each row of the batch alone, every
  input and output leading with the same batch extent: the norms,
  Softmax over another dim, convolutions, pooling, Reduction): the batch
  dim keeps the output's sharding, every other dim is gathered whole;
- ``"whole"`` (every other op, BatchNorm's batch statistics and the
  mixture-of-experts routing among them): the op runs on whole inputs,
  the same on every rank, and each output is sliced to its spec.

Parameters are gathered whole for the last three. ``grad_axes`` is the
set of axes an op's batch is split over in its computation: the
gradients of its parameters are partial over them, and the executor
all-reduces them there after the backward.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from flexflow_tpu_torch.parallel.comm import (NormSpec, norm_spec,
                                              replicated, spec_axes)

RULES = ("own", "elementwise", "per_sample", "whole")


def rule_of(op) -> str:
    """The sharded rule of ``op`` (one of ``RULES``), fixed by its type
    and shapes."""
    if hasattr(op, "forward_sharded"):
        return "own"
    rule = getattr(op, "shard_rule", "whole")
    outs = [tuple(s) for s in op.output_shapes]
    ins = [tuple(s) for s in op.input_shapes]
    if rule == "elementwise" and (len(outs) != 1
                                  or any(s != outs[0] for s in ins)):
        rule = "per_sample"
    if rule == "per_sample":
        shapes = ins + outs
        if not shapes or any(len(s) == 0 for s in shapes) or \
                len({s[0] for s in shapes}) != 1:
            rule = "whole"
    return rule


def out_specs(node, mesh) -> List[NormSpec]:
    return [norm_spec(s, len(shp), mesh)
            for s, shp in zip(node.output_specs, node.op.output_shapes)]


def param_spec(node, name: str, ndim: int, mesh) -> NormSpec:
    return norm_spec(node.param_specs.get(name), ndim, mesh)


def compute_specs(node, rule: str, mesh) -> List[NormSpec]:
    """The spec each output has when the op has run under ``rule``: the
    output's own for "elementwise", the batch sharding alone for
    "per_sample", replicated for "whole"."""
    outs = out_specs(node, mesh)
    if rule == "elementwise":
        return outs
    if rule == "per_sample":
        batch = outs[0][0] if outs and outs[0] else ()
        return [(batch,) + ((),) * (len(s) - 1) for s in outs]
    return [replicated(len(s)) for s in outs]


def grad_axes(node, mesh) -> Tuple[str, ...]:
    """The axes over which the op's batch is split as it computes: the
    all-reduce axes of its parameters' gradients."""
    op = node.op
    rule = rule_of(op)
    if rule == "own":
        return tuple(op.sharded_grad_axes(node, mesh))
    specs = compute_specs(node, rule, mesh)
    if rule == "elementwise":
        return spec_axes(specs[0]) if specs else ()
    return tuple(specs[0][0]) if specs and specs[0] else ()


def prepare(node, rule: str, comm, args: Sequence, in_specs: Sequence,
            params: dict) -> Tuple[list, dict]:
    """The inputs and parameters an op runs on under ``rule`` (not
    "own"): inputs resharded to the layout of ``compute_specs``' first
    output (elementwise: the output's spec; per_sample: its batch
    sharding; whole: replicated), parameters gathered whole."""
    mesh = comm.mesh
    target = compute_specs(node, rule, mesh)[0] if node.op.output_shapes \
        else ()
    new_args = []
    for x, src in zip(args, in_specs):
        if rule == "elementwise":
            want = target
        elif rule == "per_sample":
            want = (target[0],) + ((),) * (x.dim() - 1)
        else:
            want = replicated(x.dim())
        new_args.append(comm.reshard(x, src, want))
    new_params = {n: comm.reshard(t, param_spec(node, n, t.dim(), mesh),
                                  replicated(t.dim()))
                  for n, t in params.items()}
    return new_args, new_params


def finish(node, rule: str, comm, outs: Sequence) -> list:
    """Each output of an op that ran under ``rule``, resharded to its
    spec."""
    mesh = comm.mesh
    return [comm.reshard(o, have, want) for o, have, want in
            zip(outs, compute_specs(node, rule, mesh), out_specs(node, mesh))]
