"""fflint orchestrator: run the pass pipeline over a compiled model.

PyTorch counterpart of ``flexflow_tpu/analysis/orchestrator.py``. The
verifier runs over three progressively-more-expensive views of the same
training program:

(a) the materialized PCG (``OpNode`` list + mesh + strategy) — every
    pass reads this; pure static analysis, no device work;
(b) the searched strategy's priced collective set (native simulator
    replay) — the collective-inference pass prices the strategy when
    the native core is available;
(c) the emitted collectives of the compiled step — optional (``hlo=``).
    The port compiles no XLA program: a string is read as optimized-HLO
    text exactly as the JAX package reads it (its census, and the
    per-host programs of the multihost pass), and ``hlo=True`` takes the
    emitted side from the step's NCCL census (``obs/inspect.py``), which
    on one card is ``{}``: a one-device step runs no collective.

A pass that cannot run records a skip reason in ``report.passes``
instead of pretending it found nothing, and a pass that crashes
becomes an FFL000 diagnostic rather than killing the lint run.

``plan_model`` lays a model out over ``num_devices`` without executing
it (the strategy compile would choose, its specs recorded on the nodes,
the executor's planning record, no parameters): the port runs one
device, and this is how a strategy over 4 or 8 devices is linted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.analysis.diagnostics import LintReport, error


class SkipPass(Exception):
    """Raised by a pass that cannot run in this context (e.g. the
    multihost pass with a single program); the reason lands in
    ``report.passes`` so skipped != clean."""


class LintContext:
    """Everything a pass may read. ``ff`` is optional — hand-built
    contexts (tests, strategy files without a model) carry nodes/mesh/
    strategy directly; passes needing the model degrade or skip."""

    def __init__(self, nodes, mesh, strategy=None, machine_spec=None,
                 config=None, final_ref: Optional[Tuple[int, int]] = None,
                 ff=None, hlo_text: Optional[str] = None,
                 hlo_per_host: Optional[List[str]] = None,
                 slice_of_host: Optional[List[int]] = None,
                 priced: Optional[Dict[str, float]] = None,
                 emitted: Optional[Dict[str, float]] = None,
                 searched: Optional[bool] = None):
        self.nodes = nodes
        self.mesh = mesh
        self.strategy = strategy or {}
        self.machine_spec = machine_spec
        self.config = config
        self.final_ref = tuple(final_ref) if final_ref is not None else None
        self.ff = ff
        self.hlo_text = hlo_text
        self.hlo_per_host = hlo_per_host
        # multi-slice process topology: slice_of_host[i] is the slice id
        # of hlo_per_host[i]'s process — the multihost-order pass then
        # checks within-slice order per slice AND the cross-slice leader
        # agreement (FFL503) instead of one flat comparison
        self.slice_of_host = slice_of_host
        self.priced = priced      # simulator-priced {kind: bytes}, lazy
        self.emitted = emitted    # emitted-census {kind: bytes}, lazy
        # whether the strategy came from the auto-parallelization search
        # (the calibration pass only meaningfully audits searched runs)
        if searched is None:
            searched = bool(ff is not None
                            and isinstance(getattr(ff, "search_info", None),
                                           dict))
        self.searched = searched
        self.by_guid = {n.op.guid: n for n in nodes}
        self._consumers = None

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """The mesh's axis sizes (``machine.Mesh.shape``)."""
        if self.mesh is None:
            return {}
        return dict(self.mesh.shape)

    def consumers(self) -> Dict[Tuple[int, int], List]:
        """(producer guid, out idx) -> list of (consumer node, input pos).
        Memoized — the graph is not mutated during a lint run, and
        several passes (hygiene, layout, dtype) walk this map."""
        if self._consumers is None:
            out: Dict[Tuple[int, int], List] = {}
            for node in self.nodes:
                for j, ref in enumerate(node.input_refs):
                    if ref[0] == "op":
                        out.setdefault((ref[1], ref[2]), []).append((node, j))
            self._consumers = out
        return self._consumers

    def ensure_priced(self) -> Optional[Dict[str, float]]:
        """Simulator-priced collectives for the model's strategy (native
        replay); None when no model / native core is attached."""
        if self.priced is not None:
            return self.priced
        if self.ff is None:
            return None
        from flexflow_tpu_torch.search.native import available
        if not available():
            return None
        from flexflow_tpu_torch.search.validate import priced_collectives
        self.priced = priced_collectives(self.ff)
        return self.priced

    def ensure_emitted(self) -> Optional[Dict[str, float]]:
        """Collectives emitted by the step: the census of ``hlo_text``
        (optimized-HLO text), or the step's NCCL census when the context
        was built with ``hlo=True``; None without either."""
        if self.emitted is not None:
            return self.emitted
        if not self.hlo_text:
            return None
        from flexflow_tpu_torch.obs.inspect import (PRICED_MIN_BYTES,
                                                    collective_census)
        from flexflow_tpu_torch.search.validate import emitted_collectives
        self.emitted = emitted_collectives(
            collective_census(self.hlo_text, min_bytes=PRICED_MIN_BYTES))
        return self.emitted


def all_passes():
    """The shipped pass pipeline, in execution order (cheap graph-shape
    checks first so their findings frame the expensive ones)."""
    from flexflow_tpu_torch.analysis.passes.calibration import \
        CalibrationPass
    from flexflow_tpu_torch.analysis.passes.checkpoint import \
        CheckpointIntegrityPass
    from flexflow_tpu_torch.analysis.passes.collectives import \
        CollectiveInferencePass
    from flexflow_tpu_torch.analysis.passes.dtype import DtypePolicyPass
    from flexflow_tpu_torch.analysis.passes.hygiene import GraphHygienePass
    from flexflow_tpu_torch.analysis.passes.layout import \
        LayoutConsistencyPass
    from flexflow_tpu_torch.analysis.passes.multihost import \
        MultihostOrderPass
    from flexflow_tpu_torch.analysis.passes.sharding import \
        ShardingLegalityPass
    return [
        GraphHygienePass(),
        ShardingLegalityPass(),
        LayoutConsistencyPass(),
        DtypePolicyPass(),
        CollectiveInferencePass(),
        MultihostOrderPass(),
        CalibrationPass(),
        CheckpointIntegrityPass(),
    ]


def run_passes(ctx: LintContext, passes=None) -> LintReport:
    report = LintReport()
    report.context = dict(
        num_ops=len(ctx.nodes),
        mesh_axes=ctx.axis_sizes,
        searched=ctx.searched,
        hlo="yes" if ctx.hlo_text else "no",
    )
    for p in passes if passes is not None else all_passes():
        try:
            report.extend(p.run(ctx), p.name)
            report.passes[p.name] = "ok"
        except SkipPass as e:
            report.passes[p.name] = f"skipped: {e}"
        except Exception as e:  # a broken pass must not kill the lint run
            report.passes[p.name] = f"crashed: {e!r}"
            report.extend([error(
                "FFL000", f"pass crashed: {e!r}",
                hint="fflint internal error — report with the model config"
            )], p.name)
    return report


def lint_model(ff, hlo=None, passes=None,
               hlo_per_host: Optional[List[str]] = None,
               slice_of_host: Optional[List[int]] = None) -> LintReport:
    """Lint a compiled (or planned, ``plan_model``) FFModel.

    ``hlo``: None runs the static passes only; a string is read as the
    optimized-HLO text of the step, as the JAX package reads it (a saved
    dump); ``True`` takes the emitted collectives from the compiled
    step's NCCL census (``obs/inspect.py`` ``inspect_compiled``): the
    port compiles no XLA program, and a step on one card issues no
    collective, so that census is ``{}``. ``slice_of_host``: per-entry
    slice ids for ``hlo_per_host`` on a multi-slice deployment — the
    multihost-order pass then reports within-slice divergence with
    slice attribution plus FFL503 when the slice leaders disagree.
    """
    if ff.executor is None:
        raise ValueError("lint_model needs a compiled model — call "
                         "model.compile(...) first")
    hlo_text = hlo if isinstance(hlo, str) else None
    emitted = None
    if hlo is True:
        from flexflow_tpu_torch.obs.inspect import inspect_compiled
        from flexflow_tpu_torch.search.validate import emitted_collectives
        emitted = emitted_collectives(inspect_compiled(ff)["collectives"])
    ctx = LintContext(
        nodes=ff.executor.nodes, mesh=ff.mesh, strategy=ff.strategy,
        machine_spec=ff.machine_spec, config=ff.config,
        final_ref=ff.executor.final_ref, ff=ff, hlo_text=hlo_text,
        hlo_per_host=hlo_per_host, slice_of_host=slice_of_host,
        emitted=emitted)
    report = run_passes(ctx, passes=passes)
    if hlo is True:
        report.context["hlo"] = "yes"
    return report


def plan_model(ff, num_devices: int, optimizer=None, loss_type=None,
               metrics=(), comp_mode=None, mesh=None, outputs=None):
    """Lay ``ff`` out over ``num_devices`` as ``compile`` would, without
    executing it: the strategy (imported, searched at ``num_devices``,
    or the heuristic data-parallel one), its specs recorded on the
    nodes, the layout pass, and the executor's planning record (compute
    dtype, mode, output, weight-update sharding). No parameter or
    optimizer state is allocated and no kernel is built, so a strategy
    the port cannot execute (a mesh over several devices) still lints:
    ``lint_model(plan_model(ff, 8))``. Returns ``ff``."""
    from flexflow_tpu_torch.ffconst import CompMode, LossType
    ff._plan(optimizer,
             loss_type or LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
             metrics, comp_mode or CompMode.TRAINING, mesh=mesh,
             outputs=outputs, num_devices=num_devices)
    return ff
