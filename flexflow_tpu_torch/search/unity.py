"""Unity-style graph optimization: op graph -> (mesh shape, per-op specs).

PyTorch counterpart of ``flexflow_tpu/search/unity.py``: serialize the
materialized op graph for the native search core (``search/native.py``),
decode the returned strategy into specs (``parallel/strategy.py``), and
read and write strategy files (``--export-strategy`` /
``--import-strategy``) in the JAX package's format, so that a file
written by either package imports into the other. The requests are the
JAX package's, field for field, so the same graph and machine give the
same strategy. ``graph_optimize``'s ``measured`` table is the per-op times
``search/profile.py`` takes on the model's device under
``--search-measure-ops``; where no measured time exists, a learned table
(``costmodel/``: ``FFS_COSTMODEL_FILE`` or the repo root's
``COSTMODEL_GPU.json``, gated on the platform of the model's device)
prices the op classes it covers, and the machine model the rest. The
memory-capped search aims under its threshold divided by the median
``mem_ratio`` of the port's calibration file (``CALIBRATION_GPU.json``).
When the substitution engine rewrites the graph, ``info`` records the
static rewrite verification (``analysis/dataflow.py``
``verify_rewrite_dataflow``, fflint's FFL213) as the JAX package does.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import CompMode
from flexflow_tpu_torch.parallel.strategy import OpStrategy, Strategy

# the substitution corpus the search loads by default
DEFAULT_RULES = (Path(__file__).resolve().parent.parent.parent
                 / "substitutions" / "ffs_subst_v1.json")


def _param_shapes(op) -> Dict[str, List[int]]:
    """Parameter name -> shape, without allocating ({} on failure)."""
    try:
        return {k: list(v) for k, v in op.param_shapes().items()}
    except Exception:
        return {}


def _node_attrs(op) -> Dict[str, Any]:
    """The op attributes the native core reads (the substitution engine
    matches on them, and rewrites re-emit ops from them)."""
    attrs = {}
    for k in ("num_heads", "num_kv_heads", "groups", "axis", "out_dim",
              "k", "n", "n_experts", "hidden_size", "alpha",
              "out_channels", "dropout"):
        v = getattr(op, k, None)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            attrs[k] = v
    for name, keys in (("kernel", ("kernel_h", "kernel_w")),
                       ("stride", ("stride_h", "stride_w")),
                       ("padding", ("padding_h", "padding_w"))):
        v = getattr(op, name, None)
        if isinstance(v, tuple) and len(v) == 2:
            attrs[keys[0]], attrs[keys[1]] = int(v[0]), int(v[1])
    mesh_axis = getattr(op, "axis", None)
    if isinstance(mesh_axis, str):
        attrs["mesh_axis"] = mesh_axis
    relu = getattr(op, "relu", None)
    if isinstance(relu, bool):
        attrs["relu"] = int(relu)
    fused = getattr(op, "fused_ops", None)
    if fused:
        attrs["ops"] = [[k.name if hasattr(k, "name") else str(k),
                         int(d), int(g)] + ([a] if isinstance(a, str)
                                            else [])
                        for (k, d, g, a) in fused]
    act = getattr(op, "activation", None)
    if act is not None and hasattr(act, "value"):
        attrs["activation"] = int(act.value)
    use_bias = getattr(op, "use_bias", None)
    if isinstance(use_bias, bool):
        attrs["use_bias"] = int(use_bias)
    for prefix in ("repartition", "combine", "reduction"):
        d = getattr(op, f"{prefix}_dim", None)
        if d is not None:
            attrs["dim"] = int(d)
        g = getattr(op, f"{prefix}_degree", None)
        if g is not None:
            attrs["degree"] = int(g)
    rdeg = getattr(op, "replicate_degree", None)
    if rdeg is not None:
        attrs["degree"] = int(rdeg)
    sizes = getattr(op, "sizes", None)
    if sizes is not None:
        attrs["sizes"] = [int(s) for s in sizes]
    return attrs


def kernel_choice_of(choice: Optional[str]) -> Optional[str]:
    """Kernel impl a choice name selects (the ``_k:<impl>`` suffix), or
    None for the default lowering. The trailing ``_r`` remat suffix
    (canonical order ``base[_wus][_ovl][_k:impl][_r]``) is not part of
    the impl name."""
    if not choice or "_k:" not in choice:
        return None
    impl = choice.split("_k:", 1)[1]
    if impl.endswith("_r"):
        impl = impl[:-2]
    return impl or None


def remat_choice_of(choice: Optional[str]) -> bool:
    """Whether a choice name selects the rematerialized (``_r``) twin."""
    return bool(choice) and choice.endswith("_r")


def executed_remat_ops(nodes, strategy) -> set:
    """{op name} whose choice carries the ``_r`` remat suffix."""
    return {node.op.name for node in nodes
            if remat_choice_of(getattr((strategy or {}).get(node.op.guid),
                                       "choice", None))}


def executed_kernel_choices(nodes, strategy, mesh_axes,
                            training: bool = False,
                            device="cuda") -> Dict[str, str]:
    """{op name -> kernel impl} a node list will run: explicit ``_k:``
    suffixes from the strategy win; attention ops without one report
    their dispatch on ``device`` (``selected_impl``)."""
    out: Dict[str, str] = {}
    for node in nodes:
        st = (strategy or {}).get(node.op.guid)
        impl = kernel_choice_of(getattr(st, "choice", None))
        if impl is not None:
            out[node.op.name] = impl
        elif hasattr(node.op, "selected_impl"):
            out[node.op.name] = node.op.selected_impl(
                device, mesh_axes, training=training)
    return out


def serialize_graph(nodes, final_guid: Optional[int] = None
                    ) -> List[Dict[str, Any]]:
    """The node list as the native core's request graph."""
    from flexflow_tpu_torch.layout import train_fusable_conv_guids
    from flexflow_tpu_torch.search.rewrite import external_input_ids
    neg_of = external_input_ids(nodes)
    # convs whose sole consumer is a foldable BatchNorm, the model output
    # excepted: the legality the "_k:conv_bn_fused" twin gates on
    bn_fusable = train_fusable_conv_guids(
        nodes, keep_guids=() if final_guid is None else {final_guid})
    out = []
    for node in nodes:
        op = node.op
        inputs = []
        for ref in node.input_refs:
            if ref[0] == "op":
                inputs.append([ref[1], ref[2]])
            else:  # a graph input: a unique negative guid
                inputs.append([neg_of[tuple(ref)], 0])
        attrs = _node_attrs(op)
        if op.guid in bn_fusable:
            attrs["bn_fusable"] = 1
        out.append(dict(
            guid=op.guid,
            type=op.op_type.name,
            name=op.name,
            inputs=inputs,
            input_shapes=[list(s) for s in op.input_shapes],
            output_shapes=[list(s) for s in op.output_shapes],
            roles=[[r.value for r in rr] for rr in op.output_dim_roles()],
            params=_param_shapes(op),
            flops=float(op.flops()),
            dtype_size=op.dtype.size,
            attrs=attrs,
        ))
    return out


def machine_to_json(spec, num_devices: int,
                    comm_bytes_factor: float = 1.0,
                    learned: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """The machine as the native core reads it. With explicit slice-pair
    links the raw link matrix goes along (the core prices each
    collective's span on it); else the effective DCN figures.
    ``learned``: the trained cost model's coefficient table
    (``costmodel`` ``native_table()``), which the core prices the op
    classes it covers with; None keeps analytic pricing."""
    dcn_links = list(getattr(spec, "dcn_links", None) or [])
    if dcn_links:
        dcn_bw, dcn_latency = spec.dcn_bw, spec.dcn_latency
    else:
        dcn_bw, dcn_latency = spec.effective_dcn()
    out = dict(
        num_devices=num_devices,
        flops=spec.flops,
        hbm_bw=spec.hbm_bw,
        hbm_cap=spec.hbm_cap,
        ici_bw=spec.ici_bw,
        ici_latency=spec.ici_latency,
        dcn_bw=dcn_bw,
        dcn_latency=dcn_latency,
        num_slices=spec.num_slices,
        mxu_efficiency=spec.mxu_efficiency,
        conv_efficiency=spec.conv_efficiency,
        min_op_time=spec.min_op_time,
        collective_launch_overhead=spec.collective_launch_overhead,
        # bf16 activations and grads under mixed precision: collectives
        # move half the f32 bytes
        comm_bytes_factor=comm_bytes_factor,
        torus=[int(t) for t in spec.torus or []],
    )
    if dcn_links:
        out["dcn_links"] = [[int(a), int(b), float(bw)]
                            for a, b, bw in dcn_links]
    if learned:
        out["learned"] = learned
    return out


def _entries_to_spec(entries: List[Optional[Any]]) -> Tuple:
    while entries and entries[-1] is None:
        entries = entries[:-1]
    return tuple(entries)


def decode_strategy(resp: Dict[str, Any], nodes
                    ) -> Tuple[Dict[str, int], Strategy]:
    """The native response -> (mesh axes, strategy keyed by op guid)."""
    mesh_axes = {k: int(v) for k, v in resp["mesh"].items() if int(v) > 1}
    if not mesh_axes:
        mesh_axes = {"data": 1}
    valid = set(mesh_axes)

    def _entry(e):
        # "data+model": the 2-D sample partition over both axes
        if e == "data+model":
            axes = tuple(a for a in ("data", "model") if a in valid)
            return axes if len(axes) > 1 else (axes[0] if axes else None)
        return e if e in valid else None

    strategy: Strategy = {}
    for node in nodes:
        oj = resp["ops"].get(str(node.op.guid))
        if oj is None:
            continue
        outs = [_entries_to_spec([_entry(e) for e in entries])
                for entries in oj["outputs"]]
        # the native side enumerates param specs from the op type; keep
        # only the parameters the op owns (a bias-less Linear has no bias)
        owned = _param_shapes(node.op)
        params = {pname: _entries_to_spec([_entry(e) for e in entries])
                  for pname, entries in oj.get("params", {}).items()
                  if not owned or pname in owned}
        strategy[node.op.guid] = OpStrategy(
            output_specs=outs, param_specs=params, choice=oj.get("choice"))
    return mesh_axes, strategy


def _load_rules(config) -> Tuple[List[Any], Optional[Any]]:
    """(per-op choice filters, graph-rewrite corpus) of the request."""
    rules: List[Any] = []
    subst_rules = None
    if (not config.substitution_json
            and getattr(config, "enable_substitution", True)
            and DEFAULT_RULES.exists()):
        try:
            subst_rules = json.loads(DEFAULT_RULES.read_text())
        except (OSError, ValueError):
            subst_rules = None
    if config.substitution_json:
        # an explicitly requested rules file fails loudly
        try:
            with open(config.substitution_json) as f:
                data = json.load(f)
        except OSError as e:
            raise ValueError(
                f"--substitution-json {config.substitution_json}: {e}") from e
        if isinstance(data, dict) and "rules" in data:
            rules = data["rules"]
        else:
            subst_rules = data
    return rules, subst_rules


def switched_off(config, field: str, env: str) -> bool:
    """Whether a searched dimension is off: its flag says "off", or its
    environment switch (``FFS_NO_KERNEL_SEARCH``, ``FFS_NO_REMAT``) is
    set, as in the JAX package."""
    return (str(getattr(config, field, "auto")).lower() == "off"
            or bool(os.environ.get(env)))


def graph_optimize(nodes, machine_spec, config, num_devices: int,
                   measured: Optional[Dict[str, float]] = None,
                   batch: int = 0,
                   final_ref: Optional[Tuple[int, int]] = None,
                   device=None,
                   ) -> Tuple[Dict[str, int], Strategy, Dict[str, Any]]:
    """Run the native Unity search. Returns (mesh_axes, strategy, info).

    ``device`` is the model's torch device: its platform picks the
    learned table (``costmodel.load_native_table``); with None only a
    table of platform "unknown" loads. ``info["cost_model"]`` is
    "learned" when the table covers one of the graph's op types (named
    in ``info["learned_cost_classes"]``), else "analytic".

    When the substitution engine rewrites the graph, ``info`` carries
    ``rewritten_nodes`` (the node list the strategy is keyed to) and
    ``final_ref`` (where the designated output moved); when it picks a
    'pipe' mesh, ``info["pipeline"]`` the searched pipeline and the
    detected blocks. Raises RuntimeError when the native core fails."""
    from flexflow_tpu_torch.search.native import native_optimize

    t0 = time.perf_counter()
    rules, subst_rules = _load_rules(config)
    threshold = 0
    mem_correction = 1.0
    if config.memory_search and config.memory_threshold_mb:
        threshold = config.memory_threshold_mb * (1 << 20)
    elif config.memory_search:
        threshold = config.memory_per_chip_mb * (1 << 20)
    if threshold:
        # when the step's measured footprint runs corr x the prediction,
        # aim for budget / corr so that the measured bytes fit
        mem_correction = _memory_correction()
        if mem_correction > 1.0:
            threshold /= mem_correction
    comm_factor = 0.5 if (getattr(config, "allow_mixed_precision", True)
                          and machine_spec.chip != "cpu-sim") else 1.0
    # the learned cost table of the device's platform (None: no model,
    # another platform's, or FFS_NO_LEARNED_COSTS); a table that fails to
    # load (a newer schema, a malformed class) prices analytically, as
    # the reference does
    try:
        from flexflow_tpu_torch.costmodel import load_native_table
        learned = load_native_table(device=device)
    except Exception:
        learned = None
    # provenance is about this graph: classes (per-impl "TYPE:impl" ones
    # by their base type) that meet none of its op types price nothing
    graph_types = {n.op.op_type.name for n in nodes}
    learned_classes = sorted(
        c for c in set((learned or {}).get("classes") or ())
        if c.split(":", 1)[0] in graph_types)
    request = dict(
        nodes=serialize_graph(
            nodes,
            final_guid=final_ref[0] if final_ref is not None else None),
        machine=machine_to_json(machine_spec, num_devices,
                                comm_bytes_factor=comm_factor,
                                learned=learned),
        config=dict(
            budget=config.search_budget,
            alpha=config.search_alpha,
            only_data_parallel=config.only_data_parallel,
            enable_parameter_parallel=config.enable_parameter_parallel
                or config.enable_attribute_parallel,
            overlap=config.search_overlap_backward_update,
            # INFERENCE: forward-only cost model (no backward, no gradient
            # sync, no optimizer-state memory)
            training=getattr(config, "computation_mode",
                             CompMode.TRAINING) == CompMode.TRAINING,
            memory_threshold=threshold,
            seed=config.seed,
            batch=batch,
            rules=rules,
            enable_substitution=getattr(config, "enable_substitution", True),
            enable_sample_parallel=getattr(config, "enable_sample_parallel",
                                           True),
            # optimizer-state copies (0 SGD / 1 momentum / 2 Adam), set by
            # FFModel.compile from the optimizer
            opt_state_factor=getattr(config, "opt_state_factor", 2.0),
            enable_pipeline_parallel=getattr(
                config, "enable_pipeline_parallel", True),
            pipeline_microbatches=getattr(
                config, "pipeline_microbatches", 0),
            pipeline_schedule=getattr(config, "pipeline_schedule", "auto"),
            pipeline_shard_queue=getattr(config, "pipeline_shard_queue",
                                         True),
            perform_fusion=getattr(config, "perform_fusion", True),
            weight_update_sharding=getattr(config, "weight_update_sharding",
                                           "auto"),
            comm_overlap=("off" if str(getattr(
                config, "overlap_bucket_mb", "auto")).lower() in ("0", "off")
                else "auto"),
            kernel_search=("off" if switched_off(
                config, "kernel_search", "FFS_NO_KERNEL_SEARCH") else "auto"),
            remat_search=("off" if switched_off(
                config, "remat_search", "FFS_NO_REMAT") else "auto"),
            emit_search_trace=bool(getattr(config, "search_trace", False)
                                   or os.environ.get("FFS_SEARCH_TRACE")),
        ),
        measured=measured or {},
    )
    # repeated-block pipeline metadata: lets the core price 'pipe' meshes
    pipe_blocks = None
    if getattr(config, "enable_pipeline_parallel", True):
        from flexflow_tpu_torch.parallel.pipeline_detect import (
            detect_repeated_blocks, pipeline_meta_json)
        pipe_blocks = detect_repeated_blocks(nodes)
        if pipe_blocks is not None:
            request["pipeline"] = pipeline_meta_json(nodes, pipe_blocks)
    if subst_rules is not None:
        request["subst_rules"] = subst_rules
    if final_ref is not None:
        request["final"] = [int(final_ref[0]), int(final_ref[1])]
    resp = native_optimize(request)
    new_nodes = nodes
    new_final = final_ref
    if resp.get("rewrites"):
        from flexflow_tpu_torch.search.rewrite import apply_rewrites
        new_nodes, new_final = apply_rewrites(nodes, resp["rewrites"],
                                              final_ref)
    mesh_axes, strategy = decode_strategy(resp, new_nodes)
    # the objective is part of the answer: TRAINING minimizes the step
    # time, INFERENCE the per-batch latency
    objective = "step_time" if request["config"]["training"] else "latency"
    info = dict(predicted_time=resp.get("predicted_time"),
                predicted_memory=resp.get("predicted_memory"),
                memory_correction=mem_correction,
                objective=objective,
                cost_model="learned" if learned_classes else "analytic",
                stats=resp.get("stats", {}),
                rewrites=resp.get("rewrites", []))
    if learned_classes:
        info["learned_cost_classes"] = learned_classes
    if resp.get("search_trace"):
        trace = dict(resp["search_trace"])
        trace.setdefault("objective", objective)
        info["search_trace"] = trace
    if resp.get("overlap"):
        info["overlap"] = resp["overlap"]
    if resp.get("pipeline") and mesh_axes.get("pipe", 1) > 1:
        # rewrites never fire together with pipe meshes, so the detected
        # blocks still index new_nodes == nodes
        info["pipeline"] = dict(resp["pipeline"], blocks=pipe_blocks)
    if new_nodes is not nodes:
        info["rewritten_nodes"] = new_nodes
        info["final_ref"] = new_final
        # static rewrite verification (FFL213): the accepted rewrite's
        # post-rewrite edge-spec map must be collective-equivalent-or-
        # cheaper than the pre-rewrite map under the same strategy — a
        # substitution that wins on op-local simulated terms while
        # opening a reshard seam is caught here, before compile
        from flexflow_tpu_torch.analysis.dataflow import \
            verify_rewrite_dataflow
        try:
            info["rewrite_verification"] = verify_rewrite_dataflow(
                nodes, new_nodes, strategy, dict(mesh_axes),
                rewrites=resp.get("rewrites", []))
        except Exception as e:  # never let verification break the search
            info["rewrite_verification"] = dict(
                ok=True, findings=[], error=repr(e))
    # the whole call's host time: serialization, the core, decoding
    info["search_wall_s"] = time.perf_counter() - t0
    return mesh_axes, strategy, info


def _memory_correction() -> float:
    """The median measured/predicted memory ratio (``mem_ratio``) of the
    port's calibration file's rows (``python -m
    flexflow_tpu_torch.scripts.calibrate`` writes them; the file is
    ``search/profile.py`` ``calibration_path``), 1.0 when none exist."""
    from flexflow_tpu_torch.search.profile import read_calibration

    ratios = sorted(r["mem_ratio"]
                    for r in read_calibration().get("results", [])
                    if isinstance(r.get("mem_ratio"), (int, float))
                    and r["mem_ratio"] > 0)
    if not ratios:
        return 1.0
    return float(ratios[len(ratios) // 2])


# ---- strategy files (--export-strategy / --import-strategy) ---------------

def strategy_json(mesh_axes: Dict[str, int], strategy: Strategy,
                  nodes, objective: Optional[str] = None) -> Dict[str, Any]:
    """The body of a strategy file: ops keyed by name (stable across runs
    and packages, unlike guids)."""
    by_guid = {n.op.guid: n.op.name for n in nodes}
    ops = {}
    for guid, st in strategy.items():
        name = by_guid.get(guid)
        if name is None:
            continue
        ops[name] = dict(
            choice=st.choice,
            outputs=[list(s) if s is not None else None
                     for s in st.output_specs],
            params={k: list(v) for k, v in st.param_specs.items()},
        )
    out = dict(version=1, mesh=dict(mesh_axes), ops=ops)
    if objective:
        # "step_time" (TRAINING) or "latency" (INFERENCE)
        out["objective"] = objective
    return out


def export_strategy_file(path: str, mesh_axes: Dict[str, int],
                         strategy: Strategy, nodes,
                         objective: Optional[str] = None) -> None:
    with open(path, "w") as f:
        json.dump(strategy_json(mesh_axes, strategy, nodes,
                                objective=objective), f, indent=1)


def _spec_of(entries) -> Tuple:
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


def import_strategy_file(path: str, nodes
                         ) -> Tuple[Dict[str, int], Strategy]:
    """Read a strategy file written by either package -> (mesh axes,
    strategy) for the ops of ``nodes`` the file names, for a mesh of any
    size; ``FFModel.compile`` refuses what it cannot run."""
    with open(path) as f:
        return strategy_from_json(json.load(f), nodes)


def strategy_from_json(data: Dict[str, Any], nodes
                       ) -> Tuple[Dict[str, int], Strategy]:
    """A strategy file's body (``strategy_json``) -> (mesh axes,
    strategy) for the ops of ``nodes`` it names."""
    mesh_axes = {k: int(v) for k, v in data["mesh"].items()}
    strategy: Strategy = {}
    for node in nodes:
        oj = data["ops"].get(node.op.name)
        if oj is None:
            continue
        strategy[node.op.guid] = OpStrategy(
            output_specs=[_spec_of(e) if e is not None else None
                          for e in oj.get("outputs", [])],
            param_specs={k: _spec_of(v)
                         for k, v in oj.get("params", {}).items()},
            choice=oj.get("choice"))
    return mesh_axes, strategy
