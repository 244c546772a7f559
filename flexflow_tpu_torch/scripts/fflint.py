"""fflint CLI — static strategy & graph verifier over the model zoo.

PyTorch counterpart of the JAX package's ``scripts/fflint.py``: the same
zoo names, CPU-sized configs, flags, report and exit codes. Builds a zoo
model, lays it out as ``compile`` would (``analysis.orchestrator
.plan_model``: the strategy, its specs and the executor's record; no
parameter is allocated and no training step runs) and runs the fflint
pass pipeline (``flexflow_tpu_torch/analysis``) over the materialized
PCG and the chosen strategy. Exit code 1 when any ERROR-severity
diagnostic fires, 2 when a model fails to build or compile.

    python -m flexflow_tpu_torch.scripts.fflint --model mlp
    python -m flexflow_tpu_torch.scripts.fflint --all --json --device cpu
    python -m flexflow_tpu_torch.scripts.fflint --model resnet \\
        --layout nhwc --lint-out out.json
    python -m flexflow_tpu_torch.scripts.fflint --model llama --budget 4 \\
        --edges

The devices: on the CPU (``--device cpu``) the model is planned over 8
devices, the JAX package's virtual CPU slice, so a strategy has sharding
for the passes to verify; on the card (the default) over the visible
cards. ``--hlo`` adds the emitted-side checks from the step's NCCL
census, which is empty on one card (``analysis.lint_model``).

``--edges`` additionally renders the per-edge reshard table
(``analysis/dataflow.py``): every producer→consumer spec disagreement
with the collective it implies — kind, per-device bytes, mesh axes,
fabric (ici|dcn) — plus the generalized tiny-batch weight-movement
edges. With ``--json`` the table lands under ``edge_reshards``; the
exit code is nonzero whenever an unpriced edge fires FFL205/FFL210.

``--model all`` / ``--all`` sweeps every zoo model and merges the
reports into one JSON document keyed by model name.
"""

from __future__ import annotations

import argparse
import json
import sys

ZOO = ["mlp", "alexnet", "resnet", "resnext", "inception", "dlrm", "xdl",
       "candle_uno", "moe", "moe_encoder", "transformer", "llama"]

# the planned device count on the CPU: the JAX package's virtual slice
CPU_DEVICES = 8


def build_model(name: str, ff_config, device=None):
    """CPU-sized zoo configs (the JAX package's tests' sizes), on
    ``device`` (None: the card): build only — compile is the caller's job
    so search/mesh flags apply uniformly. Returns (model, loss kind)."""
    if name == "mlp":
        from flexflow_tpu_torch.models.mlp import create_mlp
        return create_mlp(batch_size=16, in_dim=64, hidden_dims=(128, 128),
                          out_dim=10, ff_config=ff_config,
                          device=device), "cat"
    if name == "alexnet":
        from flexflow_tpu_torch.models.alexnet import create_alexnet
        return create_alexnet(batch_size=8, num_classes=10,
                              ff_config=ff_config, device=device), "cat"
    if name == "resnet":
        from flexflow_tpu_torch.models.resnet import (ResNetConfig,
                                                      create_resnet)
        return create_resnet(
            ResNetConfig(batch_size=8, image_size=64, stages=(1, 1, 1, 1)),
            ff_config, device=device), "cat"
    if name == "resnext":
        from flexflow_tpu_torch.models.resnext import (ResNeXtConfig,
                                                       create_resnext50)
        return create_resnext50(
            ResNeXtConfig(batch_size=8, image_size=64, stages=(1, 1, 1, 1),
                          cardinality=8), ff_config, device=device), "cat"
    if name == "inception":
        from flexflow_tpu_torch.models.inception import (InceptionConfig,
                                                         create_inception_v3)
        return create_inception_v3(
            InceptionConfig(batch_size=8, image_size=75, num_classes=10),
            ff_config, device=device), "cat"
    if name == "dlrm":
        from flexflow_tpu_torch.models.dlrm import DLRMConfig, create_dlrm
        return create_dlrm(
            DLRMConfig(batch_size=8, vocab_size=1000, num_sparse_features=4),
            ff_config, device=device), "mse"
    if name == "xdl":
        from flexflow_tpu_torch.models.xdl import XDLConfig, create_xdl
        return create_xdl(XDLConfig(batch_size=8,
                                    embedding_size=(1000, 1000)),
                          ff_config, device=device), "cat"
    if name == "candle_uno":
        from flexflow_tpu_torch.models.candle_uno import (CandleUnoConfig,
                                                          create_candle_uno)
        return create_candle_uno(
            CandleUnoConfig(batch_size=8, dense_layers=(32,) * 2,
                            dense_feature_layers=(32,) * 2,
                            input_features={"dose1": 1, "cell": 24,
                                            "drug_desc": 40}),
            ff_config, device=device), "mse"
    if name == "moe":
        from flexflow_tpu_torch.models.moe_model import MoEConfig, create_moe
        return create_moe(
            MoEConfig(batch_size=16, input_dim=32, num_exp=4, num_select=2,
                      hidden_size=16), ff_config, device=device), "cat"
    if name == "moe_encoder":
        from flexflow_tpu_torch.models.moe_model import (MoEConfig,
                                                         create_moe_encoder)
        return create_moe_encoder(
            MoEConfig(batch_size=4, num_encoder_layers=2, hidden_size=16,
                      num_exp=2, num_select=1, seq_length=8, num_classes=5),
            ff_config, device=device), "mse"
    if name == "transformer":
        from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                           create_transformer)
        return create_transformer(
            TransformerConfig(num_layers=2, hidden_size=128, num_heads=4,
                              seq_length=64, batch_size=16),
            ff_config, device=device), "mse"
    if name == "llama":
        from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                     create_llama)
        return create_llama(LlamaModelConfig(), ff_config,
                            device=device), "cat"
    raise SystemExit(f"unknown --model {name!r} (zoo: {', '.join(ZOO)})")


def planned_devices(device) -> int:
    """The devices a lint lays the model out over: 8 on the CPU, the
    visible cards on CUDA."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return CPU_DEVICES


def compile_model(ff, loss_kind: str, num_devices=None):
    """Plan ``ff`` as ``compile`` would (SGD, the zoo's loss) over
    ``num_devices`` (default ``planned_devices``), allocating nothing."""
    from flexflow_tpu_torch.analysis.orchestrator import plan_model
    from flexflow_tpu_torch.ffconst import LossType
    from flexflow_tpu_torch.optimizers import SGDOptimizer
    loss = (LossType.MEAN_SQUARED_ERROR_AVG_REDUCE if loss_kind == "mse"
            else LossType.SPARSE_CATEGORICAL_CROSSENTROPY)
    n = num_devices if num_devices is not None else planned_devices(
        ff.device)
    return plan_model(ff, n, SGDOptimizer(lr=0.01), loss)


def edge_table_json(ff) -> list:
    """The per-edge reshard table of the planned model, as JSON rows —
    implicit insertions first, then explicit boundaries, then the
    generalized tiny-batch weight-movement edges."""
    from flexflow_tpu_torch.analysis import (LintContext, edge_reshard_table,
                                             weight_movement_edges)
    ctx = LintContext(
        nodes=ff.executor.nodes, mesh=ff.mesh, strategy=ff.strategy,
        machine_spec=ff.machine_spec, config=ff.config,
        final_ref=ff.executor.final_ref, ff=ff)
    rows = [e.to_json() for e in
            sorted(edge_reshard_table(ctx),
                   key=lambda e: (e.explicit, -e.bytes))]
    rows += [dict(e.to_json(), weight_movement=True)
             for e in weight_movement_edges(ctx)]
    return rows


def format_edges(rows: list) -> str:
    lines = []
    for r in rows:
        tag = ("wmove" if r.get("weight_movement")
               else "explicit" if r["explicit"] else "implicit")
        lines.append(
            f"  {tag:<8} {r['edge']}  {r['src_spec']} -> {r['dst_spec']}"
            f"  {r['kind']} {r['bytes'] / 1e6:.3f} MB"
            f" [{'+'.join(r['axes']) or '-'}/{r['fabric']}]"
            + (f" ({r['reason']})" if r.get("reason") else ""))
    return "\n".join(lines) if lines else "  (no edge reshards)"


def lint_one(name: str, args):
    """Build, plan and lint one zoo model; returns its LintReport."""
    from flexflow_tpu_torch.analysis import lint_model
    from flexflow_tpu_torch.config import FFConfig

    cfg = FFConfig(conv_compute_layout=args.layout)
    if args.budget:
        cfg.search_budget = args.budget
        cfg.enable_parameter_parallel = True
        cfg.enable_pipeline_parallel = False
    ff, loss_kind = build_model(name, cfg, device=args.device)
    compile_model(ff, loss_kind)
    report = lint_model(ff, hlo=True if args.hlo else None)
    report.context["model"] = name
    if getattr(args, "edges", False):
        report.context["edge_reshards"] = edge_table_json(ff)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default=None,
                    help=f"zoo model ({', '.join(ZOO)}) or 'all'")
    ap.add_argument("--all", action="store_true",
                    help="lint every zoo model")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--hlo", action="store_true",
                    help="also run the emitted-side checks on the step's "
                         "collective census")
    ap.add_argument("--budget", type=int, default=0,
                    help="search budget: lint the SEARCHED strategy "
                         "instead of the data-parallel default")
    ap.add_argument("--edges", action="store_true",
                    help="include the per-edge reshard table (kind, "
                         "bytes, axes, fabric per producer->consumer "
                         "spec disagreement)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "nhwc", "nchw"],
                    help="conv compute layout for the layout pass")
    ap.add_argument("--lint-out", default=None,
                    help="also write the JSON report to this path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model is built (default the card; the "
                         "CPU plans 8 devices)")
    args = ap.parse_args(argv)

    models = ZOO if (args.all or args.model in (None, "all")) \
        else [args.model]
    merged = {}
    rc = 0
    for name in models:
        try:
            report = lint_one(name, args)
        except Exception as e:
            merged[name] = dict(error=f"build/compile failed: {e!r}")
            print(f"== {name}: build/compile failed: {e!r}",
                  file=sys.stderr)
            rc = 2
            continue
        merged[name] = report.to_json()
        if report.has_errors():
            rc = rc or 1
        if not args.json:
            edges = report.context.pop("edge_reshards", None)
            print(f"== {name}")
            print(report.format_human())
            if edges is not None:
                print(f"-- edge reshard table ({len(edges)} edges)")
                print(format_edges(edges))
    doc = merged if len(models) > 1 else merged[models[0]]
    if args.json:
        print(json.dumps(doc, indent=1))
    if args.lint_out:
        with open(args.lint_out, "w") as f:
            json.dump(doc, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
