"""Per-layer roofline attribution and the layout / batch A/B of the port.

Times every op of a model standalone on the device (``obs/roofline.py``
over ``search/profile.py``'s CUDA-graph slope timing on the card, the
host clock on the CPU), counts its FLOPs and bytes at the compute
dtype's width against the machine's peaks, and names each op compute-
or bandwidth-bound. Writes ``<out>.json`` (rows and per-class
aggregates) and ``<out>.md`` (the table), and prints one JSON line.

    python -m flexflow_tpu_torch.scripts.roofline --model inception \\
        --batch 16 --layout nhwc
    python -m flexflow_tpu_torch.scripts.roofline --model inception --ab \\
        --batches 8,64
    python -m flexflow_tpu_torch.scripts.roofline --model bert --device cpu
    python -m flexflow_tpu_torch.scripts.roofline --model moe

``--layout`` is the conv family's execution layout (``layout.py``:
"auto" is channels-last on the card, NCHW on the CPU). ``--ab`` also
times full training steps (``fit``, best of two windows) for every
(layout, batch) cell, NCHW against NHWC in one process. The conv-class
``efficiency`` aggregate is the figure for ``MachineSpec.conv_efficiency``.
The card is used unless ``--device cpu`` asks for the CPU (which takes
the JAX package's reduced CPU configurations).
"""

import argparse
import json
import os
import sys
import time


def build_model(name, batch, layout, device, image_size=None):
    """(compiled model, inputs, labels) of ``name`` at ``batch`` on
    ``device``, the conv layout ``layout``; the CPU builds the reduced
    configurations the JAX package's script takes there."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.ffconst import LossType
    from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer

    on_cpu = torch.device(device).type == "cpu"
    rs = np.random.RandomState(0)
    cfg_kw = dict(conv_compute_layout=layout)
    if name == "inception":
        from flexflow_tpu_torch.models.inception import (InceptionConfig,
                                                         create_inception_v3)
        mc = InceptionConfig(
            batch_size=batch,
            image_size=image_size or (75 if on_cpu else 299),
            num_classes=10 if on_cpu else 1000,
            reduced=on_cpu)
        ff = create_inception_v3(mc, FFConfig(batch_size=batch, **cfg_kw),
                                 device=device)
        ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                   LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        x = rs.randn(batch, 3, mc.image_size, mc.image_size).astype(np.float32)
        y = rs.randint(0, mc.num_classes, (batch, 1)).astype(np.int32)
        return ff, [x], y
    if name == "bert":
        from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                           create_transformer)
        mc = (TransformerConfig(num_layers=2, hidden_size=128, num_heads=4,
                                seq_length=64, batch_size=batch)
              if on_cpu else TransformerConfig(batch_size=batch))
        ff = create_transformer(mc, FFConfig(batch_size=batch, **cfg_kw),
                                device=device)
        ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
        x = rs.randn(batch, mc.seq_length, mc.hidden_size).astype(np.float32)
        y = rs.randn(batch, mc.seq_length, 1).astype(np.float32)
        return ff, [x], y
    if name == "dlrm":
        from flexflow_tpu_torch.models.dlrm import DLRMConfig, create_dlrm
        mc = (DLRMConfig(batch_size=batch, num_sparse_features=4,
                         vocab_size=1000, embedding_dim=16) if on_cpu else
              DLRMConfig(batch_size=batch, num_sparse_features=8,
                         vocab_size=1000000, embedding_dim=64))
        ff = create_dlrm(mc, FFConfig(batch_size=batch, **cfg_kw),
                         device=device)
        ff.compile(SGDOptimizer(lr=0.01),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
        xs = []
        for n in ff.executor.input_names:
            if n.startswith("sparse"):
                xs.append(rs.randint(0, mc.vocab_size,
                                     (batch, mc.indices_per_feature))
                          .astype(np.int32))
            else:
                xs.append(rs.randn(batch, mc.dense_dim).astype(np.float32))
        y = rs.randint(0, 2, (batch, 1)).astype(np.float32)
        return ff, xs, y
    if name == "moe":
        from flexflow_tpu_torch.models.moe_model import MoEConfig, create_moe
        mc = (MoEConfig(batch_size=batch, input_dim=64, num_exp=4,
                        num_select=2, hidden_size=32) if on_cpu else
              MoEConfig(batch_size=batch, input_dim=1024, num_exp=16,
                        num_select=2, hidden_size=1024, num_classes=1000))
        ff = create_moe(mc, FFConfig(batch_size=batch, **cfg_kw),
                        device=device)
        ff.compile(SGDOptimizer(lr=0.01),
                   LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
        x = rs.randn(batch, mc.input_dim).astype(np.float32)
        y = rs.randint(0, mc.num_classes, (batch, 1)).astype(np.int32)
        return ff, [x], y
    raise SystemExit(f"unknown --model {name!r}")


def step_throughput(ff, xs, y, iters, windows):
    """Training samples/s: the best of ``windows`` runs of ``iters``
    ``fit`` steps, after one warm-up step (the capture). ``fit`` ends each
    window with its host read of the loss."""
    batch = xs[0].shape[0]
    inputs = xs if len(xs) > 1 else xs[0]
    ff.fit(inputs, y, epochs=1, verbose=False)
    best = None
    for _ in range(windows):
        t0 = time.perf_counter()
        ff.fit(inputs, y, epochs=iters, verbose=False)
        sps = batch * iters / (time.perf_counter() - t0)
        best = sps if best is None else max(best, sps)
    return best


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m flexflow_tpu_torch.scripts.roofline",
        description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="inception",
                    choices=["inception", "bert", "dlrm", "moe"])
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size (default: 8 on the CPU, 16 on the card)")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "nhwc", "nchw"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the ops run (default the card)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-bwd", action="store_true",
                    help="skip backward timing (faster)")
    ap.add_argument("--ab", action="store_true",
                    help="also run full-step layout x batch A/Bs")
    ap.add_argument("--batches", default="8,64",
                    help="comma list of batch sizes for --ab")
    ap.add_argument("--iters", type=int, default=None,
                    help="A/B steps per timing window")
    ap.add_argument("--out", default=None,
                    help="output stem (default roofline_<model>_<layout>)")
    args = ap.parse_args(argv)

    from flexflow_tpu_torch.machine import resolve_device
    from flexflow_tpu_torch.obs.artifacts import device_identity
    from flexflow_tpu_torch.obs.roofline import (finish_aggregates,
                                                 format_markdown,
                                                 roofline_report)
    from flexflow_tpu_torch.version import __version__

    device = resolve_device(args.device)
    on_cpu = device.type == "cpu"
    platform, kind = device_identity(device)
    batch = args.batch or (8 if on_cpu else 16)
    print(f"[roofline] building {args.model} batch={batch} "
          f"layout={args.layout} on {kind}", file=sys.stderr)
    ff, xs, y = build_model(args.model, batch, args.layout, device,
                            args.image_size)
    report = roofline_report(ff.executor.nodes, ff.machine_spec,
                             repeats=args.repeats,
                             include_bwd=not args.no_bwd, device=device,
                             dtype=ff.executor.compute_dtype)
    report["meta"].update(model=args.model, batch=batch,
                          layout=args.layout,
                          layout_info=dict(ff.layout_info,
                                           boundaries=None),
                          platform=platform, device=kind,
                          version=__version__)
    finish_aggregates(report["classes"], report["machine"]["peak_flops"])

    if args.ab:
        iters = args.iters or (3 if on_cpu else 10)
        ab = []
        del ff
        for layout in ("nchw", "nhwc"):
            for b in [int(s) for s in args.batches.split(",")]:
                try:
                    m, mxs, my = build_model(args.model, b, layout, device,
                                             args.image_size)
                    sps = step_throughput(m, mxs, my, iters=iters, windows=2)
                    cell = dict(layout=layout, batch=b,
                                samples_per_s=round(sps, 3),
                                steps_per_s=round(sps / b, 4))
                    del m
                except Exception as e:
                    cell = dict(layout=layout, batch=b,
                                error=f"{type(e).__name__}: {e}")
                print(f"[roofline] A/B {cell}", file=sys.stderr)
                ab.append(cell)
        report["ab"] = ab

    out = args.out or f"roofline_{args.model}_{args.layout}"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out + ".json", "w") as f:
        json.dump(report, f, indent=1)
    md = format_markdown(report)
    if args.ab:
        md += "\n\nFull-step A/B (samples/s, one process):\n\n" \
              "| layout | batch | samples/s | steps/s |\n|---|---|---|---|\n"
        for c in report["ab"]:
            md += (f"| {c['layout']} | {c['batch']} "
                   f"| {c.get('samples_per_s', c.get('error'))} "
                   f"| {c.get('steps_per_s', '')} |\n")
    with open(out + ".md", "w") as f:
        f.write(f"# Roofline: {args.model} (batch {batch}, "
                f"layout {args.layout}, {kind})\n\n" + md + "\n")
    print(f"[roofline] wrote {out}.json {out}.md", file=sys.stderr)
    conv = report["classes"].get("conv") or {}
    print(json.dumps(dict(
        model=args.model, batch=batch, layout=args.layout,
        conv_efficiency=conv.get("efficiency"),
        classes={k: dict(ops=v["ops"], efficiency=v.get("efficiency"))
                 for k, v in report["classes"].items()},
        ab=report.get("ab"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
