"""Shared driver glue for the example programs of the PyTorch port.

Counterpart of the JAX package's ``examples/common.py`` and the original
examples' top_level_task pattern (e.g.
examples/cpp/Transformer/transformer.cc:105-211): parse ``FFConfig``
flags, build the model, generate synthetic data, run the iterations loop
through ``set_batch`` / ``forward`` / ``zero_gradients`` / ``backward``
/ ``update``, and print ``ELAPSED TIME = .. THROUGHPUT = .. samples/s``
(the metric the osdi22ae scripts grep). The model runs on the card;
``--device cpu`` runs it on the CPU. Every ``FFConfig`` flag applies
(``--budget``, ``--import-strategy``, ``--lint off|warn|error``, ...).

The scripts are the JAX package's ``examples/`` eleven: alexnet,
candle_uno, dlrm, inception, llama_lm, mlp, moe, resnet, resnext,
transformer and xdl, each at the reference's config and flags.
``multihost_train.py`` comes with the port's multi-device and multi-host
execution (ROADMAP.md Queue 1 items 3 and 13).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flexflow_tpu_torch import FFConfig, LossType, MetricsType  # noqa: E402
from flexflow_tpu_torch.optimizers import SGDOptimizer  # noqa: E402


def parse_config(argv=None) -> FFConfig:
    """``FFConfig`` from ``argv`` (default ``sys.argv[1:]``); the flags it
    does not read stay in ``cfg._rest``, and ``--device cuda|cpu``
    (default the card) in ``cfg._device``."""
    cfg = FFConfig()
    rest = cfg.parse_args(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in rest:
        i = rest.index("--device")
        if i + 1 >= len(rest) or rest[i + 1] not in ("cuda", "cpu"):
            raise ValueError("--device expects cuda|cpu")
        device = rest[i + 1]
        del rest[i:i + 2]
    cfg._rest = rest
    cfg._device = device
    return cfg


def train_synthetic(ff, cfg: FFConfig, input_specs, label_shape,
                    loss=LossType.SPARSE_CATEGORICAL_CROSSENTROPY,
                    metrics=(MetricsType.ACCURACY,), classes=None,
                    optimizer=None, iterations=None):
    """input_specs: list of (shape_without_batch, dtype, high) tuples.
    The data are the JAX package's draws from ``cfg.seed``."""
    ff.compile(optimizer or SGDOptimizer(lr=cfg.learning_rate), loss,
               list(metrics))
    axes = dict(ff.mesh.shape)
    print(f"mesh: {axes}" + (
        f"  search: predicted {ff.search_info['predicted_time'] * 1e3:.3f} ms"
        if ff.search_info else "  (data-parallel default)"))
    bs = ff.input_tensors[0].shape[0]
    iters = iterations or max(cfg.iterations, 4)
    rs = np.random.RandomState(cfg.seed)
    xs = []
    for shape, dtype, high in input_specs:
        if np.issubdtype(np.dtype(dtype), np.integer):
            xs.append(rs.randint(0, high, (bs,) + tuple(shape)).astype(dtype))
        else:
            xs.append(rs.randn(bs, *shape).astype(dtype))
    if classes:
        y = rs.randint(0, classes, label_shape and (bs,) + tuple(label_shape)
                       or (bs, 1)).astype(np.int32)
    else:
        y = rs.randn(bs, *label_shape).astype(np.float32)

    ff.set_batch(xs if len(xs) > 1 else xs[0], y)
    ff.forward(); ff.backward(); ff.update()  # warmup / capture
    start = time.time()
    for _ in range(iters):
        ff.forward()
        ff.zero_gradients()
        ff.backward()
        ff.update()
    float(ff._last_loss)  # a host read: the last step has finished
    elapsed = time.time() - start
    thr = bs * iters / elapsed
    print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = {thr:.2f} samples/s")
    return thr
