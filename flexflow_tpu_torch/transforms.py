"""Exact graph transforms on a compiled model.

PyTorch counterpart of ``flexflow_tpu/transforms.py``.
``fold_conv_batchnorm`` is the offline Conv+BatchNorm fold: an explicit
pass over a compiled INFERENCE model with its live weights (the eval
fold, ``layout.FoldedConvBN``, is the automatic one that every eval and
forward runs). From the model's BN parameters and running statistics it
computes, per output channel,

    k' = k * (gamma / sqrt(var + eps))
    b' = beta + (b - mean) * gamma / sqrt(var + eps)

removes the BN layers (a BN's ReLU becomes its conv's activation),
recompiles, and installs the folded weights, carrying every other
parameter and op state over: the same function with one op fewer a pair.
"""

from __future__ import annotations

import numpy as np
import torch

from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY
from flexflow_tpu_torch.ffconst import ActiMode, CompMode, OperatorType


def fold_conv_batchnorm(ff) -> int:
    """Fold every Conv2D -> BatchNorm pair of a compiled INFERENCE model.
    Returns the number of folds; the model is recompiled with its other
    weights and op state carried over. Raises under TRAINING."""
    if ff.config.computation_mode != CompMode.INFERENCE:
        raise ValueError(
            "fold_conv_batchnorm requires CompMode.INFERENCE: under "
            "training the BN statistics are batch-dependent and cannot "
            "fold into constants")

    consumers = {}
    for layer in ff.layers:
        for t in layer.inputs:
            consumers.setdefault(t.guid, []).append(layer)
    pairs = []
    for bn in ff.layers:
        if bn.op_type != OperatorType.BATCHNORM:
            continue
        src = bn.inputs[0].owner_layer
        if (src is not None and src.op_type == OperatorType.CONV2D
                and src.properties.get("activation",
                                       ActiMode.AC_MODE_NONE)
                in (ActiMode.AC_MODE_NONE, None)
                and len(consumers.get(bn.inputs[0].guid, [])) == 1):
            pairs.append((src, bn))
    if not pairs:
        return 0

    # the live weights, before the graph changes
    folded = {}
    for conv, bn in pairs:
        k = ff.get_parameter(conv.name, "kernel")
        b = (ff.get_parameter(conv.name, "bias")
             if conv.properties.get("use_bias", True)
             else np.zeros((k.shape[0],), np.float32))
        gamma = ff.get_parameter(bn.name, "scale")
        beta = ff.get_parameter(bn.name, "bias")
        st = ff.state.get(bn.name, {})
        mean = _host(st.get("mean"), np.zeros_like(gamma))
        var = _host(st.get("var"), np.ones_like(gamma))
        g = gamma / np.sqrt(var + bn.properties.get("eps", 1e-5))
        folded[conv.name] = (k * g[:, None, None, None], beta + (b - mean) * g,
                             bool(bn.properties.get("relu", True)))

    # the weights and op state to carry over (compile re-initializes them)
    bn_names = {bn.name for _, bn in pairs}
    others = [(lname, {p: ff.get_parameter(lname, p) for p in sub})
              for lname, sub in ff.params.items()
              if lname not in folded and lname not in bn_names]
    state_save = {lname: {k: _host(v, None) for k, v in sub.items()}
                  for lname, sub in ff.state.items()
                  if lname not in bn_names and lname != COMPUTE_PARAMS_KEY
                  and isinstance(sub, dict)}

    # the surgery: drop the BNs, rewire their consumers to the conv
    # output, give the conv a bias and the BN's ReLU
    remap = {bn.outputs[0].guid: conv.outputs[0] for conv, bn in pairs}
    ff.layers = [l for l in ff.layers if l.name not in bn_names]
    for layer in ff.layers:
        layer.inputs = [remap.get(t.guid, t) for t in layer.inputs]
    for conv, _ in pairs:
        conv.properties["use_bias"] = True
        if folded[conv.name][2]:
            conv.properties["activation"] = ActiMode.AC_MODE_RELU
    if getattr(ff, "outputs", None) is not None \
            and ff.outputs.guid in remap:
        ff.outputs = remap[ff.outputs.guid]

    ff.compile(ff.optimizer, ff.loss_type, list(ff.metrics),
               comp_mode=CompMode.INFERENCE,
               machine_spec=ff.machine_spec, mesh=ff.mesh)

    # the recompiled graph is the old one less the BNs: every carried
    # weight must land, or the fold broke the graph
    failed = []
    for lname, sub in others:
        for pname, value in sub.items():
            try:
                ff.set_parameter(lname, value, pname)
            except (KeyError, ValueError) as e:
                failed.append((lname, pname, str(e)))
    if failed:
        raise RuntimeError(
            "fold_conv_batchnorm: failed to restore carried-over weights "
            f"after recompile: {failed}")
    with torch.no_grad():
        for lname, sub in state_save.items():
            live = ff.state.get(lname)
            if not isinstance(live, dict):
                continue
            for k, value in sub.items():
                old = live.get(k)
                if old is not None and tuple(old.shape) == value.shape:
                    old.copy_(torch.from_numpy(value))
    for conv, _ in pairs:
        k, b, _relu = folded[conv.name]
        ff.set_parameter(conv.name, np.asarray(k, np.float32), "kernel")
        ff.set_parameter(conv.name, np.asarray(b, np.float32), "bias")
    return len(pairs)


def _host(t, default):
    """An op-state leaf as a host f32 array (``default`` where absent)."""
    if t is None:
        return default
    return t.detach().to("cpu", torch.float32).numpy()
