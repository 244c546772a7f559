"""Carry parameters and optimizer state across from the JAX package.

JAX's PRNG has no torch twin, so parity between the two packages goes
through the JAX model's initialized parameters, copied into the port. The
layouts are identical by construction (dense ``kernel [in, out]`` and
``bias [out]``, LayerNorm ``scale``/``bias``, attention ``wq/wk/wv
[H, E, D]``, ``wo [H, D, E]``, ``bo [E]``, embedding ``kernel
[entries, out]``, conv ``kernel [Cout, Cin/groups, KH, KW]`` (OIHW in
both packages) and ``bias [Cout]``, BatchNorm and GroupNorm
``scale``/``bias [C]``), so the copy is a cast and a device move. Op state
(BatchNorm's running ``mean``/``var``) carries across the same way
(``from_jax_state``). Over a process group each rank keeps its box of
every leaf, cut from the whole array by the leaf's spec (the box JAX's
device of the same index holds), and ``to_jax_params`` gathers the
whole arrays back on every rank.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY


def from_jax_params(params: Mapping[str, Mapping[str, np.ndarray]],
                    model=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``params``: the JAX model's parameter tree as numpy arrays,
    ``{layer_name: {param_name: array}}`` (``np.asarray`` of each leaf of
    ``ff.params``; a ``__compute_params__`` entry, the JAX state's compute
    copy, is refused).

    With ``model`` (a compiled port ``FFModel``): checks that the trees
    match leaf for leaf — raising on a missing, extra or misshapen leaf —
    copies every leaf into the model's parameters, refreshes the compute
    copy, and returns ``model.params``. Without: returns the tree as CPU
    f32 tensors."""
    if COMPUTE_PARAMS_KEY in params:
        raise ValueError(f"{COMPUTE_PARAMS_KEY!r} is the JAX state's compute "
                         f"copy, not a parameter; pass ff.params")
    if model is None:
        return {layer: {name: torch.tensor(np.asarray(a), dtype=torch.float32)
                        for name, a in sub.items()}
                for layer, sub in params.items()}
    ours = model.params
    missing = sorted(f"{l}/{n}" for l, sub in ours.items() for n in sub
                     if n not in params.get(l, {}))
    extra = sorted(f"{l}/{n}" for l, sub in params.items() for n in sub
                   if n not in ours.get(l, {}))
    if missing or extra:
        raise ValueError(f"parameter trees differ: missing {missing}, "
                         f"extra {extra}")
    for layer, sub in params.items():
        for name, arr in sub.items():
            want = model.executor.whole_shape(layer, name,
                                              ours[layer][name])
            if tuple(np.shape(arr)) != want:
                raise ValueError(f"{layer}/{name}: shape {np.shape(arr)}, "
                                 f"port expects {want}")
    for layer, sub in params.items():
        for name, arr in sub.items():
            model.set_parameter(layer, np.asarray(arr), name)
    model._refresh_compute_params()
    return model.params


def from_jax_state(state: Mapping[str, Mapping[str, np.ndarray]], model
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Carry the JAX model's op state (``ff.state`` without its ``__``
    entries, each leaf as numpy: BatchNorm's running ``mean`` and
    ``var``) into a compiled port ``FFModel``, in place: the trees must
    match leaf for leaf, in shape and dtype, or it raises. Returns the
    port's op state (``model.state`` without its compute copy)."""
    state = {k: v for k, v in state.items() if not k.startswith("__")}
    ours = {k: v for k, v in model.state.items() if not k.startswith("__")}
    if {l: set(sub) for l, sub in state.items()} != \
            {l: set(sub) for l, sub in ours.items()}:
        raise ValueError(f"op state trees differ: {sorted(state)} vs the "
                         f"port's {sorted(ours)}")
    new = {l: {n: _tensor_like(a, ours[l][n], f"state/{l}/{n}")
               for n, a in sub.items()}
           for l, sub in state.items()}
    with torch.no_grad():
        for l, sub in new.items():
            for n, t in sub.items():
                ours[l][n].copy_(t)
    return ours


def _tensor_like(arr, like: torch.Tensor, where: str) -> torch.Tensor:
    """A numpy array (bf16 arrays as ``ml_dtypes.bfloat16``) as a tensor of
    ``like``'s dtype and device, bit for bit: the dtypes must agree."""
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{where}: shape {arr.shape}, port expects "
                         f"{tuple(like.shape)}")
    if arr.dtype.name == "bfloat16":
        src = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        src = torch.from_numpy(arr.copy())
    if src.dtype != like.dtype:
        raise ValueError(f"{where}: dtype {arr.dtype}, port state is "
                         f"{like.dtype}")
    return src.to(like.device)


def from_jax_opt_state(opt_state: Mapping, model) -> Dict:
    """Carry the JAX package's optimizer state into a compiled port
    ``FFModel`` (``model.opt_state``) so that both packages continue from
    one mid-training state: Adam ``{"m": tree, "v": tree, "t": int}`` or
    SGD ``{"v": tree}`` / ``{}``, every leaf a numpy array (``np.asarray``
    of the JAX leaves). m and v keep their bits (bf16 moments stay bf16)
    and ``t`` becomes the port's int32 device counter, so bias correction
    resumes at the same step. Returns ``model.opt_state``."""
    ours = model.opt_state
    if ours is None:
        raise ValueError("the model has no optimizer state: compile it with "
                         "CompMode.TRAINING first")
    if set(opt_state) != set(ours):
        raise ValueError(f"optimizer state keys differ: {sorted(opt_state)} "
                         f"vs the port's {sorted(ours)}")
    new = {}
    for key, val in opt_state.items():
        if key == "t":
            new["t"] = torch.tensor(int(np.asarray(val)), dtype=torch.int32,
                                    device=ours["t"].device)
            continue
        tree = ours[key]
        if {l: set(sub) for l, sub in val.items()} != \
                {l: set(sub) for l, sub in tree.items()}:
            raise ValueError(f"optimizer state {key!r}: trees differ")
        new[key] = {l: {n: _tensor_like(a, tree[l][n], f"{key}/{l}/{n}")
                        for n, a in sub.items()}
                    for l, sub in val.items()}
    model.opt_state = new
    return new


def to_jax_params(model) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of ``from_jax_params``: the model's parameter tree as
    whole f32 numpy arrays, ``{layer_name: {param_name: array}}``, on
    every rank of a process group (a collective there)."""
    return {layer: {name: model.get_parameter(layer, name) for name in sub}
            for layer, sub in model.params.items()}
