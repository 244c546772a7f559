"""torch.fx -> FFModel translation.

PyTorch counterpart of ``flexflow_tpu/torch/model.py``: a
``torch.nn.Module`` is traced with ``torch.fx.symbolic_trace``, each fx
node is translated through the same per-kind table (call_module /
call_function / call_method) into the port's ``FFModel`` layer calls, and
the module's weights can be copied over (``copy_weights_to``) so the
imported model starts from the module's own initialization. The module
may live on the CPU or on the card; the imported model runs where its
``FFModel`` was made (the card unless the caller asks for the CPU).

The serialized-file path: ``torch_to_ff_file`` writes a JSON description
of the traced graph (the ``.ff`` file, the JAX package's format);
``PyTorchModel.from_file`` replays it with no module at hand.

``nn.TransformerEncoderLayer`` and ``nn.TransformerEncoder`` are fx
leaves: the importer re-expresses them as the port's multi-head
attention (``qkv_bias``), dense, ReLU/GELU, LayerNorm and add ops, so
they reach the flash-attention kernels wherever attention does.
``F.scaled_dot_product_attention`` becomes the einsum / where / softmax
graph the JAX package emits, not a call to torch's SDPA.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import PoolType
from flexflow_tpu_torch.model import FFModel
from flexflow_tpu_torch.tensor import Tensor as FFTensor


def _host(t) -> np.ndarray:
    """A parameter or buffer as a host f32 (or integer) numpy array,
    wherever the module lives."""
    t = t.detach().cpu()
    if t.is_floating_point() or t.dtype == torch.bool:
        t = t.float()
    return t.numpy()


def _pair(v):
    """int-or-pair -> [h, w] (torch's pooling/conv argument convention)."""
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


def _section_sizes(length: int, per: int):
    """torch split semantics: [per]*k plus a smaller final remainder chunk."""
    sizes = [per] * (length // per)
    if length % per:
        sizes.append(length % per)
    return sizes


def _encoder_layer_cfg(layer) -> Dict[str, Any]:
    """Config of one nn.TransformerEncoderLayer (leaf-traced composite)."""
    act = getattr(layer, "activation", None)
    act_name = getattr(act, "__name__", type(act).__name__ if act else "relu")
    return dict(
        d_model=layer.self_attn.embed_dim,
        nhead=layer.self_attn.num_heads,
        dim_feedforward=layer.linear1.out_features,
        activation="gelu" if "gelu" in act_name.lower() else "relu",
        norm_first=bool(getattr(layer, "norm_first", False)),
        eps=layer.norm1.eps,
        dropout=float(getattr(layer.dropout, "p", 0.0)),
        attn_dropout=float(layer.self_attn.dropout),
        batch_first=getattr(layer.self_attn, "batch_first", False),
    )


# ---- graph description (the .ff-file schema) ------------------------------

def _node_desc_from_fx(module, node, shapes: Dict[str, Tuple[int, ...]]):
    """One serializable op record per fx node."""
    nn = torch.nn

    def arg_names(args):
        out = []
        for a in args:
            if isinstance(a, torch.fx.Node):
                out.append(["ref", a.name])
            elif isinstance(a, (list, tuple)):
                out.append(["list", arg_names(a)])
            else:
                out.append(["const", a])
        return out

    d: Dict[str, Any] = {"name": node.name, "op": node.op,
                         "args": arg_names(node.args)}
    d["kwargs"] = {k: (["ref", v.name] if isinstance(v, torch.fx.Node)
                       else ["const", v if not isinstance(v, torch.Size)
                             else list(v)])
                   for k, v in node.kwargs.items()}
    if node.op == "call_module":
        mod = dict(module.named_modules())[node.target]
        d["target"] = type(mod).__name__
        cfg: Dict[str, Any] = {}
        if isinstance(mod, nn.Linear):
            cfg = dict(out_features=mod.out_features,
                       in_features=mod.in_features, bias=mod.bias is not None)
        elif isinstance(mod, nn.Conv2d):
            cfg = dict(out_channels=mod.out_channels,
                       kernel_size=list(mod.kernel_size),
                       stride=list(mod.stride), padding=list(mod.padding),
                       groups=mod.groups, bias=mod.bias is not None)
        elif isinstance(mod, (nn.MaxPool2d, nn.AvgPool2d)):
            if (getattr(mod, "ceil_mode", False)
                    or getattr(mod, "dilation", 1) not in (1, (1, 1))
                    or getattr(mod, "count_include_pad", True) is not True
                    or getattr(mod, "divisor_override", None) is not None):
                raise NotImplementedError(
                    f"{type(mod).__name__}: ceil_mode/dilation/"
                    f"count_include_pad/divisor_override have no "
                    f"translation")
            k = mod.kernel_size
            s = mod.stride or k
            p = mod.padding
            cfg = dict(kernel_size=_pair(k), stride=_pair(s),
                       padding=_pair(p),
                       pool="max" if isinstance(mod, nn.MaxPool2d) else "avg")
        elif isinstance(mod, nn.BatchNorm2d):
            cfg = dict(num_features=mod.num_features)
        elif isinstance(mod, nn.LayerNorm):
            cfg = dict(normalized_shape=list(mod.normalized_shape),
                       eps=mod.eps)
        elif isinstance(mod, nn.Embedding):
            cfg = dict(num_embeddings=mod.num_embeddings,
                       embedding_dim=mod.embedding_dim)
        elif isinstance(mod, nn.Dropout):
            cfg = dict(p=mod.p)
        elif isinstance(mod, nn.MultiheadAttention):
            cfg = dict(embed_dim=mod.embed_dim, num_heads=mod.num_heads,
                       dropout=mod.dropout,
                       kdim=mod.kdim, vdim=mod.vdim,
                       bias=mod.in_proj_bias is not None,
                       batch_first=getattr(mod, "batch_first", False))
        elif isinstance(mod, nn.TransformerEncoderLayer):
            cfg = _encoder_layer_cfg(mod)
        elif isinstance(mod, nn.TransformerEncoder):
            cfg = dict(num_layers=mod.num_layers,
                       layer=_encoder_layer_cfg(mod.layers[0]))
        elif isinstance(mod, nn.Softmax):
            cfg = dict(dim=mod.dim)
        elif isinstance(mod, nn.Flatten):
            cfg = dict(start_dim=mod.start_dim)
        elif isinstance(mod, nn.GroupNorm):
            cfg = dict(num_groups=mod.num_groups, eps=mod.eps,
                       affine=mod.affine)
        elif isinstance(mod, nn.LeakyReLU):
            cfg = dict(negative_slope=mod.negative_slope)
        elif isinstance(mod, nn.AdaptiveAvgPool2d):
            cfg = dict(output_size=_pair(mod.output_size))
        elif hasattr(nn, "RMSNorm") and isinstance(mod, nn.RMSNorm):
            cfg = dict(eps=mod.eps if mod.eps is not None else 1e-6)
        elif isinstance(mod, (nn.ReLU, nn.GELU, nn.Sigmoid, nn.Tanh,
                              nn.SiLU, nn.ELU, nn.Identity)):
            cfg = {}
        else:
            raise NotImplementedError(
                f"torch module {type(mod).__name__} has no translation")
        d["config"] = cfg
    elif node.op in ("call_function", "call_method"):
        t = node.target
        d["target"] = (t if isinstance(t, str)
                       else getattr(t, "__name__", str(t)))
    elif node.op == "get_attr":
        # module buffer/parameter referenced directly: a registered buffer
        # (e.g. a causal mask) becomes a baked constant; a bare
        # nn.Parameter with requires_grad (e.g. a learned positional
        # embedding used as `x + self.pos`) becomes a TRAINABLE leaf so
        # training semantics match the source module. Reduced dtypes
        # (bf16/f16/bool) have no numpy/JSON path — store as f32.
        obj = module
        for part in str(node.target).split("."):
            obj = getattr(obj, part)
        arr = _host(obj)
        d["target"] = "get_attr"
        d["value"] = arr  # a list in the .ff file (torch_to_ff_file)
        d["value_dtype"] = str(arr.dtype)
        d["trainable"] = bool(isinstance(obj, torch.nn.Parameter)
                              and obj.requires_grad)
    elif node.op == "placeholder":
        d["target"] = node.name
        d["shape"] = list(shapes.get(node.name, ()))
    elif node.op == "output":
        d["target"] = "output"
    return d


def trace_module(module, input_shapes: Dict[str, Sequence[int]],
                 batch_size: int) -> List[Dict[str, Any]]:
    traced = torch.fx.symbolic_trace(module)
    shapes = {k: tuple(v) for k, v in input_shapes.items()}
    return [_node_desc_from_fx(module, n, shapes) for n in traced.graph.nodes]


def torch_to_ff_file(module, path: str, input_shapes: Dict[str, Sequence[int]],
                     batch_size: int = 1) -> None:
    """Serialize the traced graph to a ``.ff`` JSON file (the JAX
    package's format)."""
    descs = [dict(d, value=d["value"].tolist()) if "value" in d else d
             for d in trace_module(module, input_shapes, batch_size)]
    with open(path, "w") as f:
        json.dump({"version": 1, "nodes": descs}, f, indent=1)


# ---- HF causal-LM state-dict path -----------------------------------------

def from_hf_causal_lm(hf_model, batch_size: int, seq_length: int,
                      ff_config=None, device=None):
    """State-dict path for HuggingFace causal LMs: a recognized family
    (Llama) builds the port's ``create_llama`` from the module's config
    on ``device`` (None: the card) and imports its state dict. Returns
    ``(ff, load_weights)``: call ``load_weights()`` after
    ``ff.compile(...)``; it returns the number of tensors copied."""
    name = type(hf_model).__name__
    if "Llama" in name:
        from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                     create_llama,
                                                     import_hf_weights)
        c = hf_model.config
        cfg = LlamaModelConfig(
            vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            intermediate_size=c.intermediate_size,
            num_hidden_layers=c.num_hidden_layers,
            num_attention_heads=c.num_attention_heads,
            num_key_value_heads=getattr(c, "num_key_value_heads",
                                        c.num_attention_heads),
            rms_norm_eps=c.rms_norm_eps,
            rope_theta=getattr(c, "rope_theta", 10000.0),
            batch_size=batch_size, seq_length=seq_length)
        ff = create_llama(cfg, ff_config, device=device)
        return ff, (lambda: import_hf_weights(ff, hf_model))
    raise NotImplementedError(
        f"no state-dict translation for {name}; use PyTorchModel (fx "
        f"tracing) for plain torch modules")


# ---- translation to FFModel ----------------------------------------------

class PyTorchModel:
    """Wraps a torch.nn.Module (or a .ff file) and builds the FFModel
    graph: ``torch_to_ff(ffmodel, input_tensors)`` returns the output
    tensors."""

    def __init__(self, module=None, descs: Optional[List[Dict]] = None):
        self.module = module
        self._descs = descs

    @classmethod
    def from_file(cls, path: str) -> "PyTorchModel":
        with open(path) as f:
            return cls(descs=json.load(f)["nodes"])

    def descs(self, input_shapes, batch_size) -> List[Dict[str, Any]]:
        if self._descs is not None:
            return self._descs
        return trace_module(self.module, input_shapes, batch_size)

    def torch_to_ff(self, ff: FFModel, input_tensors: Sequence,
                    input_names: Optional[Sequence[str]] = None):
        inputs = list(input_tensors)
        shapes = {}
        descs = self.descs(shapes, inputs[0].shape[0] if inputs else 1)
        env: Dict[str, Any] = {}
        placeholders = [d for d in descs if d["op"] == "placeholder"]
        if input_names is None:
            input_names = [d["name"] for d in placeholders]
        for name, t in zip(input_names, inputs):
            env[name] = t
        outputs = None

        def resolve(a):
            kind, v = a
            if kind == "ref":
                return env[v]
            if kind == "list":
                return [resolve(x) for x in v]
            return v

        for d in descs:
            if d["op"] == "placeholder":
                continue
            if d["op"] == "output":
                outputs = resolve(d["args"][0])
                break
            args = [resolve(a) for a in d["args"]]
            kwargs = {k: resolve(v) for k, v in d.get("kwargs", {}).items()}
            env[d["name"]] = self._emit(ff, d, args, kwargs)
        self._env = env
        return outputs

    def _emit(self, ff: FFModel, d: Dict, args: List, kwargs: Dict):
        op, target = d["op"], d.get("target")
        cfg = d.get("config", {})
        name = d["name"]
        if op == "get_attr":
            value = np.asarray(d["value"],
                               dtype=np.dtype(d.get("value_dtype",
                                                    "float32"))
                               if d.get("value_dtype") != "bool"
                               else np.float32)
            return ff.constant(value, name=name,
                               trainable=d.get("trainable", False))
        if op == "call_module":
            if target == "Linear":
                return ff.dense(args[0], cfg["out_features"],
                                use_bias=cfg.get("bias", True), name=name)
            if target == "Conv2d":
                kh, kw = cfg["kernel_size"]
                sh, sw = cfg["stride"]
                ph, pw = cfg["padding"]
                return ff.conv2d(args[0], cfg["out_channels"], kh, kw, sh, sw,
                                 ph, pw, groups=cfg.get("groups", 1),
                                 use_bias=cfg.get("bias", True), name=name)
            if target in ("MaxPool2d", "AvgPool2d"):
                kh, kw = cfg["kernel_size"]
                sh, sw = cfg["stride"]
                ph, pw = cfg["padding"]
                pt = (PoolType.POOL_MAX if cfg.get("pool") == "max"
                      else PoolType.POOL_AVG)
                return ff.pool2d(args[0], kh, kw, sh, sw, ph, pw,
                                 pool_type=pt, name=name)
            if target == "BatchNorm2d":
                return ff.batch_norm(args[0], relu=False, name=name)
            if target == "LayerNorm":
                nd = len(cfg["normalized_shape"])
                return ff.layer_norm(args[0],
                                     axes=tuple(range(-nd, 0)),
                                     eps=cfg.get("eps", 1e-5), name=name)
            if target == "Embedding":
                return ff.embedding(args[0], cfg["num_embeddings"],
                                    cfg["embedding_dim"], name=name)
            if target == "Dropout":
                return ff.dropout(args[0], cfg.get("p", 0.5), name=name)
            if target == "Softmax":
                return ff.softmax(args[0], axis=cfg.get("dim", -1), name=name)
            if target == "Flatten":
                return ff.flat(args[0], name=name)
            if target == "MultiheadAttention":
                q, k, v = (args + [args[0], args[0]])[:3]
                if not cfg.get("batch_first", False):
                    # torch default layout is [S, B, E]; ours is [B, S, E]
                    q = ff.transpose(q, [1, 0, 2], name=f"{name}_qt")
                    k = (q if k is args[0] else
                         ff.transpose(k, [1, 0, 2], name=f"{name}_kt"))
                    v = (q if v is args[0] else
                         ff.transpose(v, [1, 0, 2], name=f"{name}_vt"))
                out = ff.multihead_attention(
                    q, k, v, cfg["embed_dim"], cfg["num_heads"],
                    kdim=cfg.get("kdim") or 0, vdim=cfg.get("vdim") or 0,
                    dropout=cfg.get("dropout", 0.0),
                    bias=cfg.get("bias", True),
                    qkv_bias=cfg.get("bias", True), name=name)
                if not cfg.get("batch_first", False):
                    out = ff.transpose(out, [1, 0, 2], name=f"{name}_ot")
                return out
            if target == "TransformerEncoderLayer":
                return self._emit_encoder_layer(ff, name, cfg, args[0])
            if target == "TransformerEncoder":
                t = args[0]
                for i in range(cfg["num_layers"]):
                    t = self._emit_encoder_layer(ff, f"{name}_l{i}",
                                                 cfg["layer"], t)
                return t
            if target == "ReLU":
                return ff.relu(args[0], name=name)
            if target == "GELU":
                return ff.gelu(args[0], name=name)
            if target == "Sigmoid":
                return ff.sigmoid(args[0], name=name)
            if target == "Tanh":
                return ff.tanh(args[0], name=name)
            if target == "SiLU":
                sig = ff.sigmoid(args[0], name=f"{name}_sig")
                return ff.multiply(args[0], sig, name=name)
            if target == "ELU":
                return ff.elu(args[0], name=name)
            if target == "LeakyReLU":
                return self._emit_function(
                    ff, "leaky_relu", [args[0],
                                       cfg.get("negative_slope", 0.01)],
                    {}, name)
            if target == "GroupNorm":
                return ff.group_norm(args[0], cfg["num_groups"],
                                     eps=cfg.get("eps", 1e-5),
                                     affine=cfg.get("affine", True),
                                     name=name)
            if target == "RMSNorm":
                return ff.rms_norm(args[0], eps=cfg.get("eps", 1e-6),
                                   name=name)
            if target == "AdaptiveAvgPool2d":
                return self._emit_function(
                    ff, "adaptive_avg_pool2d",
                    [args[0], cfg["output_size"]], {}, name)
            if target == "Identity":
                return ff.identity(args[0], name=name)
        elif op in ("call_function", "call_method"):
            return self._emit_function(ff, target, args, kwargs, name)
        raise NotImplementedError(f"fx node {op}:{target} has no translation")

    def _emit_encoder_layer(self, ff: FFModel, name: str, cfg: Dict, t):
        """Composite expansion of one nn.TransformerEncoderLayer (fx leaves
        torch.nn modules untraced, so the frontend re-expresses the block:
        post-norm `x = ln(x + sub(x))` or pre-norm `x = x + sub(ln(x))`)."""
        if not cfg.get("batch_first", False):
            t = ff.transpose(t, [1, 0, 2], name=f"{name}_in_t")
        act = ff.gelu if cfg.get("activation") == "gelu" else ff.relu
        norm_first = cfg.get("norm_first", False)
        eps = cfg.get("eps", 1e-5)
        drop = cfg.get("dropout", 0.0)

        def dropped(x, tag):
            return ff.dropout(x, drop, name=f"{name}_{tag}") if drop else x

        def sa(x):
            a = ff.multihead_attention(
                x, x, x, cfg["d_model"], cfg["nhead"], qkv_bias=True,
                dropout=cfg.get("attn_dropout", 0.0), name=f"{name}_attn")
            return dropped(a, "drop1")  # torch's dropout1 after attention

        def ffn(x):
            h = ff.dense(x, cfg["dim_feedforward"], name=f"{name}_ff1")
            h = dropped(act(h, name=f"{name}_act"), "dropa")
            return dropped(ff.dense(h, cfg["d_model"], name=f"{name}_ff2"),
                           "drop2")

        if norm_first:
            t = ff.add(t, sa(ff.layer_norm(t, eps=eps, name=f"{name}_ln1")),
                       name=f"{name}_res1")
            t = ff.add(t, ffn(ff.layer_norm(t, eps=eps, name=f"{name}_ln2")),
                       name=f"{name}_res2")
        else:
            t = ff.layer_norm(ff.add(t, sa(t), name=f"{name}_res1"),
                              eps=eps, name=f"{name}_ln1")
            t = ff.layer_norm(ff.add(t, ffn(t), name=f"{name}_res2"),
                              eps=eps, name=f"{name}_ln2")
        if not cfg.get("batch_first", False):
            t = ff.transpose(t, [1, 0, 2], name=f"{name}_out_t")
        return t

    def _emit_function(self, ff: FFModel, target: str, args, kwargs, name):
        binop = {"add": ff.add, "sub": ff.subtract, "mul": ff.multiply,
                 "truediv": ff.divide, "maximum": ff.max, "minimum": ff.min}
        if target in binop:
            a, b = args[0], args[1]
            if isinstance(a, FFTensor) and isinstance(b, FFTensor):
                return binop[target](a, b, name=name)
            if isinstance(a, FFTensor):  # tensor (op) scalar
                scalar_op = {"add": ff.scalar_add, "sub": ff.scalar_sub,
                             "mul": ff.scalar_multiply,
                             "truediv": ff.scalar_true_divide}[target]
                return scalar_op(a, float(b), name=name)
            # scalar (op) tensor — sub/div are not commutative
            s, t = float(a), b
            if target == "add":
                return ff.scalar_add(t, s, name=name)
            if target == "mul":
                return ff.scalar_multiply(t, s, name=name)
            if target == "sub":  # s - x = -x + s
                neg = ff.scalar_multiply(t, -1.0, name=f"{name}_neg")
                return ff.scalar_add(neg, s, name=name)
            if target == "truediv":  # s / x = s * x^-1
                inv = ff.pow(t, -1.0, name=f"{name}_inv")
                return ff.scalar_multiply(inv, s, name=name)
            raise NotImplementedError(f"scalar-left {target}")
        if target in ("relu", "relu_"):
            return ff.relu(args[0], name=name)
        if target == "gelu":
            return ff.gelu(args[0], name=name)
        if target == "sigmoid":
            return ff.sigmoid(args[0], name=name)
        if target == "tanh":
            return ff.tanh(args[0], name=name)
        if target == "softmax":
            axis = kwargs.get("dim", args[1] if len(args) > 1 else -1)
            return ff.softmax(args[0], axis=axis if axis is not None else -1,
                              name=name)
        if target == "cat":
            ts = args[0]
            axis = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            return ff.concat(ts, axis, name=name)
        if target == "flatten":
            return ff.flat(args[0], name=name)
        if target in ("reshape", "view"):
            shape = list(args[1] if isinstance(args[1], (list, tuple))
                         else args[1:])
            if -1 in shape:  # infer the free dim from the input's elements
                total = int(np.prod(args[0].shape))
                known = int(np.prod([s for s in shape if s != -1]))
                shape[shape.index(-1)] = total // max(known, 1)
            return ff.reshape(args[0], shape, name=name)
        if target in ("transpose", "permute"):
            x = args[0]
            if target == "transpose":
                d0, d1 = args[1], args[2]
                perm = list(range(len(x.shape)))
                perm[d0], perm[d1] = perm[d1], perm[d0]
            else:
                perm = list(args[1] if isinstance(args[1], (list, tuple))
                            else args[1:])
            return ff.transpose(x, perm, name=name)
        if target in ("matmul", "bmm"):
            return ff.batch_matmul(args[0], args[1], name=name)
        if target == "mean":
            axes = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if axes is None:
                axes = list(range(1, len(args[0].shape)))
            axes = [axes] if isinstance(axes, int) else list(axes)
            return ff.mean(args[0], axes,
                           keepdims=kwargs.get("keepdim", False), name=name)
        if target == "sum":
            axes = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if axes is None:
                axes = list(range(1, len(args[0].shape)))
            axes = [axes] if isinstance(axes, int) else list(axes)
            return ff.reduce_sum(args[0], axes,
                                 keepdims=kwargs.get("keepdim", False),
                                 name=name)
        if target == "dropout":
            return ff.dropout(args[0], kwargs.get("p", 0.5), name=name)
        if target == "getitem":
            obj, idx = args[0], args[1]
            if isinstance(obj, (tuple, list)):
                return obj[idx]
            # single-output op indexed as a tuple (e.g. nn.MultiheadAttention
            # returns (out, weights); our op emits just the output). Index 0
            # is the output; other indices (unused aux like attention
            # weights) become None and fail loudly only if consumed.
            if idx == 0:
                return obj
            return None
        if target in ("contiguous", "clone", "detach", "float", "to",
                      "type_as", "alias"):
            return args[0]
        if target == "getattr":
            # e.g. `x.shape` on a traced tensor: static shapes are known
            return getattr(args[0], args[1])
        if target == "exp":
            return ff.exp(args[0], name=name)
        if target == "sin":
            return ff.sin(args[0], name=name)
        if target == "cos":
            return ff.cos(args[0], name=name)
        if target == "pow":
            return ff.pow(args[0], float(args[1]), name=name)
        if target == "sqrt":
            return ff.pow(args[0], 0.5, name=name)
        if target == "rsqrt":
            return ff.rsqrt(args[0], name=name)
        if target == "neg":
            return ff.scalar_multiply(args[0], -1.0, name=name)
        if target in ("unsqueeze", "squeeze"):
            x = args[0]
            shape = list(x.shape)
            dim = args[1] if len(args) > 1 else None
            if target == "unsqueeze":
                dim = dim if dim >= 0 else dim + len(shape) + 1
                shape.insert(dim, 1)
            elif dim is None:
                shape = [s for s in shape if s != 1] or [1]
            else:
                dim = dim if dim >= 0 else dim + len(shape)
                if shape[dim] == 1:
                    shape.pop(dim)
            return ff.reshape(x, shape, name=name)
        if target in ("chunk", "split"):
            x = args[0]
            axis = kwargs.get("dim", args[2] if len(args) > 2 else 0)
            arg = args[1]
            length = x.shape[axis]
            if target == "chunk":
                # torch.chunk(n): chunk size ceil(len/n), smaller last chunk
                n = int(arg)
                per = -(-length // n)
                sizes = _section_sizes(length, per)
            elif isinstance(arg, (list, tuple)):
                sizes = list(arg)
            else:  # split(size, dim): [size]*k + [remainder]
                sizes = _section_sizes(length, int(arg))
            return tuple(ff.split(x, sizes, axis, name=name))
        if target == "stack":
            ts = args[0]
            axis = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            rank = len(ts[0].shape)
            axis = axis if axis >= 0 else axis + rank + 1  # new-axis space
            ts2 = [ff.reshape(t, list(t.shape[:axis]) + [1]
                              + list(t.shape[axis:]), name=f"{name}_u{i}")
                   for i, t in enumerate(ts)]
            return ff.concat(ts2, axis, name=name)
        if target in ("max_pool2d", "avg_pool2d"):
            k = _pair(kwargs.get("kernel_size",
                                 args[1] if len(args) > 1 else 2))
            stride = kwargs.get("stride", args[2] if len(args) > 2 else None)
            s_ = _pair(stride) if stride else k
            p_ = _pair(kwargs.get("padding",
                                  args[3] if len(args) > 3 else 0))
            # arguments the backend pool has no analog for must fail
            # loudly, not silently change numerics/shapes. Positional
            # signatures differ: max_pool2d(..., dilation, ceil_mode) vs
            # avg_pool2d(..., ceil_mode, count_include_pad, divisor)
            if target == "max_pool2d":
                dilation = kwargs.get("dilation",
                                      args[4] if len(args) > 4 else 1)
                ceil_mode = kwargs.get("ceil_mode",
                                       args[5] if len(args) > 5 else False)
                include_pad, divisor = True, None
            else:
                dilation = 1
                ceil_mode = kwargs.get("ceil_mode",
                                       args[4] if len(args) > 4 else False)
                include_pad = kwargs.get(
                    "count_include_pad",
                    args[5] if len(args) > 5 else True)
                divisor = kwargs.get(
                    "divisor_override",
                    args[6] if len(args) > 6 else None)
            if (dilation not in (1, (1, 1), [1, 1]) or ceil_mode
                    or include_pad is not True or divisor is not None):
                raise NotImplementedError(
                    f"{target}: dilation/ceil_mode/count_include_pad/"
                    f"divisor_override have no translation")
            pt = (PoolType.POOL_MAX if target == "max_pool2d"
                  else PoolType.POOL_AVG)
            return ff.pool2d(args[0], k[0], k[1], s_[0], s_[1], p_[0], p_[1],
                             pool_type=pt, name=name)
        if target == "adaptive_avg_pool2d":
            out = kwargs.get("output_size",
                             args[1] if len(args) > 1 else 1)
            out = tuple(_pair(out))
            if tuple(out) != (1, 1):
                raise NotImplementedError(
                    "adaptive_avg_pool2d: only output_size (1,1) "
                    "(global average pooling) translates")
            return ff.mean(args[0], [2, 3], keepdims=True, name=name)
        if target == "layer_norm":
            ns = kwargs.get("normalized_shape",
                            args[1] if len(args) > 1 else None)
            nd = len(ns) if ns else 1
            return ff.layer_norm(args[0], axes=tuple(range(-nd, 0)),
                                 eps=kwargs.get("eps", 1e-5), name=name)
        if target == "leaky_relu":
            # max(x, alpha*x)
            alpha = kwargs.get("negative_slope",
                               args[1] if len(args) > 1 else 0.01)
            scaled = ff.scalar_multiply(args[0], float(alpha),
                                        name=f"{name}_scaled")
            return ff.max(args[0], scaled, name=name)
        if target == "silu":
            sig = ff.sigmoid(args[0], name=f"{name}_sig")
            return ff.multiply(args[0], sig, name=name)
        if target == "size":
            raise NotImplementedError(
                "dynamic .size() in traced graph — use static shapes")
        if target == "einsum":
            eq = args[0]
            ts = args[1] if isinstance(args[1], (list, tuple)) else args[1:]
            return ff.einsum(eq, list(ts), name=name)
        if target in ("expand", "expand_as", "broadcast_to"):
            if target == "expand_as":
                shape = list(args[1].shape)
            else:
                shape = list(args[1] if isinstance(args[1], (list, tuple))
                             else args[1:])
            cur = list(args[0].shape)
            # torch expand: -1 keeps the source extent (align ranks first)
            cur_al = [1] * (len(shape) - len(cur)) + cur
            shape = [cur_al[i] if s == -1 else s
                     for i, s in enumerate(shape)]
            return ff.expand(args[0], shape, name=name)
        if target in ("masked_fill", "masked_fill_"):
            # fill via a broadcast constant, NOT x*0+value (x may hold inf
            # from a previous mask, and inf*0 = NaN)
            # scalar constant + Where broadcasting — an activation-shaped
            # fill would bloat the trace and pin the traced batch size
            x, mask, value = args[0], args[1], float(args[2])
            fill = ff.constant(np.float32(value), name=f"{name}_fill")
            return ff.where(mask, fill, x, name=name)
        if target == "where":
            return ff.where(args[0], args[1], args[2], name=name)
        if target in ("clamp", "clamp_", "clip"):
            x = args[0]
            lo = kwargs.get("min", args[1] if len(args) > 1 else None)
            hi = kwargs.get("max", args[2] if len(args) > 2 else None)
            if lo is not None:  # max(x, lo) = relu(x - lo) + lo
                x = ff.scalar_add(
                    ff.relu(ff.scalar_sub(x, float(lo),
                                          name=f"{name}_s1")),
                    float(lo), name=f"{name}_lo")
            if hi is not None:  # min(x, hi) = hi - relu(hi - x)
                neg = ff.scalar_multiply(x, -1.0, name=f"{name}_n")
                x = ff.scalar_multiply(
                    ff.scalar_add(
                        ff.relu(ff.scalar_add(neg, float(hi),
                                              name=f"{name}_s2")),
                        -float(hi), name=f"{name}_hi2"),
                    -1.0, name=f"{name}_hi")
            return x
        if target == "clamp_min":
            return self._emit_function(ff, "clamp", [args[0], args[1]],
                                       {}, name)
        if target == "abs":
            neg = ff.scalar_multiply(args[0], -1.0, name=f"{name}_neg")
            return ff.max(args[0], neg, name=name)
        if target == "log":
            return ff.log(args[0], name=name)
        if target == "log_softmax":
            # stable form x - max - log(sum(exp(x - max))): log(softmax(x))
            # returns -inf for any entry that underflows
            axis = kwargs.get("dim", args[1] if len(args) > 1 else -1)
            x = args[0]
            mx = ff.reduce_max(x, [axis], keepdims=True, name=f"{name}_mx")
            sh = ff.subtract(x, mx, name=f"{name}_sh")
            lse = ff.log(ff.reduce_sum(ff.exp(sh, name=f"{name}_e"),
                                       [axis], keepdims=True,
                                       name=f"{name}_s"),
                         name=f"{name}_lse")
            return ff.subtract(sh, lse, name=name)
        if target in ("amax", "max"):
            if (target == "max" and len(args) > 1
                    and isinstance(args[1], FFTensor)):
                # binary elementwise torch.max(a, b)
                return ff.max(args[0], args[1], name=name)
            axes = kwargs.get("dim", args[1] if len(args) > 1 else None)
            if axes is None:
                raise NotImplementedError(
                    "full-reduction max() has no translation; pass dim=")
            axes = [axes] if isinstance(axes, int) else list(axes)
            out = ff.reduce_max(args[0], axes,
                                keepdims=kwargs.get("keepdim", False),
                                name=name)
            # torch.max(x, dim) returns (values, indices); amax just values
            return out if target == "amax" else (out, None)
        if target in ("add_", "mul_", "sub_", "div_"):
            return self._emit_function(
                ff, target[:-1].replace("div", "truediv"), args, kwargs,
                name)
        if target == "rsub":  # rsub(x, y, alpha) = y - alpha*x
            alpha = float(kwargs.get("alpha",
                                     args[2] if len(args) > 2 else 1.0))
            scaled = (args[0] if alpha == 1.0
                      else ff.scalar_multiply(args[0], alpha,
                                              name=f"{name}_a"))
            if isinstance(args[1], FFTensor):
                return ff.subtract(args[1], scaled, name=name)
            neg = ff.scalar_multiply(scaled, -1.0, name=f"{name}_neg")
            return ff.scalar_add(neg, float(args[1]), name=name)
        if target == "scaled_dot_product_attention":
            # F.scaled_dot_product_attention(q, k, v, attn_mask=None,
            # dropout_p=0, is_causal=False, *, scale=None): q,k,v
            # [B, H, S, D]. Positional mask/dropout must not be silently
            # dropped.
            q, k, v = args[0], args[1], args[2]
            attn_mask = kwargs.get("attn_mask",
                                   args[3] if len(args) > 3 else None)
            dropout_p = float(kwargs.get(
                "dropout_p", args[4] if len(args) > 4 else 0.0))
            is_causal = bool(kwargs.get(
                "is_causal", args[5] if len(args) > 5 else False))
            if attn_mask is not None or dropout_p:
                raise NotImplementedError(
                    "sdpa: attn_mask/dropout_p have no translation yet")
            d = q.shape[-1]
            scale = kwargs.get("scale") or 1.0 / float(d) ** 0.5
            s = ff.einsum("bhqd,bhkd->bhqk", [q, k], name=f"{name}_qk")
            s = ff.scalar_multiply(s, float(scale), name=f"{name}_scale")
            if is_causal:
                tri = np.tril(np.ones((q.shape[2], k.shape[2]),
                                      np.float32))
                mask = ff.constant(tri, name=f"{name}_mask")
                neg = ff.constant(np.float32(-1e30), name=f"{name}_neg")
                s = ff.where(mask, s, neg, name=f"{name}_masked")
            p = ff.softmax(s, axis=-1, name=f"{name}_p")
            return ff.einsum("bhqk,bhkd->bhqd", [p, v], name=name)
        raise NotImplementedError(f"fx target {target!r} has no translation")

    # ---- weight transfer --------------------------------------------------
    def copy_weights_to(self, ff: FFModel) -> int:
        """Copy the module's parameters into the compiled FFModel
        (transposing Linear kernels torch [out,in] -> ours [in,out]).
        Returns the number of modules copied."""
        copied = 0
        mods = dict(self.module.named_modules())
        traced = torch.fx.symbolic_trace(self.module)
        for node in traced.graph.nodes:
            if node.op == "call_module":
                copied += self._copy_module(ff, node.name, mods[node.target])
        return copied

    def _copy_module(self, ff: FFModel, name: str, mod) -> int:
        nn = torch.nn
        copied = 0
        try:
            if isinstance(mod, nn.Linear):
                ff.set_parameter(name, _host(mod.weight).T, "kernel")
                if mod.bias is not None:
                    ff.set_parameter(name, _host(mod.bias), "bias")
                copied += 1
            elif isinstance(mod, nn.Conv2d):
                ff.set_parameter(name, _host(mod.weight), "kernel")
                if mod.bias is not None:
                    ff.set_parameter(name, _host(mod.bias), "bias")
                copied += 1
            elif isinstance(mod, nn.Embedding):
                ff.set_parameter(name, _host(mod.weight), "kernel")
                copied += 1
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d,
                                  nn.GroupNorm)):
                if getattr(mod, "weight", None) is not None:
                    ff.set_parameter(name, _host(mod.weight),
                                     "scale")
                    ff.set_parameter(name, _host(mod.bias), "bias")
                    copied += 1
            elif hasattr(nn, "RMSNorm") and isinstance(mod, nn.RMSNorm):
                if getattr(mod, "weight", None) is not None:
                    ff.set_parameter(name, _host(mod.weight),
                                     "scale")
                    copied += 1
            elif isinstance(mod, nn.MultiheadAttention):
                copied += self._copy_mha(ff, name, mod)
            elif isinstance(mod, nn.TransformerEncoderLayer):
                copied += self._copy_encoder_layer(ff, name, mod)
            elif isinstance(mod, nn.TransformerEncoder):
                for i, layer in enumerate(mod.layers):
                    copied += self._copy_encoder_layer(ff, f"{name}_l{i}",
                                                       layer)
        except (KeyError, AttributeError):
            pass  # layer absent in the compiled graph / unexpected module
        return copied

    def _copy_mha(self, ff: FFModel, name: str, mod) -> int:
        """torch packed in_proj [3E, E] → our per-head wq/wk/wv [H, E, D]
        (+ bq/bk/bv [H, D]), out_proj [E, HD] → wo [H, D, E]. With
        kdim/vdim != embed_dim torch stores separate q/k/v_proj_weight
        instead of the packed matrix."""
        e, h = mod.embed_dim, mod.num_heads
        d = e // h
        if mod.in_proj_weight is not None:
            w = _host(mod.in_proj_weight)  # [3E,E], head-major
            blocks = [w[i * e:(i + 1) * e] for i in range(3)]
        else:
            blocks = [_host(mod.q_proj_weight),
                      _host(mod.k_proj_weight),
                      _host(mod.v_proj_weight)]
        for blk, pname in zip(blocks, ("wq", "wk", "wv")):
            in_dim = blk.shape[1]  # [E_out, in_dim]; in_dim = e/kdim/vdim
            ff.set_parameter(name,
                             blk.reshape(h, d, in_dim).transpose(0, 2, 1),
                             pname)
        if mod.in_proj_bias is not None:
            b = _host(mod.in_proj_bias)
            for i, pname in enumerate(("bq", "bk", "bv")):
                ff.set_parameter(name, b[i * e:(i + 1) * e].reshape(h, d),
                                 pname)
        wo = _host(mod.out_proj.weight)  # [E_out, HD]
        ff.set_parameter(name, wo.transpose(1, 0).reshape(h, d, e), "wo")
        if mod.out_proj.bias is not None:
            ff.set_parameter(name, _host(mod.out_proj.bias), "bo")
        return 1

    def _copy_encoder_layer(self, ff: FFModel, name: str, layer) -> int:
        """Mirror _emit_encoder_layer's naming scheme."""
        copied = self._copy_mha(ff, f"{name}_attn", layer.self_attn)
        copied += self._copy_module(ff, f"{name}_ff1", layer.linear1)
        copied += self._copy_module(ff, f"{name}_ff2", layer.linear2)
        copied += self._copy_module(ff, f"{name}_ln1", layer.norm1)
        copied += self._copy_module(ff, f"{name}_ln2", layer.norm2)
        return copied
