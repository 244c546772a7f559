"""Linear (dense) operator: y = act(x W + b).

PyTorch counterpart of ``flexflow_tpu/ops/linear.py``. The kernel layout
stays ``[in, out]``. The matmul is ``torch.matmul`` in the compute dtype
(cuBLAS on the card, f32 accumulation), as the JAX package leaves it to
XLA; bias and activation are applied in f32 and the result returns in
the input's dtype.

Over a process group (``forward_sharded``) the kernel's spec picks the
parallelism, as the native search's choices lay it out
(``native/ffs_strategy.hpp``): a kernel sharded on ``in`` is row
parallel (``row`` / ``dp_row``: the input sharded on its last dim, the
local products' partial sums all-reduced, the bias added once after);
a kernel sharded on ``out`` is column parallel (``col`` / ``dp_col``:
the output's last dim sharded, the input's gradient all-reduced in the
backward); a replicated kernel runs on the batch rows the output spec
gives the rank (``dp``, ``rep``, ``sample2``'s rows over data x model).
"""

from __future__ import annotations

import math

import torch

from flexflow_tpu_torch.ffconst import ActiMode, OperatorType
from flexflow_tpu_torch.initializers import (DefaultBiasInitializer,
                                             DefaultWeightInitializer)
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op


def apply_activation(x: torch.Tensor, act: ActiMode) -> torch.Tensor:
    if act == ActiMode.AC_MODE_RELU:
        return torch.relu(x)
    if act == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if act == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if act == ActiMode.AC_MODE_GELU:
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    return x


@register_op(OperatorType.LINEAR)
class Linear(Op):
    def __init__(self, layer, input_shapes):
        self.out_dim = layer.get_property("out_dim")
        self.activation = layer.get_property("activation", ActiMode.AC_MODE_NONE)
        self.use_bias = layer.get_property("use_bias", True)
        self.kernel_init = layer.get_property("kernel_initializer") or DefaultWeightInitializer()
        self.bias_init = layer.get_property("bias_initializer") or DefaultBiasInitializer()
        super().__init__(layer, input_shapes)
        self.in_dim = self.input_shapes[0][-1]

    def compute_output_shapes(self):
        (in_shape,) = self.input_shapes
        return [tuple(in_shape[:-1]) + (self.out_dim,)]

    def param_shapes(self):
        shapes = {"kernel": (self.in_dim, self.out_dim)}
        if self.use_bias:
            shapes["bias"] = (self.out_dim,)
        return shapes

    def init_params(self, generator):
        shapes = self.param_shapes()
        params = {"kernel": self.kernel_init(generator, shapes["kernel"])}
        if self.use_bias:
            params["bias"] = self.bias_init(generator, shapes["bias"])
        return params

    def forward(self, params, inputs, ctx: OpContext):
        (x,) = inputs
        cd = ctx.compute_dtype
        y = torch.matmul(x.to(cd), params["kernel"].to(cd)).float()
        if self.use_bias:
            y = y + params["bias"].float()
        y = apply_activation(y, self.activation)
        return [y.to(x.dtype)]

    def forward_sharded(self, params, inputs, in_specs, node, ctx):
        """``forward`` on this rank's shards over ``ctx.comm``: ``inputs``
        in ``in_specs``, ``params`` the rank's boxes under the node's
        param specs; the output in the node's output spec."""
        from flexflow_tpu_torch.parallel.comm import norm_spec
        comm, mesh = ctx.comm, ctx.mesh
        (x,) = inputs
        out_spec = norm_spec(node.output_specs[0], x.dim(), mesh)
        k_in, k_out = norm_spec(node.param_specs.get("kernel"), 2, mesh)
        lead = out_spec[:-1]
        if set(k_in) & set(k_out) or any(
                set(e) & (set(k_in) | set(k_out)) for e in lead):
            raise ValueError(
                f"linear '{self.name}': kernel spec {(k_in, k_out)} shares "
                f"an axis with the output rows {lead}")
        cd = ctx.compute_dtype
        x = comm.reshard(x, in_specs[0], lead + (k_in,))
        if not k_in:
            # each rank's columns read the whole input: its gradient sums
            # over the ranks of the out axes
            x = comm.copy_to(x, k_out)
        y = torch.matmul(x.to(cd), params["kernel"].to(cd)).float()
        # row parallel: the local products are partial sums
        y = comm.reduce(y, k_in)
        if self.use_bias:
            b = comm.reshard(params["bias"], norm_spec(
                node.param_specs.get("bias"), 1, mesh), (k_out,))
            y = y + b.float()
        y = apply_activation(y, self.activation).to(inputs[0].dtype)
        return [comm.reshard(y, lead + (k_out,), out_spec)]

    def sharded_grad_axes(self, node, mesh):
        """The axes the output rows split over: what the kernel's and the
        bias's gradients sum over."""
        from flexflow_tpu_torch.parallel.comm import norm_spec, spec_axes
        spec = norm_spec(node.output_specs[0], len(self.output_shapes[0]),
                         mesh)
        return spec_axes(spec[:-1])

    def output_dim_roles(self):
        shp = self.output_shapes[0]
        mid = DimRole.SEQ if len(shp) == 3 else DimRole.OTHER
        roles = [DimRole.SAMPLE] + [mid] * (len(shp) - 2) + [DimRole.CHANNEL]
        return [tuple(roles)]

    def flops(self):
        batch = math.prod(self.input_shapes[0][:-1])
        return 2 * batch * self.in_dim * self.out_dim

    def params_elems(self):
        return self.in_dim * self.out_dim + (self.out_dim if self.use_bias else 0)
