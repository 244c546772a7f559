"""Flash attention: the CUDA kernels' wrappers, their plain versions and
the autograd Function that joins them.

PyTorch counterpart of ``flexflow_tpu/ops/pallas_kernels.py``'s forward
(``_flash_fwd``), backward (``_flash_bwd`` and ``_flash_bwd_blocked``,
one kernel here), the ``_flash`` custom_vjp, and ``flash_attention_lse``
(K5: the same kernels with o in f32 and an lse gradient, the block that
ring attention merges). The kernels are CUDA C++ for Hopper,
``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``, built by
``cuda_build`` and bound with ``ctypes``.

``flash_fwd`` / ``flash_bwd`` on CUDA tensors launch the kernel or raise;
they never give way to the plain version. On CPU tensors they run
``flash_fwd_reference`` / ``flash_bwd_reference``, the plain PyTorch
versions of the same functions, which are also what the card's kernels
are held against. Kernel launches are counted (CUDA only; a CUDA-graph
capture launches nothing, and a replay adds the graph's nodes of each
kernel, ``step_graph.py``) by what they compute: ``flash_fwd.launches``
/ ``flash_bwd.launches`` for K1 and K2/K3 (o in q's dtype),
``flash_fwd.lse_launches`` /
``flash_bwd.lse_launches`` for K5 (bf16 q, k, v with an f32 o, and in
the backward an f32 dO). One ``flash_bwd`` launch runs the backward's
kernels: in bf16 the dQ kernel, which also forms delta, then dK/dV; for
K5 first a kernel that forms delta from the f32 O and dO and rounds dO
to bf16. A counter counts launches, not attention ops: under remat
(``_k:flash_r``) a training step launches K1 twice for each attention,
the forward and its recompute in the backward, and both counts (the
Python counter of an eager step, the graph's kernel nodes of a replay)
say two.

The port's availability rule replaces the TPU's tuning gates (``BLK_Q``,
``MIN_SEQ_FOR_FLASH``, ``head_dim % 8``, ``MAX_BWD_SEQ``): the tensors
are on CUDA, the attention is self-attention (Sq == Sk), the head dim is
one the kernels support and batch x heads fits the grid. The card is not
part of the rule: the kernels are built for sm_90a, and on a card below
compute capability 9.0 both the rule and the wrappers raise
``FlashKernelDeviceError`` rather than give the work to a plain version.
The backward streams its tiles, so it has no length limit and the JAX
package's long-sequence einsum recompute has no counterpart.
"""

from __future__ import annotations

import ctypes
import math
import re
from typing import Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch import cuda_build
from flexflow_tpu_torch.step_graph import register_launch_counter

SUPPORTED_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
MAX_BATCH_HEADS = 65535  # the kernels' grids put batch*heads on grid.y


class FlashKernelDeviceError(RuntimeError):
    """A CUDA card the sm_90a flash kernels cannot run on."""


def require_sm90(device: torch.device) -> None:
    """Raise ``FlashKernelDeviceError`` unless ``device``, a CUDA device,
    has compute capability 9.0 or above."""
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) < (9, 0):
        raise FlashKernelDeviceError(
            f"the flash kernels are built for sm_90a; this card is "
            f"sm_{major}{minor}")


def flash_attention_available(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether ``MultiHeadAttention`` runs its core through the kernel:
    q, k are ``[B, H, S, D]``. (Attention dropout has no kernel path;
    the attention op refuses it before it asks.) A shape the kernel takes
    on a card below sm_90 raises ``FlashKernelDeviceError``."""
    available = (q.device.type == "cuda" and q.shape[2] == k.shape[2]
                 and q.shape[3] in SUPPORTED_HEAD_DIMS
                 and q.shape[0] * q.shape[1] <= MAX_BATCH_HEADS)
    if available:
        require_sm90(q.device)
    return available


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working dtype: f32, or f64 for f64 inputs (so
    that ``torch.autograd.gradcheck`` can run them)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, out_dtype=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: q, k, v ``[BH, S, D]`` -> (o ``[BH, S, D]`` in
    ``out_dtype``, None = q's dtype, lse ``[BH, S]`` f32), with dense f32
    scores."""
    acc = _acc_dtype(q)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    if causal:
        scores = scores.masked_fill(~_causal_mask(q.shape[1], q.device),
                                    torch.finfo(acc).min)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = torch.matmul(p, v.to(acc)).to(out_dtype or q.dtype)
    return o, lse


def flash_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5's forward (``flash_attention_lse``): q, k, v
    ``[BH, S, D]`` -> (o ``[BH, S, D]`` f32, or f64 for f64 inputs, lse
    ``[BH, S]``). Plain PyTorch ops, so autograd differentiates it; its
    VJP with an lse gradient is ``flash_bwd_reference(..., glse=g_lse)``,
    dS = P * (dO V^T - delta + g_lse)."""
    return flash_fwd_reference(q, k, v, causal, out_dtype=_acc_dtype(q))


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False,
                        glse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward, the math of ``_flash_bwd_kernel``:
    P is recomputed from the saved lse, then dV = P^T dO,
    dS = P * (dO V^T - delta + g_lse), dQ = dS K scale, dK = dS^T Q scale,
    with delta = rowsum(dO * O). q, k, v, o, do ``[BH, S, D]``; lse and
    ``glse`` (the upstream gradient of lse; None is zero) ``[BH, S]``.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    acc = _acc_dtype(q)
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    qf, kf, vf, dof = (x.to(acc) for x in (q, k, v, do))
    delta = torch.sum(dof * o.to(acc), dim=-1)
    if glse is None:
        glse = torch.zeros_like(delta)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], q.device), -math.inf)
    p = torch.exp(s - lse.to(acc)[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None] + glse.to(acc)[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_panels(fn: str, *xs: torch.Tensor, f32: Sequence = ()) -> None:
    """What the kernels take: CUDA tensors of one ``[BH, S, D]`` shape,
    contiguous and 16-byte aligned, with a supported head dim, and one
    kernel dtype for all, except K5's mix: the panels named in ``f32``
    (by identity: its o, and in the backward its dO) are f32 while the
    others are bf16."""
    q = xs[0]
    if any(x.dim() != 3 or x.shape != q.shape for x in xs):
        raise ValueError(f"{fn}: panels must share one [BH, S, D] shape, "
                         f"got {[tuple(x.shape) for x in xs]}")
    if q.shape[2] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{fn}: head dim {q.shape[2]} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    want = ([torch.float32 if any(x is y for y in f32) else torch.bfloat16
             for x in xs] if f32 else [q.dtype] * len(xs))
    if q.dtype not in KERNEL_DTYPES or [x.dtype for x in xs] != want:
        raise ValueError(
            f"{fn}: dtypes {[x.dtype for x in xs]} not supported (one of "
            f"{KERNEL_DTYPES} for all, or K5's bf16 panels with f32 o and "
            f"dO)")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{fn}: panels must be contiguous")
    if any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{fn}: panels must be 16-byte aligned")
    if any(x.device != q.device for x in xs):
        raise ValueError(f"{fn}: panels on different devices")
    if q.shape[0] > MAX_BATCH_HEADS:
        raise ValueError(f"{fn}: batch*heads {q.shape[0]} > "
                         f"{MAX_BATCH_HEADS}")


def _check_rows(fn: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse-shaped ``[BH, S]`` f32 rows beside the ``[BH, S, D]`` panels."""
    for r in rows:
        if (tuple(r.shape) != tuple(q.shape[:2]) or r.dtype != torch.float32
                or not r.is_contiguous() or r.device != q.device):
            raise ValueError(f"{fn}: row tensors must be contiguous f32 "
                             f"[BH, S] = {tuple(q.shape[:2])} on "
                             f"{q.device}, got {tuple(r.shape)} {r.dtype}")


def _entry(lib_name: str, symbol: str, argtypes):
    fn = getattr(cuda_build.load(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


FWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _is_lse_mix(q: torch.Tensor, o: torch.Tensor) -> bool:
    """K5's dtypes: bf16 q with an f32 o."""
    return q.dtype == torch.bfloat16 and o.dtype == torch.float32


def fwd_launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, causal: bool,
                    stream: int, out_dtype=None) -> tuple:
    """The arguments of ``ff_flash_attn_fwd`` (types ``FWD_ARGTYPES``), in
    its order, after checking that the kernels take these tensors: q, k,
    v, the outputs o and lse, then BH, S, D, the dtypes (0 all f32, 1 all
    bf16, 2 bf16 q, k, v with an f32 o: K5), causal, and the stream. o
    is in ``out_dtype`` (None = q's dtype). Raises ValueError on a shape,
    dtype, layout or device the kernels do not take."""
    if o.dtype != (out_dtype or q.dtype):
        raise ValueError(f"flash_fwd: o is {o.dtype}, asked for "
                         f"{out_dtype or q.dtype}")
    mix = _is_lse_mix(q, o)
    _check_panels("flash_fwd", q, k, v, o, f32=(o,) if mix else ())
    _check_rows("flash_fwd", q, lse)
    bh, s, d = q.shape
    io = 2 if mix else int(q.dtype == torch.bfloat16)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, s, d, io, int(causal), stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False, out_dtype=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v ``[BH, S, D]`` -> (o ``[BH, S, D]`` in ``out_dtype``, None =
    q's dtype, lse ``[BH, S]`` f32). An f32 o from bf16 inputs is K5's
    forward. CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    require_sm90(q.device)
    o = torch.empty(q.shape, dtype=out_dtype or q.dtype, device=q.device)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    args = fwd_launch_args(q, k, v, o, lse, causal, _stream(q), out_dtype)
    if q.numel() == 0:
        return o, lse
    fn = _entry("flash_attn_fwd", "ff_flash_attn_fwd", FWD_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA error "
                           f"{rc} ([BH, S, D] = {list(q.shape)}, {q.dtype} -> "
                           f"{o.dtype})")
    if torch.cuda.is_current_stream_capturing():
        pass  # a capture launches nothing; a replay counts its nodes
    elif _is_lse_mix(q, o):
        flash_fwd.lse_launches += 1
    else:
        flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0
flash_fwd.lse_launches = 0


BWD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def bwd_scratch(q: torch.Tensor, o: torch.Tensor
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The scratch of one backward launch: ``dlt`` ``[BH, S]`` f32, which
    the kernels fill with delta - g_lse, and, for K5 (bf16 q with an f32
    o), ``do16`` ``[BH, S, D]`` bf16 for dO rounded to bf16 (else
    None)."""
    dlt = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    do16 = (torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
            if _is_lse_mix(q, o) else None)
    return dlt, do16


def bwd_launch_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    glse: Optional[torch.Tensor], dq: torch.Tensor,
                    dk: torch.Tensor, dv: torch.Tensor, dlt: torch.Tensor,
                    do16: Optional[torch.Tensor] = None, *, causal: bool,
                    stream: int) -> tuple:
    """The arguments of ``ff_flash_attn_bwd`` (types ``BWD_ARGTYPES``), in
    its order, after checking that the kernels take these tensors: q, k,
    v, dO, lse, O, g_lse (None = zero), the scratch ``dlt`` and ``do16``
    (``bwd_scratch``: do16 is given for K5 and only for it), dq, dk, dv,
    then BH, S, D, the dtypes (0 all f32, 1 all bf16, 2 bf16 q, k, v with
    f32 O and dO: K5), causal, and the stream. Raises ValueError on a
    shape, dtype, layout or device the kernels do not take."""
    mix = _is_lse_mix(q, o)
    if mix != (do16 is not None):
        raise ValueError("flash_bwd: the bf16 dO scratch is K5's (bf16 q "
                         "with f32 O and dO) and only K5's")
    _check_panels("flash_bwd", q, k, v, o, do, dq, dk, dv,
                  *((do16,) if mix else ()), f32=(o, do) if mix else ())
    _check_rows("flash_bwd", q, lse, dlt,
                *(() if glse is None else (glse,)))
    bh, s, d = q.shape
    io = 2 if mix else int(q.dtype == torch.bfloat16)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), o.data_ptr(),
            None if glse is None else glse.data_ptr(), dlt.data_ptr(),
            None if do16 is None else do16.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, s, d, io, int(causal), stream)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = False, glse: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward: q, k, v, o, do ``[BH, S, D]``, lse and ``glse``
    (None = zero) ``[BH, S]`` f32 -> (dq, dk, dv) in q's dtype. o and do
    are in q's dtype, or f32 beside bf16 q, k, v (K5's backward). CUDA
    tensors run the kernels, one launch: in bf16 the dQ kernel forms
    delta = rowsum(dO * O) of its rows itself and leaves delta - g_lse in
    a scratch row for the dK/dV kernel that follows it (in f32, and for
    K5, a small kernel forms it first; for K5 it also rounds dO to bf16
    into a second scratch); nothing else runs around them but the
    allocation of the outputs and the scratch. CPU tensors run the plain
    version."""
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal, glse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd: no kernel for device {q.device}")
    require_sm90(q.device)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    dlt, do16 = bwd_scratch(q, o)
    args = bwd_launch_args(q, k, v, o, lse, do, glse, dq, dk, dv, dlt, do16,
                           causal=causal, stream=_stream(q))
    if q.numel() == 0:
        return dq, dk, dv
    fn = _entry("flash_attn_bwd", "ff_flash_attn_bwd", BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd kernel launch failed: CUDA error "
                           f"{rc} ([BH, S, D] = {list(q.shape)}, {q.dtype}, "
                           f"O and dO {o.dtype})")
    if torch.cuda.is_current_stream_capturing():
        pass  # a capture launches nothing; a replay counts its nodes
    elif do16 is not None:
        flash_bwd.lse_launches += 1
    else:
        flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.lse_launches = 0

# The kernel that each launch runs once, by its name, mangled
# (``_ZN12_GLOBAL__N_114flash_fwd_bf16ILi64ELi128ELi2ELi3E13__nv_bf...``)
# or demangled (``(anonymous namespace)::flash_fwd_bf16<64, 128, 2, 3,
# __nv_bfloat16>(...)``): K1 and K5's forward by o's dtype, the last
# template argument; K2/K3 and K5's backward by the dQ kernel, K5's
# reading delta from the scratch (``DLT_IN``). ``step_graph`` counts a
# captured graph's nodes by them.
KERNEL_NAMES = {
    (flash_fwd, "launches"): re.compile(
        r"(?<![A-Za-z_])flash_fwd_f32(<|I)"
        r"|(?<![A-Za-z_])flash_fwd_bf16"
        r"(<[^>]*__nv_bfloat16>|I(Li\d+E)+13__nv_bfloat16E)"),
    (flash_fwd, "lse_launches"): re.compile(
        r"(?<![A-Za-z_])flash_fwd_bf16(<[^>]*, float>|I(Li\d+E)+fE)"),
    (flash_bwd, "launches"): re.compile(
        r"(?<![A-Za-z_])flash_bwd_dq_f32(<|I)"
        r"|(?<![A-Za-z_])flash_bwd_dq_bf16(<[^>]*false>|I(Li\d+E)+Lb0EE)"),
    (flash_bwd, "lse_launches"): re.compile(
        r"(?<![A-Za-z_])flash_bwd_dq_bf16(<[^>]*true>|I(Li\d+E)+Lb1EE)"),
}
for (_fn, _attr), _name in KERNEL_NAMES.items():
    register_launch_counter(_fn, _attr, _name.search)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over folded ``[BH, S, D]`` panels,
    the counterpart of the ``_flash`` custom_vjp: the forward saves
    (q, k, v, o, lse); the backward hands dO to ``flash_bwd`` with a zero
    lse gradient (only o is consumed)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v ``[B, H, S, D]`` -> o ``[B, H, S, D]`` (self-attention).
    Folds batch and heads; the projections' einsum results may be strided
    views, so the fold makes them contiguous explicitly (autograd carries
    the gradients back through the fold to the caller's layout). With
    grad enabled it runs through ``FlashAttention``; under
    ``inference_mode`` or ``no_grad`` it calls the bare forward."""
    b, h, s, d = q.shape
    fold = lambda x: x.reshape(b * h, s, d).contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        o = FlashAttention.apply(fold(q), fold(k), fold(v), causal)
    else:
        o, _ = flash_fwd(fold(q), fold(k), fold(v), causal)
    return o.view(b, h, s, d)


class FlashAttentionLSE(torch.autograd.Function):
    """K5, the counterpart of ``flash_attention_lse``'s custom_vjp, over
    folded ``[BH, S, D]`` panels: the forward returns (o, lse) with o in
    f32 (f64 for f64 inputs) and saves (q, k, v, o, lse); the backward
    takes (dO, d lse) and hands them to ``flash_bwd`` as dO and g_lse. A
    None gradient (an output the caller did not use) is zero."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_fwd(q, k, v, causal, out_dtype=_acc_dtype(q))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        glse = None if dlse is None else dlse.contiguous()
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, glse)
        return dq, dk, dv, None


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v ``[BH, S, D]`` -> (o ``[BH, S, D]`` f32, lse ``[BH, S]``),
    the counterpart of ``pallas_kernels.py:flash_attention_lse``: the
    streaming-merge primitive of ring attention, differentiable in both
    outputs. With grad enabled it runs through ``FlashAttentionLSE``;
    under ``inference_mode`` or ``no_grad`` it calls the bare forward."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionLSE.apply(q, k, v, causal)
    return flash_fwd(q, k, v, causal, out_dtype=_acc_dtype(q))

