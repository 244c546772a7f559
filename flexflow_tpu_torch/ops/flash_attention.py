"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

PyTorch counterpart of ``flexflow_tpu/ops/pallas_kernels.py``'s forward
(``_flash_fwd`` and ``flash_attention``). The kernel is CUDA C++ for
Hopper, ``csrc/flash_attn_fwd.cu``, built by ``cuda_build`` and bound with
``ctypes``.

``flash_fwd`` on a CUDA tensor launches the kernel or raises; it never
gives way to the plain version. On a CPU tensor it runs
``flash_fwd_reference``, the plain PyTorch version of the same function,
which is also what the card's kernel is held against. ``flash_fwd.launches``
counts kernel launches (CUDA only).

The port's availability rule replaces the TPU's tuning gates (``BLK_Q``,
``MIN_SEQ_FOR_FLASH``, ``head_dim % 8``): the tensors are on CUDA, the
attention is self-attention (Sq == Sk), there is no dropout (the forward
is inference only), and the head dim is one the kernel supports.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from flexflow_tpu_torch import cuda_build

SUPPORTED_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_MAX_BH = 65535  # the kernel's grid puts batch*heads on grid.y


def flash_attention_available(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether ``MultiHeadAttention`` runs its core through the kernel:
    q, k are ``[B, H, S, D]``. (Attention dropout exists only in
    training, which the forward refuses before it asks.)"""
    return (q.device.type == "cuda" and q.shape[2] == k.shape[2]
            and q.shape[3] in SUPPORTED_HEAD_DIMS)


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: q, k, v ``[BH, S, D]`` -> (o ``[BH, S, D]`` in q's
    dtype, lse ``[BH, S]`` f32), with dense f32 scores."""
    s = q.shape[1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    o = torch.matmul(p, v.float()).to(q.dtype)
    return o, lse


def _kernel():
    lib = cuda_build.load("flash_attn_fwd")
    fn = lib.ff_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v ``[BH, S, D]`` -> (o ``[BH, S, D]`` in q's dtype, lse
    ``[BH, S]`` f32). CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd: no kernel for device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_fwd: q, k, v must share one [BH, S, D] "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {d} not supported "
                         f"(kernel takes {SUPPORTED_HEAD_DIMS})")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_fwd: dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                         f"not supported (one of {KERNEL_DTYPES} for all)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_fwd: q, k, v on different devices")
    if bh > _MAX_BH:
        raise ValueError(f"flash_fwd: batch*heads {bh} > {_MAX_BH}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, s, d, int(q.dtype == torch.bfloat16),
                int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd kernel launch failed: CUDA error "
                           f"{rc} (BH={bh}, S={s}, D={d}, {q.dtype})")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """q, k, v ``[B, H, S, D]`` -> o ``[B, H, S, D]`` (self-attention).
    Folds batch and heads; the projections' einsum results may be strided
    views, so the fold makes them contiguous explicitly."""
    b, h, s, d = q.shape
    fold = lambda x: x.reshape(b * h, s, d).contiguous()
    o, _ = flash_fwd(fold(q), fold(k), fold(v), causal)
    return o.view(b, h, s, d)
