"""Ring attention: sequence parallelism over a ring of K/V blocks.

PyTorch counterpart of ``flexflow_tpu/parallel/ring_attention.py``. The
sequence dim of Q/K/V is cut into ``n`` blocks, one for each position of
a ring. A position keeps its Q block and starts with its own K/V block;
at every step the K/V blocks move one position along the ring, so at step
``t`` position ``i`` holds K/V block ``(i - t) mod n``. Each step's
partial attention is merged into the running result with the streaming
log-sum-exp of blockwise attention.

Causal masking is exact: a K/V block is fully visible to a position with
a later index, masked for one with an earlier index, and triangle-masked
on the diagonal (step 0). A masked block's merge weight is
``exp(_NEG - lse)``, exactly 0, so no kernel is launched for it: the
result has the bits of merging the reference's zeros.

The body (``ring_attention_blocks``) runs over a leading axis of the ring
positions that the caller holds, and a ring supplies the positions and
the hop (one hop a step carries K and V):

- ``LocalRing(n)``: all ``n`` positions on the caller's device, the hop a
  device-local rotation. This is how one process runs a ``{"seq": n}``
  mesh, the counterpart of the reference's tests on XLA's virtual CPU
  devices.
- ``ProcessGroupRing(group)``: one position per rank of a
  ``torch.distributed`` group, the hop a send to rank + 1 and a receive
  from rank - 1 (the counterpart of ``jax.lax.ppermute``). It refuses to
  run inside a CUDA-graph capture; ``LocalRing`` captures as it is.

The inner block is K5, ``flash_attention_lse`` (o in f32 and lse, one
launch for every group of positions that share a mode at a step), where
the kernel takes the shape (``flash_attention_available``); otherwise
the reference's einsum block with the (m, l) merge. On CPU tensors that
is the einsum block, unless ``interpret`` asks for K5's plain versions
(the counterpart of the reference's Pallas interpret mode).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from flexflow_tpu_torch.machine import Mesh, local_ring_axis
from flexflow_tpu_torch.ops.flash_attention import (flash_attention_available,
                                                    flash_attention_lse)

# large-negative stand-in for -inf in the streaming lse accumulation: keeps
# every exp()/logaddexp() finite, so gradients through the merge weights
# never see inf - inf, while still underflowing to exactly 0
_NEG = -1e30


class LocalRing:
    """All ``n`` positions of the ring on one device; the hop rotates the
    position axis by one."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring has at least one position, got {n}")
        self.size = n
        self.positions = tuple(range(n))

    def hop(self, k: torch.Tensor, v: torch.Tensor):
        """k, v ``[P, ...]``: position i receives position i - 1's
        blocks."""
        if self.size == 1:
            return k, v
        return torch.roll(k, 1, dims=0), torch.roll(v, 1, dims=0)

    def anchor(self, o: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        return o


class _RingHop(torch.autograd.Function):
    """K and V to rank + 1, from rank - 1; the backward sends their
    gradients the other way (torch's point-to-point calls carry no
    autograd). Every rank must run the same hops' backwards in the same
    order: one hop a step carries K and V together, the hops form one
    chain, and ``_Anchor`` ties the chain's end into o, so a rank whose
    last blocks were masked still sends and receives their (zero)
    gradients."""

    @staticmethod
    def forward(ctx, k, v, ring):
        ctx.ring = ring
        return ring.exchange((k, v), +1)

    @staticmethod
    def backward(ctx, gk, gv):
        return ctx.ring.exchange((gk, gv), -1) + (None,)


class _Anchor(torch.autograd.Function):
    """o unchanged, with k and v in its graph at a zero gradient."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.save_for_backward(k, v)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        k, v = ctx.saved_tensors
        return g, torch.zeros_like(k), torch.zeros_like(v)


class ProcessGroupRing:
    """One position per rank of a ``torch.distributed`` group (None = the
    default group): rank r holds ring position r."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.positions = (self.rank,)

    def _global(self, r: int) -> int:
        import torch.distributed as dist

        return r if self.group is None else dist.get_global_rank(self.group, r)

    def exchange(self, xs, shift: int):
        """This rank's tensors ``xs`` to rank + shift; rank - shift's to
        here, in one batch."""
        import torch.distributed as dist

        dst = self._global((self.rank + shift) % self.size)
        src = self._global((self.rank - shift) % self.size)
        xs = [x.contiguous() for x in xs]
        outs = [torch.empty_like(x) for x in xs]
        ops = ([dist.P2POp(dist.isend, x, dst, self.group) for x in xs]
               + [dist.P2POp(dist.irecv, y, src, self.group) for y in outs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(outs)

    def hop(self, k: torch.Tensor, v: torch.Tensor):
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise NotImplementedError(
                "ring attention over a process group inside a CUDA graph: "
                "its NCCL hop comes with the multi-GPU slice of the "
                "PyTorch port (ROADMAP.md Queue 1 item 3)")
        return _RingHop.apply(k, v, self) if self.size > 1 else (k, v)

    def anchor(self, o: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        """o, tied to the last hop's blocks (see ``_RingHop``)."""
        needs = (self.size > 1 and torch.is_grad_enabled()
                 and (k.requires_grad or v.requires_grad))
        return _Anchor.apply(o, k, v) if needs else o


def _attn_block(q, k, v, scale, mask):
    """One Q-block x KV-block partial attention, the reference's einsum
    block: q ``[..., Sq, D]``, k/v ``[..., Sk, D]`` (f32); mask
    broadcastable to the scores or None. Returns (o_blk unnormalized,
    m_blk, l_blk)."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * scale
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    m_blk = s.amax(dim=-1)
    # fully-masked rows: keep m finite so exp() underflows to 0, not NaN
    m_safe = torch.where(torch.isfinite(m_blk), m_blk,
                         torch.zeros_like(m_blk))
    p = torch.exp(s - m_safe[..., None])
    l_blk = p.sum(dim=-1)
    o_blk = torch.einsum("...qk,...kd->...qd", p.to(v.dtype), v)
    return o_blk, m_safe, l_blk


def _flash_block(q, k, v, causal):
    """K5 on the positions of one group: ``[P, B, H, S, D]`` blocks folded
    to ``[P*B*H, S, D]`` panels, one launch. Returns (o f32, lse)."""
    p, b, h, s, d = q.shape
    fold = lambda x: x.reshape(p * b * h, s, d).contiguous()
    o, lse = flash_attention_lse(fold(q), fold(k), fold(v), causal)
    return o.view(p, b, h, s, d), lse.view(p, b, h, s)


def _tail(x: torch.Tensor, lo: int) -> torch.Tensor:
    """Positions ``lo:`` of ``x`` (``x`` itself for 0: no slice node)."""
    return x if lo == 0 else x[lo:]


def _merge(old: torch.Tensor, lo: int, new: torch.Tensor) -> torch.Tensor:
    """``old`` with positions ``lo:`` replaced by ``new``."""
    return new if lo == 0 else torch.cat([old[:lo], new])


def _use_flash(q: torch.Tensor, interpret: bool) -> bool:
    """The inner block, by the reference's rule: K5 wherever the kernel
    takes the shape (``flash_attention_available``), else the einsum
    block. ``interpret`` runs K5's plain versions on CPU tensors, the
    counterpart of the reference's Pallas interpret mode; on any other
    device it raises."""
    if interpret:
        if q.device.type != "cpu":
            raise ValueError(f"ring attention: interpret runs the plain "
                             f"versions on CPU tensors, got {q.device}")
        return True
    return flash_attention_available(q[0], q[0])


def ring_attention_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ring, causal: bool = False, *,
                          interpret: bool = False) -> torch.Tensor:
    """The ring's body, the counterpart of ``_ring_attention_local``.
    q, k, v ``[P, B, H, S_loc, D]``: the blocks of the ``P`` ring positions
    this process holds (``ring.positions``, ascending). Returns o of the
    same shape in q's dtype; the accumulation is f32.

    At step ``t`` the positions below ``t`` see a masked block when
    causal, so the active positions are a suffix: one K5 launch (or one
    einsum block) over it, triangle-masked at ``t = 0``. Step 0 finds
    every position active and nothing accumulated, so its block is taken
    as it is: merging it into o = 0, lse = _NEG (m = -inf, l = 0) gives
    the same bits and the same gradients."""
    n, pos = ring.size, tuple(ring.positions)
    if q.shape[0] != len(pos) or list(pos) != sorted(pos):
        raise ValueError(f"ring attention: {q.shape[0]} blocks for ring "
                         f"positions {pos}")
    flash = _use_flash(q, interpret)
    d = q.shape[-1]
    if not flash:
        scale = 1.0 / math.sqrt(d)
        qf = q.float()
        tri = torch.ones(q.shape[-2], q.shape[-2], dtype=torch.bool,
                         device=q.device).tril()
    k_cur, v_cur = k, v
    for t in range(n):
        # causal: position i < t holds block (i - t) mod n > i, all masked
        lo = sum(1 for i in pos if i < t) if causal else 0
        diag = causal and t == 0
        if lo < len(pos):
            kt, vt = _tail(k_cur, lo), _tail(v_cur, lo)
            if flash:
                o_blk, lse_blk = _flash_block(_tail(q, lo), kt, vt, diag)
                lse_blk = torch.clamp_min(lse_blk, _NEG)  # finite always
                if t == 0:
                    o, lse = o_blk, lse_blk
                else:
                    lse_old = _tail(lse, lo)
                    lse_new = torch.logaddexp(lse_old, lse_blk)
                    w1 = torch.exp(lse_old - lse_new)
                    w2 = torch.exp(lse_blk - lse_new)
                    o = _merge(o, lo, _tail(o, lo) * w1[..., None]
                               + o_blk * w2[..., None])
                    lse = _merge(lse, lo, lse_new)
            else:
                o_blk, m_blk, l_blk = _attn_block(
                    _tail(qf, lo), kt.float(), vt.float(), scale,
                    tri if diag else None)
                if t == 0:
                    o, m, l = o_blk, m_blk, l_blk
                else:
                    m_old = _tail(m, lo)
                    m_new = torch.maximum(m_old, m_blk)
                    c1 = torch.exp(m_old - m_new)
                    c2 = torch.exp(m_blk - m_new)
                    o = _merge(o, lo, _tail(o, lo) * c1[..., None]
                               + o_blk * c2[..., None])
                    l = _merge(l, lo, _tail(l, lo) * c1 + l_blk * c2)
                    m = _merge(m, lo, m_new)
        if t + 1 < n:  # rotate K/V to the next position on the ring
            k_cur, v_cur = ring.hop(k_cur, v_cur)
    if not flash:
        o = o / torch.clamp_min(l, 1e-30)[..., None]
    return ring.anchor(o, k_cur, v_cur).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, seq_axis: str = "seq",
                   batch_axis: Optional[str] = "data",
                   head_axis: Optional[str] = None, causal: bool = False,
                   *, interpret: bool = False) -> torch.Tensor:
    """Sequence-parallel attention. q, k, v ``[B, H, S, D]`` with S cut
    into ``mesh.shape[seq_axis]`` blocks, all held by this process on
    q's device (``LocalRing``). Returns o ``[B, H, S, D]`` in q's dtype.
    ``batch_axis`` / ``head_axis`` name axes the reference keeps sharded
    through the ring; here every axis but ``seq_axis`` must be 1 (any
    other mesh raises NotImplementedError, ``machine.local_ring_axis``).
    ``interpret``: K5's plain versions as the inner block, CPU tensors
    only (``_use_flash``)."""
    local_ring_axis(mesh, (seq_axis,))
    n = mesh.shape.get(seq_axis, 1)
    b, h, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"ring attention is self-attention: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if s % n:
        raise ValueError(f"ring attention: sequence {s} does not split into "
                         f"{n} blocks")
    split = lambda x: (x.reshape(b, h, n, s // n, d).permute(2, 0, 1, 3, 4)
                       .contiguous())
    o = ring_attention_blocks(split(q), split(k), split(v), LocalRing(n),
                              causal, interpret=interpret)
    return o.permute(1, 2, 0, 3, 4).reshape(b, h, s, d)
