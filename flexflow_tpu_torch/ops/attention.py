"""MultiHeadAttention.

PyTorch counterpart of ``flexflow_tpu/ops/attention.py``. The four
projections keep the head-first weight layout — wq/wk/wv ``[H, E, D]``,
wo ``[H, D, E]`` — so the head axis stays a first-class shardable dim and
parameters carry across from the JAX package unchanged. The attention
core is ring attention (``parallel/ring_attention.py``) when the op's
``seq_parallel`` axis is above 1 in the compiled mesh; else the
flash-attention kernel (``ops/flash_attention.py``) where its
availability rule holds, else the einsum core
``scaled_dot_product_attention``; with grad enabled the flash core runs
through the ``FlashAttention`` autograd Function (forward and backward
kernels). ``kernel_impl="einsum"`` pins the einsum core;
``kernel_impl="flash"`` asks for the flash core: where the kernel takes
the shape on CUDA it runs (a kernel that fails to build or launch
raises), and on the CPU self-attention runs ``FlashAttention`` through
the kernels' plain versions, the counterpart of the JAX package's Pallas
interpret mode. Where the kernel cannot take the forward's shape (a
head dim it lacks, cross-attention, batch x heads beyond its grid) the
op runs the einsum core and records why in ``_kernel_fallback``, in the
JAX package's words: the reference's semantics for a strategy choice the
kernel cannot take. A card below sm_90 is not such a case: there a shape
the kernel takes raises ``FlashKernelDeviceError`` unless
``kernel_impl="einsum"`` pins the einsum core. The ring keeps
the reference's rule for its inner block (K5 wherever the kernel takes
the shape, else einsum) whatever ``kernel_impl`` says; only on the CPU
does ``kernel_impl="flash"`` give it K5's plain versions.
``decode_forward``, the KV-cache decode path, always runs the einsum core
over the cache. Grouped-query attention (``num_kv_heads``) and rotary
position embeddings (``rope``, with a position offset for decode) are
the reference's. Attention-prob dropout (``dropout`` > 0) applies in
training only, in the einsum core (flash has none: a ``flash`` pin
records the fallback), its mask drawn from the model's generator
(``OpContext.next_rng``); the ring leaves it out with a warning, as the
reference does.
"""

from __future__ import annotations

import math
import warnings

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.initializers import DefaultWeightInitializer
from flexflow_tpu_torch.ops.base import DimRole, Op, OpContext, register_op
from flexflow_tpu_torch.ops.flash_attention import (
    MAX_BATCH_HEADS, SUPPORTED_HEAD_DIMS, flash_attention,
    flash_attention_available)
from flexflow_tpu_torch.parallel.ring_attention import ring_attention


def rotary_embedding(x: torch.Tensor, *, theta: float = 10000.0,
                     position_offset=0) -> torch.Tensor:
    """Apply RoPE to ``[B, H, S, D]`` (HF Llama rotate-half convention):
    positions offset..offset+S-1, inv_freq = theta^(-2i/D), angles in f32.
    ``position_offset`` is the absolute position of the first row: a
    Python int, or an integer tensor on ``x``'s device (a compiled decode
    step feeds it, so that no position is captured into its graph)."""
    b, h, s, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    pos = position_offset + torch.arange(s, dtype=torch.float32,
                                         device=x.device)
    angles = pos[:, None] * inv_freq[None, :]
    cos = torch.cat([torch.cos(angles)] * 2, dim=-1)  # [S, D]
    sin = torch.cat([torch.sin(angles)] * 2, dim=-1)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


def scaled_dot_product_attention(q, k, v, *, causal=False, dropout_rate=0.0,
                                 rng=None, compute_dtype=torch.float32):
    """The einsum core: q, k, v ``[B, H, S, D]`` -> ``[B, H, S, D]`` f32.
    Operands are rounded to the compute dtype and multiplied with f32
    accumulation and f32 output (JAX's ``preferred_element_type``); the
    softmax is f32. With ``dropout_rate`` and ``rng``, each probability
    is kept with probability ``1 - dropout_rate`` (a draw from ``rng``)
    and scaled by its inverse, the reference's attention-prob dropout."""
    cd = compute_dtype
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(cd).float(),
                          k.to(cd).float()) / math.sqrt(d)
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool,
                          device=q.device).tril(diagonal=s_k - s_q)
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0 and rng is not None:
        keep = (torch.empty_like(probs).uniform_(generator=rng)
                < 1.0 - dropout_rate)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(cd).float(),
                        v.to(cd).float())


@register_op(OperatorType.MULTIHEAD_ATTENTION)
class MultiHeadAttention(Op):
    """inputs: query [B,Sq,E], key [B,Sk,E], value [B,Sk,E] -> [B,Sq,E]."""

    def __init__(self, layer, input_shapes):
        p = layer.properties
        self.embed_dim = p["embed_dim"]
        self.num_heads = p["num_heads"]
        self.kdim = p.get("kdim") or self.embed_dim
        self.vdim = p.get("vdim") or self.embed_dim
        self.head_dim = self.embed_dim // self.num_heads
        self.dropout = p.get("dropout", 0.0)
        self.causal = p.get("causal", False)
        self.use_bias = p.get("bias", True)
        # grouped-query attention: kv heads repeat to H before the core
        self.num_kv_heads = p.get("num_kv_heads") or self.num_heads
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"attention '{layer.name}': num_heads ({self.num_heads}) "
                f"must be a multiple of num_kv_heads ({self.num_kv_heads})")
        self.rope = p.get("rope", False)
        self.rope_theta = p.get("rope_theta", 10000.0)
        self.qkv_bias = p.get("qkv_bias", False)
        # sequence parallelism: run the core as ring attention over this
        # mesh axis when the compiled mesh has it above 1
        self.seq_parallel = p.get("seq_parallel", None)
        # head-parallel mesh axis (a "head" choice sets it); the ring
        # keeps heads on it
        self.head_parallel = p.get("head_parallel", None)
        self._warned_dropout = False
        # None = availability-based pick; "flash" asks for the kernel;
        # "einsum" pins the einsum core. A "flash" the kernel cannot take
        # runs the einsum core and records why here (each compile makes
        # new ops, so a fresh record)
        self._kernel_fallback = None
        self.kernel_impl = p.get("kernel_impl", None)
        if self.kernel_impl not in (None, "flash", "einsum"):
            raise ValueError(f"attention '{layer.name}': kernel_impl "
                             f"{self.kernel_impl!r} not in (None, 'flash', "
                             f"'einsum')")
        self.kernel_init = p.get("kernel_initializer") or DefaultWeightInitializer()
        super().__init__(layer, input_shapes)

    def compute_output_shapes(self):
        b, sq, _ = self.input_shapes[0]
        return [(b, sq, self.embed_dim)]

    def param_shapes(self):
        h, e, d = self.num_heads, self.embed_dim, self.head_dim
        hk = self.num_kv_heads
        shapes = {"wq": (h, e, d), "wk": (hk, self.kdim, d),
                  "wv": (hk, self.vdim, d), "wo": (h, d, e)}
        if self.use_bias:
            shapes["bo"] = (e,)
            if self.qkv_bias:
                shapes.update(bq=(h, d), bk=(hk, d), bv=(hk, d))
        return shapes

    def init_params(self, generator):
        dev = generator.device
        return {name: (self.kernel_init(generator, shape) if name[0] == "w"
                       else torch.zeros(shape, device=dev))
                for name, shape in self.param_shapes().items()}

    def forward(self, params, inputs, ctx: OpContext):
        query, key, value = (inputs * 3)[:3] if len(inputs) == 1 else inputs
        y = self._attend(params, query, key, value, ctx)
        if self.use_bias:
            y = y + params["bo"].float()
        return [y.to(query.dtype)]

    def forward_sharded(self, params, inputs, in_specs, node, ctx):
        """``forward`` on this rank's shards over ``ctx.comm``, the
        counterpart of ``flash_attention_sharded``: the inputs take the
        output's batch sharding (``dp``: 'data'; ``sample2``: data x
        model) and are whole along sequence and features. A ``head``
        choice shards wq / wo (and wk / wv where the kv-head count divides
        the axis: the GQA rule) on their head dim, so the core runs on
        the local ``[B/dp, H/mp, S, D]`` block; replicated wk / wv give
        every kv head, of which the rank keeps those its query heads
        read. The output projection's partial sums are all-reduced over
        the head axes, then the bias is added once."""
        from flexflow_tpu_torch.parallel.comm import norm_spec
        comm, mesh = ctx.comm, ctx.mesh
        out_spec = norm_spec(node.output_specs[0], 3, mesh)
        batch = out_spec[0]
        pspec = lambda n, nd: norm_spec(node.param_specs.get(n), nd, mesh)
        heads = pspec("wq", 3)[0]
        kv_heads = pspec("wk", 3)[0]
        if pspec("wo", 3)[0] != heads or pspec("wv", 3)[0] != kv_heads or \
                kv_heads not in ((), heads) or set(heads) & set(batch):
            raise ValueError(
                f"attention '{self.name}': param specs "
                f"{dict(node.param_specs)} with output {out_spec}: the head "
                f"axes of wq/wo and of wk/wv must agree (wk/wv may stay "
                f"replicated) and differ from the batch axes")
        # self-attention's one input (given once or three times) is
        # resharded, and its gradient summed, once
        self_attn = all(x is inputs[0] for x in inputs)
        if self_attn:
            args = [comm.reshard(inputs[0], in_specs[0], (batch, (), ()))] * 3
        else:
            args = [comm.reshard(x, s, (batch, (), ()))
                    for x, s in zip(inputs, in_specs)]
        local = dict(params)
        for n in ("bq", "bk", "bv"):
            if n in local:  # per-head biases follow their weight's heads
                w = "wq" if n == "bq" else "wk"
                local[n] = comm.reshard(local[n], pspec(n, 2),
                                        (pspec(w, 3)[0], ()))
        query, key, value = args
        # each rank's heads read the whole input: its gradient sums over
        # the ranks of the head axes
        q_in = comm.copy_to(query, heads)
        kv_in = [q_in if self_attn and kv_heads == heads
                 else comm.copy_to(x, kv_heads) for x in (key, value)]
        keep = None
        if heads and not kv_heads:
            keep = lambda t: comm.scatter(t, heads, 1)
        y = self._attend(local, q_in, *kv_in, ctx, kv_heads_of=keep)
        y = comm.reduce(y, heads)
        if self.use_bias:
            y = y + comm.reshard(params["bo"], pspec("bo", 1),
                                 ((),)).float()
        return [comm.reshard(y.to(inputs[0].dtype), (batch, (), ()),
                             out_spec)]

    def sharded_grad_axes(self, node, mesh):
        from flexflow_tpu_torch.parallel.comm import norm_spec
        return norm_spec(node.output_specs[0], 3, mesh)[0]

    def _attend(self, params, query, key, value, ctx: OpContext,
                kv_heads_of=None):
        """The attention without the output bias: projections, core and
        output projection, f32 ``[B, Sq, E]``. ``kv_heads_of`` keeps the
        heads of the expanded k and v this rank's query heads read (a
        head-parallel op whose wk / wv are replicated)."""
        cd = ctx.compute_dtype
        proj = lambda x, w: torch.einsum("bse,hed->bhsd", x.to(cd),
                                         params[w].to(cd))
        q, k, v = proj(query, "wq"), proj(key, "wk"), proj(value, "wv")
        if self.qkv_bias and "bq" in params:
            q = q.float() + params["bq"].float()[None, :, None, :]
            k = k.float() + params["bk"].float()[None, :, None, :]
            v = v.float() + params["bv"].float()[None, :, None, :]
        if self.rope:
            q = rotary_embedding(q, theta=self.rope_theta)
            k = rotary_embedding(k, theta=self.rope_theta)
        if k.shape[1] != q.shape[1] or kv_heads_of is not None:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
            if kv_heads_of is not None:
                k, v = kv_heads_of(k), kv_heads_of(v)
        # the core consumes q/k/v in the compute dtype
        q, k, v = q.to(cd), k.to(cd), v.to(cd)
        dropout = self.dropout if ctx.training else 0.0
        if self._is_ring(ctx.mesh_axes) and q.shape[2] == k.shape[2]:
            if dropout > 0 and not self._warned_dropout:
                warnings.warn(
                    f"attention '{self.name}': attention-prob dropout "
                    f"(rate={dropout}) is not applied under seq_parallel "
                    f"ring attention; training proceeds without it",
                    stacklevel=2)
                self._warned_dropout = True
            o = ring_attention(q, k, v, ctx.mesh, seq_axis=self.seq_parallel,
                               head_axis=self.head_parallel,
                               causal=self.causal,
                               interpret=(self.kernel_impl == "flash"
                                          and q.device.type == "cpu"))
        elif dropout == 0 and self._use_flash(q, k, dropout):
            o = flash_attention(q, k, v, causal=self.causal)
        else:
            if (dropout > 0 and self.kernel_impl == "flash"
                    and self._kernel_fallback is None):
                # flash has no dropout: the einsum core runs, recorded in
                # the reference's words
                self._kernel_fallback = (
                    f"flash has no lowering for this forward "
                    f"(dropout_rate={dropout}, Sq={q.shape[2]}, "
                    f"Sk={k.shape[2]}) — einsum executed instead")
            o = scaled_dot_product_attention(
                q, k, v, causal=self.causal, dropout_rate=dropout,
                rng=ctx.next_rng() if dropout > 0 else None,
                compute_dtype=cd)
        return torch.einsum("bhsd,hde->bse", o.to(cd),
                            params["wo"].to(cd)).float()

    def decode_forward(self, params, inputs, ctx: OpContext,
                       k_cache, v_cache, pos):
        """KV-cache incremental forward (``serve/kv_cache.py``), the
        reference's ``decode_forward``.

        ``inputs``: the new token block only, query/key/value rows
        ``[B, T, E]`` at absolute positions ``pos..pos+T-1`` (prefill:
        T = the prompt's length at pos 0; decode: T = 1). ``k_cache`` /
        ``v_cache``: ``[B, Hk, S_max, D]`` with the positions below
        ``pos`` filled. ``pos``: a Python int or an integer tensor on the
        caches' device (the compiled decode step feeds one). Projects the
        new rows, writes their K and V into the caches in place at
        ``pos``, and attends the new queries over the filled prefix and
        themselves with the causal mask over absolute positions: always
        the einsum core (flash has no incremental form over a cache).
        The grouped query heads contract against the un-expanded cache.
        The caller keeps ``pos + T <= S_max``. Returns ``(y [B, T, E],
        k_cache, v_cache)``, the caches being the tensors given.

        Only causal attention decomposes incrementally (a bidirectional
        row needs K/V of positions that do not exist yet): a non-causal
        op refuses."""
        if not self.causal:
            raise NotImplementedError(
                f"attention '{self.name}': KV-cache incremental decode "
                f"requires causal attention (bidirectional rows depend "
                f"on future positions)")
        query, key, value = (inputs * 3)[:3] if len(inputs) == 1 else inputs
        cd = ctx.compute_dtype
        proj = lambda x, w: torch.einsum("bse,hed->bhsd", x.to(cd),
                                         params[w].to(cd))
        q, k, v = proj(query, "wq"), proj(key, "wk"), proj(value, "wv")
        if self.qkv_bias and "bq" in params:
            q = q.float() + params["bq"].float()[None, :, None, :]
            k = k.float() + params["bk"].float()[None, :, None, :]
            v = v.float() + params["bv"].float()[None, :, None, :]
        if self.rope:
            q = rotary_embedding(q, theta=self.rope_theta,
                                 position_offset=pos)
            k = rotary_embedding(k, theta=self.rope_theta,
                                 position_offset=pos)
        b, _, t, d = q.shape
        s_max = k_cache.shape[2]
        dev = k_cache.device
        # the new rows into the caches, in place, at their positions
        rows = torch.arange(t, device=dev) + pos
        k_cache.index_copy_(2, rows, k.to(k_cache.dtype))
        v_cache.index_copy_(2, rows, v.to(v_cache.dtype))
        hk = self.num_kv_heads
        rep = self.num_heads // hk
        # operands rounded to the compute dtype, f32 products and sums
        # (the reference's preferred_element_type=f32)
        qq = q.to(cd).float().reshape(b, hk, rep, t, d)
        scores = torch.einsum("bgrqd,bgkd->bgrqk", qq,
                              k_cache.to(cd).float()) / math.sqrt(d)
        # key j is visible to the query at absolute position pos + i iff
        # j <= pos + i, which also hides every slot not yet written
        visible = (torch.arange(s_max, device=dev)[None, :]
                   <= rows[:, None])
        scores = scores.masked_fill(~visible, torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bgrqk,bgkd->bgrqd", probs.to(cd).float(),
                         v_cache.to(cd).float()
                         ).reshape(b, self.num_heads, t, d)
        y = torch.einsum("bhsd,hde->bse", o.to(cd), params["wo"].to(cd)).float()
        if self.use_bias:
            y = y + params["bo"].float()
        return y.to(query.dtype), k_cache, v_cache

    def _use_flash(self, q, k, dropout_rate=0.0) -> bool:
        """Whether the core runs through the kernel. A ``flash`` pin the
        kernel cannot take runs the einsum core and records why in
        ``_kernel_fallback``, with the reference's strings
        (``flexflow_tpu/ops/attention.py:203-210, 240-250``)."""
        if self.kernel_impl == "einsum":
            return False
        if q.shape[2] != k.shape[2]:
            if self.kernel_impl == "flash" and self._kernel_fallback is None:
                self._kernel_fallback = (
                    f"flash has no lowering for this forward "
                    f"(dropout_rate={dropout_rate}, Sq={q.shape[2]}, "
                    f"Sk={k.shape[2]}) — einsum executed instead")
            return False
        if self.kernel_impl == "flash" and q.device.type == "cpu":
            return True  # the plain versions: the CPU's interpret mode
        available = flash_attention_available(q, k)
        if self.kernel_impl == "flash" and not available:
            self._kernel_fallback = (
                f"flash unavailable at runtime (seq={q.shape[2]}, "
                f"head_dim={q.shape[3]}) — einsum executed instead")
        return available

    def _is_ring(self, mesh_axes) -> bool:
        return bool(self.seq_parallel
                    and (mesh_axes or {}).get(self.seq_parallel, 1) > 1)

    def selected_impl(self, device: str = "cuda", mesh_axes=None,
                      training: bool = False) -> str:
        """Which core ``forward`` runs on ``device`` over a mesh with
        ``mesh_axes`` ('ring' | 'flash' | 'einsum'), derived statically
        from the same rule as forward's dispatch, in the reference's
        order: the ring on a sequence axis above 1; the einsum core when
        pinned or for attention dropout in training; else the port's
        availability rule."""
        if self._is_ring(mesh_axes):
            return "ring"
        if self.kernel_impl == "einsum" or (training and self.dropout > 0):
            return "einsum"
        b, s, e = self.input_shapes[0]
        sk = self.input_shapes[1][1] if len(self.input_shapes) > 1 else s
        if s != sk:
            return "einsum"
        if torch.device(device).type == "cuda":
            return ("flash" if self.head_dim in SUPPORTED_HEAD_DIMS
                    and b * self.num_heads <= MAX_BATCH_HEADS else "einsum")
        return "flash" if self.kernel_impl == "flash" else "einsum"

    def output_dim_roles(self):
        return [(DimRole.SAMPLE, DimRole.SEQ, DimRole.CHANNEL)]

    def flops(self):
        b, sq, e = self.input_shapes[0]
        sk = self.input_shapes[1][1] if len(self.input_shapes) > 1 else sq
        h, d = self.num_heads, self.head_dim
        hk = self.num_kv_heads
        proj = (2 * b * h * d * (sq * e + sq * e)
                + 2 * b * hk * d * (sk * self.kdim + sk * self.vdim))
        core = 2 * b * h * sq * sk * d * 2
        return proj + core

    def params_elems(self):
        h, e, d = self.num_heads, self.embed_dim, self.head_dim
        hk = self.num_kv_heads
        n = h * d * (e + e) + hk * d * (self.kdim + self.vdim)
        if self.use_bias:
            n += e + ((h + 2 * hk) * d if self.qkv_bias else 0)
        return n
