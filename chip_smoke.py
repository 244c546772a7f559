#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``flexflow_tpu_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Imports nothing of JAX or of the JAX
package. Phases:

1. card    — prints ``nvidia-smi``'s name and power limit; needs CUDA.
2. build   — builds every kernel of the port from ``flexflow_tpu_torch/csrc``,
             one nvcc per source, all started together; prints each
             kernel's registers, shared memory, spills, ptxas warnings and
             performance notes (the template arguments in each name give
             the tiles and CTA shape), and fails if ptxas spills any
             flash-attention kernel.
3. kernels — holds each kernel against its plain PyTorch version on the
             card and times the kernel, the plain version and the library
             call nearest to it, each as runs of back-to-back calls between
             two CUDA events over their count (``time_calls``); K1 and its
             library call, whose host time matches their device time, by
             the profiler's device time (``timed_by`` in the kernels line):
             K1 flash forward: the serving shape, ragged lengths, causal,
               head dims 64 and 128, bf16 and f32; the bf16 kernel's tile
               edges (S 1, 63, 65, 127, 129, 255, causal and not, D 64 and
               128); two runs bit-equal; timed at the serving shape and, by
               the profiler's device time beside the library's, at every
               other shape the main paths launch (FWD_BUCKET_SHAPES), each
               also held against the plain version;
             K2/K3 flash backward: the training shape (BH 128, S 512), K3's
               regime (BH 32, S 2048), causal, ragged S 1000, D 128, bf16
               and f32, with g_lse zero and random; the bf16 kernels' tile
               edges (S 1, 63, 65, 127, 129, causal and not, D 64 and 128,
               g_lse zero and random); two runs bit-equal; at the training
               shapes the kernels timed by their own entry point (the
               launch ``flash_bwd`` makes, without its allocations) and
               the library's backward by its autograd node called
               directly, both back to back, and both also by the
               profiler's device time;
             K4 fused Adam: the 158 leaf shapes of the full-width model,
               bit-equal, f32 and bf16 state, t 1 and 7, weight decay 0 and
               0.01;
             K5 flash_attention_lse (bf16 q, k, v, o in f32; its backward
               from f32 O and dO with g_lse zero and random): the tile
               edges (S 1, 63, 65, 127, 128, 129, 512, causal and not, D 64
               and 128), two runs bit-equal, timed at the ring steps'
               shapes (BH 512 S 128, BH 32 S 512) beside the bounds and
               the nearest library calls (not the same function).
   Every step of fit, evaluate, predict and the serving engine is a
   compiled step: a CUDA-graph replay once its shape has been captured.
4. serve   — builds the BERT-proxy transformer at full width
             (``TransformerConfig()``: 12 layers, hidden 1024, 16 heads, seq
             512, batch 8) with random weights from a seed, compiles it for
             inference and answers requests through the continuous-batching
             ``ServingEngine``: every bucket warmed (set-up), then 32
             requests closed-loop at concurrency 4, over which K1's launches
             are counted. Checks the results, that K1 ran 12 times per
             batch, that every batch was one replay of its bucket's
             captured forward, that a full batch through the engine equals
             ``predict``,
             and that ``predict`` agrees with the einsum attention core;
             breaks one batch-8 forward's device time down by kernel kind
             (torch.profiler). Then the same model in f32 compute
             (``allow_mixed_precision=False``, the f32 kernel) against the
             einsum core.
5. train   — (b) the full-width model compiled for training (Adam alpha
             1e-4 with bf16 moments, MSE loss) with a strategy file that
             gives attention ``dp_k:flash`` and every other op
             ``dp_k:fused``: 2 warm-up ``fit`` steps, then 10 timed steps
             on one seeded batch, over which every kernel's launches are
             counted (K1 12, the backward 12 and K4 once a step); the loss
             is finite at every step; step time, samples/s and the
             device's busy share (torch.profiler) are printed. The 12
             per-step losses follow the plain path's (einsum core, plain
             Adam, same weights); at alpha 1e-6 the kernel path's loss
             falls over 12 steps (at 1e-4 Adam's first steps overshoot on
             both paths). Then, from one state, the gradients with the
             flash core against the einsum core (bf16 and f32 compute), and
             the fused update of those gradients against
             ``AdamOptimizer.update``, bit for bit.
             (a) 2 layers at S 2048 (K3's regime) without a strategy file:
             3 steps, the backward launched twice a step; then 3 compiled
             steps against eager ones from one state, bit for bit.
   graph   — [graph train] (after K4) the compiled step: train (b) at full
             width, 4 compiled calls (the first runs the step eagerly and
             captures it; the rest are CUDA-graph replays) against 4 eager
             steps (``_train_step_fn``) from one state: losses and every
             leaf of the parameters, m, v, t and the bf16 compute copy bit
             for bit; launches a replay (K1 12, K2 12, K4 1); two replayed
             and two eager steps profiled (K1, K2 and K4 by name, the busy
             share); the capture's pool and the copy-back's size; peak
             memory; 10 interleaved pairs of a compiled and an eager step
             timed (p50, p90, a replay's host enqueue time); ``evaluate``
             and ``predict`` (a capture, then a replay each) against the
             eager eval step and forward, bit for bit; then
             ``make_multi_step(10, stacked=True)`` against 10 single
             compiled steps from one state, the losses bit-equal.
   search  — (after train (b) and K4) the Unity search on the card.
             [search train]: detect the machine (printed with the card's
             name and power limit) and take its two measured constants'
             readings (a full-width dense's share of the bf16 peak, one
             launch's time); ``compile(search_budget=SEARCH_BUDGET)`` of the
             full-width model with Adam, exporting the strategy: the
             search's wall time, mesh (one device), choices by name,
             predicted step time and cost model; every attention the
             search gave ``_k:flash`` launches K1 and K2 once a step and no
             other op claims a kernel; 2 warm-up and 10 timed steps, their
             p50 beside the predicted time, the losses within
             TRAJECTORY_RTOL of train (b)'s plain path; a fresh model
             through ``--import-strategy`` on the exported file runs the
             same kernels and gives a bit-equal first-step loss.
             [search serve]: ``serve(search_budget=SEARCH_BUDGET)``: every
             bucket's objective is the latency objective; each bucket
             timed over SEARCH_BUCKET_BATCHES batches (predicted latency
             beside the measured p50), K1 launched once a batch per flash
             attention, and the served rows against ``predict`` (the full
             batch exactly).
6. ring    — ring attention on a ``{"seq": 4}`` mesh in one process (all
             four ring positions on the card), B 8 H 16 S 512 and the
             causal B 2 H 16 S 2048: o and the q/k/v gradients against
             K1/K2 over the whole sequence, K5's launches against the
             launch plan (4 forward and 4 backward a call), times of both.
7. train c — the slice's path: ``TransformerConfig(seq_parallel="seq")``
             at full width compiled for training on ``make_mesh(4,
             {"seq": 4})`` (Adam alpha 1e-4, no strategy file), 3 ``fit``
             steps and a ``predict``, against the same seeded weights
             without ``seq_parallel`` (the K1 path): predict and per-step
             losses, K5's launches = 12 x 3 x 4 each way, K1/K2/K4 none;
             step p50; 3 compiled steps against eager ones from one state,
             bit for bit, K5 48 each way a replay; the busy share of
             replayed and eager steps and 10 interleaved pairs timed. Then
             the same for 2 causal layers at S 2048, batch 2 (no pairs).
8. llama   — the decoder LM (``create_llama``) at Mistral-7B-v0.3's
             published widths (32 layers, hidden 4096, 32 heads, 8 kv heads,
             vocab 32768), batch 4, seq 1024, random weights from a seed,
             compiled for inference. [llama serve]: K1 at its shape (BH 128,
             S 1024, D 128, causal) against its plain version, timed beside
             ``scaled_dot_product_attention(is_causal=True)``; ``predict``
             (K1 32 times in the capturing call and in each replay, the
             replay bit-equal), its p50, one replay profiled; the serving
             engine's buckets 1, 2, 4 and 8 requests closed-loop from 2
             clients (K1 32 times a batch, one replay a batch), a full batch
             equal to ``predict``. [llama decode]: ``DecodeSession.generate``
             of 64 greedy tokens after a 960-token prompt (two captures in
             all, no K1 launch); a second session fed those tokens: prefill
             and every decode step timed against the step's bound, the
             replayed step bit-equal to the eager one at two positions, two
             replayed steps profiled. Then the same seeded model through a
             ``dp_k:einsum`` strategy file: its ``predict`` against the
             flash core's, and of the generated sequence against the
             prefill's and the decode steps' logits (LLAMA_RTOL).
9. llama train — [llama train] the decoder trained at Mistral-7B-v0.3's
             widths, cut to LLAMA_TRAIN_LAYERS of its 32 layers (batch 4,
             seq 1024, random weights from a seed, Adam with bf16
             moments, the token-level sparse CE, next-token batches):
             K2 at its training launch (BH 128, S 1024, D 128, causal,
             K and V expanded for GQA) against its plain version, timed
             beside the library's backward node and the bound; K4 over
             the decoder's fused leaves bit-equal to its plain version,
             timed beside ``torch.optim.Adam(fused=True)`` and the
             bound; at LLAMA_GRAD_LAYERS layers the flash core's
             gradients against the einsum core's (bf16). Then two
             strategy files from one seed (the weights' fingerprints
             agree): (P) attention ``dp_k:flash``, every other op
             ``dp_k:fused``; (R) the same with ``_r`` on every attention
             and RMSNorm (remat). What autograd keeps for the backward,
             by op, in each; the forward and backward's peak memory;
             LLAMA_TRAIN_STEPS ``fit`` steps each: losses finite and
             falling, K1 once a layer a step in (P) and twice in (R) (the
             forward and the recompute), K2 once a layer, K4 once, no K5;
             (R) bit-equal to (P), losses and every leaf; the memory a
             step allocates (R below P) and the graph pools;
             LLAMA_TRAIN_PAIRS interleaved pairs of a (P) and an (R) step
             (p50, p90, tokens/s); two replayed steps of each profiled
             (the kernels by name, the busy share); (R)'s replayed step
             against its eager step bit for bit. [llama search]: the
             search on the same decoder uncapped (its named remat
             rejections), then memory-capped (``memory_search`` at a
             share of the uncapped prediction) until ``_r`` choices win:
             their ops, what autograd keeps with and without them beside
             what the search priced, 2 ``fit`` steps and the measured
             peak beside the prediction.
10. zoo     — [zoo] the OSDI'22 protocol's other five models at the JAX
             package's default configurations (DLRM batch 64 with 8
             tables of 100,000 x 64; XDL batch 64 with 4 tables of
             1,000,000 x 64; CANDLE-Uno batch 64 with seven 8 x 4192
             towers and a 4 x 4192 trunk; ResNeXt-50 32x4d batch 16 at
             224 x 224; Inception-v3 batch 64 at 299 x 299), random
             weights from the config's seed, one seeded batch, cuDNN in
             its deterministic mode without benchmarking; each compiled
             for training three ways, one model on the card at a time:
             (D) plain Adam, (K) a strategy file giving every op
             ``dp_k:fused`` (K4), (S) ``compile(search_budget=20)``, 10
             for Inception-v3. Each: the capture and two replays against
             eager steps from one state, bit for bit, K4 once a call in
             (K) and never in (D); (K)'s and (S)'s losses and parameters
             against (D)'s; 2 ``fit`` steps (K4's launches counted);
             ``evaluate`` and ``predict`` (a capture and a replay) against
             the eager eval step and forward, bit for bit; interleaved
             compiled and eager steps timed (p50, p90, samples/s); two
             replayed steps profiled
             (busy share; device time by kind: conv, GEMM, K4, concat and
             copies, other; the top cuDNN kernels by name; K4 by name
             once a replay in (K)); peak memory; for (S) the search's wall
             time and predicted step. Then K4 over (K)'s leaf shapes
             against its plain version, timed beside
             ``torch.optim.Adam(fused=True)`` and the bound. The conv
             models run channels-last (``conv_compute_layout="auto"``);
             [layout]: ResNeXt-50 and Inception-v3 built under
             ``"auto"`` (channels-last) and ``"nchw"`` from one seed and
             held to each other (``layout_pair``): each op's output in
             one training forward, one SGD step's loss, and each
             parameter and BN running-statistics leaf's change in that
             step, within bounds set from readings (PERF.md); then (D)
             under
             ``"nchw"``: 3 compiled steps, two replays profiled beside
             the channels-last run's (busy, conv, cuDNN's NCHW<->NHWC
             transforms by name).
11. zoo bn  — [zoo bn] ResNet-50 with BatchNorm (batch 64, 224 x 224,
             53 conv -> BN pairs) as [zoo] runs a model, in four ways:
             (D), (K), (F) a strategy file giving every conv
             ``dp_k:conv_bn_fused`` (53 fused nodes), (S) the search
             (the ops that chose ``conv_bn_fused`` printed); every
             compiled step bit-equal to its eager one and every way to
             (D), BN running statistics included. After (D): ``predict``
             and ``evaluate`` with the eval fold against
             ``fold_conv_bn=False`` (FOLD_RTOL); an INFERENCE build given
             the trained weights and statistics through
             ``transforms.fold_conv_batchnorm`` (53 folds), its
             ``predict`` against the eval fold's and ``serve()``:
             SERVE_REQUESTS requests answered with their ``predict``
             rows bit for bit. [layout resnet_bn]: the layout pair as
             above. AlexNet (batch 64, 224 x 224, two dropouts at
             0.5) as (D) and (K), each step pair from one generator
             state; each dropout's share of zeros in a training tap
             within DROPOUT_SIGMAS binomial deviations of 0.5 and its
             kept values scaled exactly; ``predict`` with dropout the
             identity; 3 ``fit`` steps finite.
12. ckpt    — [ckpt] the BERT-proxy's width at CKPT_LAYERS layers
             through train (b)'s kernel choices (K1, K2, K4 every
             step): (a) 2 x CKPT_N uninterrupted steps against CKPT_N
             steps saved with ``checkpoint_every`` and a fresh model
             resumed with ``fit(resume=True)``: losses and every leaf
             (parameters, m, v, t) bit for bit, the resumed steps'
             launches (K1 and K2 one a layer a step, K4 1) one capture
             then replays; bytes written, the snapshot's stall against
             the step, the writer's seconds and GB/s, the restore,
             goodput. (b) ``supervise`` over a child
             (``--ckpt-child``): preempted by ``FFS_FAULT=sigterm``, it
             exits PREEMPTED_EXIT with a verified grace checkpoint; the
             restart with ``--resume`` continues it to (a)'s losses bit
             for bit, its kernels already built; ``ckpt_inspect`` on the
             directory (exit 0). (c)
             ``load_for_serving`` on (a)'s checkpoint: ``predict`` equal
             to a training model's after ``load_checkpoint`` and
             ``serve()``'s rows equal to ``predict``. [ckpt zoo]:
             ResNet-50-BN and AlexNet (D) resumed at step CKPT_ZOO_EVERY
             of CKPT_ZOO_STEPS, bit for bit (BN statistics, dropout
             masks through the generator), cuDNN deterministic.
13. obs     — [obs] measurement and tracing (``obs/``, ``search/profile.py``)
             on the full-width BERT-proxy: (a) ``compile(search_budget=
             SEARCH_BUDGET)`` under ``--search-measure-ops``: each distinct
             op's forward and backward timed on the card (CUDA-graph slope
             timing), the measured table printed with the runtime constants,
             no node skipped, K1 and K2 launched by the attention's
             measurement; the compile again from the warm cache file (no
             launch, the same prediction); OBS_TIMED replayed steps, their
             p50 beside the measured search's prediction and [search
             train]'s analytic one. (d) the roofline of the ops' forward
             (no share of its bound over 1) and ``--profiling``'s table.
             (b) train (b)'s strategy file, ``fit(trace_dir=...,
             profile_steps=OBS_WINDOW)`` over OBS_STEPS steps: the six
             artifacts parse and their headers name the card; each window
             step's compute + host + idle within OBS_SUM_RTOL of its window;
             K1, K2 and K4 named with the launch counters' counts; every
             device lane inside a step; MFU, peak memory; the busy share
             against this script's own reading of the same profiler
             session's in-memory events (OBS_BUSY_POINTS), and
             ``profile_steps``' over two untraced fit calls printed beside
             them. (c) OBS_PAIRS
             pairs of untraced and traced (no window) fits in turns: both
             p50s, and no file from an untraced fit.
14. costmodel — [costmodel] measure, learn, search, calibrate
             (``costmodel/``, ``flexflow_tpu_torch/scripts``): (a) traced
             ``fit``s of the BERT-proxy's width at COSTMODEL_LAYERS
             layers over COSTMODEL_SHAPES (the full-width shape held
             out), compiled with ``--search-measure-ops`` and
             ``--profiling``: simtrace rows with per-op times on the card,
             K1 and K2 launched by each fit; (b) ``costmodel train`` on
             them: a "gpu" model whose COSTMODEL_CLASSES pass
             MIN_CLASS_ROWS, each class's rows and held-out error; (c) the
             full-width search with ``FFS_COSTMODEL_FILE`` on that model:
             "learned" (else the run fails), its predicted step beside the
             analytic and the measured-profile ones; a traced fit of its
             strategy (K1/K2 against the counters, learned sources and
             the analytic twin in the simtrace, the p50), ``costmodel
             report`` and ``obs_report`` on it; (d) ``calibrate`` of the
             full set (BERT-proxy, ResNet-50 batch 64 at 224 px, AlexNet
             batch 64, the 4096-wide MLP) into a temporary
             ``FFS_CALIBRATION_FILE``, ``--ingest-drift`` of [obs]'s
             trace dir, every row printed with the card; the search's
             ``_memory_correction()`` is the rows' median ``mem_ratio``; a
             memory-capped compile divides its threshold by it, beside
             the measured peak of 2 steps. Nothing is written into the
             tree.
15. frontends — [frontends] models written elsewhere, imported into the
             port and run on the card: (a) the BERT-proxy written in
             PyTorch (``nn.TransformerEncoder`` of 12 pre-norm
             ``TransformerEncoderLayer(1024, 16, 4096)`` and a 1-wide head,
             batch 8, seq 512, PyTorch's initialization from a seed),
             imported through ``flexflow_tpu_torch.torch`` with the
             module's weights: ``predict`` in bf16 and in f32 against the
             module's eager forward (FRONT_BF16_RTOL, MODEL_F32_RTOL), K1
             launched, ``serve()``'s rows equal to ``predict``; trained
             through the kernel path's strategy file (Adam FRONT_ALPHA,
             bf16 moments, MSE): FRONT_WARMUP + FRONT_STEPS steps, K1 and
             K2 once a layer and K4 once a step, the loss falling, a second
             run from the same weights bit-equal; its step p50 interleaved
             with the native ``create_transformer(TransformerConfig())``'s
             under the same strategy, both steps' busy shares and the peak
             memory. (b) GPT-2 small's blocks (n_embd 768, n_head 12,
             n_ctx 1024, 12 layers, batch 4) written with plain torch ops
             (packed qkv, chunk, view/transpose, matmul, an additive
             causal-mask buffer, softmax, tanh GELU): bf16 and f32
             ``predict`` against the eager forward, and one SGD step
             against torch autograd's by the loss after it
             (GPT2_LOSS_RTOL). (c) the Keras CNN and the ONNX conv net (the
             port's writer) of the reference tests, each one epoch on the
             card, ``predict`` against torch ops on their weights.
16. lint —   [lint] static analysis and the example scripts (last; its
             budget LINT_BUDGET_S printed as a ``[time]`` line, and a
             run over it fails): (1)
             ``examples_torch/transformer.py --lint error -b 8
             --import-strategy`` on the kernel path's strategy file as a
             child process at the reference config (``mesh:``, the
             samples/s, exit 0), then that model in-process through
             ``compile(lint="error")`` and LINT_STEPS steps twice: no
             error, each pass ok or skipped with its reason, K1 12 / K2
             12 / K4 1 a step by the counters and by name in two
             profiled replays, the two runs bit-equal; (2) the full-width
             search on ``--search-measure-ops`` and [costmodel]'s learned
             table and calibration file, ``lint="error"``: "learned", the
             calibration pass ok on platform gpu without FFL703, the
             attention's einsum and flash rows in the measured table and
             different, the lint's wall time beside the compile's; the
             two-linear graph searched: ``rewrite_verification`` ok; (3)
             the batch-6 MLP with a ``data=8`` strategy file:
             ``compile(lint="error")`` raises ValueError "fflint" with
             ``torch.cuda.memory_allocated()`` unchanged; (4) ``python -m
             flexflow_tpu_torch.scripts.fflint --model <m> --json`` for
             the twelve zoo models (exit 0, one device; [moe] (c) reads
             the two MoE reports) and, started with them,
             ``explain --model transformer --budget 2 --measure-ops
             --trace-dir`` [obs]'s dir: the three artifacts, the merged
             trace with ``sim:*`` and ``device:*`` lanes.
17. moe —   [moe] mixture of experts (``ops/{moe,experts}.py``,
             ``models/moe_model.py``; its budget MOE_BUDGET_S as a
             ``[time]`` line, and a run over it fails): (a) the flat MoE
             at the roofline CLI's card configuration (MOE_FLAT: 16
             experts, top-2, batch 16), fused (one Experts op) and
             unfused (top-k, group_by, 32 expert denses, aggregate),
             MOE_FLAT_STEPS ``fit`` steps each, two runs from one seed
             bit-equal; ``examples_torch/moe.py -b 64`` as a child
             process, exit 0. (b) the MoE encoder at the BERT-proxy's
             widths (MOE_ENC: 12 layers, hidden 1024, 16 heads, seq 512,
             batch 8, 8 experts, top-2, capacity factor 2.0,
             lambda_bal 0.04; no depth cut) through the kernel path's
             strategy file: ``predict`` (a capture and a replay,
             bit-equal; K1 12 a call by name), ``serve()``'s full batch
             equal to ``predict`` of the same batch, 1 + MOE_STEPS
             ``fit`` steps (K1 12, K2 12, K4 1 a step; p50, peak), two
             replays profiled (by name), MOE_GRAPH_STEPS compiled steps
             against eager ones bit for bit, the loss at lambda_bal 0.04
             minus the loss at 0 against the load-balance term
             recomputed from the routers' probabilities, the plain
             path's losses within TRAJECTORY_RTOL, and a replayed
             step's device time split into the attention kernels, the
             dispatch/combine einsums, the dispatch build and the expert
             FFN (one layer's parts timed apart) and the rest. (c)
             [lint]'s fflint reports of ``moe`` and ``moe_encoder``: one
             device, no error.
18. loop —  [loop] ``fit_loader`` and the sequence-length buckets (its
             budget LOOP_BUDGET_S, as [moe]'s): (1) the full-width
             BERT-proxy through the kernel path's file, ``fit`` and
             ``fit_loader`` over the same LOOP_BATCHES batches, 2
             epochs, bit-equal (losses, every leaf, launches), and the
             host-to-device bytes of a steady-state step of each by the
             profiler's memcpy events (``fit_loader`` 0); (3) the
             ``set_batch`` / ``forward(seq_length)`` / ``backward`` /
             ``update`` loop at LOOP_SEQS (buckets 256 and 128) on (1)'s
             model: the attention core each bucket runs, K1/K2 12 a
             step, the losses against the plain path's from the same
             state; (2) a ``fit_loader`` resume (LOOP_RESUME's depth)
             that seeks once to the cut's batch and ends bit-equal to
             the uninterrupted run.
19. mesh  — [mesh] multi-rank execution (its budget MESH_BUDGET_S): the
             full-width BERT-proxy on ``{"data": 2, "model": 2}`` as 4
             ranks (``--mesh-child``) sharing the one card over a gloo
             group the script names, attention ``dp_head_k:flash`` (K1
             and K2 on each rank's [B/2, H/2, S, D] = BH 32 block), the
             dense layers ``dp_col_k:fused`` / ``dp_row_k:fused`` (K4 over
             each rank's leaves), 3 steps against one rank on one device
             from the same seed: each rank's K1 / K2 / K4 at its shapes
             against the plain versions, its launches (12 / 12 / 1 a
             step), the losses (MESH_LOSS_RTOL), the gathered parameters
             (MESH_PARAM_ATOL, MESH_UPDATE_RTOL), ``evaluate`` and
             ``predict``; prints each rank's step p50 (gloo over host
             copies: not a multi-GPU number), the collectives a step
             issued by kind, axes and bytes, and each rank's peak memory.
20. wus   — [wus] weight-update sharding, the overlap and checkpoints
             over ranks (its budget WUS_BUDGET_S): 4 ranks
             (``--wus-child``) on ``{"data": 4}`` beside [mesh]'s one-rank
             run (``phase_wus``); (b)'s fit checkpoints at step
             WUS_SAVE_STEP (each rank its quarter of the master and
             moments, rank 0 the commit), a fresh model in the same
             processes resumes it bit-equal to the uninterrupted step
             WUS_STEPS with K1 / K2 / K4 launched after the restore, and
             the lowest WUS_ELASTIC_RANKS of them, in a group of their
             own, resume it after a search in that group (plan
             ``research``, every restored leaf bit-equal to the
             checkpoint at the pick's boxes, loss within MESH_LOSS_RTOL of
             one rank's); prints each rank's
             bytes written and read and the snapshot, write, commit and
             restore seconds.
21. report — one JSON line ``{"kernels": [...]}``, then the final line
             ``{"ok": true, "device": {...}}``. Each phase's seconds are
             printed as ``[time]`` lines.

Any failed check exits non-zero without printing the final line.

Other modes: ``--ckpt-child DIR STRATEGY_DIR STEPS [--resume]`` is one
child process of the ``[ckpt]`` phase's preemption leg,
``--mesh-child RANK WORLD DIR`` one rank of ``[mesh]``, and
``--wus-child RANK WORLD DIR`` one rank of ``[wus]``'s 4-rank world (the
lowest ranks go on to its elastic group).
"""

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

# the device-event labels, the rule behind them and the profile's device
# events are the package's, so that this script and
# ``fit(profile_steps=...)`` label kernels alike
from flexflow_tpu_torch.obs.devtrace import (KERNEL_KINDS, device_events,
                                             kernel_kind)

# Published dense peaks of the H100 SXM (NVIDIA data sheet), at its full
# 700 W power limit: device-memory bytes/s, bf16 tensor-core FLOP/s and
# f32 (non-tensor) FLOP/s.
H100_SXM_PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12}

# (bh, s, d, dtype name, causal); the first is the serving shape: batch 8
# x 16 heads, seq 512, head dim 64; then the bf16 kernel's tile edges
# (64-row warpgroups, 64- or 128-row key tiles and CTAs)
FWD_EDGE_LENGTHS = (1, 63, 65, 127, 129, 255)
KERNEL_CASES = [
    (128, 512, 64, "bfloat16", False),
    (128, 512, 64, "bfloat16", True),
    (128, 200, 64, "bfloat16", False),
    (128, 200, 64, "bfloat16", True),
    (64, 512, 128, "bfloat16", False),
    (64, 300, 128, "bfloat16", True),
    (16, 256, 64, "float32", False),
    (16, 200, 128, "float32", True),
] + [(4, s, d, "bfloat16", causal) for s in FWD_EDGE_LENGTHS
     for d in (64, 128) for causal in (False, True)]
# the forward run twice on the same inputs must give the same bits
FWD_DETERMINISM_CASES = [
    (128, 512, 64, "bfloat16", False),
    (64, 512, 64, "bfloat16", False),
    (16, 1000, 64, "bfloat16", True),
    (4, 129, 128, "bfloat16", True),
]
# (bh, s) of K1's other launches on the main paths, D 64, bf16: the serving
# buckets 1, 2 and 4 (16 heads each) and training path (a) (batch 2, seq
# 2048); FWD_SHAPES adds the serving shape (bucket 8 and the training step)
FWD_BUCKET_SHAPES = ((16, 512), (32, 512), (64, 512), (32, 2048))
FWD_SHAPES = ((128, 512),) + FWD_BUCKET_SHAPES
# o: the kernel stores o in bf16, so it differs from the f32 plain version
# by bf16 output rounding (half an ulp is <= 7.8e-3 for |o| < 4) plus the
# bf16 rounding of P before P @ V; lse is f32 on both sides from the same
# inputs and differs only by summation order.
TOL = {"bfloat16": {"o": 2e-2, "lse": 1e-3},
       "float32": {"o": 1e-4, "lse": 1e-4}}
# full model, flash core vs einsum core: both keep activations in bf16
# between ops and round P to bf16; they differ in where P is normalized and
# in summation order, a few bf16 ulps per layer over 12 layers.
MODEL_RTOL = 2e-2
# the same in f32 compute: only the order of the sums differs
MODEL_F32_RTOL = 1e-4
SERVE_REQUESTS, SERVE_CONCURRENCY = 32, 4

# flash backward: (bh, s, d, dtype name, causal, random g_lse); the first
# is the training shape (batch 8 x 16 heads, seq 512, head dim 64), the
# second K3's regime (batch 2 x 16 heads, seq 2048), the third the
# decoder's training launch (batch 4 x 32 heads after the GQA repeat, seq
# 1024, head dim 128, causal); then the tile edges of the bf16 kernels
# (64-row warpgroups, 64-row ring tiles, 128-row CTAs)
BWD_EDGE_LENGTHS = (1, 63, 65, 127, 129)
BWD_CASES = [
    (128, 512, 64, "bfloat16", False, False),
    (32, 2048, 64, "bfloat16", False, False),
    (128, 1024, 128, "bfloat16", True, False),
    (128, 512, 64, "bfloat16", True, True),
    (32, 2048, 64, "bfloat16", True, False),
    (16, 1000, 64, "bfloat16", False, True),
    (16, 1000, 64, "bfloat16", True, False),
    (32, 512, 128, "bfloat16", False, True),
    (16, 300, 128, "bfloat16", True, False),
    (16, 256, 64, "float32", False, True),
    (16, 1000, 64, "float32", True, False),
    (8, 200, 128, "float32", True, True),
] + [(4, s, d, "bfloat16", causal, glse) for s in BWD_EDGE_LENGTHS
     for d in (64, 128) for causal in (False, True) for glse in (False, True)]
# the cases timed for the kernels line: {case: (its row, the heads of its
# model)}; the library's backward runs on the [B, H, S, D] view. The GQA
# repeat in front of the decoder's K2 changes only the values K and V
# hold, not the launch, so its case draws them like any other.
BWD_TIMED = {
    (128, 512, 64, "bfloat16", False, False): ("flash_attn_bwd", 16),
    (32, 2048, 64, "bfloat16", False, False): ("flash_attn_bwd@S2048", 16),
    (128, 1024, 128, "bfloat16", True, False):
        ("flash_attn_bwd@llama_train", 32),
}
# the backward run twice on the same inputs must give the same bits
BWD_DETERMINISM_CASES = [
    (128, 512, 64, "bfloat16", False, False),
    (128, 1024, 128, "bfloat16", True, False),
    (16, 1000, 64, "bfloat16", True, True),
    (16, 300, 128, "bfloat16", True, False),
]
# times of earlier designs (NVIDIA H100 80GB HBM3, 700 W; PERF.md's kernel
# table): the mma.sync forward's profiled device time at the serving shape,
# and the mma.sync backward's and K4's one call between two CUDA events,
# host work inside the call included. Not measured by this run, so printed
# on a text line of their own and kept out of the kernels line.
EARLIER_MS = {"flash_attn_fwd": 0.0889, "flash_attn_bwd": 0.3782,
              "flash_attn_bwd@S2048": 1.1938, "fused_adam": 1.1168}
# dq, dk, dv against the plain version in f32 from the same (bf16) inputs,
# as a share of each output's max |value|: bf16 rounds P, dS and the
# outputs; f32 differs only in the order of the sums. An output's max is
# floored at BWD_SCALE_FLOOR of the largest of the three outputs' max: at
# S 1, P is 1 and dS = dP - delta is 0 up to the order of the sums, so the
# plain dq and dk are 0 or rounding noise (1e-7 against a dv of 3), and a
# share of their own max would compare noise with noise.
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
BWD_SCALE_FLOOR = 1e-3
# fused Adam: (state dtype name, t, weight decay); every case bit-equal
ADAM_CASES = [(sdt, t, wd) for sdt in ("float32", "bfloat16")
              for t in (1, 7) for wd in (0.0, 0.01)]
ADAM_KW = dict(beta1=0.9, beta2=0.999, eps=1e-8)
# training (b): warm-up and timed fit steps on one batch
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
# per-step loss of the kernel path against the plain path (einsum core,
# plain Adam) from the same weights and batch, relative: the bf16
# gradients differ by a few 1e-3 of a leaf's max (the gradient check
# below) and Adam's first, sign-like steps carry that along the
# trajectory; 12 steps stayed within 5.2e-3 (PERF.md, PR 2).
TRAJECTORY_RTOL = 2e-2
# a step size at which Adam's first steps do not overshoot on this
# 12-layer random network, for the descent check (at the reference's
# alpha 1e-4 the loss jumps to ~9e3 at step 2 on both paths)
DESCENT_ALPHA = 1e-6
# gradients of one backward from the initial weights, flash core vs einsum
# core, as a share of each leaf's max |g|: bf16 compute carries the
# forward's gap (2e-2 of the output, measured for serving) back through 12
# layers; f32 differs only in the order of the sums. Some leaves are more
# sensitive than that to any change of rounding (a ReLU whose input lies
# within rounding of 0 flips; the query weights' gradient at a near-uniform
# softmax is a difference of near-equal terms), so each leaf is also held
# against its floor: the larger gap of the einsum core against itself with
# the model input scaled by 1 + NUDGE and by 1 - NUDGE. A leaf passes
# within GRAD_RTOL or within FLOOR_FACTOR times its floor; both are
# printed.
GRAD_RTOL = {"bfloat16": 5e-2, "float32": 1e-3}
NUDGE = 1e-6
FLOOR_FACTOR = 2.0
# training (a): K3's regime at a smaller depth
TRAIN_A = dict(num_layers=2, seq_length=2048, batch_size=2)
TRAIN_A_STEPS = 3
# the compiled step (CUDA graphs): steps of the compiled-vs-eager check
# from one state (after the capturing call), interleaved pairs of a
# compiled and an eager step timed, and the stacked multi-step's length
GRAPH_STEPS = 3
GRAPH_PAIRS = 10
MULTI_STEPS = 10

# K5 (flash_attention_lse): (bh, s, d, causal) at the bf16 kernels' tile
# edges, then at every shape the ring's steps give it on the main paths
# (D 64): the full-width step (BH 512 = 4 positions x batch 8 x 16 heads,
# S 128), and the causal S 2048 ring's steps (BH 32 a position, S 512:
# the diagonal over all 4 positions, then the 3, 2 and 1 visible ones),
# which between them run both forward configurations of the bf16 kernel
# (Narrow64 at BH 64). The forward is held against its plain version
# element by element: o is stored in f32, so only the bf16 rounding of P
# before P @ V (l sums the unrounded P) and the order of the sums differ,
# and rounding each P to bf16 (unit roundoff 2^-8) moves o by at most
# 2^-8 of P @ |V|, the plain version's o of |V|; LSE_TOL["o"] adds room
# for the order of the sums. A kernel that rounded o to bf16 fails the
# second check outright: the share of o's elements that a bf16 holds
# exactly, at most the rows that are one bf16 value v_0 (a causal row 0:
# 1/S of them) plus LSE_BF16_EXACT_SLACK. The backward with
# BWD_TOL["bfloat16"] (dO is rounded to bf16 as an MMA operand, beside P
# and dS), g_lse zero and random.
LSE_EDGE_LENGTHS = (1, 63, 65, 127, 128, 129, 512)
LSE_RING_STEPS = [(512, 128, 64, False), (128, 512, 64, True),
                  (96, 512, 64, False), (64, 512, 64, False),
                  (32, 512, 64, False)]
LSE_CASES = [(4, s, d, causal) for s in LSE_EDGE_LENGTHS for d in (64, 128)
             for causal in (False, True)] + LSE_RING_STEPS
LSE_TOL = {"o_rel": 2.0 ** -8, "o": 1e-4, "lse": 1e-3}
LSE_BF16_EXACT_SLACK = 0.01
LSE_DETERMINISM_CASES = [(512, 128, 64, False), (128, 512, 64, True),
                         (4, 129, 128, True)]
# (label, bh, s) of the ring steps timed, D 64, not causal: the full-width
# ring (batch 8 x 16 heads x 4 positions of S 512 / 4) and one position
# of the S 2048 ring (batch 2 x 16 heads, S 2048 / 4)
LSE_SHAPES = (("full-width ring step", 512, 128),
              ("S 2048 ring, one position", 32, 512))
# ring attention on a {"seq": 4} mesh in one process (LocalRing(4)):
# (b, h, s, d, causal), held against K1 over the whole sequence. Both
# store o in bf16 (the ring after an f32 merge of four f32 blocks), so
# each element of o may differ by one bf16 ulp of the larger of the two
# (at most 2^-7 of it) plus RING_TOL["o"] for the bf16 rounding of P,
# which both round against other running maxima (K5 alone reads up to
# 4.6e-3 against f32, PERF.md); the first run read 1.95e-3 at most. A
# wrong merge reads 0.15 to 3.1 at these shapes (one block dropped, or
# the four blocks averaged: PERF.md). The q/k/v gradients at 2e-2 of each
# gradient's max (BWD_TOL's; the first run read 9.9e-3 at most, and a
# dropped block's dK/dV are all wrong): the ring's backward rounds its
# f32 dO to bf16 once per block, K2's gets a bf16 dO.
RING_MESH = {"seq": 4}
# K5 launches of one ring attention call on it, forward and backward: one
# a ring step over the step's active positions (ring_attention_blocks),
# and every step has one (position n - 1 sees every block, causal or not)
RING_LAUNCHES = RING_MESH["seq"]
RING_SHAPES = ((8, 16, 512, 64, False), (2, 16, 2048, 64, True))
RING_TOL = {"o": 5e-3, "grad": 2e-2}
# training (c): the slice's path, seq-parallel BERT-proxy on RING_MESH;
# the full width, then a 2-layer causal run at S 2048
TRAIN_C_STEPS = 3
TRAIN_C_CAUSAL = dict(num_layers=2, seq_length=2048, batch_size=2,
                      causal=True)
# the searched path: the README quick start's search budget; the searched
# training takes train (b)'s warm-up and timed steps, and each serving
# bucket is timed over this many full batches of its size
SEARCH_BUDGET = 30
SEARCH_BUCKET_BATCHES = 10
# the decoder LM: create_llama at Mistral-7B-v0.3's published widths
# (its config.json: hidden 4096, intermediate 14336, 32 layers, 32 heads,
# 8 kv heads, so head dim 128; vocab 32768, RMSNorm eps 1e-5, RoPE theta
# 1e6), batch 4, seq 1024, random weights from the config's seed
LLAMA = dict(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=1e6,
             batch_size=4, seq_length=1024)
# its K1 launch: BH = 4 x 32 heads after the GQA repeat, causal, D 128
LLAMA_K1 = (128, 1024, 128)
# the served requests' closed loop, and predict's timed calls
LLAMA_BUCKETS, LLAMA_REQUESTS, LLAMA_CONCURRENCY = (1, 2, 4), 8, 2
LLAMA_PREDICTS = 5
# greedy decode: a prompt of LLAMA_PROMPT tokens, then LLAMA_NEW tokens,
# which fill the model's 1024 positions; the captured decode step is held
# against the eager one at LLAMA_CHECK_AT
LLAMA_PROMPT, LLAMA_NEW = 960, 64
LLAMA_CHECK_AT = (980, 1010)
# logits, flash core against the einsum core and decode against a full
# predict, as a share of the largest |logit|: both sides keep activations
# in bf16 between ops, and differ in where the attention rounds P and in
# the order of the sums (and, for decode, in every GEMM's blocking, at
# M = 4 rows a step against 4096): a few bf16 ulps (2^-8 each) a layer,
# as MODEL_RTOL allows 2e-2 over 12 layers, here over 32 layers
LLAMA_RTOL = 5e-2


# [llama train]: the decoder at LLAMA's widths cut to LLAMA_TRAIN_LAYERS of
# its 32 layers (training state, about 12 bytes a parameter, would hold
# 87 GB at full depth: more than the card); Adam with bf16 moments
LLAMA_TRAIN_LAYERS = 8
LLAMA_TRAIN_ALPHA = 1e-4
LLAMA_TRAIN_STEPS = 3
LLAMA_TRAIN_PAIRS = 5
# the flash core's gradients against the einsum core's, at this depth
LLAMA_GRAD_LAYERS = 2
# the memory-capped search's thresholds, as shares of the uncapped
# search's predicted memory, tried in turn until an _r twin wins
LLAMA_SEARCH_FRACTIONS = (0.95, 0.9, 0.8)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_calls(fn, target_ms=25.0, repeats=3, warmup=3):
    """(device ms a call, host ms a call): runs of back-to-back calls
    between two CUDA events, each run's elapsed time over its count, the
    median of ``repeats`` runs; the count makes a run last about
    ``target_ms``. The host figure is the host clock over the same calls
    before the closing synchronize: where it comes near the device figure,
    the host, not the card, set the pace. The calls reuse their inputs, so
    whatever of them fits the 50 MB L2 stays there: warm-L2 times."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    n = max(3, min(500, int(target_ms / max(one_ms, 1e-3))))
    dev, host = [], []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        host.append((time.perf_counter() - h0) * 1e3 / n)
        end.synchronize()
        dev.append(start.elapsed_time(end) / n)
    return statistics.median(dev), statistics.median(host)


def time_ms(fn):
    """Device ms a call (``time_calls``)."""
    return time_calls(fn)[0]


def profiled_ms(fn, n=20, label=None, attempts=3):
    """The card's own time for one call: the summed duration of the
    device events (kernels, copies, sets) that ``n`` calls issue, by
    torch.profiler, over ``n``; None if the profiler recorded none in
    ``attempts`` tries (it sometimes returns a profile without device
    events). With ``label``, prints each event name's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        if events:
            break
    if not events:
        return None
    if label:
        by_name = {}
        for e in events:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / n)
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
            print(f"[profile] {label}: {ms:.4f} ms a call in {name[:100]}")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / n


def flash_bound(bh, s, d, itemsize, causal, peaks, o_itemsize=None):
    """Least time (s) the card could take for one call, and what bounds
    it: q, k, v read once and o (``o_itemsize`` bytes an element, default
    the inputs') and lse written once; 4*D FLOPs per visible (query, key)
    pair, on the tensor cores for bf16."""
    nbytes = (bh * s * d * (3 * itemsize + (o_itemsize or itemsize))
              + bh * s * 4)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * bh * pairs * d
    rate = peaks["bf16"] if itemsize == 2 else peaks["f32"]
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_card():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    if "H100" not in name or "PCIe" in name or "NVL" in name:
        print(f"[card] note: bounds use the H100 SXM peaks; this card is "
              f"{name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build():
    """Build every kernel source, one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from flexflow_tpu_torch import cuda_build
    from flexflow_tpu_torch.search import native

    def build_search_core():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    names = sorted(p.stem for p in cuda_build.SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    # the native search core's g++ runs beside the nvcc builds
    with ThreadPoolExecutor(max_workers=1) as pool:
        core = pool.submit(build_search_core)
        cuda_build.build_all(names)
        secs = time.perf_counter() - t0
        core_path, core_secs = core.result()
    print(f"[build] {', '.join(names)} built in {secs:.2f} s")
    print(f"[build] search core {os.path.relpath(core_path)} built in "
          f"{core_secs:.2f} s beside them ({native.ffs_version()})")
    for name in names:
        for line in cuda_build.build_log(name).splitlines():
            if any(t in line for t in ("Compiling entry", "registers",
                                       "spill", "warning", "Performance")):
                print(f"[build] {name}: {line.strip()}")
    # the flash kernels keep their accumulators in registers: ptxas reports
    # no spill for any of them
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        spills = [line.strip() for line in
                  cuda_build.build_log(name).splitlines()
                  if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
        check(not spills, f"{name}: ptxas reports spills: {spills}")
    return names


def phase_kernels():
    """K1 against its plain version on the card, two runs bit-equal, and
    its times at the main paths' shapes; returns the serving-shape entry of
    the kernels line (launches filled in later)."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_fwd,
                                                        flash_fwd_reference)

    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entry = None
    for bh, s, d, dname, causal in KERNEL_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_fwd_reference(q.float(), k.float(), v.float(),
                                             causal)
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all()),
              f"non-finite kernel output at {(bh, s, d, dname, causal)}")
        err_o = (o.float() - ref_o).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        tol = TOL[dname]
        print(f"[kernels] flash_attn_fwd BH={bh} S={s} D={d} {dname} "
              f"causal={causal}: o max_abs_err {err_o:.3e} (tol {tol['o']}), "
              f"lse max_abs_err {err_lse:.3e} (tol {tol['lse']})")
        check(err_o <= tol["o"] and err_lse <= tol["lse"],
              f"kernel disagrees with its plain version at "
              f"{(bh, s, d, dname, causal)}")
        if entry is None:  # the serving shape
            b, h = 8, bh // 8
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                q.view(b, h, s, d), k.view(b, h, s, d), v.view(b, h, s, d),
                is_causal=causal)
            # the library's call, one SDPA forward of about 0.03 ms on the
            # card, takes as long on the host, so back to back it reads
            # the host: both sides are given by the profiler's device time
            # (back to back beside it, and in its place if the profiler
            # records nothing)
            kernel = lambda: flash_fwd(q, k, v, causal)
            b2b_ms, host_ms = time_calls(kernel)
            plain_ms = time_ms(lambda: flash_fwd_reference(q, k, v, causal))
            library_b2b_ms, library_host_ms = time_calls(lib)
            dev_ms = profiled_ms(kernel)
            lib_dev_ms = profiled_ms(lib)
            profiled = dev_ms is not None and lib_dev_ms is not None
            ms, library_ms = ((dev_ms, lib_dev_ms) if profiled
                              else (b2b_ms, library_b2b_ms))
            bound_s, bound_by = flash_bound(bh, s, d, q.element_size(),
                                            causal, H100_SXM_PEAKS)
            entry = dict(
                name="flash_attn_fwd", route="cuda",
                source="flexflow_tpu_torch/csrc/flash_attn_fwd.cu",
                replaces="flexflow_tpu/ops/pallas_kernels.py:70 (_flash_fwd)",
                shape=f"BH={bh} S={s} D={d} {dname} causal={causal}",
                launches=None, max_abs_err=err_o, lse_max_abs_err=err_lse,
                ms=ms, timed_by="profiler" if profiled else "back to back",
                b2b_ms=b2b_ms, host_ms=host_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_b2b_ms=library_b2b_ms,
                library_host_ms=library_host_ms, bound_ms=bound_s * 1e3,
                bound_us=bound_s * 1e6, bound_by=bound_by)
            print(f"[kernels] serving shape: kernel profiled {fmt(dev_ms)}, "
                  f"{b2b_ms:.4f} ms back to back (host {host_ms:.4f} ms); "
                  f"plain {plain_ms:.4f} ms; library (sdpa) profiled "
                  f"{fmt(lib_dev_ms)}, {library_b2b_ms:.4f} ms back to back "
                  f"(host {library_host_ms:.4f} ms); bound "
                  f"{bound_s * 1e6:.2f} us ({bound_by})")
    for case in FWD_DETERMINISM_CASES:
        bh, s, d, dname, causal = case
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(getattr(torch, dname)) for _ in range(3))
        first = flash_fwd(q, k, v, causal)
        second = flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(first, second)]
        print(f"[kernels] flash_attn_fwd determinism {case}: o, lse "
              f"bit-equal over two runs: {same}")
        check(all(same), f"two forward runs differ at {case}")
    # the other shapes the main paths launch (some run the kernel's other
    # D-64 tile config): held against the plain version like
    # KERNEL_CASES, then timed; there the wrapper's host work outlasts the
    # kernel, so both sides by the profiler's device time
    tol = TOL["bfloat16"]
    for bh, s in FWD_BUCKET_SHAPES:
        d = 64
        q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        o, lse = flash_fwd(q, k, v)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_fwd_reference(q.float(), k.float(), v.float())
        err_o = (o.float() - ref_o).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        print(f"[kernels] flash_attn_fwd BH={bh} S={s} D={d} bfloat16 "
              f"causal=False: o max_abs_err {err_o:.3e} (tol {tol['o']}), "
              f"lse max_abs_err {err_lse:.3e} (tol {tol['lse']})")
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
              and err_o <= tol["o"] and err_lse <= tol["lse"],
              f"kernel disagrees with its plain version at BH={bh} S={s}")
        b = bh // 16
        dev_ms = profiled_ms(lambda: flash_fwd(q, k, v))
        lib_dev_ms = profiled_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                *(x.view(b, 16, s, d) for x in (q, k, v))))
        bound_s, bound_by = flash_bound(bh, s, d, 2, False, H100_SXM_PEAKS)
        print(f"[kernels] flash_attn_fwd BH={bh} S={s} D={d} bfloat16: "
              f"kernel profiled {fmt(dev_ms)}; library (sdpa) profiled "
              f"{fmt(lib_dev_ms)}; bound {bound_s * 1e6:.2f} us ({bound_by})")
    return entry


def phase_serve():
    """Drive the serving path at full width; returns the kernel launches
    counted during it, and K1's launches a replayed batch, counted on the
    device."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.obs.registry import get_registry
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.ops.flash_attention import flash_fwd
    from flexflow_tpu_torch.serve.loadgen import (build_serve_model,
                                                  run_closed_loop,
                                                  warm_buckets)

    t0 = time.perf_counter()
    ff, make_request, cfg = build_serve_model("transformer", on_cpu=False,
                                              device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] model {cfg} built and compiled in "
          f"{time.perf_counter() - t0:.2f} s; compute dtype "
          f"{ff.executor.compute_dtype}")
    attn = [n.op for n in ff.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    check(len(attn) == cfg["num_layers"], "expected one attention op per layer")
    engine = ff.serve()
    buckets = tuple(engine.scheduler.buckets)
    check(buckets == (1, 2, 4, 8), f"unexpected buckets {buckets}")
    for b, rep in engine.bucket_report().items():
        check(set(rep["kernel_choices"].values()) == {"flash"},
              f"bucket {b} does not run the flash kernel: {rep}")

    served = []
    submit = engine.submit

    def tracked_submit(inputs):
        req = submit(inputs)
        served.append(req)
        return req

    engine.submit = tracked_submit
    reg = get_registry()
    try:
        # warming every bucket is set-up; the counts start after it
        warmed = warm_buckets(engine, make_request)
        torch.cuda.synchronize()
        reg.reset()
        flash_fwd.launches = 0
        graphs = {b: be.executor.step_graphs["forward"]
                  for b, be in engine.buckets.items()}
        replays0 = {b: g.replays for b, g in graphs.items()}
        engine.start()
        stats = run_closed_loop(engine, make_request, SERVE_REQUESTS,
                                concurrency=SERVE_CONCURRENCY)
    finally:
        engine.stop()
    torch.cuda.synchronize()
    launches = flash_fwd.launches
    replays = {b: g.replays - replays0[b] for b, g in graphs.items()}
    counters = reg.to_dict()["counters"]
    batches = int(counters.get("serve/batches", 0))
    engine.submit = submit

    check(not stats["errors"], f"closed loop errors: {stats['errors'][:3]}")
    check(counters.get("serve/batch_errors", 0) == 0,
          f"serve/batch_errors = {counters.get('serve/batch_errors')}")
    check(counters.get("serve/request_errors", 0) == 0,
          f"serve/request_errors = {counters.get('serve/request_errors')}")
    check(stats["num_measured"] == SERVE_REQUESTS,
          f"served {stats['num_measured']} of {SERVE_REQUESTS} requests")
    check(len(served) == warmed + SERVE_REQUESTS,
          f"tracked {len(served)} requests, expected "
          f"{warmed + SERVE_REQUESTS}")
    for req in served:
        out = req.wait(60)
        check(out.shape == (cfg["seq_length"], 1),
              f"request {req.id}: result shape {out.shape}")
        check(bool(np.isfinite(out).all()), f"request {req.id}: non-finite")
    check(launches == cfg["num_layers"] * batches and batches > 0,
          f"kernel launches {launches} != {cfg['num_layers']} x {batches} "
          f"served batches")
    print(f"[serve] {warmed} warmup requests, then {stats['num_measured']} "
          f"closed-loop requests in {batches} batches; kernel launches "
          f"{launches} = {cfg['num_layers']} x {batches}; CUDA-graph "
          f"replays by bucket {replays}, captures "
          f"{ {b: g.captures for b, g in graphs.items()} }")
    check(sum(replays.values()) == batches
          and all(g.captures == 1 for g in graphs.values()),
          "the served batches did not each replay their bucket's graph")
    print(f"[serve] closed loop (concurrency {SERVE_CONCURRENCY}): p50 "
          f"{stats['p50_s'] * 1e3:.3f} ms, p99 {stats['p99_s'] * 1e3:.3f} ms, "
          f"{stats['throughput_rps']:.2f} requests/s over "
          f"{stats['wall_s']:.3f} s")
    obs = reg.to_dict()["observations"]
    for b in buckets:
        o = obs.get(f"serve/bucket{b}/batch_latency_s")
        if o:
            print(f"[serve] closed loop, bucket {b}: {int(o['count'])} "
                  f"batches, batch latency p50 {o['p50'] * 1e3:.3f} ms, p99 "
                  f"{o['p99'] * 1e3:.3f} ms")

    # a full batch through the engine equals predict on the same samples
    batch = [make_request(i)[0] for i in range(cfg["batch_size"])]
    reqs = [engine.submit([x]) for x in batch]
    engine.pump()
    got = np.stack([r.wait(60) for r in reqs])
    want = ff.predict(np.stack(batch))
    check(np.array_equal(got, want),
          f"engine full batch != predict: max diff "
          f"{np.abs(got - want).max()}")
    print("[serve] full batch through the engine equals predict exactly")

    # predict with the flash core vs the einsum core, same weights, same
    # card (the einsum core through the eager forward: the compiled one
    # keeps the kernels it captured)
    for op in attn:
        op.kernel_impl = "einsum"
    try:
        plain = eager_predict(ff, np.stack(batch))
    finally:
        for op in attn:
            op.kernel_impl = None
    err = float(np.abs(want - plain).max())
    scale = float(np.abs(plain).max())
    print(f"[serve] predict flash core vs einsum core: max_abs_err {err:.4e}, "
          f"max |output| {scale:.4e}, ratio {err / scale:.3e} "
          f"(tol {MODEL_RTOL})")
    check(np.isfinite(want).all() and err <= MODEL_RTOL * scale,
          "flash-core predict disagrees with the einsum core")
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_forward(ff, np.stack(batch))

    # one full batch through the engine, profiled: its bucket's replay
    # runs K1 once a layer, counted on the device by kernel name
    full = graphs[cfg["batch_size"]]
    replays0 = full.replays

    def served_batch():
        reqs = [engine.submit([x]) for x in batch]
        engine.pump()
        for r in reqs:
            r.wait(60)

    prof = profile_steps("[serve] one full batch through the engine",
                         served_batch, steps=1)
    check(full.replays - replays0 == 1 + LEAD_IN_CALLS,
          "[serve] the profiled batch was not one replay")
    replay = check_replay_launches("[serve] one full batch", prof, 1,
                                   dict(flash_attn_fwd=cfg["num_layers"]))
    return launches, replay["flash_attn_fwd"]


def by_kind(events):
    out = dict.fromkeys(KERNEL_KINDS, 0.0)
    for e in events:
        out[kernel_kind(e.name)] += e.time_range.elapsed_us() / 1e3
    return out


def profile_forward(ff, x):
    """Where the time of one full-batch predict goes on the device: kernel
    time by kind from torch.profiler's kernel events, against the wall
    time of the same (profiled) forward."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        ff.predict(x)  # ends in a device-to-host copy: synchronous
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ff.predict(x)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = by_kind(device_events(prof))
    busy = sum(kinds.values())
    print(f"[profile] batch-8 predict: wall {statistics.median(walls) * 1e3:.3f}"
          f" ms (median of 5, unprofiled); profiled forward {prof_wall_ms:.3f}"
          f" ms with device busy {busy:.3f} ms "
          f"({100 * busy / prof_wall_ms:.1f}%); "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / max(busy, 1e-9):.1f}%)"
                      for k, v in kinds.items() if v))
    if busy <= 0:
        print("[profile] torch.profiler recorded no kernel: the breakdown is "
              "not measured")


def eager_predict(ff, x):
    """``predict`` through the eager forward (``_forward_fn``), which
    reads the attention ops' kernel choice as it runs."""
    from flexflow_tpu_torch.model import host_copy

    ff._refresh_compute_params()
    inputs = ff._stage_inputs(as_inputs(x))
    return host_copy(ff.executor._forward_fn()(ff.params, ff.state, inputs))


def check_f32_model():
    """The f32 route on the card (allow_mixed_precision=False): the full
    model with the f32 kernel against the einsum core."""
    import numpy as np
    from flexflow_tpu_torch import CompMode, FFConfig, LossType
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    cfg = TransformerConfig()
    ff = create_transformer(cfg, FFConfig(batch_size=cfg.batch_size,
                                          allow_mixed_precision=False),
                            device="cuda")
    ff.compile(None, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=CompMode.INFERENCE)
    x = np.random.RandomState(1).randn(cfg.batch_size, cfg.seq_length,
                                       cfg.hidden_size).astype(np.float32)
    flash = ff.predict(x)
    attn = [n.op for n in ff.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    for op in attn:
        op.kernel_impl = "einsum"
    plain = eager_predict(ff, x)
    err = float(np.abs(flash - plain).max())
    scale = float(np.abs(plain).max())
    print(f"[f32] predict (compute dtype {ff.executor.compute_dtype}) flash "
          f"core vs einsum core: max_abs_err {err:.4e}, max |output| "
          f"{scale:.4e}, ratio {err / scale:.3e} (tol {MODEL_F32_RTOL})")
    check(np.isfinite(flash).all() and err <= MODEL_F32_RTOL * scale,
          "f32 flash-core predict disagrees with the einsum core")


def bwd_bound(bh, s, d, itemsize, causal, with_glse, peaks,
              od_itemsize=None):
    """Least time (s) the card could take for one backward, and what
    bounds it: q, k, v, o, dO read and dq, dk, dv written once (o and dO
    ``od_itemsize`` bytes an element, default the inputs'), lse (and
    g_lse) read once; five products of 2*D FLOPs per visible (query, key)
    pair, on the tensor cores for bf16."""
    nbytes = (bh * s * d * (6 * itemsize + 2 * (od_itemsize or itemsize))
              + bh * s * 4 * (2 if with_glse else 1))
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 10 * bh * pairs * d
    rate = peaks["bf16"] if itemsize == 2 else peaks["f32"]
    t_bytes, t_ops = nbytes / peaks["bytes"], flops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_inputs(gen, bh, s, d, dname, causal, with_glse):
    """Seeded q, k, v, dO (and g_lse) of one backward case on the card, and
    the forward's o and lse for them."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import flash_fwd

    dtype = getattr(torch, dname)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    glse = (torch.randn(bh, s, generator=gen, device="cuda")
            if with_glse else None)
    o, lse = flash_fwd(q, k, v, causal)
    return q, k, v, o, lse, do, glse


def bwd_entry_launch(q, k, v, o, lse, do, causal, want):
    """A function that launches the backward's kernels through their
    entry point, ``ff_flash_attn_bwd``, with the arguments ``flash_bwd``
    gives it (K5's for an f32 o beside bf16 q), into outputs and scratch
    allocated once: the launch ``flash_bwd`` makes, without its
    allocations, and not counted. Checks that one launch gives ``want``
    (``flash_bwd``'s dq, dk, dv) bit for bit."""
    import ctypes

    import torch
    from flexflow_tpu_torch import cuda_build
    from flexflow_tpu_torch.ops.flash_attention import (
        BWD_ARGTYPES, bwd_launch_args, bwd_scratch)

    fn = cuda_build.load("flash_attn_bwd").ff_flash_attn_bwd
    fn.argtypes, fn.restype = BWD_ARGTYPES, ctypes.c_int
    out = [torch.empty_like(x) for x in (q, k, v)]
    scratch = bwd_scratch(q, o)
    args = bwd_launch_args(q, k, v, o, lse, do, None, *out, *scratch,
                           causal=causal,
                           stream=torch.cuda.current_stream().cuda_stream)

    def launch():
        check(fn(*args) == 0, "flash_attn_bwd entry point: launch failed")

    # the entry point writes through raw pointers: the outputs and scratch
    # live as long as the function that launches into them
    launch.buffers = (out, scratch)
    launch()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, want)),
          "the entry point's launch differs from flash_bwd's")
    return launch


def phase_kernels_bwd():
    """K2/K3 against the plain version on the card, every case of
    BWD_CASES; bit-equal results from two runs; returns the entries of the
    kernels line for the cases of BWD_TIMED, in its order: the training
    shape (K2), K3's regime and the decoder's training launch (K2)."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_bwd,
                                                        flash_bwd_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entries = []
    for case in BWD_CASES:
        bh, s, d, dname, causal, with_glse = case
        q, k, v, o, lse, do, glse = bwd_inputs(gen, *case)
        got = flash_bwd(q, k, v, o, lse, do, causal, glse)
        torch.cuda.synchronize()
        want = flash_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                                   lse, do.float(), causal, glse)
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"non-finite backward at {case}")
        errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        scales = [w.abs().max().item() for w in want]
        scales = [max(sc, BWD_SCALE_FLOOR * max(scales)) for sc in scales]
        tol = BWD_TOL[dname]
        print(f"[kernels] flash_attn_bwd BH={bh} S={s} D={d} {dname} "
              f"causal={causal} g_lse={'random' if with_glse else 0}: "
              + ", ".join(f"{n} max_abs_err {e:.3e} ({e / sc:.2e} of max "
                          f"{sc:.3e})" for n, e, sc in
                          zip(("dq", "dk", "dv"), errs, scales))
              + f" (tol {tol} of max)")
        check(all(e <= tol * sc for e, sc in zip(errs, scales)),
              f"backward kernel disagrees with its plain version at {case}")
        if case not in BWD_TIMED:
            continue
        # the training shapes. The kernels are timed through their entry
        # point with the arguments flash_bwd gives it (the wrapper's
        # allocations and checks, timed beside it, take about as long on
        # the host as the kernels on the card at S 512); the library by
        # scaled_dot_product_attention's backward node called directly on
        # its saved forward: the op autograd runs, without the engine.
        launch = bwd_entry_launch(q, k, v, o, lse, do, causal, got)
        ms, host_ms = time_calls(launch)
        wrapper_ms, wrapper_host_ms = time_calls(
            lambda: flash_bwd(q, k, v, o, lse, do, causal))
        plain_ms = time_ms(
            lambda: flash_bwd_reference(q, k, v, o, lse, do, causal))
        name, heads = BWD_TIMED[case]
        b = bh // heads
        lq, lk, lv = (x.view(b, heads, s, d).detach().requires_grad_()
                      for x in (q, k, v))
        ldo = do.view(b, heads, s, d)
        node = sdpa(lq, lk, lv, is_causal=causal).grad_fn
        lib = lambda: node(ldo)
        lib_errs = [(g.reshape(bh, s, d).float() - w).abs().max().item() / sc
                    for g, w, sc in zip(lib(), want, scales)]
        print(f"[kernels] library backward {node.name()} at S={s}: dq, dk, "
              f"dv against the plain version "
              + ", ".join(f"{e:.2e}" for e in lib_errs) + " of max")
        check(len(lib_errs) == 3 and max(lib_errs) <= tol,
              f"the library's backward node does not give dq, dk, dv at {case}")
        library_ms, library_host_ms = time_calls(lib)
        _, fb_host_ms = time_calls(
            lambda: torch.autograd.grad(sdpa(lq, lk, lv, is_causal=causal),
                                        (lq, lk, lv), ldo))
        dev_ms = profiled_ms(launch, label=f"kernel S={s}")
        lib_dev_ms = profiled_ms(lib, label=f"library backward S={s}")
        bound_s, bound_by = bwd_bound(bh, s, d, q.element_size(), causal,
                                      with_glse, H100_SXM_PEAKS)
        k3 = s > 1024
        entries.append(dict(
            name=name, route="cuda",
            source="flexflow_tpu_torch/csrc/flash_attn_bwd.cu",
            replaces=("flexflow_tpu/ops/pallas_kernels.py:214 "
                      "(_flash_bwd_blocked)" if k3 else
                      "flexflow_tpu/ops/pallas_kernels.py:144 (_flash_bwd)"),
            shape=f"BH={bh} S={s} D={d} {dname} causal={causal}",
            launches=None, max_abs_err=max(errs),
            rel_err=max(e / sc for e, sc in zip(errs, scales)),
            ms=ms, timed_by="back to back", host_ms=host_ms,
            device_ms=dev_ms, wrapper_ms=wrapper_ms,
            wrapper_host_ms=wrapper_host_ms, plain_ms=plain_ms,
            library_ms=library_ms, library_host_ms=library_host_ms,
            library_device_ms=lib_dev_ms,
            library_fwd_bwd_host_ms=fb_host_ms,
            bound_ms=bound_s * 1e3, bound_by=bound_by))
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
        print(f"[kernels] backward at BH={bh} S={s} D={d} causal={causal}: "
              f"kernels {ms:.4f} ms a "
              f"launch back to back (host {host_ms:.4f} ms), profiled device "
              f"time {fmt(dev_ms)}; through flash_bwd {wrapper_ms:.4f} ms "
              f"(host {wrapper_host_ms:.4f} ms); plain {plain_ms:.4f} ms; "
              f"library backward {library_ms:.4f} ms back to back (host "
              f"{library_host_ms:.4f} ms), profiled {fmt(lib_dev_ms)}; "
              f"library fwd+bwd through autograd: host {fb_host_ms:.4f} ms "
              f"a call; bound {bound_s * 1e6:.2f} us ({bound_by})")
    check(len(entries) == len(BWD_TIMED),
          "missing a training-shape backward timing")
    for case in BWD_DETERMINISM_CASES:
        q, k, v, o, lse, do, glse = bwd_inputs(gen, *case)
        first = flash_bwd(q, k, v, o, lse, do, case[4], glse)
        second = flash_bwd(q, k, v, o, lse, do, case[4], glse)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(first, second)]
        print(f"[kernels] flash_attn_bwd determinism {case}: dq, dk, dv "
              f"bit-equal over two runs: {same}")
        check(all(same), f"two backward runs differ at {case}")
    return entries


def lse_inputs(gen, bh, s, d, causal):
    """Seeded bf16 q, k, v, K5's f32 o and lse for them, an f32 dO and a
    g_lse on the card."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import flash_fwd

    q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    o, lse = flash_fwd(q, k, v, causal, out_dtype=torch.float32)
    do = torch.randn(bh, s, d, generator=gen, device="cuda")
    glse = torch.randn(bh, s, generator=gen, device="cuda")
    return q, k, v, o, lse, do, glse


def phase_kernels_lse():
    """K5 (flash_attention_lse) against its plain version on the card: the
    forward's f32 o and lse, and the backward from f32 O and dO with
    g_lse zero and random, at the tile edges (LSE_CASES); bit-equal over
    two runs; both timed at the ring steps' shapes (LSE_SHAPES) by the
    profiler's device time (and the backward back to back through its
    entry point) beside the plain versions, the bounds and the nearest
    library calls. Returns the kernels line's K5 entries (forward,
    backward)."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_bwd,
                                                        flash_bwd_reference,
                                                        flash_fwd,
                                                        flash_lse_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    tol, btol = LSE_TOL, BWD_TOL["bfloat16"]
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    worst = dict(o=0.0, lse=0.0, grad=0.0, grad_rel=0.0)
    for bh, s, d, causal in LSE_CASES:
        q, k, v, o, lse, do, glse = lse_inputs(gen, bh, s, d, causal)
        torch.cuda.synchronize()
        ref_o, ref_lse = flash_lse_reference(q.float(), k.float(), v.float(),
                                             causal)
        check(o.dtype == torch.float32 and bool(torch.isfinite(o).all())
              and bool(torch.isfinite(lse).all()),
              f"K5 forward: non-finite or not f32 at {(bh, s, d, causal)}")
        ref_pv, _ = flash_lse_reference(q.float(), k.float(), v.float().abs(),
                                        causal)
        diff = (o - ref_o).abs()
        err_o = diff.max().item()
        ratio_o = (diff / (ref_pv * tol["o_rel"] + tol["o"])).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        worst["o"], worst["lse"] = (max(worst["o"], err_o),
                                    max(worst["lse"], err_lse))
        exact = (o.bfloat16().float() == o).float().mean().item()
        exact_max = ((1 / s if causal else 0.0) + LSE_BF16_EXACT_SLACK
                     if s > 1 else 1.0)
        line = (f"[kernels] K5 BH={bh} S={s} D={d} causal={causal}: forward o "
                f"max_abs_err {err_o:.3e}, worst element at {ratio_o:.3f} of "
                f"its bound (2^-8 P|V| + {tol['o']}), lse {err_lse:.3e} "
                f"(tol {tol['lse']}), share of o a bf16 holds exactly "
                f"{exact:.4f} (at most {exact_max:.4f}); backward")
        check(ratio_o <= 1.0 and err_lse <= tol["lse"],
              f"K5 forward disagrees with its plain version at "
              f"{(bh, s, d, causal)}")
        check(exact <= exact_max, f"K5's o is not f32 at {(bh, s, d, causal)}")
        for g in (None, glse):
            got = flash_bwd(q, k, v, o, lse, do, causal, g)
            torch.cuda.synchronize()
            want = flash_bwd_reference(q.float(), k.float(), v.float(), o, lse,
                                       do, causal, g)
            errs = [(a.float() - w).abs().max().item()
                    for a, w in zip(got, want)]
            scales = [w.abs().max().item() for w in want]
            scales = [max(sc, BWD_SCALE_FLOOR * max(scales)) for sc in scales]
            rel = max(e / sc for e, sc in zip(errs, scales))
            worst["grad"] = max(worst["grad"], *errs)
            worst["grad_rel"] = max(worst["grad_rel"], rel)
            line += (f" g_lse={'random' if g is not None else 0}: "
                     f"{rel:.2e} of max")
            check(all(bool(torch.isfinite(a).all()) for a in got)
                  and rel <= btol,
                  f"K5 backward disagrees with its plain version at "
                  f"{(bh, s, d, causal, g is not None)}")
        print(line + f" (tol {btol})")
    for bh, s, d, causal in LSE_DETERMINISM_CASES:
        q, k, v, o, lse, do, glse = lse_inputs(gen, bh, s, d, causal)
        again = flash_fwd(q, k, v, causal, out_dtype=torch.float32)
        first = flash_bwd(q, k, v, o, lse, do, causal, glse)
        second = flash_bwd(q, k, v, o, lse, do, causal, glse)
        torch.cuda.synchronize()
        same = ([torch.equal(a, b) for a, b in zip((o, lse), again)]
                + [torch.equal(a, b) for a, b in zip(first, second)])
        print(f"[kernels] K5 determinism {(bh, s, d, causal)}: o, lse, dq, "
              f"dk, dv bit-equal over two runs: {same}")
        check(all(same), f"two K5 runs differ at {(bh, s, d, causal)}")

    sdpa_flash = torch.ops.aten._scaled_dot_product_flash_attention
    entries = {}
    for label, bh, s in LSE_SHAPES:
        d, causal = 64, False
        q, k, v, o, lse, do, _ = lse_inputs(gen, bh, s, d, causal)
        b4 = lambda x: x.view(bh // 16, 16, s, d)
        fwd = lambda: flash_fwd(q, k, v, causal, out_dtype=torch.float32)
        fwd_ms = profiled_ms(fwd)
        fwd_b2b, fwd_host = time_calls(fwd)
        fwd_plain = time_ms(lambda: flash_lse_reference(q, k, v, causal))
        lib_fwd = lambda: sdpa_flash(b4(q), b4(k), b4(v))
        lib_fwd_ms = profiled_ms(lib_fwd)
        fb, fb_by = flash_bound(bh, s, d, 2, causal, H100_SXM_PEAKS,
                                o_itemsize=4)
        got = flash_bwd(q, k, v, o, lse, do, causal)
        launch = bwd_entry_launch(q, k, v, o, lse, do, causal, got)
        bwd_ms, bwd_host = time_calls(launch)
        bwd_dev = profiled_ms(launch, label=f"K5 backward {label}")
        bwd_plain = time_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do,
                                                        causal))
        lq, lk, lv = (b4(x).detach().requires_grad_() for x in (q, k, v))
        node = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv).grad_fn
        ldo = b4(do).bfloat16()
        lib_bwd = lambda: node(ldo)
        lib_bwd_ms = time_calls(lib_bwd)[0]
        lib_bwd_dev = profiled_ms(lib_bwd)
        bb, bb_by = bwd_bound(bh, s, d, 2, causal, False, H100_SXM_PEAKS,
                              od_itemsize=4)
        print(f"[kernels] K5 {label} (BH={bh} S={s} D={d} bf16 in, f32 o): "
              f"forward profiled {fmt(fwd_ms)}, {fwd_b2b:.4f} ms back to back "
              f"(host {fwd_host:.4f} ms), plain {fwd_plain:.4f} ms, library "
              f"(aten._scaled_dot_product_flash_attention, o in bf16: not the "
              f"same function) profiled {fmt(lib_fwd_ms)}, bound "
              f"{fb * 1e6:.2f} us ({fb_by}); backward {bwd_ms:.4f} ms back "
              f"to back (host {bwd_host:.4f} ms), profiled {fmt(bwd_dev)}, "
              f"plain {bwd_plain:.4f} ms, library backward node (bf16 o and "
              f"dO: not the same function) {lib_bwd_ms:.4f} ms, profiled "
              f"{fmt(lib_bwd_dev)}, bound {bb * 1e6:.2f} us ({bb_by})")
        if label == LSE_SHAPES[0][0]:
            shape = f"BH={bh} S={s} D={d} bf16 in, f32 o, causal={causal}"
            entries["fwd"] = dict(
                name="flash_attention_lse_fwd", route="cuda",
                source="flexflow_tpu_torch/csrc/flash_attn_fwd.cu",
                replaces=("flexflow_tpu/ops/pallas_kernels.py:290 "
                          "(flash_attention_lse, via _flash_fwd)"),
                shape=shape, launches=None, max_abs_err=worst["o"],
                lse_max_abs_err=worst["lse"],
                ms=fwd_ms if fwd_ms is not None else fwd_b2b,
                timed_by="profiler" if fwd_ms is not None else "back to back",
                b2b_ms=fwd_b2b, host_ms=fwd_host, plain_ms=fwd_plain,
                library_ms=lib_fwd_ms,
                library_note="aten._scaled_dot_product_flash_attention: o "
                             "in bf16, not the same function",
                bound_ms=fb * 1e3, bound_by=fb_by)
            entries["bwd"] = dict(
                name="flash_attention_lse_bwd", route="cuda",
                source="flexflow_tpu_torch/csrc/flash_attn_bwd.cu",
                replaces=("flexflow_tpu/ops/pallas_kernels.py:307 "
                          "(_flash_lse_vjp_bwd, via _flash_bwd with g_lse)"),
                shape=shape + ", f32 dO", launches=None,
                max_abs_err=worst["grad"], rel_err=worst["grad_rel"],
                ms=bwd_ms, timed_by="back to back", host_ms=bwd_host,
                device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd_ms,
                library_device_ms=lib_bwd_dev,
                library_note="scaled_dot_product_attention's backward node: "
                             "bf16 o and dO, no g_lse, not the same function",
                bound_ms=bb * 1e3, bound_by=bb_by)
    return entries["fwd"], entries["bwd"]


def phase_ring():
    """Ring attention on a {"seq": 4} mesh in one process, at full width
    and on the causal S 2048 ring (RING_SHAPES): o and the q/k/v gradients
    against K1/K2 over the whole sequence, K5's launches against the
    launch plan, and the times of both. Returns K5's launches by shape."""
    import torch
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.ops.flash_attention import flash_attention
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    mesh = make_mesh(4, RING_MESH)
    out = {}
    for b, h, s, d, causal in RING_SHAPES:
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device="cuda")
                       .bfloat16().requires_grad_(i < 3) for i in range(4))
        reset_launches()
        o = ring_attention(q, k, v, mesh, causal=causal)
        grads = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        launches = read_launches()
        plan = RING_LAUNCHES
        want = dict(flash_attn_fwd=0, flash_attn_bwd=0, fused_adam=0,
                    flash_lse_fwd=plan, flash_lse_bwd=plan)
        print(f"[ring] B={b} H={h} S={s} D={d} causal={causal} on "
              f"{RING_MESH}: launches {launches} (expected {want}: K5 "
              f"{plan} forward and {plan} backward a call, one a step with "
              f"an active position)")
        check(launches == want, "ring launches differ from the launch plan")
        o1 = flash_attention(q, k, v, causal=causal)
        grads1 = torch.autograd.grad(o1, (q, k, v), do)
        diff = (o.float() - o1.float()).abs()
        bound = (torch.maximum(o.float().abs(), o1.float().abs()) * 2.0 ** -7
                 + RING_TOL["o"])
        err_o, worst_o = diff.max().item(), (diff / bound).max().item()
        rel = [((a.float() - w.float()).abs().max()
                / w.float().abs().max()).item() for a, w in zip(grads, grads1)]
        print(f"[ring] against K1/K2 over the whole sequence: o max_abs_err "
              f"{err_o:.3e} (max |o| {o1.float().abs().max().item():.4f}; "
              f"worst element at {worst_o:.3f} of its bound, 2^-7 |o| + "
              f"{RING_TOL['o']}), dq, dk, dv "
              + ", ".join(f"{r:.2e}" for r in rel)
              + f" of max (tol {RING_TOL['grad']})")
        check(bool(torch.isfinite(o).all()) and worst_o <= 1.0
              and max(rel) <= RING_TOL["grad"],
              f"ring attention disagrees with K1/K2 at {(b, h, s, causal)}")
        qd, kd, vd = (x.detach() for x in (q, k, v))
        with torch.inference_mode():
            ring_fwd = profiled_ms(lambda: ring_attention(qd, kd, vd, mesh,
                                                          causal=causal))
            k1_fwd = profiled_ms(lambda: flash_attention(qd, kd, vd,
                                                         causal=causal))

        def step(fn):
            return lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), do)

        ring_fb, ring_fb_host = time_calls(step(
            lambda *a: ring_attention(*a, mesh, causal=causal)))
        k1_fb, k1_fb_host = time_calls(step(
            lambda *a: flash_attention(*a, causal=causal)))
        fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
        print(f"[ring] times: forward profiled, ring {fmt(ring_fwd)} vs K1 "
              f"{fmt(k1_fwd)}; forward + backward back to back, ring "
              f"{ring_fb:.4f} ms (host {ring_fb_host:.4f}) vs K1/K2 "
              f"{k1_fb:.4f} ms (host {k1_fb_host:.4f})")
        out[f"B{b}_S{s}_{'causal' if causal else 'full'}"] = launches[
            "flash_lse_fwd"]
    return out


def phase_train_c(cfg_kw, label, timed=False):
    """Training path (c), the slice's path: the seq-parallel BERT-proxy
    (``cfg_kw`` over ``TransformerConfig``) compiled for training on a
    {"seq": 4} mesh, no strategy file, against the same seeded weights
    without ``seq_parallel`` (the K1 path): ``predict`` within the ring's
    tolerance, TRAIN_C_STEPS per-step losses within TRAJECTORY_RTOL,
    K5's launches = layers x steps x the launch plan and no K1/K2/K4
    launch; then a ``predict`` and the step's p50; then GRAPH_STEPS
    compiled steps against eager ones from one state, bit for bit, K5's
    launches a replay, and the device-busy share of replayed steps; with
    ``timed``, also of eager steps, and GRAPH_PAIRS interleaved pairs of a
    compiled and an eager step timed. Returns the launches of the fit
    steps and the replayed steps' profile."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.machine import make_mesh
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.obs.registry import percentile
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    cfg = TransformerConfig(seq_parallel="seq", **cfg_kw)
    mesh = make_mesh(4, RING_MESH)
    t0 = time.perf_counter()
    ring = compile_for_training(cfg, mesh=mesh)
    plain = compile_for_training(TransformerConfig(**cfg_kw))
    torch.cuda.synchronize()
    attn = [n.op for n in ring.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    check(len(attn) == cfg.num_layers and all(
        op.selected_impl("cuda", mesh.shape, training=True) == "ring"
        for op in attn), f"[train c {label}] attention does not take the ring")
    check(all(torch.equal(ring.params[o][n], plain.params[o][n])
              for o in plain.params for n in plain.params[o]),
          f"[train c {label}] the two models' seeded weights differ")
    print(f"[train c {label}] {cfg} on mesh {mesh.shape}: compiled with the "
          f"K1-path twin in {time.perf_counter() - t0:.2f} s")
    x, y = training_batch(cfg, seed=5)
    p_ring, p_plain = ring.predict(x), plain.predict(x)
    err = float(np.abs(p_ring - p_plain).max())
    scale = float(np.abs(p_plain).max())
    print(f"[train c {label}] predict, ring vs K1 path: max_abs_err "
          f"{err:.4e}, max |output| {scale:.4e}, ratio {err / scale:.3e} "
          f"(tol {MODEL_RTOL})")
    check(np.isfinite(p_ring).all() and err <= MODEL_RTOL * scale,
          f"[train c {label}] ring predict disagrees with the K1 path")
    torch.cuda.synchronize()
    reset_launches()
    step_s = []
    for _ in range(TRAIN_C_STEPS):
        t0 = time.perf_counter()
        ring.fit(x, y, epochs=1, verbose=False)  # ends in a host read
        step_s.append(time.perf_counter() - t0)
    launches = read_launches()
    plan = cfg.num_layers * TRAIN_C_STEPS * RING_LAUNCHES
    want = dict(flash_attn_fwd=0, flash_attn_bwd=0, fused_adam=0,
                flash_lse_fwd=plan, flash_lse_bwd=plan)
    print(f"[train c {label}] launches over {TRAIN_C_STEPS} steps: "
          f"{launches} (expected {want}: {cfg.num_layers} layers x "
          f"{TRAIN_C_STEPS} steps x {RING_LAUNCHES} K5 launches a ring call, "
          f"forward and backward)")
    check(launches == want, f"[train c {label}] launches differ from the "
                            f"expected count")
    plain.fit(x, y, epochs=TRAIN_C_STEPS, verbose=False)
    rel = [abs(a - b) / abs(b)
           for a, b in zip(ring.epoch_losses, plain.epoch_losses)]
    print(f"[train c {label}] losses, ring: "
          + ", ".join(f"{v:.6f}" for v in ring.epoch_losses)
          + "; K1 path: " + ", ".join(f"{v:.6f}" for v in plain.epoch_losses)
          + f"; worst {max(rel):.3e} relative (tol {TRAJECTORY_RTOL})")
    check(len(ring.epoch_losses) == TRAIN_C_STEPS
          and all(np.isfinite(ring.epoch_losses))
          and max(rel) <= TRAJECTORY_RTOL,
          f"[train c {label}] the ring's losses leave the K1 path's")
    out = ring.predict(x)
    check(out.shape == (cfg.batch_size, cfg.seq_length, 1)
          and np.isfinite(out).all(),
          f"[train c {label}] predict after training: {out.shape}")
    p50 = statistics.median(step_s)
    print(f"[train c {label}] step time (fit of one step, host clock, ends in "
          f"the epoch's host read): p50 {p50 * 1e3:.3f} ms over "
          f"{TRAIN_C_STEPS} steps ("
          + ", ".join(f"{t * 1e3:.3f}" for t in step_s)
          + f" ms), {cfg.batch_size / p50:.2f} samples/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del plain
    release()
    per_call = graph_vs_eager(ring, x, y, GRAPH_STEPS, f"[train c {label}]")
    k5 = cfg.num_layers * RING_LAUNCHES
    check(all(d == dict(want, flash_lse_fwd=k5, flash_lse_bwd=k5)
              for d in per_call),
          f"[train c {label}] launches a replay differ: K5 {k5} each way "
          f"expected")
    sg = ring.executor.step_graphs["train_step"]
    replays0 = sg.replays
    prof = profile_train(ring, x, y, label=f"[train c {label}] 2 replayed "
                                          f"steps")
    check(sg.replays - replays0 == 2 + LEAD_IN_CALLS,
          f"[train c {label}] the profiled steps were not 2 replays")
    replay_launches = check_replay_launches(
        f"[train c {label}] 2 replayed steps", prof, 2,
        dict(flash_lse_fwd=k5, flash_lse_bwd=k5))
    del sg
    out = dict(launches=launches, replay_launches=replay_launches,
               kinds=prof[0])
    if timed:
        inputs, labels = ring._stage_inputs([x]), ring._stage_labels(y)
        profile_steps(f"[train c {label}] 2 eager steps",
                      eager_stepper(ring, inputs, labels)[0])
        g_s, e_s, enq = time_pairs(ring, x, y, GRAPH_PAIRS)
        (g50, g90), (e50, e90) = p50_p90(g_s), p50_p90(e_s)
        print(f"[train c {label}] {GRAPH_PAIRS} interleaved pairs, step time "
              f"(host clock, ends in a host read of the loss): compiled p50 "
              f"{g50 * 1e3:.3f} ms, p90 {g90 * 1e3:.3f} ms; eager p50 "
              f"{e50 * 1e3:.3f} ms, p90 {e90 * 1e3:.3f} ms; eager / "
              f"compiled {e50 / g50:.2f} at p50; a replay's host enqueue "
              f"p50 {statistics.median(enq) * 1e3:.3f} ms "
              f"({nvidia_smi_line()})")
        out.update(p50=g50, eager_p50=e50)
    del ring
    release()
    return out


def write_strategy(ff, path, choice_of):
    """Write a one-device strategy file for ``ff``'s layers, each op's
    choice ``choice_of(its OperatorType)``."""
    from flexflow_tpu_torch import OperatorType

    ops = {layer.name: dict(choice=choice_of(layer.op_type), outputs=[None],
                            params={})
           for layer in ff.layers if layer.op_type != OperatorType.INPUT}
    with open(path, "w") as f:
        json.dump(dict(version=1, mesh={"data": 1}, ops=ops), f, indent=1)


def kernel_path(remat=False):
    """The kernel path's choice by op type (training path (b) and the
    decoder's): attention ``dp_k:flash`` (K1, K2), every other op
    ``dp_k:fused`` (K4); with ``remat``, ``_r`` on every attention and
    every RMSNorm."""
    from flexflow_tpu_torch import OperatorType

    r = "_r" if remat else ""

    def choice_of(kind):
        if kind == OperatorType.MULTIHEAD_ATTENTION:
            return "dp_k:flash" + r
        return "dp_k:fused" + (r if kind == OperatorType.RMSNORM else "")

    return choice_of


COUNTER_KEYS = {"flash_fwd.launches": "flash_attn_fwd",
                "flash_bwd.launches": "flash_attn_bwd",
                "fused_adam_multi.launches": "fused_adam",
                "flash_fwd.lse_launches": "flash_lse_fwd",
                "flash_bwd.lse_launches": "flash_lse_bwd"}


def reset_launches():
    from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from flexflow_tpu_torch.ops.fused_update import fused_adam_multi

    flash_fwd.launches = flash_bwd.launches = fused_adam_multi.launches = 0
    flash_fwd.lse_launches = flash_bwd.lse_launches = 0


def read_launches():
    """Every kernel's launches since ``reset_launches``: K1, K2/K3, K4,
    and K5's forward and backward."""
    from flexflow_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from flexflow_tpu_torch.ops.fused_update import fused_adam_multi

    return dict(flash_attn_fwd=flash_fwd.launches,
                flash_attn_bwd=flash_bwd.launches,
                fused_adam=fused_adam_multi.launches,
                flash_lse_fwd=flash_fwd.lse_launches,
                flash_lse_bwd=flash_bwd.lse_launches)


def training_batch(cfg, seed=0):
    import numpy as np

    rs = np.random.RandomState(seed)
    x = rs.randn(cfg.batch_size, cfg.seq_length,
                 cfg.hidden_size).astype(np.float32)
    y = rs.randn(cfg.batch_size, cfg.seq_length, 1).astype(np.float32)
    return x, y


def compile_for_training(cfg, strategy_dir=None, mixed=True, alpha=1e-4,
                         mesh=None, choice_of=None, strategy_file=None,
                         **cfg_kw):
    """The BERT-proxy ``cfg`` on the card, compiled for training as the
    reference's bert_proxy is (Adam alpha 1e-4 with bf16 moments, MSE
    avg-reduce loss, MSE metric); with ``strategy_dir``, through the
    strategy file of path (b) written there (or of ``choice_of``, a
    choice by op type); through ``strategy_file`` as it is; over
    ``mesh`` if given; ``cfg_kw`` are further ``FFConfig`` fields. The
    weights come from the config's seed, so every call starts from the
    same weights."""
    import torch
    from flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from flexflow_tpu_torch.models.transformer import create_transformer
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    ff = create_transformer(cfg, FFConfig(batch_size=cfg.batch_size,
                                          allow_mixed_precision=mixed,
                                          **cfg_kw),
                            device="cuda")
    if strategy_dir is not None:
        path = os.path.join(strategy_dir, "strategy.json")
        write_strategy(ff, path, choice_of or kernel_path())
        ff.config.import_strategy_file = path
    if strategy_file is not None:
        ff.config.import_strategy_file = strategy_file
    ff.compile(AdamOptimizer(alpha=alpha, state_dtype=torch.bfloat16),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
               [MetricsType.MEAN_SQUARED_ERROR], mesh=mesh)
    return ff


def phase_train_b(strategy_dir):
    """Training path (b) at full width: the main path of this slice.
    Returns (model, batch, launches over the timed steps, the losses of
    the warm-up and timed steps)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    cfg = TransformerConfig()
    t0 = time.perf_counter()
    ff = compile_for_training(cfg, strategy_dir)
    torch.cuda.synchronize()
    attn = [n.op for n in ff.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    fused = ff.executor.fused_update_ops & set(ff.params)
    n_leaves = sum(len(ff.params[op]) for op in fused)
    n_elems = sum(t.numel() for op in fused for t in ff.params[op].values())
    print(f"[train b] model {cfg} compiled for training in "
          f"{time.perf_counter() - t0:.2f} s; compute dtype "
          f"{ff.executor.compute_dtype}; {len(fused)} fused ops, {n_leaves} "
          f"leaves, {n_elems} elements through fused Adam")
    check(len(attn) == cfg.num_layers and all(
        op.kernel_impl == "flash"
        and op.selected_impl("cuda", training=True) == "flash"
        for op in attn), "the strategy did not pin every attention to flash")
    check(ff.kernel_choices and n_leaves == 8 * cfg.num_layers + 2,
          f"expected 98 fused leaves, got {n_leaves}")
    x, y = training_batch(cfg)
    for _ in range(TRAIN_WARMUP):
        ff.fit(x, y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    reset_launches()
    step_s = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        ff.fit(x, y, epochs=1, verbose=False)  # ends in a host read
        step_s.append(time.perf_counter() - t0)
    launches = read_launches()
    losses = list(ff.epoch_losses)
    print(f"[train b] loss per step: "
          + ", ".join(f"{v:.6f}" for v in losses))
    check(len(losses) == TRAIN_WARMUP + TRAIN_STEPS
          and all(np.isfinite(losses)), "non-finite training loss")
    want = dict(flash_attn_fwd=cfg.num_layers * TRAIN_STEPS,
                flash_attn_bwd=cfg.num_layers * TRAIN_STEPS,
                fused_adam=TRAIN_STEPS, flash_lse_fwd=0, flash_lse_bwd=0)
    print(f"[train b] launches over {TRAIN_STEPS} steps: {launches} "
          f"(expected {want}: per step {cfg.num_layers} forward, "
          f"{cfg.num_layers} backward launches, each the dK/dV and the dQ "
          f"kernel, and one fused Adam)")
    check(launches == want, "kernel launches differ from the expected count")
    from flexflow_tpu_torch.obs.registry import percentile

    p50 = statistics.median(step_s)
    p90 = percentile(sorted(step_s), 0.90)
    print(f"[train b] step time (fit of one step, host clock, ends in the "
          f"epoch's host read): p50 {p50 * 1e3:.3f} ms, p90 {p90 * 1e3:.3f} "
          f"ms, {cfg.batch_size / p50:.2f} samples/s at p50; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_train(ff, x, y)
    return ff, (x, y), launches, losses


def phase_train_trajectory(losses, strategy_dir):
    """The kernel path's per-step losses against the plain path's (einsum
    core, plain Adam, no strategy) from the same weights and batch; then
    the kernel path at a small step size, where the loss must fall.
    Returns the plain path's losses."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    cfg = TransformerConfig()
    x, y = training_batch(cfg)
    plain = compile_for_training(cfg)
    for n in plain.executor.nodes:
        if isinstance(n.op, MultiHeadAttention):
            n.op.kernel_impl = "einsum"
    plain.fit(x, y, epochs=len(losses), verbose=False)
    plain_losses = list(plain.epoch_losses)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain.epoch_losses)]
    print(f"[train trajectory] plain path (einsum core, plain Adam) losses: "
          + ", ".join(f"{v:.6f}" for v in plain.epoch_losses)
          + f"; kernel path vs plain: worst step {int(np.argmax(rel)) + 1} "
          f"at {max(rel):.3e} relative (tol {TRAJECTORY_RTOL})")
    check(max(rel) <= TRAJECTORY_RTOL,
          "the kernel path's losses leave the plain path's")
    del plain
    small = compile_for_training(cfg, strategy_dir, alpha=DESCENT_ALPHA)
    small.fit(x, y, epochs=len(losses), verbose=False)
    print(f"[train trajectory] kernel path at alpha {DESCENT_ALPHA}: losses "
          + ", ".join(f"{v:.6f}" for v in small.epoch_losses))
    check(all(np.isfinite(small.epoch_losses))
          and small.epoch_losses[-1] < small.epoch_losses[0],
          f"the loss did not fall over {len(losses)} steps at alpha "
          f"{DESCENT_ALPHA}")
    del small
    torch.cuda.empty_cache()
    return plain_losses


def phase_graph_train(strategy_dir):
    """[graph train] train (b) at full width through the compiled step (a
    CUDA-graph replay): from one state GRAPH_STEPS + 1 compiled calls (the
    first runs the step eagerly and captures it) against as many eager
    steps, bit for bit; K1 12, K2 12 and K4 once a replay; two replayed
    and two eager steps profiled (the kernels by name, the busy share,
    the memcpys that copy the batch in and the new state back); GRAPH_PAIRS
    interleaved pairs of a compiled and an eager step timed; peak memory
    of each; ``evaluate`` and ``predict`` twice each (a capture, then a
    replay) against the eager eval step and forward, bit for bit; then
    ``make_multi_step(MULTI_STEPS, stacked=True)`` against MULTI_STEPS
    single compiled steps from one state. Returns the report's
    numbers."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig()
    release()
    base_gib = torch.cuda.memory_reserved() / 2**30
    ff = compile_for_training(cfg, strategy_dir)
    ex = ff.executor
    x, y = training_batch(cfg, seed=7)
    per_call = graph_vs_eager(ff, x, y, GRAPH_STEPS + 1, "[graph train]")
    want = dict(flash_attn_fwd=cfg.num_layers, flash_attn_bwd=cfg.num_layers,
                fused_adam=1, flash_lse_fwd=0, flash_lse_bwd=0)
    check(all(d == want for d in per_call),
          f"[graph train] launches a compiled call {per_call}, want {want}")
    sg = ex.step_graphs["train_step"]
    print(f"[graph train] the executor's graph pool reserves "
          f"{pool_gib(ff):.2f} "
          f"GiB (the captured step's activations, gradients and new "
          f"state); the copy-back writes {sg.copy_back_bytes / 2**20:.1f} "
          f"MiB a step into {sg.copy_back_leaves} leaves (the plain-Adam "
          f"params, m and v, t, and the bf16 compute copy), at least "
          f"{2 * sg.copy_back_bytes / H100_SXM_PEAKS['bytes'] * 1e3:.4f} ms "
          f"of device time (read and written once)")

    inputs, labels = ff._stage_inputs([x]), ff._stage_labels(y)
    graph = graph_stepper(ff, x, y)
    eager, _ = eager_stepper(ff, inputs, labels)
    replays0 = sg.replays
    prof_graph = profile_steps("[graph train] 2 replayed steps", graph)
    check(sg.replays - replays0 == 2 + LEAD_IN_CALLS,
          "[graph train] the profiled steps were not 2 replays")
    replay_launches = check_replay_launches(
        "[graph train] 2 replayed steps", prof_graph, 2, want)
    prof_eager = profile_steps("[graph train] 2 eager steps", eager)
    copies = prof_graph[3]
    print(f"[graph train] copies in the 2 replayed steps: "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in sorted(copies.items()))
          + " (HtoD: the batch from its pinned buffer into the static "
          "feeds; DtoD: the copy-back)")
    peaks = {}
    for name, run in (("compiled", graph), ("eager", eager)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"[graph train] device memory a step allocates above what is "
          f"live before it, at its peak: compiled {peaks['compiled']:.2f} "
          f"GiB (its graph runs in the pool above), eager "
          f"{peaks['eager']:.2f} GiB")
    g_s, e_s, enq = time_pairs(ff, x, y, GRAPH_PAIRS)
    (g50, g90), (e50, e90) = p50_p90(g_s), p50_p90(e_s)
    print(f"[graph train] {GRAPH_PAIRS} interleaved pairs, step time (host "
          f"clock, ends in a host read of the loss): compiled p50 "
          f"{g50 * 1e3:.3f} ms, p90 {g90 * 1e3:.3f} ms; eager p50 "
          f"{e50 * 1e3:.3f} ms, p90 {e90 * 1e3:.3f} ms; eager / compiled "
          f"{e50 / g50:.2f} at p50; a replay's host enqueue p50 "
          f"{statistics.median(enq) * 1e3:.3f} ms ({nvidia_smi_line()})")

    # evaluate and predict through their compiled steps, against the
    # eager eval step and forward from the same state
    want_loss = float(ex._eval_step_fn()(ff.params, ff.state, inputs,
                                         labels)[0])
    reports = [ff.evaluate(x, y)["loss"] for _ in range(2)]
    want_out = eager_predict(ff, x)
    outs = [ff.predict(x) for _ in range(2)]
    graphs = {n: ex.step_graphs[n] for n in ("eval_step", "forward")}
    print(f"[graph train] evaluate {reports} against the eager eval step "
          f"{want_loss!r}; predict against the eager forward: "
          f"{[bool(np.array_equal(o, want_out)) for o in outs]}; captures "
          f"and replays "
          f"{ {n: (g.captures, g.replays) for n, g in graphs.items()} }")
    check(reports == [want_loss] * 2
          and all(np.array_equal(o, want_out) for o in outs)
          and all((g.captures, g.replays) == (1, 1)
                  for g in graphs.values()),
          "[graph train] evaluate or predict differ from the eager steps, "
          "or did not replay their graphs")

    # make_multi_step(MULTI_STEPS, stacked=True) against MULTI_STEPS
    # single compiled steps from one state, on distinct batches
    rs = np.random.RandomState(8)
    xs = rs.randn(MULTI_STEPS, cfg.batch_size, cfg.seq_length,
                  cfg.hidden_size).astype(np.float32)
    ys = rs.randn(MULTI_STEPS, cfg.batch_size, cfg.seq_length,
                  1).astype(np.float32)
    start = clone_tree((ff.params, ff.opt_state, ff.state))
    step = ex.make_train_step()
    single = []
    for i in range(MULTI_STEPS):
        ff.params, ff.opt_state, ff.state, loss, _ = step(
            ff.params, ff.opt_state, ff.state, ff._host_inputs([xs[i]]),
            ys[i], ff._generator)
        single.append(float(loss))
    with torch.no_grad():
        for t, s0 in zip(flatten_leaves((ff.params, ff.opt_state, ff.state)),
                         flatten_leaves(start)):
            t.copy_(s0)
    del start
    multi = ex.make_multi_step(MULTI_STEPS, stacked=True)
    captures = sg.captures
    before = read_launches()
    t0 = time.perf_counter()
    ff.params, ff.opt_state, ff.state, losses = multi(
        ff.params, ff.opt_state, ff.state, ff._host_inputs([xs]), ys,
        ff._generator)
    losses = losses.tolist()
    multi_s = time.perf_counter() - t0
    launched = launch_delta(before)
    print(f"[graph train] make_multi_step({MULTI_STEPS}, stacked=True) "
          f"losses " + ", ".join(f"{v:.6f}" for v in losses)
          + f" in {multi_s * 1e3:.3f} ms ({multi_s / MULTI_STEPS * 1e3:.3f} "
          f"ms a step); {MULTI_STEPS} single compiled steps "
          + ", ".join(f"{v:.6f}" for v in single) + f"; launches {launched}")
    check(losses == single, "[graph train] the multi-step's losses differ "
          "from the single compiled steps'")
    check(launched == {k: v * MULTI_STEPS for k, v in want.items()}
          and sg.captures == captures,
          "[graph train] the multi-step's launches differ, or it captured "
          "a graph of its own")
    del ff, ex, sg, graph, graphs, eager, run, step, multi
    release()
    left_gib = torch.cuda.memory_reserved() / 2**30
    print(f"[graph train] the model deleted, no collector run: "
          f"{left_gib:.2f} GiB reserved on the card, {base_gib:.2f} GiB "
          f"before it was built")
    check(left_gib <= base_gib + 0.5, "[graph train] the deleted model's "
          "memory (its graphs and their pool) was not freed by reference "
          "counting")
    return dict(per_call=per_call, kinds=prof_graph[0],
                replay_launches=replay_launches,
                eager_kinds=(prof_eager or [None])[0], p50=g50,
                eager_p50=e50)


def pool_gib(ff):
    """What the model's executor's CUDA-graph pool reserves, GiB."""
    import torch

    pool = tuple(ff.executor._graph_pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id") or ()) == pool) / 2**30


def release():
    """Give the allocator's cached blocks back after a model is deleted
    (the model, its executor and its compiled steps are freed by their
    reference counts as the last reference goes)."""
    import torch

    torch.cuda.empty_cache()


def profile_train(ff, x, y, steps=2, label=None):
    """``profile_steps`` over ``steps`` one-step ``fit``s: compiled steps,
    CUDA-graph replays once the model has captured its step."""
    return profile_steps(label or f"{steps} train steps",
                         lambda: ff.fit(x, y, epochs=1, verbose=False),
                         steps)


# Late in a long process the first call a fresh profiler session records
# can lose its first kernels (its first 4.4-6.0 ms, PERF.md §6; late in
# this script a K1, or a replay's K4, also behind 50 ms of device spin):
# each session runs LEAD_IN_CALLS calls before the
# measured ones and counts only the device events after the host range
# MEASURED_RANGE opens around the measured calls. A caller that counts
# replays across a profile counts these calls too.
LEAD_IN_CALLS = 1
MEASURED_RANGE = "chip_smoke_measured"


def profile_steps(label, run_step, steps=2, top_of=()):
    """Where the time of ``steps`` calls of ``run_step`` (each a training
    step that ends in a host read) goes on the device: kernel time by
    kind, the top kernels (also of each kind in ``top_of``), the busy
    share against the host clock, and the largest idle gaps (named by the
    kernel that ended each). Returns (ms by kind, events by kind, wall
    ms, ms by copy or set, launches by kernel wrapper, cuDNN's
    NCHW<->NHWC transform kernels: their ms, launches and ms by name), or
    None if the profiler recorded no kernel. The launches are the device's kernel events
    named by each wrapper's kernel (``step_graph.launch_counters``: the
    one kernel a launch runs once), keyed as ``read_launches``. The
    session opens with LEAD_IN_CALLS calls of ``run_step`` and keeps the
    device events after MEASURED_RANGE opens."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN_CALLS):
            run_step()
        torch.cuda.synchronize()
        with record_function(MEASURED_RANGE):
            t0 = time.perf_counter()
            for _ in range(steps):
                run_step()
            wall_ms = (time.perf_counter() - t0) * 1e3
    # the range is a host event and, as an annotation, a device one
    opened = [e.time_range.start for e in prof.events()
              if e.name == MEASURED_RANGE and e.device_type == DeviceType.CPU]
    check(len(opened) == 1, f"{label}: the profile holds {len(opened)} "
                            f"measured ranges, want 1")
    events = [e for e in device_events(prof)
              if e.name != MEASURED_RANGE and e.time_range.start >= opened[0]]
    if not events:
        print(f"[profile] {label}: torch.profiler recorded no kernel: the "
              f"breakdown is not measured")
        return None
    kinds = by_kind(events)
    counts = dict.fromkeys(KERNEL_KINDS, 0)
    for e in events:
        counts[kernel_kind(e.name)] += 1
    busy = sum(kinds.values())
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%), idle "
          f"{wall_ms - busy:.3f} ms; "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)"
                      for k, v in kinds.items() if v))
    totals = {}
    for e in events:
        t = totals.setdefault(e.name[:110], [0.0, 0, kernel_kind(e.name)])
        t[0] += e.time_range.elapsed_us() / 1e3
        t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    for name, (ms, n, _) in ranked[:8]:
        print(f"[profile]   top: {ms:.3f} ms in {n} launches: {name}")
    for kind in top_of:
        for name, (ms, n, _) in [kv for kv in ranked
                                 if kv[1][2] == kind][:8]:
            print(f"[profile]   top {kind}: {ms:.3f} ms in {n} launches: "
                  f"{name}")
    events.sort(key=lambda e: e.time_range.start)
    gaps = [(b.time_range.start - a.time_range.end, a.name[:70])
            for a, b in zip(events, events[1:])
            if b.time_range.start > a.time_range.end]
    gaps.sort(reverse=True)
    print(f"[profile]   idle between device events: {len(gaps)} gaps, "
          f"{sum(g for g, _ in gaps) / 1e3:.3f} ms; largest after: "
          + "; ".join(f"{g / 1e3:.3f} ms after {n}" for g, n in gaps[:5]))
    copies = {}
    for e in events:
        if kernel_kind(e.name) == "memcpy":
            copies[e.name] = (copies.get(e.name, 0.0)
                              + e.time_range.elapsed_us() / 1e3)
    transforms = {}
    for e in events:
        low = e.name.lower()
        if "nchwtonhwc" in low or "nhwctonchw" in low:
            t = transforms.setdefault(e.name[:110], [0.0, 0])
            t[0] += e.time_range.elapsed_us() / 1e3
            t[1] += 1
    layout = dict(ms=sum(t[0] for t in transforms.values()),
                  launches=sum(t[1] for t in transforms.values()),
                  by_name=transforms)
    print(f"[profile]   NCHW<->NHWC transforms: {layout['ms']:.3f} ms in "
          f"{layout['launches']} launches"
          + "".join(f"; {ms:.3f} ms in {n}: {name}"
                    for name, (ms, n) in sorted(transforms.items())))
    return kinds, counts, wall_ms, copies, launches_by_name(events), layout


def launches_by_name(events):
    """{read_launches key: device kernel events of that wrapper's kernel}."""
    import flexflow_tpu_torch.ops.flash_attention  # noqa: F401
    import flexflow_tpu_torch.ops.fused_update  # noqa: F401
    from flexflow_tpu_torch.step_graph import launch_counters

    got = {COUNTER_KEYS[f"{fn.__name__}.{attr}"]:
           sum(1 for e in events if is_kernel(e.name))
           for fn, attr, is_kernel in launch_counters()}
    check(sorted(got) == sorted(COUNTER_KEYS.values()),
          f"the registered launch counters {sorted(got)} are not the "
          f"kernels line's")
    return got


def check_replay_launches(label, prof, replays, want):
    """The kernels that ``replays`` replayed graphs ran on the device, by
    name from their profile: each wrapper's kernel ``want[key]`` times a
    replay, and the flash kernels' events all accounted for (a K1 or K5
    forward launch runs one kernel, a K2/K3 backward launch two, a K5
    backward launch three). Returns the launches a replay."""
    check(prof is not None, f"{label}: the profiler recorded no kernel, so "
                            f"the launches a replay are not measured")
    got = prof[4]
    per = {k: v / replays for k, v in got.items()}
    counts = prof[1]
    fwd_events = got["flash_attn_fwd"] + got["flash_lse_fwd"]
    bwd_events = 2 * got["flash_attn_bwd"] + 3 * got["flash_lse_bwd"]
    print(f"{label}: kernel events on the device by name over {replays} "
          f"replays {got}, a replay {per} (want {want}); flash forward "
          f"events {counts['flash_attn_fwd']} (want {fwd_events}), flash "
          f"backward events {counts['flash_attn_bwd']} (want {bwd_events}), "
          f"K4 events {counts['fused_adam']}")
    check(per == {k: want.get(k, 0) for k in per}
          and counts["flash_attn_fwd"] == fwd_events
          and counts["flash_attn_bwd"] == bwd_events
          and counts["fused_adam"] == got["fused_adam"],
          f"{label}: the kernels the replays ran differ from the expected")
    return {k: int(v) for k, v in per.items()}


def clone_tree(tree):
    from flexflow_tpu_torch.step_graph import flatten, unflatten

    leaves, spec = flatten(tree)
    return unflatten(spec, [t.clone() for t in leaves])


def leaves_differ(a, b):
    """How many leaves of two trees of one structure are not bit-equal."""
    import torch
    from flexflow_tpu_torch.step_graph import flatten

    la, sa = flatten(a)
    lb, sb = flatten(b)
    check(sa == sb, "the two trees differ in structure")
    return sum(1 for u, w in zip(la, lb) if not torch.equal(u, w))


def launch_delta(before):
    now = read_launches()
    return {k: now[k] - before[k] for k in now}


def eager_stepper(ff, inputs, labels):
    """One eager step (``_train_step_fn``) a call on a copy of the model's
    state, ending in a host read of its loss; returns (step, the trees)."""
    step = ff.executor._train_step_fn()
    trees = [clone_tree(ff.params), clone_tree(ff.opt_state),
             clone_tree(ff.state)]

    def run():
        p, o, st, loss, _ = step(*trees, inputs, labels, ff._generator)
        trees[:] = [p, o, st]
        return float(loss)

    return run, trees


def graph_stepper(ff, x, y):
    """One compiled step a call on the model's own state over the host
    batch (x, y), as ``fit`` gives it, ending in a host read of its loss;
    the host's time to enqueue each (the batch's copy and the replay,
    before the read) is appended to ``run.enqueue_s``."""
    step = ff.executor.make_train_step()
    inputs = ff._host_inputs(as_inputs(x))
    enqueue_s = []  # (not through ``run``: no cycle keeps ``ff`` alive)

    def run():
        t0 = time.perf_counter()
        ff.params, ff.opt_state, ff.state, loss, _ = step(
            ff.params, ff.opt_state, ff.state, inputs, y, ff._generator)
        enqueue_s.append(time.perf_counter() - t0)
        return float(loss)

    run.enqueue_s = enqueue_s
    return run


def as_inputs(x):
    """A model's batch as ``FFModel`` takes it: one array per input."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def graph_vs_eager(ff, x, y, steps, label, losses_out=None):
    """From the model's current state: ``steps`` eager steps
    (``_train_step_fn``) on a copy of it and ``steps`` compiled steps on
    the model itself, on one batch (``x``: an array, or one a model
    input); every loss, and every leaf of the parameters, the optimizer
    state (t included) and the state (the compute copy), must be
    bit-equal. Each pair of steps starts from one state of the model's
    generator, so that they draw one dropout mask (a capture's graph
    registers the generator, and a replay takes the offset it has then).
    Returns the launches of each compiled call; the compiled calls'
    losses are appended to ``losses_out``."""
    import torch

    inputs, labels = ff._stage_inputs(as_inputs(x)), ff._stage_labels(y)
    eager, trees = eager_stepper(ff, inputs, labels)
    graph = graph_stepper(ff, x, y)
    per_call, losses = [], []
    for _ in range(steps):
        # both steps draw their dropout masks from one generator state
        rng_state = ff._generator.get_state()
        want = eager()
        ff._generator.set_state(rng_state)
        before = read_launches()
        got = graph()
        per_call.append(launch_delta(before))
        losses.append((got, want))
    torch.cuda.synchronize()
    differ = leaves_differ((ff.params, ff.opt_state, ff.state), tuple(trees))
    n = len(flatten_leaves((ff.params, ff.opt_state, ff.state)))
    sg = ff.executor.step_graphs["train_step"]
    print(f"{label} compiled step vs eager step from one state, {steps} "
          f"steps: losses " + ", ".join(f"{g!r}/{w!r}" for g, w in losses)
          + f"; {differ} of {n} leaves (params, m, v, t, the op state and "
          f"the compute copy) "
          f"differ (want 0); captures {sg.captures}, replays {sg.replays}; "
          f"launches a compiled call {per_call}")
    check(all(g == w for g, w in losses) and differ == 0,
          f"{label} the compiled step is not bit-equal to the eager step")
    if losses_out is not None:
        losses_out.extend(g for g, _ in losses)
    return per_call


def flatten_leaves(tree):
    from flexflow_tpu_torch.step_graph import flatten

    return flatten(tree)[0]


def time_pairs(ff, x, y, pairs):
    """Compiled and eager steps timed in turn (the order alternating), each
    on its own copy of the state, by the host clock around a step and the
    host read of its loss. Returns (compiled s, eager s, the compiled
    steps' enqueue s)."""
    inputs, labels = ff._stage_inputs(as_inputs(x)), ff._stage_labels(y)
    eager, _ = eager_stepper(ff, inputs, labels)
    graph = graph_stepper(ff, x, y)
    graph()  # a capture, if the model has none yet
    graph.enqueue_s.clear()
    times = {graph: [], eager: []}
    for i in range(pairs):
        for run in ((graph, eager) if i % 2 == 0 else (eager, graph)):
            t0 = time.perf_counter()
            run()
            times[run].append(time.perf_counter() - t0)
    return times[graph], times[eager], graph.enqueue_s


def p50_p90(xs):
    from flexflow_tpu_torch.obs.registry import percentile

    return statistics.median(xs), percentile(sorted(xs), 0.90)


def leaf_shares(ga, gb):
    """{leaf: max |ga - gb| / max |gb|} over two gradient trees."""
    return {f"{op}/{pn}": ((ga[op][pn].float() - w.float()).abs().max()
                           / w.float().abs().max().clamp_min(1e-30)).item()
            for op, sub in gb.items() for pn, w in sub.items()}


def grads_of_core(ff, x, y, impl):
    """One backward from the model's current state with every attention
    op pinned to ``impl`` ("flash" or "einsum") -> grads."""
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    ex = ff.executor
    attn = [n.op for n in ex.nodes if isinstance(n.op, MultiHeadAttention)]
    pins = [op.kernel_impl for op in attn]
    ff._refresh_compute_params()
    for op in attn:
        op.kernel_impl = impl
    try:
        return ex.grads_of(ff.params, ff.state, ff._stage_inputs([x]),
                           ff._stage_labels(y))[2]
    finally:
        for op, pin in zip(attn, pins):
            op.kernel_impl = pin


def check_grads(ff, x, y, dname, label="[train grads]", nudged=None):
    """Flash gradients against einsum gradients from the model's state,
    each leaf within GRAD_RTOL or within FLOOR_FACTOR times its floor (the
    einsum core against itself with its input scaled by 1 +- NUDGE:
    ``nudged(sign)`` gives those gradients; by default the batch ``x``
    nudged)."""
    g_plain = grads_of_core(ff, x, y, "einsum")
    err = leaf_shares(grads_of_core(ff, x, y, "flash"), g_plain)
    nudged = nudged or (lambda sign: grads_of_core(
        ff, x * (1 + sign * NUDGE), y, "einsum"))
    nudged = [leaf_shares(nudged(sign), g_plain) for sign in (1, -1)]
    floor = {l: max(f[l] for f in nudged) for l in err}
    tol = GRAD_RTOL[dname]
    worst = max(err, key=err.get)
    over = sorted((l for l in err if err[l] > tol), key=lambda l: -err[l])
    bad = [l for l in over if err[l] > FLOOR_FACTOR * floor[l]]
    print(f"{label} {dname} compute, initial weights, flash core vs "
          f"einsum core: worst leaf {worst} at {err[worst]:.3e} of its max "
          f"|g| (tol {tol}); its floor (einsum core, input scaled by 1 "
          f"+- {NUDGE}) {floor[worst]:.3e}; largest floor "
          f"{max(floor.values()):.3e}; {len(over)} of {len(err)} leaves "
          f"above tol: "
          + (", ".join(f"{l} {err[l]:.3e} (floor {floor[l]:.3e})"
                       for l in over[:6]) or "none"))
    check(not bad, f"{dname} gradients through the kernels disagree with "
                   f"the einsum core beyond tol and {FLOOR_FACTOR}x the "
                   f"floor: {bad[:5]}")


def phase_train_grads(ff, batch, strategy_dir):
    """The fused update of the trained model's flash gradients against
    AdamOptimizer.update from its mid-training state, bit for bit; then,
    from the initial weights, the flash core's gradients against the
    einsum core's in bf16 and in f32 compute. (After the timed steps at
    alpha 1e-4 the model is far from smooth: there the einsum core's
    gradients move by ~6e-2 of a leaf's norm when its own input is nudged
    by 1e-6, so the comparison is made where it can see the kernels.)"""
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                     fused_optimizer_update)

    g_flash = grads_of_core(ff, *batch, "flash")
    clone = lambda tree: {op: {pn: t.clone() for pn, t in sub.items()}
                          for op, sub in tree.items()}
    opt, state = ff.optimizer, ff.opt_state
    want_p, want_s = opt.update(g_flash, state, ff.params)
    before = fused_adam_multi.launches
    got_p, got_s = fused_optimizer_update(
        opt, g_flash, dict(m=clone(state["m"]), v=clone(state["v"]),
                           t=state["t"]), clone(ff.params),
        ff.executor.fused_update_ops)
    torch.cuda.synchronize()
    check(fused_adam_multi.launches == before + 1,
          "the fused update did not launch the kernel once")
    differ = [f"{op}/{pn}" for op in ff.params for pn in ff.params[op]
              if not (torch.equal(got_p[op][pn], want_p[op][pn])
                      and torch.equal(got_s["m"][op][pn], want_s["m"][op][pn])
                      and torch.equal(got_s["v"][op][pn], want_s["v"][op][pn]))]
    n_fused = sum(len(ff.params[o]) for o in ff.executor.fused_update_ops
                  if o in ff.params)
    print(f"[train grads] fused update (one kernel launch over the {n_fused} "
          f"fused leaves) vs AdamOptimizer.update at t = "
          f"{int(state['t']) + 1}: {len(differ)} leaves differ (want 0)")
    check(not differ, f"fused update not bit-equal: {differ[:5]}")
    del want_p, want_s, got_p, got_s, g_flash

    for mixed, dname in ((True, "bfloat16"), (False, "float32")):
        fresh = compile_for_training(TransformerConfig(), strategy_dir,
                                     mixed=mixed)
        check(fresh.executor.compute_dtype == getattr(torch, dname),
              f"expected {dname} compute")
        check_grads(fresh, *batch, dname)
        del fresh
        torch.cuda.empty_cache()


def adam_bound(n_elems, g_size, s_size, peaks):
    """Least time (s) of one fused Adam step over ``n_elems`` elements:
    p read and written (f32), g read, m and v read and written; 15 f32
    operations an element (outside the tensor cores)."""
    nbytes = n_elems * (8 + g_size + 4 * s_size)
    t_bytes, t_ops = nbytes / peaks["bytes"], 15 * n_elems / peaks["f32"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels_adam(ff):
    """K4 against its plain version over the 158 leaf shapes of the
    full-width model, bit for bit; times it on the fused leaves of the
    main path. Returns the entry of the kernels line."""
    import torch
    from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                     fused_adam_reference)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    leaves = [(op, pn) for op, sub in ff.params.items() for pn in sub]
    shapes = [tuple(ff.params[op][pn].shape) for op, pn in leaves]
    check(len(shapes) == 158, f"expected 158 leaves, got {len(shapes)}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rnd = lambda shp, k=1.0: torch.randn(shp, generator=gen,
                                         device="cuda") * k
    ps = [rnd(s) for s in shapes]
    gs = [rnd(s, 1e-2).bfloat16() for s in shapes]
    for sdt_name, t, wd in ADAM_CASES:
        sdt = getattr(torch, sdt_name)
        ms = [rnd(s, 1e-2).to(sdt) for s in shapes]
        vs = [(rnd(s, 1e-2) ** 2).to(sdt) for s in shapes]
        _, alpha_t = AdamOptimizer(alpha=1e-4).step_scalars(
            torch.tensor(t - 1, dtype=torch.int32, device="cuda"))
        want = fused_adam_reference(ps, gs, ms, vs, alpha_t, wd=wd, **ADAM_KW)
        kp = [p.clone() for p in ps]
        fused_adam_multi(kp, gs, ms, vs, alpha_t, wd=wd, **ADAM_KW)
        torch.cuda.synchronize()
        differ = sum(int((a != b).sum()) for got, w in zip(zip(kp, ms, vs),
                                                           want)
                     for a, b in zip(got, w))
        print(f"[kernels] fused_adam {len(shapes)} leaves, state {sdt_name}, "
              f"t={t}, wd={wd}: {differ} elements differ from the plain "
              f"version (want 0)")
        check(differ == 0, "fused Adam is not bit-equal to its plain version")
        del want
    # times on the main path's fused leaves, bf16 state
    fused = [i for i, (op, _) in enumerate(leaves)
             if op in ff.executor.fused_update_ops]
    fp = [ps[i] for i in fused]
    fg = [gs[i] for i in fused]
    fm = [rnd(shapes[i], 1e-2).bfloat16() for i in fused]
    fv = [(rnd(shapes[i], 1e-2) ** 2).bfloat16() for i in fused]
    alpha_t = torch.tensor(1e-4, device="cuda")
    n = sum(p.numel() for p in fp)
    ms = time_ms(lambda: fused_adam_multi(fp, fg, fm, fv, alpha_t, wd=0.0,
                                          **ADAM_KW))
    plain_ms = time_ms(lambda: fused_adam_reference(fp, fg, fm, fv, alpha_t,
                                                    wd=0.0, **ADAM_KW))
    lib_params = [torch.nn.Parameter(p.clone()) for p in fp]
    for lp, g in zip(lib_params, fg):
        lp.grad = g.float()
    lib = torch.optim.Adam(lib_params, lr=1e-4, fused=True)
    library_ms = time_ms(lib.step)
    bound_s, bound_by = adam_bound(n, 2, 2, H100_SXM_PEAKS)
    print(f"[kernels] fused_adam on the {len(fused)} fused leaves ({n} "
          f"elements, bf16 g/m/v): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, library (torch.optim.Adam fused, f32 moments and grads: not "
          f"the same function) {library_ms:.4f} ms, bound "
          f"{bound_s * 1e3:.4f} ms ({bound_by})")
    return dict(
        name="fused_adam", route="cuda",
        source="flexflow_tpu_torch/csrc/fused_adam.cu",
        replaces="flexflow_tpu/ops/fused_update.py:78 (fused_adam_leaf)",
        shape=f"{len(fused)} leaves, {n} elements, p f32, g/m/v bf16",
        launches=None, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        timed_by="back to back", library_ms=library_ms,
        bound_ms=bound_s * 1e3, bound_by=bound_by)


def phase_train_a():
    """Training path (a) in K3's regime: 2 layers at S 2048, no strategy
    file: TRAIN_A_STEPS ``fit`` steps, then GRAPH_STEPS compiled steps
    against eager ones from one state, bit for bit, and the kernels of
    two replayed steps by name from their profile. Returns the launches
    of the fit steps and the launches a replay."""
    import numpy as np
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    cfg = TransformerConfig(**TRAIN_A)
    ff = compile_for_training(cfg)
    check(ff.kernel_choices is None and all(
        n.op.selected_impl("cuda", training=True) == "flash"
        for n in ff.executor.nodes if isinstance(n.op, MultiHeadAttention)),
        "path (a) does not pick flash by availability")
    x, y = training_batch(cfg, seed=3)
    reset_launches()
    ff.fit(x, y, epochs=TRAIN_A_STEPS, verbose=False)
    launches = read_launches()
    want = dict(flash_attn_fwd=cfg.num_layers * TRAIN_A_STEPS,
                flash_attn_bwd=cfg.num_layers * TRAIN_A_STEPS, fused_adam=0,
                flash_lse_fwd=0, flash_lse_bwd=0)
    print(f"[train a] {cfg}: losses "
          + ", ".join(f"{v:.6f}" for v in ff.epoch_losses)
          + f"; launches {launches} (expected {want})")
    check(all(np.isfinite(ff.epoch_losses)), "non-finite loss in path (a)")
    check(launches == want, "path (a) launches differ from the expected")
    per_call = graph_vs_eager(ff, x, y, GRAPH_STEPS, "[train a]")
    check(all(d["flash_attn_bwd"] == cfg.num_layers
              and d["flash_attn_fwd"] == cfg.num_layers for d in per_call),
          "[train a] launches a replay differ from the expected")
    sg = ff.executor.step_graphs["train_step"]
    replays0 = sg.replays
    prof = profile_train(ff, x, y, label="[train a] 2 replayed steps")
    check(sg.replays - replays0 == 2 + LEAD_IN_CALLS,
          "[train a] the profiled steps were not 2 replays")
    replay_launches = check_replay_launches(
        "[train a] 2 replayed steps", prof, 2,
        dict(flash_attn_fwd=cfg.num_layers, flash_attn_bwd=cfg.num_layers))
    del ff, sg
    release()
    return dict(launches=launches, replay_launches=replay_launches)


def nvidia_smi_line():
    """The card's name and power limit as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def machine_readings(peaks):
    """The H100 entry's two measured constants: the achieved share of the
    bf16 peak of the full-width FFN dense's GEMM ([8 x 512, 1024] @
    [1024, 4096] in bf16, ``mxu_efficiency``), and one launch of a
    one-element elementwise kernel (the smallest op the port's eager
    executor issues), back to back (``min_op_time``). Both by
    ``time_calls``; returns (efficiency, seconds a launch, host ms a
    launch)."""
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig()
    tokens = cfg.batch_size * cfg.seq_length
    ffn = cfg.hidden_size * cfg.ffn_mult
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(tokens, cfg.hidden_size, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = torch.randn(cfg.hidden_size, ffn, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    gemm_ms, _ = time_calls(lambda: torch.matmul(x, w))
    eff = 2 * tokens * cfg.hidden_size * ffn / (gemm_ms * 1e-3) / peaks["bf16"]
    one = torch.zeros(1, device="cuda")
    launch_ms, launch_host_ms = time_calls(lambda: one.add_(1.0),
                                           target_ms=5.0)
    print(f"[search train] machine readings: the FFN GEMM {gemm_ms:.4f} ms "
          f"= {eff:.4f} of the bf16 peak; a one-element launch "
          f"{launch_ms * 1e3:.3f} us back to back (host "
          f"{launch_host_ms * 1e3:.3f} us a call)")
    return eff, launch_ms * 1e-3, launch_host_ms


def phase_search_train(plain_losses):
    """The searched path of training at full width: detect the machine,
    ``compile(search_budget=SEARCH_BUDGET)`` with Adam (the strategy
    exported through ``--export-strategy``), train TRAIN_WARMUP + TRAIN_STEPS
    steps from train (b)'s weights and batch, and hold the kernels the
    strategy chose to their launches; then compile a fresh model through
    ``--import-strategy`` on the exported file: the same kernel choices
    and a bit-equal first-step loss. Returns the launches over the timed
    steps."""
    from collections import Counter

    import numpy as np
    import torch
    from flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from flexflow_tpu_torch.machine import CHIP_SPECS, detect_machine_spec
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.obs.registry import percentile
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.optimizers import AdamOptimizer
    from flexflow_tpu_torch.search.unity import (executed_kernel_choices,
                                                 machine_to_json)

    card = nvidia_smi_line()
    spec = detect_machine_spec(1, device="cuda")
    print(f"[search train] card {card}; machine {spec.chip}: "
          f"{json.dumps(machine_to_json(spec, 1, comm_bytes_factor=0.5))}")
    eff, launch_s, _ = machine_readings(H100_SXM_PEAKS)
    entry = CHIP_SPECS[spec.chip]
    print(f"[search train] the table's mxu_efficiency {entry['mxu_efficiency']}"
          f" and min_op_time {entry['min_op_time']:.3e} s; this run's "
          f"readings {eff:.4f} and {launch_s:.3e} s ({card})")

    cfg = TransformerConfig()
    x, y = training_batch(cfg)

    def build(argv):
        fcfg = FFConfig(batch_size=cfg.batch_size)
        check(fcfg.parse_args(argv) == [], f"unread flags in {argv}")
        ff = create_transformer(cfg, fcfg, device="cuda")
        ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [MetricsType.MEAN_SQUARED_ERROR])
        return ff

    with tempfile.TemporaryDirectory(prefix="ff_search_") as tmp:
        path = os.path.join(tmp, "searched.json")
        t0 = time.perf_counter()
        ff = build(["--budget", str(SEARCH_BUDGET), "--export-strategy", path])
        compile_s = time.perf_counter() - t0
        info = ff.search_info
        choices = Counter(st.choice for st in ff.strategy.values())
        predicted = info["predicted_time"]
        print(f"[search train] compile(search_budget={SEARCH_BUDGET}): search "
              f"{info['search_wall_s']:.3f} s wall (whole compile "
              f"{compile_s:.2f} s); mesh {ff.mesh.shape}; choices "
              f"{dict(choices)}; predicted_time {predicted * 1e3:.3f} ms, "
              f"predicted_memory {info['predicted_memory']}, cost model "
              f"{info['cost_model']}, objective {info['objective']}, "
              f"{len(info['rewrites'])} rewrites")
        check(ff.mesh.size == 1, f"the search chose {ff.mesh.shape}, not one "
              f"device")
        check(info["objective"] == "step_time" and predicted > 0,
              f"search info {info['objective']}, {predicted}")
        attn = [n.op for n in ff.executor.nodes
                if isinstance(n.op, MultiHeadAttention)]
        kc = ff.kernel_choices or {}
        flash_ops = [op.name for op in attn if kc.get(op.name) == "flash"]
        fused = ff.executor.fused_update_ops & set(ff.params)
        # every claimed kernel is the one that runs, and no other op
        # claims one
        for op in attn:
            want = kc.get(op.name)
            check(want in ("flash", "einsum") and op.kernel_impl == want
                  and op.selected_impl("cuda", ff.mesh.shape,
                                       training=True) == want,
                  f"{op.name}: claims {want}, pinned {op.kernel_impl}")
        others = {n: i for n, i in kc.items()
                  if n not in {op.name for op in attn}}
        check(set(others.values()) <= {"fused"},
              f"non-attention ops claim kernels {others}")
        for _ in range(TRAIN_WARMUP):
            ff.fit(x, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
        reset_launches()
        step_s = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            ff.fit(x, y, epochs=1, verbose=False)  # ends in a host read
            step_s.append(time.perf_counter() - t0)
        launches = read_launches()
        losses = list(ff.epoch_losses)
        want = dict(flash_attn_fwd=len(flash_ops) * TRAIN_STEPS,
                    flash_attn_bwd=len(flash_ops) * TRAIN_STEPS,
                    fused_adam=TRAIN_STEPS if fused else 0,
                    flash_lse_fwd=0, flash_lse_bwd=0)
        print(f"[search train] {len(flash_ops)} attention ops on K1/K2, "
              f"{len(attn) - len(flash_ops)} on the einsum core, {len(fused)} "
              f"ops through fused Adam; launches over {TRAIN_STEPS} steps: "
              f"{launches} (expected {want})")
        check(launches == want, "the searched path's launches differ from "
              "its kernel choices")
        print(f"[search train] loss per step: "
              + ", ".join(f"{v:.6f}" for v in losses))
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        print(f"[search train] against train (b)'s plain path from the same "
              f"weights: worst step {int(np.argmax(rel)) + 1} at "
              f"{max(rel):.3e} relative (tol {TRAJECTORY_RTOL})")
        check(len(losses) == len(plain_losses) and all(np.isfinite(losses))
              and max(rel) <= TRAJECTORY_RTOL,
              "the searched path's losses leave the plain path's")
        p50 = statistics.median(step_s)
        p90 = percentile(sorted(step_s), 0.90)
        print(f"[search train] compiled step time (CUDA-graph replays) p50 "
              f"{p50 * 1e3:.3f} ms, p90 "
              f"{p90 * 1e3:.3f} ms ({cfg.batch_size / p50:.2f} samples/s) "
              f"against the predicted {predicted * 1e3:.3f} ms: measured / "
              f"predicted {p50 / predicted:.2f} ({card})")
        n_ops = len(ff.executor.nodes)
        print(f"[search train] the step's p50 over its {n_ops} graph ops: "
              f"{p50 / n_ops * 1e6:.1f} us a graph op, against the table's "
              f"min_op_time {entry['min_op_time'] * 1e6:.3f} us, one "
              f"host-paced launch, which the cost model charges once a "
              f"graph op")
        profile_train(ff, x, y)
        with open(path) as f:
            exported = json.load(f)
        check(exported["objective"] == "step_time"
              and exported["mesh"] == dict(ff.mesh.shape)
              and len(exported["ops"]) == len(ff.strategy),
              f"exported file: mesh {exported['mesh']}, "
              f"{len(exported['ops'])} ops")
        executed = executed_kernel_choices(ff.executor.nodes, ff.strategy,
                                           ff.mesh.shape, training=True)
        first = losses[0]
        del ff
        torch.cuda.empty_cache()
        again = build(["--import-strategy", path])
    check(again.search_info is None and again.kernel_choices == kc
          and executed_kernel_choices(again.executor.nodes, again.strategy,
                                      again.mesh.shape, training=True)
          == executed, "the imported strategy runs other kernels")
    again.fit(x, y, epochs=1, verbose=False)
    print(f"[search train] exported and imported through --import-strategy: "
          f"the same kernel choices; first-step loss {again.epoch_losses[0]!r}"
          f" vs {first!r}")
    check(again.epoch_losses[0] == first,
          "the imported strategy's first-step loss is not bit-equal")
    del again
    torch.cuda.empty_cache()
    return launches, predicted


def phase_search_serve():
    """The searched path of serving at full width: ``serve(search_budget=
    SEARCH_BUDGET)`` runs the latency search for every default bucket;
    each bucket is then timed over SEARCH_BUCKET_BATCHES full batches of
    its size, K1's launches counted against the bucket's kernel choices,
    and its rows held against ``predict``. Returns K1's launches."""
    from collections import Counter

    import numpy as np
    import torch
    from flexflow_tpu_torch.obs.registry import get_registry
    from flexflow_tpu_torch.ops.flash_attention import flash_fwd
    from flexflow_tpu_torch.serve.loadgen import build_serve_model

    card = nvidia_smi_line()
    ff, make_request, cfg = build_serve_model("transformer", on_cpu=False,
                                              device="cuda")
    t0 = time.perf_counter()
    engine = ff.serve(search_budget=SEARCH_BUDGET)
    build_s = time.perf_counter() - t0
    report = engine.bucket_report()
    buckets = tuple(engine.scheduler.buckets)
    check(buckets == (1, 2, 4, 8), f"unexpected buckets {buckets}")
    print(f"[search serve] serve(search_budget={SEARCH_BUDGET}): {len(buckets)} "
          f"bucket searches and executors in {build_s:.3f} s")
    n_flash = {}
    for b in buckets:
        rep = report[str(b)]
        kinds = Counter(rep["kernel_choices"].values())
        n_flash[b] = kinds.get("flash", 0)
        print(f"[search serve] bucket {b}: objective {rep['objective']}, mesh "
              f"{rep['mesh']}, predicted latency "
              f"{rep['predicted_latency_s'] * 1e3:.3f} ms, kernels "
              f"{dict(kinds)}, differs from the model's strategy "
              f"{rep['strategy_differs_from_training']}")
        check(rep["objective"] == f"latency@batch{b}"
              and rep["predicted_latency_s"] > 0
              and math.prod(rep["mesh"].values()) == 1,
              f"bucket {b}: {rep}")
        check(set(kinds) <= {"flash", "einsum"}
              and sum(kinds.values()) == cfg["num_layers"],
              f"bucket {b}: kernel choices {rep['kernel_choices']}")
    # first calls of every bucket are set-up
    for b in buckets:
        reqs = [engine.submit(make_request(i)) for i in range(b)]
        engine.pump()
        for r in reqs:
            r.wait(60)
    torch.cuda.synchronize()
    reg = get_registry()
    reg.reset()
    flash_fwd.launches = 0
    for b in buckets:
        for _ in range(SEARCH_BUCKET_BATCHES):
            reqs = [engine.submit(make_request(i)) for i in range(b)]
            engine.pump()
            for r in reqs:
                check(np.isfinite(r.wait(60)).all(), f"bucket {b}: non-finite")
    torch.cuda.synchronize()
    launches = flash_fwd.launches
    obs = reg.to_dict()["observations"]
    counts = {b: int(obs[f"serve/bucket{b}/batch_latency_s"]["count"])
              for b in buckets}
    want = sum(counts[b] * n_flash[b] for b in buckets)
    print(f"[search serve] batches {counts}; K1 launches {launches} "
          f"(expected {want}: each batch one a flash attention)")
    check(counts == {b: SEARCH_BUCKET_BATCHES for b in buckets}
          and launches == want, "K1's launches differ from the buckets' "
          "kernel choices")
    for b in buckets:
        o = obs[f"serve/bucket{b}/batch_latency_s"]
        pred = report[str(b)]["predicted_latency_s"]
        print(f"[search serve] bucket {b}: batch latency p50 "
              f"{o['p50'] * 1e3:.3f} ms, p99 {o['p99'] * 1e3:.3f} ms against "
              f"the predicted {pred * 1e3:.3f} ms: measured / predicted "
              f"{o['p50'] / pred:.2f} ({card})")
    # the served rows against predict on the same samples: the full batch
    # exactly (the same graph, the same kernels), smaller buckets within
    # MODEL_RTOL of the output's max (other GEMM shapes)
    batch = np.stack([make_request(i)[0] for i in range(cfg["batch_size"])])
    want_rows = ff.predict(batch)
    scale = float(np.abs(want_rows).max())
    for b in buckets:
        reqs = [engine.submit([batch[i]]) for i in range(b)]
        engine.pump()
        got = np.stack([r.wait(60) for r in reqs])
        err = float(np.abs(got - want_rows[:b]).max())
        print(f"[search serve] bucket {b} rows vs predict: max_abs_err "
              f"{err:.4e} (max |output| {scale:.4e})")
        if b == cfg["batch_size"]:
            check(err == 0.0, "the full batch differs from predict")
        check(err <= MODEL_RTOL * scale, f"bucket {b}'s rows leave predict's")
    return launches


def build_llama(strategy_dir=None):
    """``create_llama`` at LLAMA on the card, compiled for INFERENCE; with
    ``strategy_dir``, through a strategy file written there that pins every
    attention op to the einsum core (``dp_k:einsum``). The weights come
    from the config's seed, so every call builds the same weights."""
    from flexflow_tpu_torch import (CompMode, FFConfig, LossType,
                                    OperatorType)
    from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                 create_llama)

    ff = create_llama(LlamaModelConfig(**LLAMA),
                      FFConfig(batch_size=LLAMA["batch_size"]),
                      device="cuda")
    if strategy_dir is not None:
        path = os.path.join(strategy_dir, "llama_einsum.json")
        write_strategy(ff, path, lambda kind: "dp_k:einsum" if kind
                       == OperatorType.MULTIHEAD_ATTENTION else "dp")
        ff.config.import_strategy_file = path
    ff.compile(None, LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
               comp_mode=CompMode.INFERENCE)
    return ff


def model_leaves(ff):
    """The model's parameter leaves and then its op-state leaves (the
    BatchNorms' running statistics; not the compute copy), in build
    order."""
    return ([t for sub in ff.params.values() for t in sub.values()]
            + [t for k, sub in ff.state.items() if not k.startswith("__")
               for t in sub.values()])


def host_params(ff):
    """Host copies of the model's parameter and op-state leaves in build
    order (``model_leaves``), to hold another build of the model against
    (``params_differ``): two builds name their layers apart (the layer
    counter is global), so the leaves are matched by position, not by
    name."""
    return [t.detach().to("cpu", copy=True) for t in model_leaves(ff)]


def params_differ(ff, base):
    """How many of ``ff``'s parameter and op-state leaves, in build order,
    are not equal to ``base``'s (``host_params`` of another build); every
    leaf when the two disagree in count or shapes."""
    import torch

    got = model_leaves(ff)
    if [t.shape for t in got] != [t.shape for t in base]:
        return max(len(got), len(base))
    return sum(1 for t, b in zip(got, base)
               if not torch.equal(t.detach().cpu(), b))


def weights_fingerprint(ff):
    """Each f32 parameter leaf's sum in f64, in a fixed order: two builds
    from one seed must give the same list."""
    import torch

    return [float(ff.params[op][pn].sum(dtype=torch.float64))
            for op in sorted(ff.params) for pn in sorted(ff.params[op])]


def llama_ids(seed, batch, length):
    import numpy as np

    return np.random.RandomState(seed).randint(
        0, LLAMA["vocab_size"], (batch, length)).astype(np.int32)


def memory_line():
    import torch

    return (f"device memory allocated "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, peak reserved "
            f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB")


def take_peaks(acc):
    """Folds the card's peak allocated and reserved memory since the last
    reset into ``acc`` ([GiB, GiB], the larger of each kept), then resets
    the peaks: a phase that resets them for each of its readings still
    knows its own peak."""
    import torch

    acc[0] = max(acc[0], torch.cuda.max_memory_allocated() / 2**30)
    acc[1] = max(acc[1], torch.cuda.max_memory_reserved() / 2**30)
    torch.cuda.reset_peak_memory_stats()


def peaks_line(acc):
    import torch

    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    return (f"peak allocated {acc[0]:.2f} GiB, peak reserved {acc[1]:.2f} "
            f"GiB of the card's {total:.2f} GiB")


def rel_gap(got, want):
    """Largest |got - want| over the largest |want|."""
    import numpy as np

    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def llama_k1_row():
    """K1 at the decoder LM's launch (BH 128 = 4 x 32 heads after the GQA
    repeat, S 1024, D 128, causal, bf16): against its plain version, two
    runs bit-equal, timed by the profiler's device time beside
    ``scaled_dot_product_attention(is_causal=True)`` on the same
    GQA-expanded q, k, v (and both back to back), the plain version and
    the bound. Returns the numbers for the kernels line."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_fwd,
                                                        flash_fwd_reference)

    bh, s, d = LLAMA_K1
    b, h = LLAMA["batch_size"], LLAMA["num_attention_heads"]
    rep = h // LLAMA["num_key_value_heads"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q = torch.randn(b, h, s, d, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(b, h // rep, s, d, generator=gen, device="cuda")
            .bfloat16().repeat_interleave(rep, dim=1) for _ in range(2))
    q3, k3, v3 = (x.reshape(bh, s, d) for x in (q, k, v))
    o, lse = flash_fwd(q3, k3, v3, True)
    again = flash_fwd(q3, k3, v3, True)
    torch.cuda.synchronize()
    ref_o, ref_lse = flash_fwd_reference(q3.float(), k3.float(), v3.float(),
                                         True)
    err_o = (o.float() - ref_o).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    tol = TOL["bfloat16"]
    same = all(torch.equal(a, b_) for a, b_ in zip((o, lse), again))
    print(f"[llama serve] flash_attn_fwd BH={bh} S={s} D={d} bfloat16 "
          f"causal=True: o max_abs_err {err_o:.3e} (tol {tol['o']}), lse "
          f"max_abs_err {err_lse:.3e} (tol {tol['lse']}); two runs "
          f"bit-equal: {same}")
    check(bool(torch.isfinite(o).all()) and err_o <= tol["o"]
          and err_lse <= tol["lse"] and same,
          "K1 disagrees with its plain version at the decoder LM's shape, "
          "or two runs differ")
    kernel = lambda: flash_fwd(q3, k3, v3, True)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True)
    dev_ms, lib_dev_ms = profiled_ms(kernel), profiled_ms(lib)
    b2b_ms, host_ms = time_calls(kernel)
    lib_b2b_ms, lib_host_ms = time_calls(lib)
    plain_ms = time_ms(lambda: flash_fwd_reference(q3, k3, v3, True))
    profiled = dev_ms is not None and lib_dev_ms is not None
    bound_s, bound_by = flash_bound(bh, s, d, 2, True, H100_SXM_PEAKS)
    row = dict(shape=f"BH={bh} S={s} D={d} bfloat16 causal=True",
               max_abs_err=err_o, lse_max_abs_err=err_lse,
               ms=dev_ms if profiled else b2b_ms,
               timed_by="profiler" if profiled else "back to back",
               b2b_ms=b2b_ms, host_ms=host_ms, plain_ms=plain_ms,
               library_ms=lib_dev_ms if profiled else lib_b2b_ms,
               library_b2b_ms=lib_b2b_ms, library_host_ms=lib_host_ms,
               bound_ms=bound_s * 1e3, bound_by=bound_by)
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    print(f"[llama serve] K1 at BH={bh} S={s} D={d} causal: kernel profiled "
          f"{fmt(dev_ms)}, {b2b_ms:.4f} ms back to back (host "
          f"{host_ms:.4f} ms); library (sdpa, is_causal) profiled "
          f"{fmt(lib_dev_ms)}, {lib_b2b_ms:.4f} ms back to back (host "
          f"{lib_host_ms:.4f} ms); plain {plain_ms:.4f} ms; bound "
          f"{bound_s * 1e6:.2f} us ({bound_by}) ({nvidia_smi_line()})")
    return row


def phase_llama_serve():
    """[llama serve] the decoder LM at LLAMA through ``predict`` and the
    serving engine: K1's row at its shape; ``predict`` a capture and then
    a replay, each launching K1 once a layer, the two bit-equal, timed
    over LLAMA_PREDICTS replays and one replay profiled (K1 by name); the
    engine's buckets LLAMA_BUCKETS warmed, then LLAMA_REQUESTS requests
    closed-loop at LLAMA_CONCURRENCY (K1 once a layer a batch, one replay
    a batch); a full batch through the engine equal to ``predict``, and
    one profiled. Returns (the model, predict's ids and logits, the
    weights' fingerprint, the report's numbers)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import CompMode
    from flexflow_tpu_torch.obs.registry import get_registry
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.serve.loadgen import (run_closed_loop,
                                                  warm_buckets)

    release()
    torch.cuda.reset_peak_memory_stats()
    print(f"[llama serve] before the model: {memory_line()}")
    k1 = llama_k1_row()
    layers = LLAMA["num_hidden_layers"]
    t0 = time.perf_counter()
    ff = build_llama()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(t.numel() for sub in ff.params.values()
                   for t in sub.values())
    attn = [n.op for n in ff.executor.nodes
            if isinstance(n.op, MultiHeadAttention)]
    print(f"[llama serve] create_llama {LLAMA}: {n_params} parameters, "
          f"built and compiled in {build_s:.2f} s (weights drawn on the "
          f"card), compute dtype {ff.executor.compute_dtype}; "
          f"{memory_line()}")
    check(len(attn) == layers
          and all(ff._selected_impl(op, CompMode.INFERENCE) == "flash"
                  for op in attn)
          and "flash_attn_fwd" in ff._kernels_of_path(ff.executor.nodes,
                                                      CompMode.INFERENCE),
          "[llama serve] the attention ops do not run K1")
    fingerprint = weights_fingerprint(ff)

    x = llama_ids(0, LLAMA["batch_size"], LLAMA["seq_length"])
    reset_launches()
    out = ff.predict(x)  # the capture: its eager warm-up launches K1
    first = read_launches()["flash_attn_fwd"]
    again = ff.predict(x)  # a replay
    both = read_launches()["flash_attn_fwd"]
    fwd = ff.executor.step_graphs["forward"]
    print(f"[llama serve] predict: logits {out.shape} {out.dtype}, K1 "
          f"launches {first} in the capturing call, {both - first} in the "
          f"replay; replay equals the first call bit for bit: "
          f"{bool(np.array_equal(out, again))}")
    check(out.shape == (LLAMA["batch_size"], LLAMA["seq_length"],
                        LLAMA["vocab_size"])
          and bool(np.isfinite(out).all()), "[llama serve] predict's "
          "logits are misshapen or not finite")
    check(first == layers and both == 2 * layers
          and (fwd.captures, fwd.replays) == (1, 1)
          and np.array_equal(out, again),
          "[llama serve] predict did not launch K1 once a layer in each "
          "call, or its replay differs from the first call")
    del again
    walls = []
    for _ in range(LLAMA_PREDICTS):
        t0 = time.perf_counter()
        ff.predict(x)
        walls.append(time.perf_counter() - t0)
    p50, p90 = p50_p90(walls)
    print(f"[llama serve] predict (batch {LLAMA['batch_size']} x "
          f"{LLAMA['seq_length']} tokens, f32 logits to the host), "
          f"{LLAMA_PREDICTS} replays: p50 {p50 * 1e3:.3f} ms, p90 "
          f"{p90 * 1e3:.3f} ms ({nvidia_smi_line()})")
    prof = profile_steps("[llama serve] one replayed predict",
                         lambda: ff.predict(x), steps=1)
    predict_replay = check_replay_launches(
        "[llama serve] one replayed predict", prof, 1,
        dict(flash_attn_fwd=layers))

    engine = ff.serve(batch_buckets=LLAMA_BUCKETS)
    buckets = tuple(engine.scheduler.buckets)
    check(buckets == LLAMA_BUCKETS, f"unexpected buckets {buckets}")
    for b, rep in engine.bucket_report().items():
        check(set(rep["kernel_choices"].values()) == {"flash"},
              f"[llama serve] bucket {b} does not run K1: {rep}")
    samples = llama_ids(1, 16, LLAMA["seq_length"])
    make_request = lambda i: [samples[i % len(samples)]]
    reg = get_registry()
    try:
        warmed = warm_buckets(engine, make_request)
        graphs = {b: be.executor.step_graphs["forward"]
                  for b, be in engine.buckets.items()}
        torch.cuda.synchronize()
        reg.reset()
        reset_launches()
        replays0 = {b: g.replays for b, g in graphs.items()}
        engine.start()
        stats = run_closed_loop(engine, make_request, LLAMA_REQUESTS,
                                concurrency=LLAMA_CONCURRENCY)
    finally:
        engine.stop()
    torch.cuda.synchronize()
    launches = read_launches()["flash_attn_fwd"]
    replays = {b: g.replays - replays0[b] for b, g in graphs.items()}
    counters = reg.to_dict()["counters"]
    batches = int(counters.get("serve/batches", 0))
    check(not stats["errors"] and counters.get("serve/batch_errors", 0) == 0
          and stats["num_measured"] == LLAMA_REQUESTS,
          f"[llama serve] closed loop errors: {stats['errors'][:3]}")
    check(launches == layers * batches and batches > 0
          and sum(replays.values()) == batches
          and all(g.captures == 1 for g in graphs.values()),
          f"[llama serve] K1 launches {launches} != {layers} x {batches} "
          f"batches, or a batch was not one replay ({replays})")
    print(f"[llama serve] {warmed} warm-up requests, then "
          f"{stats['num_measured']} requests closed-loop (concurrency "
          f"{LLAMA_CONCURRENCY}) in {batches} batches, replays by bucket "
          f"{replays}; K1 launches {launches} = {layers} x {batches}; p50 "
          f"{stats['p50_s'] * 1e3:.3f} ms, p99 {stats['p99_s'] * 1e3:.3f} "
          f"ms, {stats['throughput_rps']:.3f} requests/s over "
          f"{stats['wall_s']:.3f} s ({nvidia_smi_line()})")
    obs = reg.to_dict()["observations"]
    for b in buckets:
        o = obs.get(f"serve/bucket{b}/batch_latency_s")
        if o:
            print(f"[llama serve] bucket {b}: {int(o['count'])} batches, "
                  f"batch latency p50 {o['p50'] * 1e3:.3f} ms")

    full = graphs[LLAMA["batch_size"]]
    replays0 = full.replays

    def served_batch():
        reqs = [engine.submit([row]) for row in x]
        engine.pump()
        return np.stack([r.wait(120) for r in reqs])

    got = served_batch()
    print(f"[llama serve] a full batch through the engine equals predict "
          f"exactly: {bool(np.array_equal(got, out))}")
    check(np.array_equal(got, out), "[llama serve] served rows differ from "
          "predict's")
    del got
    prof = profile_steps("[llama serve] one full batch through the engine",
                         served_batch, steps=1)
    check(full.replays - replays0 == 2 + LEAD_IN_CALLS,
          "[llama serve] the served batches were not one replay each")
    serve_replay = check_replay_launches(
        "[llama serve] one full batch", prof, 1, dict(flash_attn_fwd=layers))
    print(f"[llama serve] after serving: {memory_line()}")
    del engine, graphs, full, prof, served_batch
    release()
    return ff, x, out, fingerprint, dict(
        k1=k1, launches=launches, replay=serve_replay["flash_attn_fwd"],
        predict_launches=first,
        predict_replay=predict_replay["flash_attn_fwd"],
        predict_p50_ms=p50 * 1e3, p50_ms=stats["p50_s"] * 1e3,
        p99_ms=stats["p99_s"] * 1e3, rps=stats["throughput_rps"])


def profile_ops(label, fn, top=8):
    """Where one call of ``fn`` (eager PyTorch ops) spends its device
    time, by aten op and input shapes (torch.profiler with
    ``record_shapes``): the ``top`` ops by their own device time, each
    with its calls. Returns fn's result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    self_ms = lambda r: getattr(r, "self_device_time_total",
                                getattr(r, "self_cuda_time_total", 0)) / 1e3
    # the host-side ops, each with the device time of the kernels it
    # launched itself (the kernels' own rows would count it twice)
    rows = [r for r in prof.key_averages(group_by_input_shape=True)
            if r.device_type == DeviceType.CPU and self_ms(r) > 0]
    total = sum(self_ms(r) for r in rows)
    print(f"[profile] {label}: device time {total:.3f} ms by aten op "
          f"(its own time, calls, input shapes):")
    for r in sorted(rows, key=lambda r: -self_ms(r))[:top]:
        print(f"[profile]   {self_ms(r):.3f} ms ({100 * self_ms(r) / total:.1f}"
              f"%) in {r.count} calls: {r.key} {str(r.input_shapes)[:90]}")
    return out


def decode_step_bound(ff, sess):
    """Least time (s) of one decode step: the bytes it must move over the
    card's memory rate, every bf16 weight read once (of the embedding
    table only the batch's rows) and both caches of every layer read
    once (attention at the last position reads them whole)."""
    from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY

    tree = ff.state.get(COMPUTE_PARAMS_KEY, ff.params)
    nbytes = sum(t.numel() * t.element_size() for op, sub in tree.items()
                 for t in sub.values() if op != "embed_tokens")
    emb = tree["embed_tokens"]["kernel"]
    nbytes += sess.batch * emb.shape[1] * emb.element_size()
    nbytes += sum(t.numel() * t.element_size()
                  for c in sess.caches.values() for t in c.values())
    return nbytes / H100_SXM_PEAKS["bytes"], nbytes


def phase_llama_decode(ff):
    """[llama decode] greedy decode on the model of [llama serve]:
    ``DecodeSession.generate`` of LLAMA_NEW tokens after a LLAMA_PROMPT-
    token prompt (two captures in all, no K1 launch); then a second
    session fed the generated tokens one at a time: its prefill (the
    capture, then replays from position 0), every decode step timed, the
    greedy tokens reproduced, at LLAMA_CHECK_AT the replayed step against
    the eager one from the same caches and position bit for bit, two
    replayed steps profiled. Returns the generated ids, the prefill's and
    the decode steps' logits and the report's numbers."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.serve import DecodeSession

    release()
    torch.cuda.reset_peak_memory_stats()
    b = LLAMA["batch_size"]
    prompt = llama_ids(2, b, LLAMA_PROMPT)
    reset_launches()
    sess = DecodeSession(ff)
    t0 = time.perf_counter()
    gen = sess.generate(prompt, LLAMA_NEW)
    gen_s = time.perf_counter() - t0
    launched = read_launches()
    graphs = sess.step_graphs
    caps = {t: g.captures for t, g in graphs.items()}
    per_replay = {t: g.launches_a_replay() for t, g in graphs.items()}
    print(f"[llama decode] generate({LLAMA_PROMPT}-token prompt, "
          f"{LLAMA_NEW} steps) at batch {b} in {gen_s:.3f} s: ids "
          f"{gen.shape} {gen.dtype}; captures {caps}, replays "
          f"{ {t: g.replays for t, g in graphs.items()} }; kernel launches "
          f"{launched}, a replay {per_replay}; report {sess.report()}")
    check(gen.shape == (b, LLAMA["seq_length"]) and gen.dtype == np.int32
          and np.array_equal(gen[:, :LLAMA_PROMPT], prompt),
          "[llama decode] generate returned the wrong ids")
    check(caps == {LLAMA_PROMPT: 1, 1: 1}
          and graphs[1].replays == LLAMA_NEW - 2,
          "[llama decode] generate did not capture exactly two graphs")
    check(not any(launched.values())
          and not any(v for d in per_replay.values() for v in d.values()),
          "[llama decode] the decode path launched a kernel of the port "
          "(it runs the cached einsum)")
    check(set(sess.report()["kernel_choices"].values()) == {"cached_einsum"},
          "[llama decode] the session reports another attention core")
    del sess, graphs
    release()

    sess = DecodeSession(ff)
    t0 = time.perf_counter()
    pre = sess.prefill([gen[:, :LLAMA_PROMPT]])
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_ms = []
    for _ in range(3):
        sess.pos = 0  # the same prompt again: its rows are rewritten
        t0 = time.perf_counter()
        again = sess.prefill([gen[:, :LLAMA_PROMPT]])
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    check(np.array_equal(pre, again), "[llama decode] a replayed prefill "
          "differs from the capturing one")
    del again
    rows, step_ms, checked = [pre[:, -1]], [], []
    prof = None
    for p in range(LLAMA_PROMPT, LLAMA["seq_length"]):
        tok = gen[:, p:p + 1]
        if p in LLAMA_CHECK_AT:
            saved = {n: {k: t.clone() for k, t in c.items()}
                     for n, c in sess.caches.items()}
            replayed = sess.decode([tok])
            after = {n: {k: t.clone() for k, t in c.items()}
                     for n, c in sess.caches.items()}
            with torch.no_grad():
                for n, c in saved.items():
                    for k, t in c.items():
                        sess.caches[n][k].copy_(t)
            sess.pos = p
            run = lambda: sess._run([tok], 1, eager=True)
            eager = (profile_ops("[llama decode] one eager decode step", run)
                     if p == LLAMA_CHECK_AT[-1] else run())
            same = (np.array_equal(replayed, eager)
                    and all(torch.equal(sess.caches[n][k], after[n][k])
                            for n in after for k in ("k", "v")))
            checked.append((p, same))
            del saved, after
            rows.append(replayed[:, 0])
            continue
        if p == LLAMA_CHECK_AT[0] + 4:
            def decode_next():
                rows.append(sess.decode([gen[:, sess.pos:sess.pos + 1]])[:, 0])
            step = sess.step_graphs[1]
            replays0 = step.replays
            prof = profile_steps("[llama decode] two replayed decode steps",
                                 decode_next, steps=2)
            check(step.replays - replays0 == 2 + LEAD_IN_CALLS,
                  "[llama decode] the profiled steps were not two replays")
            continue
        if sess.pos != p:  # the profiled steps ran these positions
            continue
        t0 = time.perf_counter()
        rows.append(sess.decode([tok])[:, 0])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    check(sess.pos == LLAMA["seq_length"] and len(rows) == LLAMA_NEW + 1,
          "[llama decode] the timed session did not reach the last position")
    print(f"[llama decode] the replayed decode step against the eager one "
          f"from the same caches and position, logits and caches bit for "
          f"bit, at positions: {checked}")
    check(all(same for _, same in checked) and len(checked) == 2,
          "[llama decode] a replayed decode step differs from the eager "
          "step")
    check({t: g.captures for t, g in sess.step_graphs.items()}
          == {LLAMA_PROMPT: 1, 1: 1},
          "[llama decode] the timed session captured more than two graphs")
    logits = np.stack(rows, axis=1)  # positions LLAMA_PROMPT - 1 .. 1023
    greedy = np.argmax(logits[:, :-1], axis=-1)
    check(np.array_equal(greedy, gen[:, LLAMA_PROMPT:]),
          "[llama decode] the teacher-fed session's argmax differs from "
          "generate's tokens")
    replay_launches = check_replay_launches(
        "[llama decode] two replayed decode steps", prof, 2, {})
    capture_ms, timed = step_ms[0], step_ms[1:]
    (d50, d90) = p50_p90(timed)
    bound_s, nbytes = decode_step_bound(ff, sess)
    kinds, wall_ms = prof[0], prof[2]
    busy = sum(kinds.values())
    print(f"[llama decode] prefill of {LLAMA_PROMPT} tokens at batch {b}: "
          f"{first_prefill_ms:.3f} ms capturing, then "
          + ", ".join(f"{t:.3f}" for t in prefill_ms)
          + f" ms replayed; decode step (one token a row, logits to the "
          f"host): the capturing call {capture_ms:.3f} ms, then "
          f"{len(timed)} replays p50 {d50:.3f} ms, p90 {d90:.3f} ms, "
          f"{b / d50 * 1e3:.1f} tokens/s; the step's bound "
          f"{bound_s * 1e3:.4f} ms ({nbytes / 1e9:.3f} GB of bf16 weights "
          f"and caches over {H100_SXM_PEAKS['bytes'] / 1e12:.2f} TB/s), "
          f"p50 = {d50 / (bound_s * 1e3):.2f}x the bound; two replayed "
          f"steps: device busy {busy:.3f} of {wall_ms:.3f} ms "
          f"({100 * busy / wall_ms:.1f}%) ({nvidia_smi_line()})")
    print(f"[llama decode] {memory_line()}")
    del sess, step, prof
    release()
    return gen, pre, logits[:, 1:], dict(
        prefill_ms=statistics.median(prefill_ms),
        first_prefill_ms=first_prefill_ms, step_p50_ms=d50, step_p90_ms=d90,
        tokens_per_s=b / d50 * 1e3, bound_ms=bound_s * 1e3,
        busy_share=busy / wall_ms, replay_launches=replay_launches)


def phase_llama_reference(x, flash_out, gen, pre, dec, fingerprint):
    """The einsum-core reference for both llama phases: the same model
    from the same seed (the weights' fingerprint must agree) compiled
    through a strategy file that pins every attention op to the einsum
    core (``dp_k:einsum``): its ``predict`` of [llama serve]'s ids against
    the flash core's, and of the generated sequence against the prefill's
    and the decode steps' logits, each within LLAMA_RTOL of the largest
    |logit|. Also the share of rows whose argmax agrees."""
    import numpy as np
    import torch

    release()
    print(f"[llama] the flash-core model deleted: {memory_line()}")
    with tempfile.TemporaryDirectory(prefix="ff_strategy_") as tmp:
        ff = build_llama(tmp)
    check(weights_fingerprint(ff) == fingerprint, "[llama] the einsum-core "
          "model does not hold the same weights")
    attn = {n.op.kernel_impl for n in ff.executor.nodes
            if n.op.op_type.name == "MULTIHEAD_ATTENTION"}
    check(attn == {"einsum"}, f"[llama] the strategy file pinned {attn}")
    reset_launches()
    ein_x = ff.predict(x)
    ein_gen = ff.predict(gen)
    check(not any(read_launches().values()), "[llama] the einsum-core "
          "model launched a kernel")
    del ff
    release()
    gaps = dict(serve=rel_gap(flash_out, ein_x),
                prefill=rel_gap(pre, ein_gen[:, :LLAMA_PROMPT]),
                decode=rel_gap(dec, ein_gen[:, LLAMA_PROMPT:]))
    agree = float(np.mean(np.argmax(dec, -1)
                          == np.argmax(ein_gen[:, LLAMA_PROMPT:], -1)))
    print(f"[llama serve] predict, flash core vs einsum core (a dp_k:einsum "
          f"strategy file, same seed): max_abs_err / max |logit| "
          f"{gaps['serve']:.3e} (tol {LLAMA_RTOL})")
    print(f"[llama decode] against one full predict (einsum core) of the "
          f"generated sequence, max_abs_err / max |logit|: prefill rows "
          f"{gaps['prefill']:.3e}, decode rows {LLAMA_PROMPT}-"
          f"{LLAMA['seq_length'] - 1} {gaps['decode']:.3e} (tol "
          f"{LLAMA_RTOL}); argmax agrees on {100 * agree:.1f}% of the decode "
          f"rows")
    check(all(np.isfinite(v) and v <= LLAMA_RTOL for v in gaps.values()),
          f"[llama] logits beyond {LLAMA_RTOL} of the einsum-core predict: "
          f"{gaps}")
    return gaps


def build_llama_train(layers, strategy_dir=None, remat=False, **cfg_kw):
    """``create_llama`` at LLAMA's widths and ``layers`` layers on the
    card, compiled for training (Adam LLAMA_TRAIN_ALPHA with bf16 moments,
    the token-level sparse CE); with ``strategy_dir``, through a strategy
    file of ``kernel_path(remat)`` written there; ``cfg_kw`` go to
    the FFConfig. The weights come from the config's seed: every call
    builds the same weights."""
    import torch
    from flexflow_tpu_torch import FFConfig, LossType
    from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                 create_llama)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    ff = create_llama(LlamaModelConfig(**dict(LLAMA,
                                              num_hidden_layers=layers)),
                      FFConfig(batch_size=LLAMA["batch_size"], **cfg_kw),
                      device="cuda")
    if strategy_dir is not None:
        path = os.path.join(strategy_dir, f"llama_train_{layers}_"
                                          f"{'remat' if remat else 'plain'}"
                                          f".json")
        write_strategy(ff, path, kernel_path(remat))
        ff.config.import_strategy_file = path
    ff.compile(AdamOptimizer(alpha=LLAMA_TRAIN_ALPHA,
                             state_dtype=torch.bfloat16),
               LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    return ff


def llama_batch(seed):
    """Ids and their labels in ``tests/test_llama.py``'s learnable pattern
    (the next token is the token + 1)."""
    import numpy as np

    v = LLAMA["vocab_size"]
    x = np.random.RandomState(seed).randint(
        0, v - 1, (LLAMA["batch_size"], LLAMA["seq_length"])).astype(np.int32)
    return x, ((x + 1) % v).astype(np.int32)


def llama_k4_row(layers):
    """K4 over the decoder's ``_k:fused`` leaves at ``layers`` layers
    (every op's parameters but attention's, their shapes read from the
    materialized graph): ``k4_row``."""
    from flexflow_tpu_torch.models.llama import (LlamaModelConfig,
                                                 create_llama)
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    graph = create_llama(LlamaModelConfig(**dict(LLAMA,
                                                 num_hidden_layers=layers)),
                         device="cuda")._materialize_nodes()[0]
    shapes = [tuple(shp) for n in graph
              if not isinstance(n.op, MultiHeadAttention)
              for shp in n.op.param_shapes().values()]
    return k4_row("[llama train]", f"the decoder's {len(shapes)} fused "
                  f"leaves at {layers} layers", shapes, LLAMA_TRAIN_ALPHA,
                  seed=12)


def k4_row(label, what, shapes, alpha, seed):
    """K4 over leaves of ``shapes`` (p f32, g, m, v bf16, random from
    ``seed``): one launch bit-equal to its plain version, leaf by leaf;
    timed back to back beside the plain version,
    ``torch.optim.Adam(fused=True)`` on the same parameters (f32 grads and
    moments: not the same function) and the bound (every byte read and
    written once). Returns the numbers for the kernels line."""
    import torch
    from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                     fused_adam_reference)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    n = sum(math.prod(shp) for shp in shapes)
    chunks = sum(-(-math.prod(shp) // 1024) for shp in shapes)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rnd = lambda shp, k: torch.randn(shp, generator=gen, device="cuda") * k
    ps = [rnd(shp, 1e-2) for shp in shapes]
    gs = [rnd(shp, 1e-3).bfloat16() for shp in shapes]
    ms = [rnd(shp, 1e-3).bfloat16() for shp in shapes]
    vs = [(rnd(shp, 1e-3) ** 2).bfloat16() for shp in shapes]
    _, alpha_t = AdamOptimizer(alpha=alpha).step_scalars(
        torch.tensor(0, dtype=torch.int32, device="cuda"))
    kw = dict(wd=0.0, **ADAM_KW)
    kp, km, kv = ([t.clone() for t in ts] for ts in (ps, ms, vs))
    fused_adam_multi(kp, gs, km, kv, alpha_t, **kw)
    torch.cuda.synchronize()
    differ = 0
    for i in range(len(shapes)):
        want = fused_adam_reference([ps[i]], [gs[i]], [ms[i]], [vs[i]],
                                    alpha_t, **kw)[0]
        differ += sum(int((a != b).sum())
                      for a, b in zip((kp[i], km[i], kv[i]), want))
    del kp, km, kv, want
    print(f"{label} fused_adam over {what} ({n} elements in {chunks} "
          f"1024-element chunks, one CTA each: the launch's grid): "
          f"{differ} elements differ from the plain version (want 0)")
    check(differ == 0, f"{label} K4 is not bit-equal to its plain version")
    launch = lambda: fused_adam_multi(ps, gs, ms, vs, alpha_t, **kw)
    k4_ms, k4_host_ms = time_calls(launch)
    plain_ms = time_ms(lambda: fused_adam_reference(ps, gs, ms, vs, alpha_t,
                                                    **kw))
    del ms, vs
    lib_params = [torch.nn.Parameter(p) for p in ps]
    for lp, g in zip(lib_params, gs):
        lp.grad = g.float()
    del gs
    lib = torch.optim.Adam(lib_params, lr=alpha, fused=True)
    library_ms = time_ms(lib.step)
    del lib, lib_params, ps
    release()
    bound_s, bound_by = adam_bound(n, 2, 2, H100_SXM_PEAKS)
    print(f"{label} fused_adam over the {len(shapes)} leaves: kernel "
          f"{k4_ms:.4f} ms (the host's time a call {k4_host_ms:.4f} ms: "
          f"the leaf table is built and copied every call), plain "
          f"{plain_ms:.4f} ms, library "
          f"(torch.optim.Adam fused, f32 moments and grads: not the same "
          f"function) {library_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms "
          f"({bound_by}) ({nvidia_smi_line()})")
    return dict(shape=f"{len(shapes)} leaves, {n} elements, p f32, g/m/v "
                      f"bf16", leaves=len(shapes), elements=n, chunks=chunks,
                max_abs_err=0.0, ms=k4_ms, timed_by="back to back",
                host_ms=k4_host_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by)


def phase_llama_train_grads(strategy_dir):
    """The decoder at LLAMA_GRAD_LAYERS layers, from its initial weights:
    the flash core's gradients against the einsum core's in bf16 compute
    (``check_grads``: each leaf within GRAD_RTOL of its largest |g|, or
    within FLOOR_FACTOR times its floor, the einsum core against itself
    with the embedding table, the model's input, scaled by 1 +- NUDGE)."""
    import torch

    release()
    ff = build_llama_train(LLAMA_GRAD_LAYERS, strategy_dir)
    x, y = llama_batch(7)
    emb = ff.params["embed_tokens"]["kernel"]
    start = emb.clone()

    def nudged(sign):
        with torch.no_grad():
            emb.mul_(1 + sign * NUDGE)
        ff._compute_params_dirty = True
        try:
            return grads_of_core(ff, x, y, "einsum")
        finally:
            with torch.no_grad():
                emb.copy_(start)
            ff._compute_params_dirty = True

    check_grads(ff, x, y, "bfloat16", label=f"[llama train] "
                f"{LLAMA_GRAD_LAYERS} layers,", nudged=nudged)
    del ff, emb, start, nudged
    release()


def phase_llama_train(strategy_dir):
    """[llama train] the decoder at LLAMA's widths and LLAMA_TRAIN_LAYERS
    layers through two strategy files from one seed: (P) attention
    ``dp_k:flash``, the rest ``dp_k:fused``; (R) the same with ``_r`` on
    every attention and RMSNorm. What autograd keeps for the backward, by
    op, in each; LLAMA_TRAIN_STEPS ``fit`` steps each (K1 once a layer a
    step in P and twice in R, K2 once a layer, K4 once; the losses finite
    and falling; R bit-equal to P, losses and every leaf; the device
    memory a step allocates and the graph pool, R below P);
    LLAMA_TRAIN_PAIRS interleaved pairs of a P and an R step timed; two
    replayed steps of each profiled (the kernels by name, the busy
    share); then, with P deleted, R's replayed step against its eager
    step bit for bit. Returns the report's numbers."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.ops.norm import RMSNorm

    release()
    torch.cuda.reset_peak_memory_stats()
    peaks = [0.0, 0.0]
    print(f"[llama train] before the models: {memory_line()}")
    layers = LLAMA_TRAIN_LAYERS
    x, y = llama_batch(5)
    models = {}
    for name in ("plain", "remat"):
        t0 = time.perf_counter()
        ff = models[name] = build_llama_train(layers, strategy_dir,
                                              remat=name == "remat")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for sub in ff.params.values()
                       for t in sub.values())
        print(f"[llama train] ({name[0].upper()}) create_llama at "
              f"{layers} of 32 layers, batch {LLAMA['batch_size']} x "
              f"{LLAMA['seq_length']}: {n_params} parameters, built and "
              f"compiled in {time.perf_counter() - t0:.2f} s; kernels "
              f"{sorted(set(ff.kernel_choices.values()))}, remat ops "
              f"{len(ff.remat_ops or ())}; {memory_line()}")
    pff, rff = models["plain"], models["remat"]
    check(weights_fingerprint(pff) == weights_fingerprint(rff),
          "[llama train] (P) and (R) do not hold the same weights")
    remat_kinds = {n.op.name for n in rff.executor.nodes
                   if isinstance(n.op, (MultiHeadAttention, RMSNorm))}
    check(pff.remat_ops is None and rff.remat_ops == remat_kinds
          and len(remat_kinds) == 3 * layers + 1
          and pff.kernel_choices == rff.kernel_choices
          and set(pff.kernel_choices.values()) == {"flash", "fused"},
          "[llama train] the strategy files did not give the expected "
          "kernels and remat ops")

    # what autograd keeps for the backward, by op (one eager forward each)
    saved = {}
    for name, ff in models.items():
        saved[name] = ff.executor.saved_bytes_by_op(
            ff.params, ff.state, ff._stage_inputs(x), ff._stage_labels(y))
        release()
    mib = lambda b: b / 2**20
    rows = [op for op in saved["plain"] if not op.startswith("l")
            or op.startswith("l0_")]
    print("[llama train] what autograd keeps for the backward, MiB by op "
          "(P / R; layer 0 and the ops outside the layers): "
          + ", ".join(f"{op} {mib(saved['plain'][op]):.1f} / "
                      f"{mib(saved['remat'][op]):.1f}" for op in rows))
    totals = {k: sum(v.values()) for k, v in saved.items()}
    freed = {op: saved["plain"][op] - saved["remat"][op]
             for op in saved["plain"] if op in rff.remat_ops}
    print(f"[llama train] in all: P {mib(totals['plain']):.1f} MiB, R "
          f"{mib(totals['remat']):.1f} MiB; remat frees "
          f"{mib(totals['plain'] - totals['remat']):.1f} MiB: attention "
          f"{mib(sum(v for k, v in freed.items() if k.endswith('_attn'))):.1f}"
          f", RMSNorm "
          f"{mib(sum(v for k, v in freed.items() if k.endswith('_ln'))):.1f}"
          f" (each checkpoint keeping its input)")
    check(totals["remat"] < totals["plain"]
          and all(saved["remat"][op] == b for op, b in saved["plain"].items()
                  if op not in rff.remat_ops)
          and all(v > 0 for v in freed.values()),
          "[llama train] remat did not free what the remat ops kept, or "
          "changed what another op keeps")
    # the forward and backward alone (an eager grads_of), without the
    # update: where each step's peak falls
    fwd_bwd = {}
    for name, ff in models.items():
        torch.cuda.synchronize()
        take_peaks(peaks)
        base = torch.cuda.memory_allocated()
        ff.executor.grads_of(ff.params, ff.state, ff._stage_inputs(x),
                             ff._stage_labels(y))
        torch.cuda.synchronize()
        fwd_bwd[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        release()
    print(f"[llama train] the forward and backward alone (an eager "
          f"grads_of), peak above what is held: P {fwd_bwd['plain']:.2f} "
          f"GiB, R {fwd_bwd['remat']:.2f} GiB")

    # LLAMA_TRAIN_STEPS fit steps each: launches, memory, losses
    want = {name: dict(flash_attn_fwd=layers * (2 if name == "remat" else 1),
                       flash_attn_bwd=layers, fused_adam=1, flash_lse_fwd=0,
                       flash_lse_bwd=0) for name in models}
    per = {}
    for name, ff in models.items():
        torch.cuda.synchronize()
        take_peaks(peaks)
        base = torch.cuda.memory_allocated()
        steps, walls = [], []
        for _ in range(LLAMA_TRAIN_STEPS):
            before = read_launches()
            t0 = time.perf_counter()
            ff.fit(x, y, epochs=1, verbose=False)
            walls.append(time.perf_counter() - t0)
            steps.append(launch_delta(before))
        torch.cuda.synchronize()
        sg = ff.executor.step_graphs["train_step"]
        per[name] = dict(
            saved_mib=mib(totals[name]), fwd_bwd_gib=fwd_bwd[name],
            losses=list(ff.epoch_losses),
            peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
            held_gib=base / 2**30, pool_gib=pool_gib(ff),
            copy_back_mib=sg.copy_back_bytes / 2**20,
            launches={k: sum(d[k] for d in steps) for k in steps[0]})
        r = per[name]
        print(f"[llama train] ({name[0].upper()}) {LLAMA_TRAIN_STEPS} fit "
              f"steps: losses " + ", ".join(f"{v:.6f}" for v in r["losses"])
              + f"; wall " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
              + f" ms (the first captures); launches a step {steps} (want "
              f"{want[name]}); captures {sg.captures}, replays {sg.replays}; "
              f"{r['held_gib']:.2f} GiB held before the first step, a step "
              f"allocates {r['peak_gib']:.2f} GiB above it at its peak; the "
              f"graph pool {r['pool_gib']:.2f} GiB, the copy-back "
              f"{r['copy_back_mib']:.1f} MiB a step ({nvidia_smi_line()})")
        check(all(d == want[name] for d in steps)
              and (sg.captures, sg.replays) == (1, LLAMA_TRAIN_STEPS - 1),
              f"[llama train] ({name}) launches a step differ, or a step "
              f"was not one replay")
        check(all(np.isfinite(r["losses"]))
              and r["losses"][-1] < r["losses"][0],
              f"[llama train] ({name}) the loss is not finite or does not "
              f"fall")
    differ = leaves_differ((pff.params, pff.opt_state, pff.state),
                           (rff.params, rff.opt_state, rff.state))
    n_leaves = len(flatten_leaves((pff.params, pff.opt_state, pff.state)))
    print(f"[llama train] (R) against (P): losses equal "
          f"{per['remat']['losses'] == per['plain']['losses']}; {differ} of "
          f"{n_leaves} leaves (params, m, v, t, the compute copy) differ "
          f"(want 0); a step's peak R {per['remat']['peak_gib']:.2f} GiB "
          f"against P {per['plain']['peak_gib']:.2f} GiB")
    check(per["remat"]["losses"] == per["plain"]["losses"] and differ == 0,
          "[llama train] remat changed the losses or the weights")
    check(per["remat"]["peak_gib"] < per["plain"]["peak_gib"],
          "[llama train] the remat step does not allocate less")

    # interleaved pairs of replayed steps, then two of each profiled
    runs = {name: graph_stepper(ff, x, y) for name, ff in models.items()}
    times = {name: [] for name in models}
    for i in range(LLAMA_TRAIN_PAIRS):
        for name in (("plain", "remat") if i % 2 == 0
                     else ("remat", "plain")):
            t0 = time.perf_counter()
            runs[name]()
            times[name].append(time.perf_counter() - t0)
    tokens = LLAMA["batch_size"] * LLAMA["seq_length"]
    for name in models:
        p50, p90 = p50_p90(times[name])
        per[name].update(p50_ms=p50 * 1e3, p90_ms=p90 * 1e3,
                         tokens_per_s=tokens / p50)
        print(f"[llama train] ({name[0].upper()}) {LLAMA_TRAIN_PAIRS} "
              f"interleaved pairs, a replayed step (host clock, ends in a "
              f"host read of the loss): p50 {p50 * 1e3:.3f} ms, p90 "
              f"{p90 * 1e3:.3f} ms, {tokens / p50:.1f} tokens/s "
              f"({nvidia_smi_line()})")
    for name, ff in models.items():
        sg = ff.executor.step_graphs["train_step"]
        replays0 = sg.replays
        label = f"[llama train] ({name[0].upper()}) 2 replayed steps"
        prof = profile_steps(label, runs[name])
        check(sg.replays - replays0 == 2 + LEAD_IN_CALLS,
              f"{label} were not 2 replays")
        per[name]["replay"] = check_replay_launches(label, prof, 2,
                                                    want[name])
        per[name]["kinds"] = prof[0]
        per[name]["busy_share"] = sum(prof[0].values()) / prof[2]
    torch.cuda.synchronize()
    take_peaks(peaks)
    print(f"[llama train] the phase with (P) and (R) both on the card: "
          f"{peaks_line(peaks)} ({nvidia_smi_line()})")
    del runs, prof, pff, ff
    models.pop("plain")
    release()
    per_call = graph_vs_eager(rff, x, y, 2, "[llama train] (R)")
    check(all(d == want["remat"] for d in per_call),
          f"[llama train] (R) launches a compiled call {per_call}")
    del rff, models
    release()
    return per


def phase_llama_search():
    """The memory-capped search on the decoder at LLAMA_TRAIN_LAYERS
    layers: ``compile(search_budget=SEARCH_BUDGET)`` uncapped, then with
    ``memory_search`` and a threshold at each of LLAMA_SEARCH_FRACTIONS of
    the uncapped prediction until the search gives ``_r`` choices; their
    ops, the predicted memory and step, then 2 ``fit`` steps: the loss
    finite, the measured peak beside the prediction. If no threshold
    makes an ``_r`` twin win, the search trace's named rejections of the
    decoder's ops. Returns the report's numbers."""
    import numpy as np
    import torch

    release()
    torch.cuda.reset_peak_memory_stats()
    peaks = [0.0, 0.0]
    layers = LLAMA_TRAIN_LAYERS
    ff = build_llama_train(layers, search_budget=SEARCH_BUDGET,
                           search_trace=True)
    free = ff.search_info
    trace = free.get("search_trace") or {}
    print(f"[llama search] compile(search_budget={SEARCH_BUDGET}) at "
          f"{layers} layers, uncapped: predicted step "
          f"{free['predicted_time'] * 1e3:.3f} ms, memory "
          f"{free['predicted_memory'] / 2**30:.2f} GiB, remat ops "
          f"{sorted(ff.remat_ops or ())}, kernels "
          f"{sorted(set((ff.kernel_choices or {}).values()))}; search "
          f"{free['search_wall_s']:.3f} s")
    rejected = {}
    for o in trace.get("ops", []):
        for r in o.get("remat_rejections") or []:
            rejected.setdefault(r["reason"], []).append(o["name"])
    twins = sorted({o["name"] for o in trace.get("ops", [])
                    for c in o.get("candidates", [])
                    if c["choice"].endswith("_r")})
    print(f"[llama search] the gate's twins: {len(twins)} ops with an _r "
          f"candidate ({', '.join(twins[:6])}, ...); named rejections: "
          + "; ".join(f"{reason} x {len(names)} ({', '.join(names[:4])}, "
                      f"...)" for reason, names in rejected.items()))
    del ff
    release()
    for frac in LLAMA_SEARCH_FRACTIONS:
        cap_mb = int(free["predicted_memory"] * frac) >> 20
        ff = build_llama_train(layers, search_budget=SEARCH_BUDGET,
                               memory_search=True, memory_threshold_mb=cap_mb)
        if ff.remat_ops:
            break
        print(f"[llama search] threshold {cap_mb} MiB ({frac}): no _r "
              f"choice")
        del ff
        release()
    else:
        # every capped compile ran and none chose _r: the finding is the
        # gate's named rejections, which must then be there
        print(f"[llama search] no threshold in {LLAMA_SEARCH_FRACTIONS} of "
              f"the uncapped prediction made an _r twin win")
        check(rejected, "[llama search] no _r choice under any threshold "
                        "and no named remat rejection in the search trace")
        return dict(remat_ops=[], rejected=rejected)
    info = ff.search_info
    print(f"[llama search] threshold {cap_mb} MiB ({frac} of the uncapped "
          f"prediction): {len(ff.remat_ops)} ops carry _r: "
          f"{sorted(ff.remat_ops)}; predicted step "
          f"{info['predicted_time'] * 1e3:.3f} ms, memory "
          f"{info['predicted_memory'] / 2**30:.2f} GiB; {memory_line()}")
    x, y = llama_batch(6)
    # what the _r choices free, measured: what autograd keeps with them
    # and with the executor's remat set aside for the count
    ex = ff.executor
    feeds = (ff._stage_inputs(x), ff._stage_labels(y))
    kept = {"remat": ex.saved_bytes_by_op(ff.params, ff.state, *feeds)}
    ex.remat_ops, remat_ops = None, ex.remat_ops
    try:
        kept["plain"] = ex.saved_bytes_by_op(ff.params, ff.state, *feeds)
    finally:
        ex.remat_ops = remat_ops
    release()
    freed_gib = (sum(kept["plain"].values())
                 - sum(kept["remat"].values())) / 2**30
    priced_gib = (free["predicted_memory"] - info["predicted_memory"]) / 2**30
    print(f"[llama search] what autograd keeps for the backward, MiB, "
          f"without / with the _r choices, for their ops: "
          + ", ".join(f"{op} {kept['plain'][op] / 2**20:.1f} / "
                      f"{kept['remat'][op] / 2**20:.1f}"
                      for op in sorted(remat_ops))
          + f"; in all, remat frees {freed_gib:.3f} GiB, where the search "
          f"priced {priced_gib:.3f} GiB (its uncapped and capped "
          f"predictions)")
    torch.cuda.synchronize()
    take_peaks(peaks)
    reset_launches()
    for _ in range(2):
        ff.fit(x, y, epochs=1, verbose=False)
    torch.cuda.synchronize()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    take_peaks(peaks)
    print(f"[llama search] 2 fit steps: losses "
          + ", ".join(f"{v:.6f}" for v in ff.epoch_losses)
          + f"; launches {read_launches()}; peak allocated {peak_gib:.2f} GiB "
          f"(the search predicted {info['predicted_memory'] / 2**30:.2f} "
          f"GiB); the phase: {peaks_line(peaks)} ({nvidia_smi_line()})")
    check(all(np.isfinite(ff.epoch_losses)),
          "[llama search] the searched remat strategy's loss is not finite")
    out = dict(remat_ops=sorted(ff.remat_ops), threshold_mb=cap_mb,
               freed_gib=freed_gib, priced_gib=priced_gib,
               predicted_gib=info["predicted_memory"] / 2**30,
               free_predicted_gib=free["predicted_memory"] / 2**30,
               peak_gib=peak_gib, losses=list(ff.epoch_losses))
    del ff
    release()
    return out


ZOO_MODELS = ("dlrm", "xdl", "candle_uno", "resnext", "inception")
# compile(search_budget=...) as in the OSDI'22 scripts
ZOO_BUDGET = dict(dlrm=20, xdl=20, candle_uno=20, resnext=20, inception=10,
                  resnet_bn=20)
ZOO_ALPHA = 1e-4
ZOO_CALLS = 3  # compiled calls against eager steps: the capture, 2 replays
ZOO_FIT_STEPS = 2
ZOO_PAIRS = 5
# [zoo bn]: the models and the ways each is compiled ((F): every fusable
# conv "dp_k:conv_bn_fused")
BN_MODES = dict(resnet_bn=("D", "K", "F", "S"), alexnet=("D", "K"))
BN_PAIRS = 53  # ResNet-50's conv -> BatchNorm pairs
# the eval fold's weights are rounded to bf16 after folding, the unfolded
# conv's output before its f32 BatchNorm: each of the 53 pairs rounds
# once more or less (2^-9 of a value), so the two predictions part by a
# random walk of such steps, the bf16 model tolerance of this script
FOLD_RTOL = MODEL_RTOL
# the layout pair (``layout_pair``), in f32 compute (TF32 off): one SGD
# step at LAYOUT_LR changes a parameter leaf by minus its gradient. The
# bounds are set from the readings of sound runs on an H100 80GB HBM3
# (PERF.md section 6), a few times the largest of the three models':
# each op's output in one training forward, of its largest (read 1.5e-4,
# ResNet-50-BN's last block, a BN over a channel of nearly equal values
# amplifying; 4.6e-6 and 5.5e-6 without BN); the step's loss, relative
# (6.1e-7, 0, 0); a leaf's change, the norm of the gap over its norm:
# parameters (2.7e-2, 6.4e-2, 7.7e-2: a gradient at random weights is a
# sum of terms of either sign, far smaller than their magnitudes, so the
# two layouts' orders of summation part it), running statistics
# (1.2e-5); a conv bias that a BatchNorm cancels has a gradient of
# rounding alone, so its change is held under LAYOUT_NULL of the model's
# largest parameter change instead (2.8e-7). In bf16 (as ``fit`` runs)
# only step 1's loss is held, relative (8.8e-4, 0, 0): bf16 rounding,
# amplified by such a BatchNorm, parts single activations and gradients
# by as much as they are large
LAYOUT_LR = 1.0
LAYOUT_SEED = 5  # the pair's He-normal conv kernels
LAYOUT_ACT_RTOL = 1e-3
LAYOUT_LOSS_RTOL = 1e-5
LAYOUT_LEAF_RTOL = 0.25
LAYOUT_STATE_RTOL = 1e-3
LAYOUT_NULL = 1e-5
LAYOUT_BF16_LOSS = 4e-3
SERVE_REQUESTS = 8
DROPOUT_SIGMAS = 5


def zoo_spec(name):
    """(builder, config, loss, metrics) of the zoo model ``name`` at the
    JAX package's default configuration; ``builder(config, ff_config,
    device=)``."""
    import types
    from flexflow_tpu_torch import LossType, MetricsType
    from flexflow_tpu_torch import models as M

    mse = (LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
           [MetricsType.MEAN_SQUARED_ERROR])
    sce = (LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [MetricsType.ACCURACY])
    alexnet = types.SimpleNamespace(batch_size=64, image_size=224,
                                    num_classes=10)
    return {"dlrm": (M.create_dlrm, M.DLRMConfig(), *mse),
            "xdl": (M.create_xdl, M.XDLConfig(), *sce),
            "candle_uno": (M.create_candle_uno, M.CandleUnoConfig(), *mse),
            "resnext": (M.create_resnext50, M.ResNeXtConfig(), *sce),
            "inception": (M.create_inception_v3, M.InceptionConfig(),
                          *sce),
            "resnet_bn": (M.create_resnet, M.ResNetConfig(batch_norm=True),
                          *sce),
            "alexnet": (lambda c, ff_config, device: M.create_alexnet(
                c.batch_size, c.num_classes, c.image_size,
                ff_config=ff_config, device=device), alexnet, *sce)}[name]


def zoo_batch(name, cfg, seed=11):
    """One batch of ``name``'s inputs and labels, from ``seed``: ids below
    each table's rows, floats from a normal, labels by the loss."""
    import numpy as np

    rs = np.random.RandomState(seed)
    b = cfg.batch_size
    if name == "dlrm":
        xs = [rs.randint(0, cfg.vocab_size, (b, cfg.indices_per_feature))
              for _ in range(cfg.num_sparse_features)]
        xs.append(rs.randn(b, cfg.dense_dim))
        y = rs.rand(b, 1)
    elif name == "xdl":
        xs = [rs.randint(0, v, (b, cfg.embedding_bag_size))
              for v in cfg.embedding_size]
        y = rs.randint(0, cfg.mlp[-1], (b, 1))
    elif name == "candle_uno":
        xs = [rs.randn(b, d) for d in cfg.input_features.values()]
        y = rs.rand(b, 1)
    else:
        xs = [rs.randn(b, 3, cfg.image_size, cfg.image_size)]
        y = rs.randint(0, cfg.num_classes, (b, 1))
    cast = lambda a: a.astype(np.int32 if a.dtype.kind == "i" else np.float32)
    return [cast(a) for a in xs], cast(y)


def compile_zoo(name, mode, strategy_dir, layout="auto",
                comp_mode="TRAINING", optimizer=None, mixed=True):
    """``name`` on the card, compiled for training (``optimizer``, by
    default Adam alpha ZOO_ALPHA with bf16 moments; the model's loss)
    from the config's seed, bf16 compute (f32 with ``mixed=False``), the
    conv
    family's layout ``layout``: (D) no strategy file; (K) a strategy file
    giving every op ``dp_k:fused`` (K4); (F) one giving every conv
    ``dp_k:conv_bn_fused`` and every other op ``dp``; (S)
    ``compile(search_budget=ZOO_BUDGET[name])``. ``comp_mode="INFERENCE"``
    compiles (D) for inference."""
    import torch
    from flexflow_tpu_torch import CompMode, FFConfig, OperatorType
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    create, cfg, loss, metrics = zoo_spec(name)
    ff = create(cfg, FFConfig(batch_size=cfg.batch_size,
                              conv_compute_layout=layout,
                              allow_mixed_precision=mixed), device="cuda")
    if mode in ("K", "F"):
        path = os.path.join(strategy_dir, f"{name}_{mode}.json")
        write_strategy(ff, path, (lambda kind: "dp_k:fused") if mode == "K"
                       else (lambda kind: "dp_k:conv_bn_fused"
                             if kind == OperatorType.CONV2D else "dp"))
        ff.config.import_strategy_file = path
    elif mode == "S":
        ff.config.search_budget = ZOO_BUDGET[name]
    if comp_mode == "INFERENCE":
        ff.compile(None, loss, metrics, comp_mode=CompMode.INFERENCE)
    else:
        ff.compile(optimizer or AdamOptimizer(
            alpha=ZOO_ALPHA, state_dtype=torch.bfloat16), loss, metrics)
    return ff


def phase_zoo(name, strategy_dir, modes=("D", "K", "S"), after=None,
              tag="zoo"):
    """[zoo] one of the OSDI'22 protocol's other five models (or, as
    ``[zoo bn]``, ResNet-50 with BatchNorm or AlexNet) at the JAX
    package's default configuration, compiled in each of ``modes`` from
    one seed, one compiled model on the card at a time: (D) plain Adam,
    (K) every op ``dp_k:fused`` (K4), (F) every conv
    ``dp_k:conv_bn_fused``, (S) the search. For each: ZOO_CALLS compiled
    calls (the capture, then replays) against as many eager steps from
    one state, bit for bit (the BatchNorms' running statistics too), K4's
    launches a call (1 in (K), 0 elsewhere);
    the others' losses against (D)'s and their parameter and op-state
    leaves bit for bit (unless the search rewrote the graph); (F) and
    (S) run each ``conv_bn_fused`` choice as one fused node; ZOO_FIT_STEPS ``fit``
    steps (replays; K4's launches counted from 0 around them);
    ``evaluate`` and ``predict`` of the batch (a capture, then a replay)
    against the eager eval step and forward, bit for bit. All of that
    with cuDNN deterministic (for (D) two replays of that capture are
    profiled too); then, as ``fit`` runs by default
    (deterministic off) and the step captured anew: ZOO_PAIRS
    interleaved pairs of a compiled and an eager step; two replayed
    steps profiled (busy share, device time by kind, the top conv
    kernels, K4 by name); peak memory; for (S) the search's wall time
    and prediction.
    Then K4 on (K)'s leaf shapes against its plain version and the
    library (``k4_row``), where (K) ran. ``after(mode, ff, x, y,
    label)`` runs the model's own checks once the common ones have,
    still deterministic; its dict joins the mode's row. Returns the
    report's numbers."""
    import numpy as np
    import torch
    from collections import Counter
    from flexflow_tpu_torch.layout import TrainFusedConvBN

    create, cfg, _, _ = zoo_spec(name)
    x, y = zoo_batch(name, cfg)
    card = nvidia_smi_line()
    rows, base_init, shapes = {}, None, None
    base_losses = base_trained = None
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    for mode in modes:
        label = f"[{tag} {name} {mode}]"
        t_mode = time.perf_counter()
        # the checks: cuDNN picks its algorithms by heuristics (no
        # benchmarking, so no choice is timed inside a capture) and only
        # deterministic ones, so that a replayed step can be held
        # bit-equal to an eager one
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = True
        release()
        base_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        peaks = [0.0, 0.0]
        t0 = time.perf_counter()
        ff = compile_zoo(name, mode, strategy_dir)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        ex, info = ff.executor, ff.search_info
        fused = ex.fused_update_ops & set(ff.params)
        leaves = [tuple(t.shape) for op in sorted(fused)
                  for t in ff.params[op].values()]
        n_params = sum(t.numel() for sub in ff.params.values()
                       for t in sub.values())
        n_leaves = sum(len(sub) for sub in ff.params.values())
        print(f"{label} {cfg} compiled in {compile_s:.2f} s: "
              f"{len(ex.nodes)} ops, {n_params} parameters in {n_leaves} "
              f"leaves; K4 over {len(leaves)} leaves "
              f"({sum(math.prod(s) for s in leaves)} elements); cuDNN "
              f"benchmark {torch.backends.cudnn.benchmark}, deterministic "
              f"{torch.backends.cudnn.deterministic}; layout "
              f"{ff.layout_info}")
        rewritten = bool(info and info.get("rewrites"))
        if base_init is None:
            base_init = host_params(ff)
        elif rewritten:
            print(f"{label} the search rewrote the graph "
                  f"({len(info['rewrites'])} rewrites): its parameters are "
                  f"not held to (D)'s, before or after training")
        else:
            differ = params_differ(ff, base_init)
            check(not differ, f"{label} {differ} initial parameter leaves "
                              f"differ from (D)'s: not one seed")
        if mode in ("D", "F"):
            check(not leaves, f"{label} a compile without _k:fused routes "
                              f"leaves through K4")
        chosen = sorted(n for n, k in (ff.kernel_choices or {}).items()
                        if k == "conv_bn_fused")
        fused_nodes = sum(isinstance(n.op, TrainFusedConvBN)
                          for n in ex._training_nodes())
        if chosen or mode == "F":
            print(f"{label} {len(chosen)} ops chose conv_bn_fused "
                  f"({chosen[:3]}...): {fused_nodes} fused nodes in the "
                  f"train step; unfused {ex.unfused_conv_bn}")
            check(fused_nodes == len(chosen) and not ex.unfused_conv_bn
                  and (mode != "F" or fused_nodes == BN_PAIRS),
                  f"{label} the conv_bn_fused choices do not all fuse")
        if mode == "K":
            check(len(leaves) == n_leaves, f"{label} {len(leaves)} of "
                  f"{n_leaves} leaves through K4")
            shapes = leaves
        if mode == "S":
            choices = Counter(st.choice for st in ff.strategy.values())
            print(f"{label} compile(search_budget={ZOO_BUDGET[name]}): "
                  f"search {info['search_wall_s']:.3f} s wall; mesh "
                  f"{ff.mesh.shape}; choices {dict(choices)}; kernel "
                  f"choices {ff.kernel_choices}; predicted_time "
                  f"{info['predicted_time'] * 1e3:.3f} ms, predicted_memory "
                  f"{info['predicted_memory']}, cost model "
                  f"{info['cost_model']}, {len(info['rewrites'])} rewrites")
            check(ff.mesh.size == 1 and info["objective"] == "step_time",
                  f"{label} the search chose {ff.mesh.shape}, "
                  f"{info['objective']}")
        want = dict(flash_attn_fwd=0, flash_attn_bwd=0,
                    fused_adam=1 if leaves else 0, flash_lse_fwd=0,
                    flash_lse_bwd=0)
        losses = []
        per_call = graph_vs_eager(ff, x, y, ZOO_CALLS, label, losses)
        sg = ex.step_graphs["train_step"]
        check(all(d == want for d in per_call)
              and (sg.captures, sg.replays) == (1, ZOO_CALLS - 1),
              f"{label} launches a compiled call {per_call} (want {want}), "
              f"captures and replays {(sg.captures, sg.replays)}")
        check(all(np.isfinite(losses)), f"{label} non-finite loss")
        if base_losses is None:
            base_losses, base_trained = losses, host_params(ff)
            differ = 0
        else:
            differ = (0 if rewritten
                      else params_differ(ff, base_trained))
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        print(f"{label} losses {losses} against (D)'s {base_losses}: "
              f"{rel:.3e} relative (tol {TRAJECTORY_RTOL}); bit-equal "
              f"{losses == base_losses}; parameter and op-state leaves after "
              f"the {ZOO_CALLS} steps bit-equal to (D)'s: "
              + ("not compared (the graph was rewritten)" if rewritten
                 else f"{len(base_trained) - differ} of "
                      f"{len(base_trained)}"))
        check(rel <= TRAJECTORY_RTOL, f"{label} the losses leave (D)'s")
        # K4 is bit-equal to the plain update, and the search's
        # one-device strategy runs (D)'s ops: the parameters agree
        check(not differ, f"{label} {differ} parameter leaves after "
                          f"{ZOO_CALLS} steps differ from (D)'s")
        # fit and evaluate, the entry points a user calls: fit replays
        # the captured step, evaluate captures its step, then replays it
        reset_launches()
        ff.fit(x, y, epochs=ZOO_FIT_STEPS, verbose=False)
        fit_launches = read_launches()
        fit_losses = ff.epoch_losses[-ZOO_FIT_STEPS:]
        want_fit = {k: v * ZOO_FIT_STEPS for k, v in want.items()}
        print(f"{label} fit, {ZOO_FIT_STEPS} steps: losses {fit_losses}; "
              f"launches {fit_launches} (want {want_fit}); replays "
              f"{sg.replays}")
        check(fit_launches == want_fit and np.isfinite(fit_losses).all()
              and sg.captures == 1,
              f"{label} fit's launches or losses differ")
        want_loss = float(ex._eval_step_fn()(
            ff.params, ff.state, ff._stage_inputs(as_inputs(x)),
            ff._stage_labels(y))[0])
        reports = [ff.evaluate(x, y)["loss"] for _ in range(2)]
        ev = ex.step_graphs["eval_step"]
        print(f"{label} evaluate {reports} against the eager eval step "
              f"{want_loss!r}; captures and replays "
              f"{(ev.captures, ev.replays)}")
        check(reports == [want_loss] * 2
              and (ev.captures, ev.replays) == (1, 1),
              f"{label} evaluate differs from the eager eval step")
        want_out = eager_predict(ff, x)
        outs = [ff.predict(x) for _ in range(2)]
        fwd = ex.step_graphs["forward"]
        print(f"{label} predict {outs[0].shape} against the eager forward: "
              f"{[bool(np.array_equal(o, want_out)) for o in outs]}; "
              f"captures and replays {(fwd.captures, fwd.replays)}")
        check(all(np.array_equal(o, want_out) for o in outs)
              and np.isfinite(want_out).all()
              and (fwd.captures, fwd.replays) == (1, 1),
              f"{label} predict differs from the eager forward")
        extra = after(mode, ff, x, y, label) if after else {}
        # (D): two replays of the deterministic capture profiled, to set
        # beside the same under cuDNN's default algorithms below
        det = (profile_steps(f"{label} 2 replayed steps, cuDNN "
                             f"deterministic", graph_stepper(ff, x, y),
                             top_of=("conv",)) if mode == "D" else None)
        # the timing and the profile: cuDNN's default choice of
        # algorithms, as ``fit`` runs (deterministic off, benchmarking
        # still off), the step captured anew under it; only finite losses
        # are asked of these steps
        torch.backends.cudnn.deterministic = False
        del ex.step_graphs["train_step"], sg
        graph = graph_stepper(ff, x, y)
        check(math.isfinite(graph()), f"{label} non-finite loss under "
                                      f"cuDNN's default algorithms")
        sg = ex.step_graphs["train_step"]
        take_peaks(peaks)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        graph()
        step_gib = (torch.cuda.max_memory_allocated() - held) / 2**30
        g_s, e_s, enq = time_pairs(ff, x, y, ZOO_PAIRS)
        (g50, g90), (e50, e90) = p50_p90(g_s), p50_p90(e_s)
        print(f"{label} {ZOO_PAIRS} interleaved pairs (host clock, each "
              f"step ends in a host read of its loss): compiled p50 "
              f"{g50 * 1e3:.3f} ms, p90 {g90 * 1e3:.3f} ms, "
              f"{cfg.batch_size / g50:.1f} samples/s; eager p50 "
              f"{e50 * 1e3:.3f} ms, p90 {e90 * 1e3:.3f} ms; a replay's "
              f"host enqueue p50 {statistics.median(enq) * 1e3:.3f} ms "
              f"({card})")
        replays0 = sg.replays
        prof = profile_steps(f"{label} 2 replayed steps", graph,
                             top_of=("conv",))
        check(sg.replays - replays0 == 2 + LEAD_IN_CALLS
              and sg.captures == 1,
              f"{label} the profiled steps were not 2 replays of one "
              f"capture")
        per_replay = check_replay_launches(f"{label} 2 replayed steps",
                                           prof, 2, want)
        check(math.isfinite(graph()), f"{label} non-finite loss under "
                                      f"cuDNN's default algorithms")
        kinds = prof[0]
        if det:
            print(f"{label} 2 replayed steps' device ms, cuDNN deterministic"
                  f" against its default algorithms: busy "
                  f"{sum(det[0].values()):.3f} against "
                  f"{sum(kinds.values()):.3f}, conv {det[0]['conv']:.3f} "
                  f"against {kinds['conv']:.3f}")
        take_peaks(peaks)
        row = dict(p50_ms=g50 * 1e3, p90_ms=g90 * 1e3,
                   samples_s=cfg.batch_size / g50, eager_p50_ms=e50 * 1e3,
                   busy=sum(prof[0].values()) / prof[2], kinds=kinds,
                   deterministic_kinds=det[0] if det else None,
                   step_gib=step_gib, pool_gib=pool_gib(ff),
                   peak_allocated_gib=peaks[0], peak_reserved_gib=peaks[1],
                   compile_s=compile_s, losses=losses,
                   k4_launches=fit_launches["fused_adam"],
                   k4_a_replay=per_replay["fused_adam"],
                   k4_graph_ms=(prof[0]["fused_adam"] / 2 if leaves
                                else None),
                   layout_info=ff.layout_info, transforms=prof[5],
                   deterministic_transforms=det[5] if det else None,
                   **extra)
        if mode == "S":
            pred = info["predicted_time"]
            row.update(search_s=info["search_wall_s"],
                       predicted_ms=pred * 1e3, measured_over_predicted=g50
                       / pred)
            print(f"{label} measured p50 {g50 * 1e3:.3f} ms against the "
                  f"predicted {pred * 1e3:.3f} ms: {g50 / pred:.2f}x")
        print(f"{label} memory: a replayed step allocates {step_gib:.2f} "
              f"GiB above what is held; the graph pool {row['pool_gib']:.2f}"
              f" GiB; {peaks_line(peaks)} (the eager reference steps' copy "
              f"of the state included)")
        rows[mode] = row
        del ff, ex, sg, ev, fwd, graph, prof
        release()
        left = torch.cuda.memory_allocated() / 2**30
        print(f"{label} the model freed before the next is built: "
              f"{memory_line()}")
        check(left <= base_gib + 0.5, f"{label} the freed model still holds "
              f"{left - base_gib:.2f} GiB")
        print(f"{label} {time.perf_counter() - t_mode:.1f} s")
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = flags
    if "K" not in rows:
        return dict(rows=rows)
    k4 = k4_row(f"[{tag} {name}]", f"{name}'s {len(shapes)} leaves", shapes,
                ZOO_ALPHA, seed=13)
    k4.update(launches=rows["K"]["k4_launches"],
              launches_a_replay=rows["K"]["k4_a_replay"],
              graph_ms=rows["K"]["k4_graph_ms"])
    return dict(rows=rows, k4=k4)


def copy_model(src, dst):
    """``src``'s parameter and op-state values into ``dst``, another build
    of the same graph whose layers carry the same names (every layer with
    parameters or state is named in the model's builder)."""
    import torch

    trees = [(src.params, dst.params)] + [
        ({k: v for k, v in m.state.items() if not k.startswith("__")}
         for m in (src, dst))]
    for a, b in trees:
        check({k: sorted(v) for k, v in a.items()}
              == {k: sorted(v) for k, v in b.items()},
              "the two builds' parameter or state trees differ")
        with torch.no_grad():
            for op, sub in a.items():
                for pn, t in sub.items():
                    b[op][pn].copy_(t)
    dst._compute_params_dirty = True


def resnet_bn_after(mode, ff, x, y, label):
    """[zoo bn] ResNet-50-BN's (D), after its steps: ``predict`` and
    ``evaluate`` with the eval fold against ``fold_conv_bn=False``
    (FOLD_RTOL); then an INFERENCE-compiled build given the trained
    weights and running statistics, folded offline
    (``transforms.fold_conv_batchnorm``, BN_PAIRS folds), its ``predict``
    against the eval fold's (FOLD_RTOL), and ``serve()``: SERVE_REQUESTS
    requests through a batch-64 bucket, each answered with its
    ``predict`` row, bit for bit."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.transforms import fold_conv_batchnorm

    if mode != "D":
        return {}
    ex = ff.executor
    folded, folded_logits = ff.predict(x), logits_of(ff, x)
    folded_loss = ff.evaluate(x, y)["loss"]
    ex.fold_conv_bn = False
    try:
        check(ex._inference_nodes() is ex.nodes, f"{label} fold off still "
                                                 f"folds")
        plain, plain_logits = eager_predict(ff, x), logits_of(ff, x)
        plain_loss = float(ex._eval_step_fn()(
            ff.params, ff.state, ff._stage_inputs(as_inputs(x)),
            ff._stage_labels(y))[0])
    finally:
        ex.fold_conv_bn = True
    # the logits (bf16) too: the softmax's bf16 probabilities, near 0.1
    # each here, may round two close logits to one value
    gap, logit_gap = rel_gap(folded, plain), rel_gap(folded_logits,
                                                     plain_logits)
    loss_gap = abs(folded_loss - plain_loss) / abs(plain_loss)
    print(f"{label} eval fold against fold_conv_bn=False: predict "
          f"{gap:.3e} of max, logits {logit_gap:.3e} of max (max |logit| "
          f"{float(abs(plain_logits).max()):.4g}), evaluate loss "
          f"{folded_loss!r} against {plain_loss!r} ({loss_gap:.3e} "
          f"relative); tolerance {FOLD_RTOL}")
    check(max(gap, logit_gap, loss_gap) <= FOLD_RTOL,
          f"{label} the eval fold leaves the unfolded eval")

    t0 = time.perf_counter()
    inf = compile_zoo("resnet_bn", "D", None, comp_mode="INFERENCE")
    copy_model(ff, inf)
    n_folds = fold_conv_batchnorm(inf)
    offline = inf.predict(x)
    off_gap = max(rel_gap(offline, folded),
                  rel_gap(logits_of(inf, x), folded_logits))
    bn_left = sum(n.op.op_type.name == "BATCHNORM"
                  for n in inf.executor.nodes)
    print(f"{label} transforms.fold_conv_batchnorm: {n_folds} folds, "
          f"{bn_left} BatchNorms left, {len(inf.executor.nodes)} ops; its "
          f"predict and logits against the eval fold's: {off_gap:.3e} of "
          f"max "
          f"(tolerance {FOLD_RTOL}); layout {inf.layout_info['nhwc_ops']} "
          f"ops channels-last")
    check(n_folds == BN_PAIRS and bn_left == 0 and off_gap <= FOLD_RTOL,
          f"{label} the offline fold differs")
    images = x[0]
    engine = inf.serve(batch_buckets=[len(images)])
    rows = np.linspace(0, len(images) - 1, SERVE_REQUESTS).astype(int)
    reqs = [engine.submit([images[i]]) for i in rows]
    engine.pump()
    got = [np.asarray(r.wait(60)) for r in reqs]
    equal = [bool(np.array_equal(g, offline[i])) for g, i in zip(got, rows)]
    print(f"{label} serve() of the folded model: {len(reqs)} requests in "
          f"bucket {len(images)}, each its predict row: {equal} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(all(equal), f"{label} a served reply differs from its predict row")
    del inf, engine, reqs
    release()
    return dict(fold_gap=gap, fold_logit_gap=logit_gap,
                fold_loss_gap=loss_gap, offline_gap=off_gap,
                offline_folds=n_folds)


def op_taps(ff, kind, training, inputs):
    """Each ``kind`` op's (input, output) in one eager forward
    (``_forward_fn``, the eval fold's node list outside training) of
    ``inputs``, its randomness drawn from the model's generator."""
    ex = ff.executor
    nodes = ex.nodes if training else ex._inference_nodes()
    ops = [n.op for n in nodes if n.op.op_type.name == kind]
    taps = {}
    for op in ops:
        def tapped(params, args, ctx, op=op, forward=op.forward):
            outs = forward(params, args, ctx)
            taps[op.name] = (args[0], outs[0])
            return outs
        op.forward = tapped
    try:
        ex._forward_fn(training)(ff.params, ff.state, inputs, ff._generator)
    finally:
        for op in ops:
            del op.forward
    return taps


def logits_of(ff, x):
    """The model's logits on ``x`` (the input of its final softmax) as
    the eval forward computes them, as f32 numpy."""
    from flexflow_tpu_torch.model import host_copy

    ff._refresh_compute_params()
    (logits, _), = op_taps(ff, "SOFTMAX", False,
                           ff._stage_inputs(as_inputs(x))).values()
    return host_copy(logits)


def alexnet_after(mode, ff, x, y, label):
    """[zoo bn] AlexNet's checks, after its steps: in a training forward,
    each dropout zeroes a share of the elements its input holds nonzero
    within DROPOUT_SIGMAS binomial standard deviations of its rate, and
    scales the rest by 1 / (1 - rate) exactly; ``predict``'s forward
    takes each dropout as the identity and draws nothing from the
    generator; 3 ``fit`` steps give finite losses."""
    import numpy as np
    import torch

    inputs = ff._stage_inputs(as_inputs(x))
    shares = {}
    with torch.no_grad():
        for name, (inp, out) in op_taps(ff, "DROPOUT", True,
                                        inputs).items():
            rate = next(n.op.rate for n in ff.executor.nodes
                        if n.op.name == name)
            live = inp != 0
            dropped = (out == 0) & live
            n = int(live.sum())
            share = float(dropped.sum()) / n
            exact = torch.equal(out[live & ~dropped],
                                (inp / (1.0 - rate))[live & ~dropped])
            bound = DROPOUT_SIGMAS * (rate * (1 - rate) / n) ** 0.5
            shares[name] = share
            print(f"{label} dropout {name} (rate {rate}): {share:.5f} of "
                  f"{n} nonzero inputs dropped (within {bound:.5f} of "
                  f"{rate}); the kept scaled exactly: {exact}")
            check(abs(share - rate) <= bound and exact,
                  f"{label} dropout {name} off its rate or scale")
    state = ff._generator.get_state()
    identity = all(out is inp for inp, out
                   in op_taps(ff, "DROPOUT", False, inputs).values())
    outs = [ff.predict(x) for _ in range(2)]
    same_rng = torch.equal(state, ff._generator.get_state())
    print(f"{label} predict: dropout the identity {identity}, two predicts "
          f"equal {np.array_equal(*outs)}, the generator untouched "
          f"{same_rng}")
    check(identity and np.array_equal(*outs) and same_rng,
          f"{label} predict is not dropout-free")
    ff.fit(x, y, epochs=3, verbose=False)
    losses = ff.epoch_losses[-3:]
    print(f"{label} 3 fit steps: losses {losses}")
    check(np.isfinite(losses).all(), f"{label} non-finite fit loss")
    return dict(dropout_shares=shares, fit3_losses=losses)


def forward_outputs(ff, x):
    """Each op's first output, detached, in graph order, from one
    training-mode forward of ``x`` (batch statistics; the model's state
    and parameters untouched)."""
    import torch

    ex = ff.executor
    ops = [n.op for n in ex.nodes]
    got = {}
    for op in ops:
        for attr in ("forward", "forward_with_state"):
            fn = getattr(op, attr, None)
            if fn is None:
                continue

            def tapped(*a, op=op, fn=fn, attr=attr, **k):
                r = fn(*a, **k)
                got[op.name] = (r[0] if attr == "forward_with_state"
                                else r)[0].detach()
                return r
            setattr(op, attr, tapped)
    try:
        ff._refresh_compute_params()
        with torch.no_grad():
            ex._forward_fn(True)(ff.params, ff.state,
                                 ff._stage_inputs(as_inputs(x)),
                                 ff._generator)
    finally:
        for op in ops:
            for attr in ("forward", "forward_with_state"):
                op.__dict__.pop(attr, None)
    return [(op.name, op.op_type.name, got[op.name]) for op in ops]


def cancelled_biases(ff):
    """(op, "bias") of every conv whose output only a BatchNorm reads:
    the BN subtracts the batch mean, so the bias's gradient is rounding
    alone."""
    nodes = ff.executor.nodes
    readers = {}
    for n in nodes:
        for ref in n.input_refs:
            if ref[0] == "op":
                readers.setdefault(ref[1], []).append(n.op)
    return {(n.op.name, "bias") for n in nodes
            if n.op.op_type.name == "CONV2D"
            and "bias" in ff.params.get(n.op.name, {})
            and [r.op_type.name for r in readers.get(n.op.guid, [])]
            == ["BATCHNORM"]}


def layout_pair(name, auto_row):
    """The model under ``"auto"`` (channels-last) and ``"nchw"`` held to
    each other, then its (D) profiled under ``"nchw"``.

    The check, in f32 compute (TF32 off) and cuDNN deterministic (so
    that a reading repeats): both builds from the config's seed, their
    conv kernels He-normal from LAYOUT_SEED (every leaf equal), compiled
    with SGD at LAYOUT_LR. Each op's output in one training-mode forward
    within LAYOUT_ACT_RTOL of its largest (the eval forward says little
    at the initial running statistics: its logits are near 0). One
    compiled step each: its loss within LAYOUT_LOSS_RTOL, and each
    parameter and BN running-statistics leaf's change in that step (a
    gradient; a batch statistic), the norm of the gap over the norm of
    the change, within LAYOUT_LEAF_RTOL (LAYOUT_STATE_RTOL for the
    statistics); a conv bias that a BN cancels
    (``cancelled_biases``) held under LAYOUT_NULL of the model's
    largest parameter change under both layouts instead. Only rounding
    parts the two: the conv algorithms differ by layout. Then bf16 and
    cuDNN's default algorithms, as ``fit`` runs: (D) under ``"nchw"``,
    ZOO_CALLS compiled steps, the first's loss within LAYOUT_BF16_LOSS
    of the ``"auto"`` run's (the later ones printed, not held: from
    step 2 the model memorizes its one batch and the rounding
    compounds), two replays profiled (busy share, conv time, cuDNN's
    NCHW<->NHWC transforms by name) beside the ``"auto"`` run's profile
    (``auto_row``)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.optimizers import SGDOptimizer

    label = f"[layout {name}]"
    t0 = time.perf_counter()
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    release()
    try:
        _, cfg, _, _ = zoo_spec(name)
        x, y = zoo_batch(name, cfg)
        pair = {lay: compile_zoo(name, "D", None, layout=lay,
                                 optimizer=SGDOptimizer(lr=LAYOUT_LR),
                                 mixed=False)
                for lay in ("auto", "nchw")}
        # a step hands back new trees, in an order of its own: a leaf is
        # found again by its name, taken in build order beforehand
        names = {lay: [("params", op, pn) for op, sub in ff.params.items()
                       for pn in sub]
                 + [("state", k, n) for k, sub in ff.state.items()
                    if not k.startswith("__") for n in sub]
                 for lay, ff in pair.items()}
        # the builders' conv kernels (Glorot) halve a ReLU signal's power
        # each layer: without BatchNorm, ResNeXt-50's and Inception-v3's
        # logits come out 0 and most leaves get no gradient, which would
        # leave nothing to compare. He-normal kernels from one seed keep
        # the signal, and the last dense's kernel, scaled to give logits
        # of RMS 1, keeps the loss off its clip (where the gradient is 0);
        # the same values in both builds
        def put(i, value):
            with torch.no_grad():
                for lay, ff in pair.items():
                    _, op, pn = names[lay][i]
                    ff.params[op][pn].copy_(value)
                    ff._compute_params_dirty = True

        rs = np.random.RandomState(LAYOUT_SEED)
        for i, (k, op, pn) in enumerate(names["auto"]):
            t = pair["auto"].params[op][pn] if k == "params" else None
            if t is not None and pn == "kernel" and t.dim() == 4:
                put(i, torch.from_numpy(
                    rs.randn(*t.shape).astype(np.float32)
                    * math.sqrt(2 / math.prod(t.shape[1:]))))
        fc, _, logits = [a for a in forward_outputs(pair["auto"], x)
                         if a[1] == "LINEAR"][-1]
        rms = float(logits.float().pow(2).mean().sqrt())
        i = names["auto"].index(("params", fc, "kernel"))
        put(i, pair["auto"].params[fc]["kernel"] / rms)
        del logits
        before = host_params(pair["auto"])
        n_params = sum(len(sub) for sub in pair["auto"].params.values())
        cancelled = cancelled_biases(pair["auto"])
        nulls = {i for i, (_, op, pn) in enumerate(names["auto"])
                 if (op, pn) in cancelled}
        differ = params_differ(pair["nchw"], before)
        info = {lay: ff.layout_info for lay, ff in pair.items()}
        print(f"{label} f32 (compute dtype "
              f"{pair['auto'].executor.compute_dtype}, TF32 "
              f"{torch.backends.cudnn.allow_tf32}): auto layout "
              f"{info['auto']}; nchw layout {info['nchw']}; {len(before)} "
              f"leaves ({n_params} "
              f"parameters, {len(nulls)} of them conv biases a BN cancels; "
              f"{len(before) - n_params} running statistics), {differ} "
              f"differ before the step")
        check(info["auto"]["enabled"] and not info["nchw"]["enabled"]
              and not differ, f"{label} not the two layouts from one seed")

        acts = forward_outputs(pair["auto"], x)
        act_gaps, zero_ops = [], 0
        for (op, kind, a), (_, _, n) in zip(acts,
                                            forward_outputs(pair["nchw"], x)):
            a, n = a.float(), n.float()
            top, gap = float(a.abs().max()), float((n - a).abs().max())
            if top == 0 and gap == 0:
                zero_ops += 1
            else:
                act_gaps.append((gap / top if top else math.inf,
                                 f"{op} ({kind})"))
        logit_gap = act_gaps[-1][0] if act_gaps else 0.0
        del acts
        loss = {lay: graph_stepper(ff, x, y)() for lay, ff in pair.items()}
        change = {lay: [getattr(ff, k)[op][n].detach().cpu().float()
                        - b.float() for (k, op, n), b in zip(names[lay],
                                                             before)]
                  for lay, ff in pair.items()}
        del pair
        release()
        loss_gap = abs(loss["nchw"] - loss["auto"]) / abs(loss["auto"])
        top = {lay: [float(d.abs().max()) for d in ch]
               for lay, ch in change.items()}
        largest = max(top["auto"][:n_params])
        null_top = max((max(top["auto"][i], top["nchw"][i]) / largest
                        for i in nulls), default=0.0)
        # a leaf's gap: the norm of the difference of its changes over the
        # norm of its change (the largest element's gap, over the largest
        # change, printed beside it). A ReLU whose input lies within
        # rounding of 0 under one layout and not the other sends one
        # element of the gradient elsewhere: that moves the largest
        # element's gap by a few percent, the norm's hardly
        leaf_gaps, leaf_max_gaps, still = [], [], 0
        for i, (k, op, pn) in enumerate(names["auto"]):
            if i in nulls:
                continue
            d = change["nchw"][i] - change["auto"][i]
            norm = float(change["auto"][i].norm())
            if norm == 0 and float(d.abs().max()) == 0:
                still += 1
                continue
            leaf_gaps.append((float(d.norm()) / norm if norm else math.inf,
                              f"{op}.{pn}"))
            leaf_max_gaps.append((float(d.abs().max()) / top["auto"][i]
                                  if top["auto"][i] else math.inf,
                                  f"{op}.{pn}"))
        worst = lambda gaps: sorted(gaps)[-5:]
        fmt = lambda gaps: [(f"{g:.2e}", n) for g, n in worst(gaps)]
        state_names = {f"{op}.{n}" for k, op, n in names["auto"]
                       if k == "state"}
        s_gaps = [g for g in leaf_gaps if g[1] in state_names]
        p_gaps = [g for g in leaf_gaps if g[1] not in state_names]
        p_max = max((g for g in leaf_max_gaps if g[1] not in state_names),
                    default=(0.0, None))
        s_max = max((g for g in leaf_max_gaps if g[1] in state_names),
                    default=(0.0, None))
        p_worst = max(p_gaps, default=(0.0, None))
        s_worst = max(s_gaps, default=(0.0, None))
        act_worst = max(act_gaps, default=(0.0, None))
        print(f"{label} one training forward, each op's output against its"
              f" largest: worst {act_worst[0]:.3e} ({act_worst[1]}), the "
              f"logits {logit_gap:.3e}, {zero_ops} ops 0 under both layouts"
              f" (tol {LAYOUT_ACT_RTOL}); the 5 worst {fmt(act_gaps)}")
        print(f"{label} one SGD step (lr {LAYOUT_LR}): loss {loss['nchw']!r}"
              f" against {loss['auto']!r}, {loss_gap:.3e} relative (tol "
              f"{LAYOUT_LOSS_RTOL}); a leaf's change, the norm of the gap "
              f"over its norm: parameters worst {p_worst[0]:.3e} "
              f"({p_worst[1]}), running statistics worst {s_worst[0]:.3e} "
              f"({s_worst[1]}) (tol {LAYOUT_LEAF_RTOL}, "
              f"{LAYOUT_STATE_RTOL}); the largest "
              f"element's gap over the largest change: parameters "
              f"{p_max[0]:.3e} ({p_max[1]}), running statistics "
              f"{s_max[0]:.3e} ({s_max[1]}); {still} leaves unchanged under "
              f"both; "
              f"the 5 worst parameters {fmt(p_gaps)}; the cancelled conv "
              f"biases' largest change {null_top:.3e} of the model's "
              f"largest ({largest:.4g}; tol {LAYOUT_NULL})")
        check(act_worst[0] <= LAYOUT_ACT_RTOL and loss_gap <= LAYOUT_LOSS_RTOL
              and p_worst[0] <= LAYOUT_LEAF_RTOL
              and s_worst[0] <= LAYOUT_STATE_RTOL
              and null_top <= LAYOUT_NULL,
              f"{label} the layouts part beyond rounding")
        out = dict(act_gap=act_worst[0], logit_gap=logit_gap,
                   zero_ops=zero_ops, loss_gap=loss_gap,
                   param_gap=p_worst[0], state_gap=s_worst[0],
                   param_max_gap=p_max[0], state_max_gap=s_max[0],
                   null_top=null_top, unchanged_leaves=still,
                   act_gaps=act_gaps, leaf_gaps=leaf_gaps,
                   leaf_max_gaps=leaf_max_gaps)
        del change

        torch.backends.cudnn.deterministic = False
        ff = compile_zoo(name, "D", None, layout="nchw")
        graph = graph_stepper(ff, x, y)
        losses = [graph() for _ in range(ZOO_CALLS)]
        first = abs(losses[0] - auto_row["losses"][0]) / abs(
            auto_row["losses"][0])
        print(f"{label} (D) in bf16 under nchw, cuDNN's default "
              f"algorithms: {ZOO_CALLS} compiled steps' losses {losses}, "
              f"the auto run's {auto_row['losses']}: step 1 {first:.3e} "
              f"relative (tol {LAYOUT_BF16_LOSS}), the later ones not held")
        check(np.isfinite(losses).all() and first <= LAYOUT_BF16_LOSS,
              f"{label} bf16 step 1's loss parts by layout")
        out.update(bf16_loss_gap=first)
        prof = profile_steps(f"{label} nchw, 2 replayed steps", graph,
                             top_of=("conv",))
        kinds, wall, tr = prof[0], prof[2], prof[5]
        auto_kinds, auto_tr = auto_row["kinds"], auto_row["transforms"]
        print(f"{label} 2 replayed steps, nchw against auto (channels-"
              f"last): busy {sum(kinds.values()):.3f} against "
              f"{sum(auto_kinds.values()):.3f} ms, conv {kinds['conv']:.3f} "
              f"against {auto_kinds['conv']:.3f} ms, NCHW<->NHWC transforms "
              f"{tr['ms']:.3f} ms in {tr['launches']} launches against "
              f"{auto_tr['ms']:.3f} ms in {auto_tr['launches']} "
              f"({nvidia_smi_line()}; {time.perf_counter() - t0:.1f} s)")
        out.update(losses=losses, busy_ms=sum(kinds.values()),
                   busy_share=sum(kinds.values()) / wall, kinds=kinds,
                   transforms=tr, layout_info=ff.layout_info)
        del ff, graph, prof
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic \
            = flags
        release()
    return out


def phase_zoo_bn(strategy_dir):
    """[zoo bn] ResNet-50 with BatchNorm (batch 64, 224 x 224, 53
    conv -> BN pairs) as (D), (K), (F) and (S), with the eval and offline
    folds and ``serve()`` after (D) (``resnet_bn_after``), then its (D)
    under ``"nchw"`` (``layout_pair``); AlexNet (batch 64, 224 x 224, two
    dropouts at 0.5) as (D) and (K), with its dropout checks
    (``alexnet_after``). Returns {model: ``phase_zoo``'s report, with the
    layout pair under "nchw"}."""
    out = {}
    for name, after in (("resnet_bn", resnet_bn_after),
                        ("alexnet", alexnet_after)):
        t0 = time.perf_counter()
        out[name] = phase_zoo(name, strategy_dir, modes=BN_MODES[name],
                              after=after, tag="zoo bn")
        if name == "resnet_bn":
            out[name]["nchw"] = layout_pair(name, out[name]["rows"]["D"])
        print(f"[zoo bn {name}] {time.perf_counter() - t0:.1f} s")
    return out


# [ckpt]: the BERT-proxy's checkpoint, resume, preemption and deploy, at
# its full width and CKPT_LAYERS of its 12 layers (depth only scales the
# bytes and compiles: [wus] saves and restores all 12 over 4 ranks). The
# uninterrupted run takes 2 * CKPT_N steps; the interrupted one saves at
# step CKPT_N and a fresh model resumes it. The preempted child raises
# SIGTERM on itself after step slot CKPT_SIGTERM_SLOT (FFS_FAULT), so its
# grace checkpoint holds step CKPT_SIGTERM_SLOT + 1, inside CKPT_GRACE_S.
CKPT_LAYERS = 4
CKPT_N = 3
CKPT_SIGTERM_SLOT = 1
CKPT_GRACE_S = 300.0
CKPT_CHILD_TIMEOUT_S = 300
# the zoo's resumes: checkpoint every CKPT_ZOO_EVERY steps, against an
# uninterrupted run of CKPT_ZOO_STEPS
CKPT_ZOO_STEPS, CKPT_ZOO_EVERY = 4, 2
# PREEMPTED_EXIT of flexflow_tpu_torch/runtime_health.py (the reference's)
PREEMPTED_EXIT = 78


def state_bits(ff):
    """{leaf key: its bits as host numpy} of every leaf of the live
    training state, read from the trees themselves (``ff.params``,
    ``ff.opt_state``'s m, v and t, ``ff.state`` without the bf16 compute
    copy), and the payload bytes of ``ckpt.snapshot(ff)``, which must hold
    exactly these leaves with these bits: a leaf the checkpoint leaves out
    fails here, not only through the losses."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ckpt import snapshot
    from flexflow_tpu_torch.executor import COMPUTE_PARAMS_KEY

    def leaves(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(f"{prefix}/{k}", v)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(f"{prefix}/{i}", v)
        elif isinstance(tree, torch.Tensor):
            yield prefix, tree

    def bits(arr):
        return arr.view(np.dtype(f"uint{8 * arr.dtype.itemsize}"))

    int_of = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    live = {}
    for key, t in [*leaves("params", ff.params),
                   *leaves("opt_state", ff.opt_state),
                   *leaves("op_state", {k: v for k, v in ff.state.items()
                                        if k != COMPUTE_PARAMS_KEY})]:
        t = t.detach()
        if t.dtype.is_floating_point:
            t = t.contiguous().view(int_of[t.element_size()])
        live[key] = bits(t.to("cpu", copy=True).numpy())
    snap = snapshot(ff)
    missing = sorted(set(live) - set(snap.shards))
    extra = sorted(set(snap.shards) - set(live))
    check(not missing and not extra,
          f"the snapshot's leaves differ from the live state's: missing "
          f"{missing[:8]}, not in the state {extra[:8]}")
    wrong = sorted(k for k, [(_, arr)] in snap.shards.items()
                   if arr.shape != live[k].shape
                   or arr.dtype.itemsize != live[k].dtype.itemsize
                   or not np.array_equal(bits(arr), live[k]))
    check(not wrong, f"snapshot leaves differ from the live state's bits: "
                     f"{wrong[:8]}")
    return live, snap.payload_bytes


def bits_differ(a, b):
    """Keys whose bits differ between two ``state_bits`` dicts."""
    import numpy as np

    if set(a) != set(b):
        return sorted(set(a) ^ set(b))
    return sorted(k for k in a if not np.array_equal(a[k], b[k]))


def registry_obs(name):
    """(count, sum) of a registry observation series."""
    from flexflow_tpu_torch.obs.registry import get_registry

    o = get_registry().to_dict()["observations"].get(name, {})
    return o.get("count", 0.0), o.get("sum", 0.0)


def obs_since(name, before):
    """(count, sum) of a registry observation series since ``before``."""
    now = registry_obs(name)
    return now[0] - before[0], now[1] - before[1]


def quiet(fn, *args):
    """(what ``fn(*args)`` returns, what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def ckpt_child(argv):
    """``chip_smoke.py --ckpt-child DIR STRATEGY_DIR STEPS [--resume]``:
    one process of the [ckpt] phase's preemption leg. Trains the
    BERT-proxy at full width and CKPT_LAYERS layers through
    ``fit(epochs=STEPS)`` with
    ``checkpoint_dir=DIR`` and a grace window (``FFS_FAULT`` comes from
    the environment); prints one ``[ckpt child]`` JSON line with its
    losses, launches and whether the kernels were built before it
    started. A SIGTERM makes ``fit`` raise ``Preempted``, which exits
    the process with PREEMPTED_EXIT."""
    import torch
    from flexflow_tpu_torch import cuda_build
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    ckpt_dir, strategy_dir, steps = argv[0], argv[1], int(argv[2])
    resume = "--resume" in argv[3:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = ["flash_attn_fwd", "flash_attn_bwd", "fused_adam"]
    prebuilt = {n: cuda_build._paths(n)[1].exists() for n in names}
    cfg = TransformerConfig(num_layers=CKPT_LAYERS)
    ff = compile_for_training(cfg, strategy_dir)
    ff.config.grace_window_s = CKPT_GRACE_S
    x, y = training_batch(cfg)
    reset_launches()
    t0 = time.perf_counter()
    try:
        ff.fit(x, y, epochs=steps, verbose=False, checkpoint_dir=ckpt_dir,
               resume=resume)
    finally:
        record = json.dumps(dict(
            losses=list(ff.epoch_losses), iteration=ff._iter,
            launches=read_launches(), prebuilt=prebuilt,
            fit_s=time.perf_counter() - t0))
        print("[ckpt child] " + record, flush=True)
        with open(ckpt_child_record(ckpt_dir, resume), "w") as f:
            f.write(record)
    return 0


def ckpt_child_record(ckpt_dir, resume):
    """The file a ``--ckpt-child`` leaves its JSON line in, beside its
    checkpoint directory (the supervisor does not read its output)."""
    return ckpt_dir + (".resumed.json" if resume else ".first.json")


def phase_ckpt(strategy_dir):
    """[ckpt] the BERT-proxy at full width and CKPT_LAYERS layers
    through train (b)'s kernel choices (K1, K2, K4 in every step): (a) 2N uninterrupted steps against N
    steps saved with ``checkpoint_every=N`` and a fresh model resumed by
    ``fit(resume=True)``, bit for bit, the resumed steps' launches and
    replays counted; (b) ``supervise`` over a child preempted by
    SIGTERM: its grace checkpoint, the restart resuming it bit-equal to
    (a), and ``ckpt_inspect`` on the directory; (c)
    ``load_for_serving`` on (a)'s checkpoint against a training model's
    ``load_checkpoint``, ``predict`` and ``serve()`` bit for bit. Returns
    the resumed steps' launches and the figures."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.ckpt import (latest_complete, list_steps,
                                         load_manifest, load_sharded,
                                         snapshot, verify_step_dir)
    from flexflow_tpu_torch.ckpt import manifest as mf
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.obs.registry import get_registry
    from flexflow_tpu_torch.scripts import ckpt_inspect as inspect_cli
    from flexflow_tpu_torch.scripts import supervise as supervise_cli
    from flexflow_tpu_torch.serve import load_for_serving

    cfg = TransformerConfig(num_layers=CKPT_LAYERS)
    x, y = training_batch(cfg)
    n = CKPT_N
    reg = get_registry()
    out = {}
    root = tempfile.mkdtemp(prefix="ff_ckpt_")
    try:
        # (a) the uninterrupted run, step by step to time the steps
        ref = compile_for_training(cfg, strategy_dir)
        step_s = []
        for _ in range(2 * n):
            t0 = time.perf_counter()
            ref.fit(x, y, epochs=1, verbose=False)
            step_s.append(time.perf_counter() - t0)
        ref_losses = list(ref.epoch_losses)
        ref_bits, nbytes = state_bits(ref)
        leaves = len(ref_bits)
        n_params = sum(a.size for k, a in ref_bits.items()
                       if k.startswith("params/"))
        del ref
        release()
        print(f"[ckpt] uninterrupted {2 * n} steps: losses "
              + ", ".join(repr(v) for v in ref_losses)
              + f"; checkpoint payload {nbytes} bytes ({nbytes / 1e9:.3f} "
              f"GB) in {leaves} leaves, {n_params} parameters")
        d = os.path.join(root, "a")
        stall0 = registry_obs("fit/ckpt_save_stall_s")
        write0 = registry_obs("fit/ckpt_async_write_s")
        bytes0 = reg.get("fit/ckpt_bytes_written")
        first = compile_for_training(cfg, strategy_dir)
        first.fit(x, y, epochs=n, verbose=False, checkpoint_dir=d,
                  checkpoint_every=n)
        check(first.epoch_losses == ref_losses[:n],
              "checkpointing changed the first steps' losses")
        del first
        release()
        stalls, stall_sum = obs_since("fit/ckpt_save_stall_s", stall0)
        writes, write_sum = obs_since("fit/ckpt_async_write_s", write0)
        written = reg.get("fit/ckpt_bytes_written") - bytes0
        step, sdir = latest_complete(d)
        rep = verify_step_dir(sdir)
        check(step == n and rep["complete"],
              f"no complete checkpoint at step {n}: {rep['errors']}")
        check(written == nbytes == rep["payload_bytes"],
              f"bytes written {written} against a payload of {nbytes}")
        resumed = compile_for_training(cfg, strategy_dir)
        reset_launches()
        stall1 = registry_obs("fit/ckpt_save_stall_s")
        t0 = time.perf_counter()
        resumed.fit(x, y, epochs=2 * n, verbose=False, checkpoint_dir=d,
                    resume=True)
        resume_fit_s = time.perf_counter() - t0
        launches = read_launches()
        graph = resumed.executor.step_graphs["train_step"]
        restore_s = reg.get("fit/ckpt_restore_s")
        goodput = reg.get("fit/goodput_effective")
        final_stalls = obs_since("fit/ckpt_save_stall_s", stall1)
        got_bits, _ = state_bits(resumed)
        differ = bits_differ(ref_bits, got_bits)
        del got_bits
        # a snapshot once its pinned host buffers are cached, as every
        # save after a process's first finds them
        snap_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            snap = snapshot(resumed)
            snap_ms.append((time.perf_counter() - t0) * 1e3)
            del snap
        print(f"[ckpt] (a) resumed at step {step}: losses "
              + ", ".join(repr(v) for v in resumed.epoch_losses)
              + f"; leaves differing from the uninterrupted run: "
              f"{len(differ)} of {leaves} {differ[:5]}; launches {launches}; "
              f"train_step captures {graph.captures}, replays "
              f"{graph.replays}")
        check(resumed.epoch_losses == ref_losses[n:],
              "the resumed losses differ from the uninterrupted run's")
        check(not differ, f"resumed leaves differ: {differ[:8]}")
        want = dict(flash_attn_fwd=cfg.num_layers * n,
                    flash_attn_bwd=cfg.num_layers * n, fused_adam=n,
                    flash_lse_fwd=0, flash_lse_bwd=0)
        check(launches == want, f"resumed launches {launches}, expected "
                                f"{want}")
        check(graph.captures == 1 and graph.replays == n - 1,
              "the resumed steps were not one capture and then replays")
        replay_launches = graph.launches_a_replay()
        check(replay_launches.get("flash_fwd.launches") == cfg.num_layers
              and replay_launches.get("flash_bwd.launches") == cfg.num_layers
              and replay_launches.get("fused_adam_multi.launches") == 1,
              f"a resumed replay's kernel nodes: {replay_launches}")
        # where a save's and a restore's time goes: the writer's CRC pass
        # over the payload, one read of the shards file, and the restore
        # with and without its CRC checks
        snap = snapshot(resumed)
        t0 = time.perf_counter()
        for entries in snap.shards.values():
            for _, arr in entries:
                mf.crc32_bytes(arr.tobytes())
        crc_s = time.perf_counter() - t0
        del snap
        t0 = time.perf_counter()
        with open(os.path.join(latest_complete(d)[1], mf.shards_name(0)),
                  "rb") as f:
            while f.read(1 << 26):
                pass
        read_s = time.perf_counter() - t0
        load_s = []
        for verify in (False, True):
            t0 = time.perf_counter()
            load_sharded(d, resumed, verify=verify)
            torch.cuda.synchronize()
            load_s.append(time.perf_counter() - t0)
        print(f"[ckpt] breakdown: a CRC32 pass over the payload "
              f"{crc_s:.3f} s; one read of the shards file {read_s:.3f} s; "
              f"load_sharded {load_s[0]:.3f} s without CRC checks, "
              f"{load_s[1]:.3f} s with them")
        del resumed
        release()
        steady = statistics.median(step_s[2:])
        stall_ms = stall_sum / max(stalls, 1) * 1e3
        write_s = write_sum / max(writes, 1)
        print(f"[ckpt] save at step {n}: {nbytes} bytes written, snapshot "
              f"stall {stall_ms:.3f} ms ({stall_ms / (steady * 1e3):.2f} "
              f"replayed steps of {steady * 1e3:.3f} ms, p50 of steps "
              f"3-{2 * n}), async write {write_s:.3f} s "
              f"({nbytes / write_s / 1e9:.3f} GB/s); the resumed fit's "
              f"final save stalled {final_stalls[1] * 1e3:.3f} ms; two "
              f"snapshots after it {snap_ms[0]:.3f} and {snap_ms[1]:.3f} ms "
              f"({nbytes / snap_ms[1] / 1e6:.3f} GB/s device to host); "
              f"restore "
              f"{restore_s:.3f} s; resumed fit {resume_fit_s:.3f} s; "
              f"goodput_effective {goodput:.6f}")
        out["a"] = dict(bytes=nbytes, leaves=leaves, params=n_params,
                        stall_ms=stall_ms, step_ms=steady * 1e3,
                        snapshot_ms=snap_ms,
                        write_s=write_s, write_gbps=nbytes / write_s / 1e9,
                        restore_s=restore_s, goodput=goodput,
                        crc_s=crc_s, read_s=read_s, load_s=load_s,
                        launches=launches)

        # (b) ``supervise`` over a child preempted by SIGTERM: its grace
        # checkpoint, then the restart with --resume continuing it
        d2 = os.path.join(root, "b")
        os.makedirs(d2)
        k = CKPT_SIGTERM_SLOT
        state_path = os.path.join(d2, mf.SUPERVISOR_NAME)
        cmd = ["timeout", "-k", "10", str(CKPT_CHILD_TIMEOUT_S),
               sys.executable, os.path.abspath(__file__), "--ckpt-child",
               d2, strategy_dir, str(2 * n)]
        os.environ["FFS_FAULT"] = f"sigterm:0@step:{k}"
        t0 = time.perf_counter()
        try:
            rc = supervise_cli.main(["--max-restarts", "2", "--backoff-base",
                                     "0.5", "--state", state_path, "--"]
                                    + cmd)
        finally:
            del os.environ["FFS_FAULT"]
        sup_s = time.perf_counter() - t0
        with open(state_path) as f:
            history = json.load(f)["history"]
        print(f"[ckpt] (b) supervise: exit {rc} in {sup_s:.1f} s; attempts "
              + ", ".join(f"{h['outcome']}({h['code']}, "
                          f"{h['duration_s']:.1f} s)" for h in history))
        check(rc == 0 and [h["code"] for h in history]
              == [PREEMPTED_EXIT, 0], f"supervise: {history}")
        first_out, second = (json.load(open(ckpt_child_record(d2, r)))
                             for r in (False, True))
        print(f"[ckpt] (b) preempted child: {first_out}")
        print(f"[ckpt] (b) resuming child: {second}")
        steps = [(s_, ok) for s_, _, ok in list_steps(d2)]
        grace = [sd for s_, sd, ok in list_steps(d2) if s_ == k + 1 and ok]
        rep = verify_step_dir(grace[0]) if grace else {
            "complete": False, "errors": ["none"]}
        check(rep["complete"],
              f"grace checkpoint: steps {steps}, {rep['errors']}")
        # one batch an epoch: the preempted slot's epoch reads no loss
        check(first_out["losses"] == ref_losses[:k]
              and first_out["iteration"] == k + 1,
              "the preempted child's losses differ from (a)'s")
        check(second["losses"] == ref_losses[k + 1:],
              "the resumed child's losses differ from the uninterrupted "
              "run's")
        check(all(second["prebuilt"].values()),
              f"the second child rebuilt kernels: {second['prebuilt']}")
        rest = 2 * n - (k + 1)
        check(second["launches"]["fused_adam"] == rest
              and second["launches"]["flash_attn_fwd"] ==
              cfg.num_layers * rest,
              f"the resumed child's launches: {second['launches']}")
        rc, text = quiet(inspect_cli.main, [d2])
        for line in text.splitlines():
            print(f"[ckpt] (b) ckpt_inspect: {line}")
        check(rc == 0, f"ckpt_inspect exited {rc}")
        out["b"] = dict(exit=PREEMPTED_EXIT, grace_step=k + 1,
                        child_s=[h["duration_s"] for h in history],
                        supervise=[h["code"] for h in history])

        # (c) deploy (a)'s checkpoint
        manifest = load_manifest(d)
        trained = compile_for_training(cfg, strategy_dir)
        t0 = time.perf_counter()
        it = trained.load_checkpoint(d)
        load_s = time.perf_counter() - t0
        want_rows = trained.predict(x)
        del trained
        release()
        reset_launches()
        t0 = time.perf_counter()
        served = load_for_serving(
            d, create_transformer(cfg, FFConfig(batch_size=cfg.batch_size),
                                  device="cuda"), search_budget=0)
        deploy_s = time.perf_counter() - t0
        rows = served.predict(x)
        k1 = read_launches()["flash_attn_fwd"]
        engine = served.serve()
        reqs = [engine.submit([x[i]]) for i in range(cfg.batch_size)]
        check(engine.pump() == cfg.batch_size, "the engine served no batch")
        served_rows = np.stack([r.wait(60) for r in reqs])
        info = served.serve_load_info
        print(f"[ckpt] (c) load_for_serving of step {manifest['step']} "
              f"(iteration {it}) in {deploy_s:.3f} s (load_checkpoint into "
              f"a training model {load_s:.3f} s): mode {info['mode']}, "
              f"cross mesh {info['cross_mesh']}; predict equal to the "
              f"training model's: {np.array_equal(rows, want_rows)}; served "
              f"rows equal: {np.array_equal(served_rows, rows)}; K1 "
              f"launches in predict {k1}")
        check(info["mode"] == "reused-saved-strategy"
              and manifest["step"] == 2 * n, f"deploy: {info}")
        check(np.array_equal(rows, want_rows),
              "the deployed predict differs from the training model's")
        check(np.array_equal(served_rows, rows),
              "the served rows differ from predict")
        check(k1 == cfg.num_layers, f"K1 launched {k1} times in predict")
        del served, engine
        release()
        out["c"] = dict(deploy_s=deploy_s, load_s=load_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["zoo"] = {name: ckpt_zoo_resume(name, strategy_dir)
                  for name in ("resnet_bn", "alexnet")}
    return out


def ckpt_zoo_resume(name, strategy_dir):
    """[ckpt zoo] ``name`` (D) at its default width: CKPT_ZOO_STEPS
    uninterrupted steps against a run saved every CKPT_ZOO_EVERY steps and
    a fresh model resumed, bit for bit (losses, parameters, moments, BN
    running statistics; AlexNet's dropout masks from the restored
    generator), cuDNN deterministic."""
    import torch

    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix=f"ff_ckpt_{name}_")
    try:
        _, cfg, _, _ = zoo_spec(name)
        xs, y = zoo_batch(name, cfg)
        ref = compile_zoo(name, "D", strategy_dir)
        ref.fit(xs, y, epochs=CKPT_ZOO_STEPS, verbose=False)
        ref_losses = list(ref.epoch_losses)
        ref_bits, nbytes = state_bits(ref)
        ref_generator = ref._generator.get_state()
        del ref
        release()
        first = compile_zoo(name, "D", strategy_dir)
        first.fit(xs, y, epochs=CKPT_ZOO_EVERY, verbose=False,
                  checkpoint_dir=root, checkpoint_every=CKPT_ZOO_EVERY)
        del first
        release()
        resumed = compile_zoo(name, "D", strategy_dir)
        t0 = time.perf_counter()
        resumed.fit(xs, y, epochs=CKPT_ZOO_STEPS, verbose=False,
                    checkpoint_dir=root, resume=True)
        secs = time.perf_counter() - t0
        got_bits, _ = state_bits(resumed)
        differ = bits_differ(ref_bits, got_bits)
        losses = list(resumed.epoch_losses)
        generator_equal = torch.equal(resumed._generator.get_state(),
                                      ref_generator)
        op_state = sorted(k for k in ref_bits if k.startswith("op_state/"))
        del resumed
        release()
        print(f"[ckpt zoo {name}] {nbytes} bytes a checkpoint, "
              f"{len(ref_bits)} leaves ({len(op_state)} of op state); "
              f"resumed at step {CKPT_ZOO_EVERY}, fit of "
              f"{CKPT_ZOO_STEPS - CKPT_ZOO_EVERY} steps {secs:.2f} s; "
              f"uninterrupted losses {ref_losses}, resumed {losses}; leaves "
              f"differing: {len(differ)} {differ[:5]}; generator state "
              f"equal: {generator_equal}")
        check(losses == ref_losses[CKPT_ZOO_EVERY:],
              f"{name}: the resumed losses differ from the uninterrupted "
              f"run's")
        check(not differ, f"{name}: resumed leaves differ: {differ[:8]}")
        check(generator_equal, f"{name}: the generator's state differs")
        check(name != "resnet_bn" or len(op_state) == 2 * BN_PAIRS,
              f"{name}: {len(op_state)} BN statistics leaves in the "
              f"checkpoint")
        return dict(bytes=nbytes, leaves=len(ref_bits),
                    op_state_leaves=len(op_state))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags


OBS_WINDOW = "2:4"
OBS_STEPS = 6
OBS_PAIRS = 5
OBS_TIMED = 5
# devtrace's busy share against this script's reading of the same
# profiler session's in-memory record, in share points
OBS_BUSY_POINTS = 0.5
# compute + host + idle against the step's window
OBS_SUM_RTOL = 0.01
OBS_ARTIFACTS = ("trace.json", "events.jsonl", "summary.json", "drift.json",
                 "devtrace.json", "counters.json")


def obs_header(path):
    """An artifact's header (the JSONL stream's first line)."""
    with open(path) as f:
        if path.endswith(".jsonl"):
            return json.loads(f.readline())
        data = json.load(f)
    return data.get("metadata") or data.get("header")


def session_busy_share(prof, steps):
    """The device's busy share of the given steps, read from the
    profiler session's in-memory record (``prof.events()``), not from the
    Chrome trace that ``obs/`` exports and parses: the union of the device
    events (``device_events``) inside each step's host annotation
    ``ff_step#<step>``, over the annotations' total time. A device-side
    copy of an annotation is no device work, and is left out."""
    from torch.autograd import DeviceType

    windows = {int(e.name.split("#")[1]): (e.time_range.start,
                                           e.time_range.end)
               for e in prof.events() if e.device_type == DeviceType.CPU
               and e.name.startswith("ff_step#")}
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(prof)
                   if not e.name.startswith("ff_step#"))
    busy = wall = 0.0
    for step in steps:
        t0, t1 = windows[step]
        wall += t1 - t0
        end = t0
        for a, b in spans:
            a, b = max(a, end), min(b, t1)
            if b > a:
                busy += b - a
                end = b
    return busy / wall


def phase_obs(strategy_dir, analytic_predicted_s, trace_root=None):
    """[obs] measurement and tracing at full width (``obs/``,
    ``search/profile.py``): (a) a search on per-op times measured on the
    card, (b) a traced ``fit`` through train (b)'s strategy file with a
    device-trace window, (c) the cost of tracing, (d) the roofline and
    ``--profiling``. Returns the launches of (a)'s measurement and of
    (b)'s traced steps, and (b)'s trace dir (``trace_root/obs_trace``,
    kept when ``trace_root`` is given, for [costmodel]'s
    ``--ingest-drift``)."""
    import glob

    import numpy as np
    import torch
    from flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from flexflow_tpu_torch.layout import propagate_layouts
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.obs.registry import percentile
    from flexflow_tpu_torch.obs.roofline import (format_markdown,
                                                 roofline_report)
    from flexflow_tpu_torch.optimizers import AdamOptimizer
    from flexflow_tpu_torch.search import profile

    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    cfg = TransformerConfig()
    x, y = training_batch(cfg)
    out = {}

    def build(argv):
        fcfg = FFConfig(batch_size=cfg.batch_size)
        check(fcfg.parse_args(argv) == [], f"unread flags in {argv}")
        ff = create_transformer(cfg, fcfg, device="cuda")
        ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [MetricsType.MEAN_SQUARED_ERROR])
        return ff

    with tempfile.TemporaryDirectory(prefix="ff_obs_") as tmp:
        # ---- (a) a search on measured costs ------------------------------
        cache = os.path.join(tmp, "measured.json")
        argv = ["--budget", str(SEARCH_BUDGET), "--search-measure-ops",
                "--measured-cache", cache]
        profile._CACHE.clear()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        ff = build(argv)
        cold_s = time.perf_counter() - t0
        measure = read_launches()
        cold_search_s = ff.search_info["search_wall_s"]
        nodes, _, _ = ff._materialize_nodes()
        propagate_layouts(nodes, mode=ff.config.conv_compute_layout,
                          on_accelerator=True)
        table = profile.microbenchmark(nodes, machine_spec=ff.machine_spec,
                                       device=ff.device,
                                       dtype=ff.executor.compute_dtype)
        by_key = {}
        for n in nodes:
            key = profile.op_cost_key(n.op, ff.device, profile.node_layout(n),
                                      ff.executor.compute_dtype)
            by_key.setdefault(key, []).append(n)
        print(f"[obs] (a) per-op times on the card ({card}; CUDA-graph "
              f"slope timing, operands rotated past L2, bf16): "
              f"{len(by_key)} distinct ops of {len(nodes)}")
        for key, group in by_key.items():
            op = group[0].op
            # the row of the core that runs the op (attention: flash)
            impl = profile.executed_impl(ff, op)
            f_s, b_s = profile.executed_rows(table, op.guid, impl)
            if f_s is not None:
                core = f"  [{impl}]" if impl else ""
                print(f"[obs]   {key} {op.op_type.name:20s} x{len(group):2d} "
                      f"({op.name}...): fwd {f_s * 1e6:9.2f} us  bwd "
                      f"{b_s * 1e6:9.2f} us{core}")
        print(f"[obs]   __step_overhead__ {table['__step_overhead__'] * 1e6:.3f}"
              f" us, __update_bw__ {table['__update_bw__'] / 1e9:.1f} GB/s")
        skipped = [n.op.name for n in nodes
                   if f"{n.op.guid}:fwd" not in table]
        print(f"[obs]   {len(nodes) - len(skipped)} of {len(nodes)} nodes "
              f"measured; skipped {skipped}")
        check(not skipped, f"the measurement skipped {skipped}; the JAX "
              f"package skips none of this graph")
        print(f"[obs]   launches during the measured compile: {measure}")
        check(measure["flash_attn_fwd"] > 0 and measure["flash_attn_bwd"] > 0
              and measure["flash_lse_fwd"] == measure["flash_lse_bwd"] == 0,
              "the attention measurement did not run K1 and K2")
        out["measure"] = measure
        predicted = ff.search_info["predicted_time"]
        choices = sorted({st.choice for st in ff.strategy.values()})
        del ff
        torch.cuda.empty_cache()
        profile._CACHE.clear()  # the warm run reads the cache file only
        reset_launches()
        t0 = time.perf_counter()
        ff = build(argv)
        warm_s = time.perf_counter() - t0
        warm = read_launches()
        print(f"[obs]   compile with the measurement {cold_s:.2f} s (search "
              f"{cold_search_s:.3f} s); again with the warm cache file "
              f"{warm_s:.2f} s (search {ff.search_info['search_wall_s']:.3f}"
              f" s, launches {warm})")
        check(not any(warm.values()), "a warm cache file measured again")
        check(ff.search_info["predicted_time"] == predicted,
              "the warm cache priced another prediction")
        for _ in range(TRAIN_WARMUP):
            ff.fit(x, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
        step_s = []
        for _ in range(OBS_TIMED):
            t0 = time.perf_counter()
            ff.fit(x, y, epochs=1, verbose=False)
            step_s.append(time.perf_counter() - t0)
        p50 = statistics.median(step_s)
        losses = ff.epoch_losses
        check(all(np.isfinite(losses)), "non-finite loss on measured costs")
        print(f"[obs]   strategy on measured costs: choices {choices}; step "
              f"p50 {p50 * 1e3:.3f} ms against its predicted "
              f"{predicted * 1e3:.3f} ms (measured / predicted "
              f"{p50 / predicted:.2f}) and the analytic search's "
              f"{analytic_predicted_s * 1e3:.3f} ms (measured / predicted "
              f"{p50 / analytic_predicted_s:.2f}); {card}")
        out["measured_search"] = dict(predicted_s=predicted, step_p50_s=p50,
                                      analytic_predicted_s=analytic_predicted_s)

        # ---- (d) roofline and --profiling ----------------------------------
        rep = roofline_report(nodes, ff.machine_spec, device=ff.device,
                              dtype=ff.executor.compute_dtype,
                              include_bwd=False)
        print("[obs] (d) roofline of the BERT-proxy's ops (forward, bf16 "
              f"bytes, {card}):")
        for line in format_markdown(rep, top=8).splitlines():
            print(f"[obs]   {line}")
        over = [r["name"] for r in rep["rows"] if r.get("over_bound")]
        check(not over, f"roofline shares over 100%: {over}")
        worst = max(r["bound_share"] for r in rep["rows"] if "fwd_s" in r)
        print(f"[obs]   the highest share of its bound: {worst:.3f}")
        del ff
        torch.cuda.empty_cache()
        prof = build(["--profiling"])
        print(f"[obs]   --profiling's per-op table ({len(prof.op_profile)} "
              f"entries; the RecursiveLogger's lines are on stderr):")
        for n in prof.executor.nodes[:8]:
            impl = profile.executed_impl(prof, n.op)
            f_s, b_s = profile.executed_rows(prof.op_profile, n.guid, impl)
            print(f"[obs]     {n.op.name}: fwd {f_s * 1e6:.2f} us, bwd "
                  f"{b_s * 1e6:.2f} us" + (f"  [{impl}]" if impl else ""))
        check(all(f"{n.guid}:fwd" in prof.op_profile
                  for n in prof.executor.nodes), "--profiling missed an op")
        del prof
        torch.cuda.empty_cache()

        # ---- (b) a traced fit ---------------------------------------------
        ff = compile_for_training(cfg, strategy_dir)
        xs = np.concatenate([training_batch(cfg, seed=i)[0]
                             for i in range(OBS_STEPS)])
        ys = np.concatenate([training_batch(cfg, seed=i)[1]
                             for i in range(OBS_STEPS)])
        td = os.path.join(trace_root or tmp, "obs_trace")
        out["trace_dir"] = td
        # keep the fit's capture: its profiler session's in-memory record
        # is the independent reader of the busy share below
        captures = []
        make_capture = ff._make_capture

        def keep_capture(tracer, profile_steps):
            captures.append(make_capture(tracer, profile_steps))
            return captures[-1]

        ff._make_capture = keep_capture
        reset_launches()
        ff.fit(xs, ys, epochs=1, verbose=False, trace_dir=td,
               profile_steps=OBS_WINDOW)
        launches = read_launches()
        del ff._make_capture
        paths = {}
        for suffix in OBS_ARTIFACTS:
            found = glob.glob(os.path.join(td, f"fit_*.{suffix}"))
            check(len(found) == 1, f"artifact *.{suffix}: {found}")
            head = obs_header(found[0])
            check(head["platform"] == "gpu" and head["device"] == name,
                  f"{suffix}: header {head}")
            paths[suffix] = found[0]
        # a dp_k:fused strategy file has no simulated schedule: the core
        # has no _k:fused twin on one device (ROADMAP.md Queue 3)
        print(f"[obs] (b) traced fit of {OBS_STEPS} steps, window "
              f"{OBS_WINDOW}: {sorted(os.listdir(td))}; every header names "
              f"{name}; simtrace written: "
              f"{bool(glob.glob(os.path.join(td, '*.simtrace.json')))}")
        dv = json.load(open(paths["devtrace.json"]))
        check(dv["device_events"] > 0 and dv["steps"] == 2
              and not dv["refused_steps"],
              f"devtrace: {dv['device_events']} events, {dv['steps']} steps,"
              f" refused {dv['refused_steps']}")
        check(all(v % OBS_STEPS == 0 for v in launches.values()),
              f"launches over {OBS_STEPS} steps: {launches}")
        per_step = {k: v // OBS_STEPS for k, v in launches.items()}
        for row in dv["per_step"]:
            parts = row["compute_s"] + row["host_s"] + row["idle_s"]
            print(f"[obs]   step {row['step']}: window "
                  f"{row['wall_s'] * 1e3:.3f} ms = compute "
                  f"{row['compute_s'] * 1e3:.3f} + host "
                  f"{row['host_s'] * 1e3:.3f} + idle "
                  f"{row['idle_s'] * 1e3:.3f} ms (sum {parts * 1e3:.3f});"
                  f" by label "
                  + ", ".join(f"{k} {v['time_s'] * 1e3:.3f} ms/{v['count']}"
                              for k, v in sorted(row["per_label"].items()))
                  + f"; launches {row['launches']}; launch calls in "
                  f"its window and the device events linked to them "
                  f"{dv['launch_calls'].get(str(row['step']))}")
            check(abs(parts - row["wall_s"]) <= OBS_SUM_RTOL * row["wall_s"],
                  f"step {row['step']}: the buckets do not sum to its window")
            for lab in ("flash_attn_fwd", "flash_attn_bwd", "fused_adam"):
                check(row["per_label"].get(lab, {}).get("time_s", 0) > 0,
                      f"step {row['step']}: no {lab} device time")
            want = {k: per_step[COUNTER_KEYS[k]] for k in COUNTER_KEYS}
            check(row["launches"] == want,
                  f"step {row['step']}: devtrace launches {row['launches']} "
                  f"against the counters' {want} a step")
        tot = dv["totals"]
        busy = tot["busy_s"] / tot["wall_s"]
        trace = json.load(open(paths["trace.json"]))
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                 if e.get("name") == "step" and e.get("ph") == "X"]
        lanes = [e for e in trace["traceEvents"]
                 if e.get("cat") == "devtrace" and e.get("ph") == "X"]
        outside = [e["name"][:60] for e in lanes
                   if not any(a - 1e3 <= e["ts"] + e["dur"] / 2 <= b + 1e3
                              for a, b in spans)]
        print(f"[obs]   {len(lanes)} device lane events rebased by "
              f"{dv['clock_shift_us']:.1f} us; outside every step: "
              f"{len(outside)}; linked to their launch: "
              f"{dv['launch_linked']} of {dv['device_events']}, of them "
              f"{dv['moved_by_launch']} starting outside the window of the "
              f"step that launched them; least start after launch "
              f"{dv['launch_to_start_min_us']} us")
        check(lanes and not outside, f"device lanes outside their steps: "
              f"{outside[:3]}")
        drift = json.load(open(paths["drift.json"]))
        mem = json.load(open(paths["summary.json"]))["memory"]
        sm = drift["step_metrics"]
        print(f"[obs]   MFU {sm['mfu']:.4f} of {sm['mfu_peak_flops']:.3e} "
              f"FLOP/s (the bf16 dense peak; {card}) at step p50 "
              f"{sm['step_time_p50'] * 1e3:.3f} ms, goodput "
              f"{sm['goodput']:.3f}; predicted "
              f"{drift['predicted']['total_s'] * 1e3:.3f} ms (ratio "
              f"{drift['ratio']:.3f}); this run's peak allocated over its "
              f"replayed steps {mem['peak_bytes'] / 2**30:.3f} GiB, "
              f"footprint with the graph pool that holds a replay's "
              f"activations {mem['footprint_bytes'] / 2**30:.3f} GiB "
              f"(arguments {mem['argument_bytes'] / 2**30:.3f} GiB, temp "
              f"{mem['temp_bytes'] / 2**30:.3f} GiB, graph pool "
              f"{mem['graph_pool_bytes'] / 2**30:.3f} GiB)")
        check(mem["peak_bytes"] > mem["argument_bytes"] > 0
              and mem["footprint_bytes"] > mem["argument_bytes"]
              and mem["graph_pool_bytes"] > 0, f"summary memory {mem}")
        # the independent reader, on the same replayed steps: the
        # profiler session's in-memory events, not the exported trace
        check(len(captures) == 1 and captures[0].session is not None,
              "the traced fit kept no profiler session")
        same = session_busy_share(captures[0].session,
                                  [r["step"] for r in dv["per_step"]])
        del captures
        # and profile_steps over two other replays (untraced fit calls,
        # whose host pace moves between runs), printed only
        x1, y1 = training_batch(cfg)
        kinds = profile_train(ff, x1, y1,
                              label="[obs] two untraced fit calls")
        check(kinds is not None, "the profiler recorded no kernel")
        other = sum(kinds[0].values()) / kinds[2]
        print(f"[obs]   busy share of the window's steps: devtrace "
              f"{100 * busy:.3f}%, the profiler session's in-memory record "
              f"of the same steps {100 * same:.3f}%; profile_steps over two "
              f"untraced fit calls {100 * other:.1f}% ({card})")
        check(abs(busy - same) * 100 <= OBS_BUSY_POINTS,
              f"busy shares differ by more than {OBS_BUSY_POINTS} points")
        out["traced"] = dict(launches=launches,
                             devtrace_launches=dv["launches"], busy=busy,
                             session_busy=same, profile_busy=other,
                             mfu=sm["mfu"])

        # ---- (c) the cost of tracing ---------------------------------------
        pairs = os.path.join(tmp, "pairs")
        before = sorted(os.listdir("."))
        plain, traced = [], []
        for i in range(OBS_PAIRS):
            thr = ff.fit(xs, ys, epochs=1, verbose=False)
            plain.append(cfg.batch_size / thr)
            thr = ff.fit(xs, ys, epochs=1, verbose=False, trace_dir=pairs)
            traced.append(cfg.batch_size / thr)
        check(sorted(os.listdir(".")) == before,
              "a fit without trace_dir wrote a file")
        written = glob.glob(os.path.join(pairs, "fit_*.trace.json"))
        check(len(written) == OBS_PAIRS, f"{len(written)} traced runs")
        print(f"[obs] (c) {OBS_PAIRS} pairs of {OBS_STEPS}-step fits in "
              f"turns (the loop's own seconds a step): untraced p50 "
              f"{statistics.median(plain) * 1e3:.3f} ms, traced p50 "
              f"{statistics.median(traced) * 1e3:.3f} ms "
              f"(p90 {percentile(sorted(plain), 0.9) * 1e3:.3f} / "
              f"{percentile(sorted(traced), 0.9) * 1e3:.3f} ms); {card}")
        out["pairs"] = dict(plain=plain, traced=traced)
        del ff
        torch.cuda.empty_cache()
    return out


# [costmodel]: the corpus fits' model (the BERT-proxy's width, 2 layers)
# at distinct (batch, seq) shapes, the full-width shape (batch 8, seq 512)
# held out of the corpus
# one layer: the corpus dedups rows by (class, shape, choice), so equal
# layers add no row; a second layer only added time
COSTMODEL_LAYERS = 1
COSTMODEL_SHAPES = [(b, s) for b in (2, 4, 8, 16) for s in (128, 256)]
COSTMODEL_HELD_OUT = (8, 512)
COSTMODEL_STEPS = 3
# the classes the corpus must train past MIN_CLASS_ROWS: attention's two
# cores both, so that the search weighs learned against learned
COSTMODEL_CLASSES = ("LINEAR", "LAYERNORM", "MULTIHEAD_ATTENTION:flash",
                     "MULTIHEAD_ATTENTION")
# the memory-capped compile's threshold, in MiB: at least this, and at
# least twice the uncapped prediction times the correction, so that the
# divided threshold stays feasible
COSTMODEL_MEMORY_MB = 16384
def phase_costmodel(obs_trace_dir):
    """[costmodel] measure, learn, search, calibrate (``costmodel/``,
    ``flexflow_tpu_torch/scripts``). (a) Traced ``fit``s of the
    BERT-proxy's width at COSTMODEL_LAYERS layers over COSTMODEL_SHAPES,
    each compiled with the search on measured ops and ``--profiling``, so
    that their simtrace rows carry per-op times taken on the card; K1 and
    K2 counted. (b) ``costmodel train`` on those dirs: a "gpu" model whose
    COSTMODEL_CLASSES pass MIN_CLASS_ROWS, the full-width shape held out.
    (c) The full-width search under that model (``FFS_COSTMODEL_FILE``):
    "learned", its prediction beside the analytic and the measured-profile
    ones of the same graph; a traced fit of its strategy (learned sources
    and the analytic twin in its simtrace, K1/K2 against the counters),
    ``costmodel report`` and ``obs_report`` on it. (d) ``calibrate`` (the
    full set) into a temporary ``FFS_CALIBRATION_FILE``, then
    ``--ingest-drift`` of [obs]'s trace dir; the search's memory
    correction is the rows' median ``mem_ratio``; a memory-capped compile
    divides its threshold by it, beside the measured peak of 2 steps.
    Nothing is written into the tree. Returns the launches of (a) and
    (c)."""
    import gc
    import glob

    import numpy as np
    import torch
    from flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from flexflow_tpu_torch.costmodel import MIN_CLASS_ROWS, CostModel
    from flexflow_tpu_torch.costmodel import load_corpus
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.obs.inspect import step_footprint_bytes
    from flexflow_tpu_torch.optimizers import AdamOptimizer
    from flexflow_tpu_torch.scripts import calibrate as calibrate_cli
    from flexflow_tpu_torch.scripts import costmodel as costmodel_cli
    from flexflow_tpu_torch.scripts import obs_report as obs_report_cli
    from flexflow_tpu_torch.search import native, profile, unity

    card = nvidia_smi_line()
    root = os.path.dirname(os.path.abspath(__file__))
    tree_before = sorted(os.listdir(root))
    env_keys = ("FFS_COSTMODEL_FILE", "FFS_NO_LEARNED_COSTS",
                "FFS_CALIBRATION_FILE", "FFS_FAULT")
    env_before = {k: os.environ.get(k) for k in env_keys}
    for k in env_keys:
        os.environ.pop(k, None)
    out = {}

    def build(cfg, argv):
        fcfg = FFConfig(batch_size=cfg.batch_size)
        check(fcfg.parse_args(argv) == [], f"unread flags in {argv}")
        ff = create_transformer(cfg, fcfg, device="cuda")
        ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [MetricsType.MEAN_SQUARED_ERROR])
        return ff

    def n_flash(ff):
        return sum(1 for v in unity.executed_kernel_choices(
            ff.executor.nodes, ff.strategy, ff.mesh.shape, training=True,
            device=ff.device).values() if v == "flash")

    def one(pattern):
        found = glob.glob(pattern)
        check(len(found) == 1, f"{pattern}: {found}")
        with open(found[0]) as f:
            return json.load(f)

    try:
        with tempfile.TemporaryDirectory(prefix="ff_costmodel_") as tmp:
            # ---- (a) the corpus ---------------------------------------------
            cache = os.path.join(tmp, "measured.json")
            profile._CACHE.clear()
            dirs = []
            corpus_launches = dict.fromkeys(("flash_attn_fwd",
                                             "flash_attn_bwd"), 0)
            print(f"[costmodel] (a) corpus: traced fits of the BERT-proxy's "
                  f"width at {COSTMODEL_LAYERS} layers, compiled with "
                  f"--search-measure-ops and --profiling (per-op times on "
                  f"the card; {card})")
            t0 = time.perf_counter()
            fits = [(b, s, core) for b, s in COSTMODEL_SHAPES
                    for core in ("searched", "einsum")]
            for batch, seq, core in fits:
                cfg = TransformerConfig(num_layers=COSTMODEL_LAYERS,
                                        seq_length=seq, batch_size=batch)
                if core == "searched":
                    # the search on measured ops (it gives attention
                    # _k:flash on the card)
                    ff = build(cfg, ["--budget", str(SEARCH_BUDGET),
                                     "--search-measure-ops",
                                     "--measured-cache", cache,
                                     "--profiling"])
                else:
                    # the einsum core's rows: attention pinned by a
                    # strategy file, so that the table prices both cores
                    path = os.path.join(tmp, f"einsum_b{batch}_s{seq}.json")
                    shell = create_transformer(cfg, FFConfig(
                        batch_size=batch), device="cuda")
                    write_strategy(shell, path, lambda kind: (
                        "rep_k:einsum" if kind.name == "MULTIHEAD_ATTENTION"
                        else "rep"))
                    del shell
                    ff = build(cfg, ["--import-strategy", path,
                                     "--profiling"])
                x, y = training_batch(cfg)
                d = os.path.join(tmp, f"corpus_b{batch}_s{seq}_{core}")
                flash = n_flash(ff)
                reset_launches()
                ff.fit(x, y, epochs=COSTMODEL_STEPS, verbose=False,
                       trace_dir=d)
                got = read_launches()
                sim = one(os.path.join(d, "fit_*.simtrace.json"))
                rows = sim["per_op"]
                measured = sum(1 for r in rows
                               if (r.get("measured") or {}).get("source")
                               == "measured")
                impls = sorted({f"{r['type']}:{r.get('impl')}" for r in rows
                                if r.get("impl")})
                print(f"[costmodel]   batch {batch:2d} S {seq} {core}: "
                      f"{len(rows)} "
                      f"rows, {measured} measured, impls {impls}; choices "
                      f"{sorted({st.choice for st in ff.strategy.values()})};"
                      f" launches over {COSTMODEL_STEPS} steps K1 "
                      f"{got['flash_attn_fwd']} K2 {got['flash_attn_bwd']} "
                      f"({flash} flash attentions)")
                check(sim["header"]["platform"] == "gpu",
                      f"simtrace platform {sim['header']['platform']}")
                check(measured == len(rows) and rows,
                      f"{len(rows) - measured} rows without a measurement")
                check(flash == (COSTMODEL_LAYERS if core == "searched"
                                else 0)
                      and got["flash_attn_fwd"] == got["flash_attn_bwd"]
                      == flash * COSTMODEL_STEPS,
                      f"the corpus fit's launches {got} against {flash} "
                      f"flash attentions x {COSTMODEL_STEPS} steps")
                for k in corpus_launches:
                    corpus_launches[k] += got[k]
                dirs.append(d)
                del ff
                torch.cuda.empty_cache()
            out["corpus_launches"] = corpus_launches
            print(f"[costmodel] (a) {len(fits)} fits in "
                  f"{time.perf_counter() - t0:.1f} s; K1 / K2 launches "
                  f"{corpus_launches}")

            # ---- (b) train --------------------------------------------------
            corpus_path = os.path.join(tmp, "COSTMODEL_CORPUS_GPU.json")
            model_path = os.path.join(tmp, "COSTMODEL_GPU.json")
            argv = ["train", "--corpus", corpus_path, "--out", model_path]
            for d in dirs:
                argv += ["--trace-dir", d]
            rc, text = quiet(costmodel_cli.main, argv)
            for line in text.splitlines():
                print(f"[costmodel] (b) {line}")
            check(rc == 0, f"costmodel train exited {rc}")
            model = CostModel.load(model_path)
            corpus = load_corpus(corpus_path)
            held = [r["out_shape"] for r in corpus["rows"]
                    if list(r.get("out_shape") or [])[:2]
                    == list(COSTMODEL_HELD_OUT)]
            check(not held, f"the held-out shape is in the corpus: {held}")
            print(f"[costmodel] (b) model platform {model.platform}, "
                  f"{model.corpus_rows} rows; per class (corpus rows, train "
                  f"/ test, held-out error factor of the forward):")
            for name, n in sorted(corpus["classes"].items()):
                cm = model.classes.get(name)
                print(f"[costmodel]     {name:28s} {n:3d} rows: "
                      + (f"{cm.n_train} / {cm.n_test}, x{cm.err_factor:.4f}"
                         f" (backward x{math.exp(cm.err_bwd):.4f})"
                         if cm else f"below {MIN_CLASS_ROWS}: analytic"))
            check(model.platform == "gpu", f"model platform {model.platform}")
            missing = [c for c in COSTMODEL_CLASSES if c not in model.classes]
            check(not missing, f"classes under MIN_CLASS_ROWS: {missing}")
            out["model"] = {k: dict(n_train=v.n_train, n_test=v.n_test,
                                    err_factor=v.err_factor)
                            for k, v in model.classes.items()}

            # ---- (c) the full-width search on the learned table --------------
            os.environ["FFS_COSTMODEL_FILE"] = model_path
            cfg = TransformerConfig()
            ff = build(cfg, ["--budget", str(SEARCH_BUDGET)])
            info = ff.search_info
            check(info["cost_model"] == "learned",
                  f"the full-width search priced {info['cost_model']}")
            learned_s = info["predicted_time"]
            nodes, _, tensor_ref = ff._materialize_nodes()
            final = ff._select_final_ref(nodes, tensor_ref)
            os.environ["FFS_NO_LEARNED_COSTS"] = "1"
            _, _, an = unity.graph_optimize(
                nodes, ff.machine_spec, ff.config, 1, batch=cfg.batch_size,
                final_ref=final, device=ff.device)
            del os.environ["FFS_NO_LEARNED_COSTS"]
            check(an["cost_model"] == "analytic", "FFS_NO_LEARNED_COSTS "
                  "left the table on")
            table = profile.microbenchmark(nodes, machine_spec=ff.machine_spec,
                                           device=ff.device,
                                           dtype=ff.executor.compute_dtype,
                                           cache_file=cache)
            _, _, me = unity.graph_optimize(
                nodes, ff.machine_spec, ff.config, 1, batch=cfg.batch_size,
                final_ref=final, measured=table, device=ff.device)
            print(f"[costmodel] (c) full-width search under the model: cost "
                  f"model {info['cost_model']}, classes "
                  f"{info['learned_cost_classes']}; choices "
                  f"{sorted({st.choice for st in ff.strategy.values()})}; "
                  f"predicted step: learned {learned_s * 1e3:.3f} ms, "
                  f"analytic {an['predicted_time'] * 1e3:.3f} ms, measured "
                  f"profile {me['predicted_time'] * 1e3:.3f} ms ({card})")
            xs = np.concatenate([training_batch(cfg, seed=i)[0]
                                 for i in range(OBS_STEPS)])
            ys = np.concatenate([training_batch(cfg, seed=i)[1]
                                 for i in range(OBS_STEPS)])
            td = os.path.join(tmp, "learned")
            flash = n_flash(ff)
            fused = bool(ff.executor.fused_update_ops & set(ff.params))
            reset_launches()
            ff.fit(xs, ys, epochs=1, verbose=False, trace_dir=td)
            got = read_launches()
            want = dict(flash_attn_fwd=flash * OBS_STEPS,
                        flash_attn_bwd=flash * OBS_STEPS,
                        fused_adam=OBS_STEPS if fused else 0,
                        flash_lse_fwd=0, flash_lse_bwd=0)
            print(f"[costmodel] (c) traced fit of the searched strategy, "
                  f"{OBS_STEPS} steps: launches {got} (the counters; "
                  f"expected {want} from {flash} flash attentions)")
            check(got == want and flash == cfg.num_layers,
                  f"the learned strategy runs {flash} flash attentions of "
                  f"{cfg.num_layers}, or its launches differ from its "
                  f"kernel choices")
            out["learned_launches"] = got
            sim = one(os.path.join(td, "fit_*.simtrace.json"))
            drift = one(os.path.join(td, "fit_*.drift.json"))
            p50 = drift["step_metrics"]["step_time_p50"]
            twin = (sim.get("predicted_analytic") or {}).get("step_s")
            print(f"[costmodel] (c) simtrace: sources {sim['cost_sources']}; "
                  f"predicted {sim['predicted']['step_s'] * 1e3:.3f} ms, "
                  f"analytic twin "
                  f"{(twin or float('nan')) * 1e3:.3f} ms; measured p50 "
                  f"{p50 * 1e3:.3f} ms: measured / learned "
                  f"{p50 / learned_s:.3f}, / analytic "
                  f"{p50 / an['predicted_time']:.3f}, / measured profile "
                  f"{p50 / me['predicted_time']:.3f} ({card})")
            check(sim["cost_sources"].get("learned", 0) > 0 and twin,
                  "the simtrace carries no learned source or no analytic "
                  "twin")
            uncapped_mem = info["predicted_memory"]
            out["search"] = dict(learned_s=learned_s,
                                 analytic_s=an["predicted_time"],
                                 measured_profile_s=me["predicted_time"],
                                 simtrace_s=sim["predicted"]["step_s"],
                                 twin_s=twin, p50_s=p50)
            rc, text = quiet(costmodel_cli.main, [
                "report", "--model", model_path, "--corpus", corpus_path,
                "--trace-dir", td, "--json"])
            check(rc == 0, f"costmodel report exited {rc}")
            rep = json.loads(text)
            for k, e in rep["corpus_accuracy"].items():
                print(f"[costmodel] (c) report {k:24s} rows {e['rows']:3d}: "
                      f"learned x{e['learned_err_factor'] or float('nan'):.3f}"
                      f" ({e['learned_rows']}), analytic on those rows "
                      f"x{e['analytic_err_factor_matched'] or float('nan'):.3f}"
                      f", on all x{e['analytic_err_factor']:.3f}")
            for row in rep["step_accuracy"]:
                print(f"[costmodel] (c) report step accuracy {row}")
            check(len(rep["step_accuracy"]) == 1, "no step-accuracy row")
            obs_out = os.path.join(tmp, "OBS_REPORT.json")
            rc, _ = quiet(obs_report_cli.main, [td, "--out", obs_out])
            check(rc == 0, f"obs_report exited {rc}")
            with open(obs_out) as f:
                (run,) = json.load(f)["runs"]
            # the counters are the process's registry: its fit/step_time_s
            # p50 spans every fit of this process, not this run's steps
            print(f"[costmodel] (c) obs_report: the registry's fit p50 (every "
                  f"fit of the process) {run['step_time_p50_s'] * 1e3:.3f} "
                  f"ms, this run's {p50 * 1e3:.3f} ms (drift); sim "
                  f"{run['sim']}")
            del ff
            torch.cuda.empty_cache()

            print(f"[costmodel] (b)+(c) {time.perf_counter() - t0:.1f} s "
                  f"after (a)'s start")
            # ---- (d) calibrate -----------------------------------------------
            cal_path = os.path.join(tmp, "CALIBRATION_GPU.json")
            os.environ["FFS_CALIBRATION_FILE"] = cal_path
            t0 = time.perf_counter()
            rc, text = quiet(calibrate_cli.main, ["--device", "cuda"])
            for line in text.splitlines():
                print(f"[costmodel] (d) {line}")
            print(f"[costmodel] (d) calibrate exited {rc} in "
                  f"{time.perf_counter() - t0:.1f} s ({card})")
            check((rc == 0 and "calibration PASS" in text)
                  or (rc == 1 and "calibration FAIL" in text),
                  f"calibrate exited {rc} without its verdict")
            rc, text = quiet(calibrate_cli.main,
                             ["--ingest-drift", obs_trace_dir])
            for line in text.splitlines():
                print(f"[costmodel] (d) ingest: {line}")
            check(rc == 0, f"--ingest-drift exited {rc}")
            with open(cal_path) as f:
                cal = json.load(f)
            for r in cal["results"]:
                print(f"[costmodel] (d) row {json.dumps(r, sort_keys=True)} "
                      f"({card})")
            check(cal["platform"] == "gpu"
                  and cal["device"] == torch.cuda.get_device_name(0),
                  f"calibration file of {cal['platform']} {cal['device']}")
            sweep = [r for r in cal["results"]
                     if r.get("source") != "drift_report"]
            check(sorted(r["model"] for r in sweep)
                  == ["alexnet", "bert_proxy", "mlp", "resnet"]
                  and all(r["ops_measured"] == r["ops_total"]
                          and r["actual_mem_bytes"] > 0 for r in sweep),
                  "the sweep's rows")
            ratios = sorted(r["mem_ratio"] for r in cal["results"]
                            if isinstance(r.get("mem_ratio"), (int, float))
                            and r["mem_ratio"] > 0)
            median = ratios[len(ratios) // 2]
            corr = unity._memory_correction()
            print(f"[costmodel] (d) mem_ratio rows {ratios}: median {median}; "
                  f"the search's _memory_correction() {corr}")
            check(corr == median, "the search reads another correction")
            out["calibration"] = dict(rows=cal["results"],
                                      memory_correction=corr)
            # the learned table and the calibration file, for [lint]'s
            # searched compile (this phase's directory goes with it)
            with open(model_path) as f:
                out["files"] = {"COSTMODEL_GPU.json": f.read()}
            with open(cal_path) as f:
                out["files"]["CALIBRATION_GPU.json"] = f.read()
            seen = []
            real = native.native_optimize

            def spy(req):
                seen.append(req["config"]["memory_threshold"])
                return real(req)

            cap_mb = max(COSTMODEL_MEMORY_MB, math.ceil(
                2 * corr * uncapped_mem / 2**20))
            gc.collect()
            torch.cuda.synchronize()
            baseline = torch.cuda.memory_allocated()
            native.native_optimize = spy
            try:
                ff = build(cfg, ["--budget", str(SEARCH_BUDGET),
                                 "--memory-search", "--memory-threshold",
                                 str(cap_mb)])
            finally:
                native.native_optimize = real
            want = cap_mb * (1 << 20) / max(corr, 1.0)
            check(seen and abs(seen[0] - want) <= 1e-6 * want
                  and ff.search_info["memory_correction"] == corr,
                  f"threshold {seen} against {want}")
            x, y = training_batch(cfg)
            ff.fit(x, y, epochs=1, verbose=False)  # the capture
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ff.fit(x, y, epochs=2, verbose=False)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - baseline
            held = step_footprint_bytes(ff, peak + baseline) - baseline
            pred = ff.search_info["predicted_memory"]
            print(f"[costmodel] (d) memory-capped compile: threshold "
                  f"{cap_mb} MiB / {corr} = "
                  f"{seen[0] / 2**20:.1f} MiB; predicted memory "
                  f"{pred / 2**30:.3f} GiB (x correction "
                  f"{pred * corr / 2**30:.3f}); measured over 2 steps: peak "
                  f"allocated {peak / 2**30:.3f} GiB, with the graph pool "
                  f"{held / 2**30:.3f} GiB (the process's "
                  f"{baseline / 2**30:.3f} GiB before the model left out): "
                  f"measured / predicted {held / pred:.3f} ({card})")
            out["capped"] = dict(threshold=seen[0], predicted=pred,
                                 peak=peak, footprint=held)
            del ff
            torch.cuda.empty_cache()
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(sorted(os.listdir(root)) == tree_before,
          "[costmodel] wrote into the tree: "
          f"{sorted(set(os.listdir(root)) - set(tree_before))}")
    return out


# ---- [frontends]: models written elsewhere, imported and run on the card ----

# (a) the BERT-proxy written in plain PyTorch: nn.TransformerEncoder at
# TransformerConfig()'s widths, imported through torch.fx
FRONT_ENC = dict(d_model=1024, nhead=16, dim_feedforward=4096, layers=12,
                 batch=8, seq=512)
FRONT_SEED = 16
# Adam's alpha: DESCENT_ALPHA, at which the loss falls over the first
# steps (at 1e-5 the first steps overshoot: 7.73, 14.40, 6.47, ...,
# PERF.md §6)
FRONT_ALPHA = DESCENT_ALPHA
FRONT_WARMUP, FRONT_STEPS = 2, 6
# the imported model's predict against the module's eager forward (f32),
# as a share of the output's max: bf16 rounds each of the 2L residual sums
# (unit roundoff 2^-8), which grow as a random walk, sqrt(2L) x 2^-8, with
# a margin of 2; in f32 compute only the order of the sums differs
# (MODEL_F32_RTOL)
FRONT_BF16_RTOL = 2 * math.sqrt(2 * FRONT_ENC["layers"]) * 2.0 ** -8
# (b) a GPT-2-class causal model written with plain torch ops at GPT-2
# small's published widths (n_embd 768, n_head 12, n_ctx 1024), all 12 of
# its layers, batch 4; one SGD step (lr 0.01, MSE) against torch
# autograd's: f32 on both sides, the losses within GPT2_LOSS_RTOL
GPT2 = dict(n_embd=768, n_head=12, n_ctx=1024, layers=12, batch=4)
GPT2_LR = 0.01
GPT2_LOSS_RTOL = 1e-3
# the bf16 predict against the eager forward: as FRONT_BF16_RTOL
GPT2_BF16_RTOL = 2 * math.sqrt(2 * GPT2["layers"]) * 2.0 ** -8


def frontend_encoder():
    """The BERT-proxy as a user writes it in PyTorch: 12 pre-norm encoder
    layers (no dropout) and a 1-wide head, on the card, weights from
    FRONT_SEED (PyTorch's own initialization)."""
    import torch
    import torch.nn as nn

    class Encoder(nn.Module):
        def __init__(self):
            super().__init__()
            e = FRONT_ENC
            self.enc = nn.TransformerEncoder(
                nn.TransformerEncoderLayer(
                    e["d_model"], e["nhead"], e["dim_feedforward"],
                    dropout=0.0, batch_first=True, norm_first=True),
                e["layers"], enable_nested_tensor=False)
            self.head = nn.Linear(e["d_model"], 1)

        def forward(self, x):
            return self.head(self.enc(x))

    torch.manual_seed(FRONT_SEED)
    return Encoder().to("cuda").eval()


def frontend_gpt2():
    """GPT-2 small's blocks written with plain torch ops (the reference
    test's MiniGPT2 structure: packed qkv, chunk, view/transpose, matmul,
    an additive causal-mask buffer, softmax, a GELU MLP in GPT-2's tanh
    form), on the card."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    e, h, s = GPT2["n_embd"], GPT2["n_head"], GPT2["n_ctx"]

    class Block(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln_1 = nn.LayerNorm(e)
            self.c_attn = nn.Linear(e, 3 * e)
            self.c_proj = nn.Linear(e, e)
            self.ln_2 = nn.LayerNorm(e)
            self.mlp_fc = nn.Linear(e, 4 * e)
            self.mlp_proj = nn.Linear(4 * e, e)
            bias = (1.0 - torch.tril(torch.ones(s, s))) * -1e9
            self.register_buffer("attn_bias", bias.view(1, 1, s, s))

        def forward(self, x):
            b = x.shape[0]
            d = e // h
            q, k, v = self.c_attn(self.ln_1(x)).chunk(3, dim=2)
            q = q.view(b, s, h, d).transpose(1, 2)
            k = k.view(b, s, h, d).transpose(1, 2)
            v = v.view(b, s, h, d).transpose(1, 2)
            att = torch.matmul(q, k.transpose(2, 3)) * (1.0 / d ** 0.5)
            att = torch.softmax(att + self.attn_bias, dim=-1)
            y = torch.matmul(att, v).transpose(1, 2).reshape(b, s, e)
            x = x + self.c_proj(y)
            m = self.mlp_fc(self.ln_2(x))
            return x + self.mlp_proj(F.gelu(m, approximate="tanh"))

    class GPT2Stack(nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = nn.ModuleList(Block()
                                        for _ in range(GPT2["layers"]))

        def forward(self, x):
            for blk in self.blocks:
                x = blk(x)
            return x

    torch.manual_seed(FRONT_SEED + 1)
    return GPT2Stack().to("cuda").eval()


def import_module(module, shape, mixed=True, comp_mode=None, strategy=None,
                  optimizer=None):
    """``module`` traced and imported through the port's fx frontend into
    an FFModel on the card, compiled (INFERENCE without ``optimizer``, else
    TRAINING with MSE; through the strategy file ``strategy(ff)`` writes,
    where given), holding the module's own weights. Returns (model,
    modules copied, compile seconds)."""
    import torch
    from flexflow_tpu_torch import CompMode, FFConfig, FFModel, LossType
    from flexflow_tpu_torch.torch import PyTorchModel

    t0 = time.perf_counter()
    ff = FFModel(FFConfig(batch_size=shape[0], allow_mixed_precision=mixed))
    check(ff.device.type == "cuda", f"the model is on {ff.device}")
    ptm = PyTorchModel(module)
    ptm.torch_to_ff(ff, [ff.create_tensor(shape)])
    if strategy is not None:
        ff.config.import_strategy_file = strategy(ff)
    ff.compile(optimizer, LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
               comp_mode=(CompMode.INFERENCE if optimizer is None
                          else CompMode.TRAINING))
    copied = ptm.copy_weights_to(ff)
    torch.cuda.synchronize()
    check(all(t.device.type == "cuda" for sub in ff.params.values()
              for t in sub.values()), "a parameter is not on the card")
    return ff, copied, time.perf_counter() - t0


def module_forward(module, x):
    """The module's own eager forward on the card, f32, as host numpy."""
    import torch

    with torch.no_grad():
        return module(torch.from_numpy(x).to("cuda")).float().cpu().numpy()


def phase_frontends(strategy_dir):
    """(a) the encoder written in PyTorch, imported through fx: served and
    predicted (K1) against its eager forward, bf16 and f32; trained through
    the kernel path's strategy file (K1, K2, K4), loss falling, two runs
    bit-equal, its step beside the native BERT-proxy's; (b) GPT-2 small's
    widths written with plain ops: predict against the eager forward, one
    SGD step against torch autograd's; (c) the reference tests' Keras CNN
    and ONNX conv net, one epoch each on the card. Returns the kernels'
    launches on the imported paths."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.model import host_copy
    from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer

    card = nvidia_smi_line()
    out = {}
    enc = FRONT_ENC
    L = enc["layers"]
    shape = (enc["batch"], enc["seq"], enc["d_model"])
    module = frontend_encoder()
    rs = np.random.RandomState(FRONT_SEED)
    x = rs.randn(*shape).astype(np.float32)
    y = rs.randn(enc["batch"], enc["seq"], 1).astype(np.float32)
    want = module_forward(module, x)

    # --- (a) serve: bf16 (the main path) and f32, against the module ---
    for mixed, tol in ((True, FRONT_BF16_RTOL), (False, MODEL_F32_RTOL)):
        ff, copied, secs = import_module(module, shape, mixed=mixed)
        dt = ff.executor.compute_dtype
        check(copied == 5 * L + 1,
              f"copy_weights_to copied {copied} modules, want {5 * L + 1}")
        reset_launches()
        got = ff.predict(x)
        launches = read_launches()
        gap = rel_gap(got, want)
        print(f"[frontends] (a) encoder imported through fx ({len(ff.layers)}"
              f" layers, {copied} modules' weights copied, compiled in "
              f"{secs:.2f} s), {dt}: predict vs the module's eager forward "
              f"(f32): max_abs_err / max |out| {gap:.3e} (tol {tol:.3e}); "
              f"K1 launches {launches['flash_attn_fwd']} ({card})")
        check(np.isfinite(got).all() and got.shape == want.shape
              and gap <= tol, "(a) imported encoder disagrees with torch")
        check(launches["flash_attn_fwd"] > 0
              and launches["flash_attn_fwd"] % L == 0,
              f"(a) predict launched K1 {launches['flash_attn_fwd']} times")
        if mixed:
            out["serve_predict"] = launches["flash_attn_fwd"]
            engine = ff.serve()
            reset_launches()
            reqs = [engine.submit([x[i]]) for i in range(enc["batch"])]
            engine.pump()
            rows = np.stack([r.wait(120) for r in reqs])
            served = read_launches()["flash_attn_fwd"]
            print(f"[frontends] (a) serve(): {len(reqs)} requests, K1 "
                  f"launches {served}; rows equal predict: "
                  f"{np.array_equal(rows, got)}")
            check(served > 0 and np.array_equal(rows, got),
                  "(a) served rows differ from predict or no K1 launch")
            out["serve"] = served
            del engine
        del ff
        release()

    # --- (a) train: the kernel path's strategy file, two runs, beside the
    # native BERT-proxy under the same strategy ---
    def strategy(ff):
        path = os.path.join(strategy_dir, "frontend_strategy.json")
        write_strategy(ff, path, kernel_path())
        return path

    def adam():
        return AdamOptimizer(alpha=FRONT_ALPHA, state_dtype=torch.bfloat16)

    runs = []
    for run in range(2):
        ff, copied, secs = import_module(module, shape, strategy=strategy,
                                         optimizer=adam())
        check(set((ff.kernel_choices or {}).values()) == {"flash", "fused"},
              f"(a) kernel choices {ff.kernel_choices}")
        for _ in range(FRONT_WARMUP):
            ff.fit(x, y, epochs=1, verbose=False)
        if run == 0:
            from flexflow_tpu_torch.models.transformer import \
                TransformerConfig
            native = compile_for_training(TransformerConfig(), strategy_dir,
                                          alpha=FRONT_ALPHA)
            for _ in range(FRONT_WARMUP):
                native.fit(x, y, epochs=1, verbose=False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = {"imported": [], "native": []}
            launches = dict.fromkeys(read_launches(), 0)
            for i in range(FRONT_STEPS):
                order = (("imported", ff), ("native", native))
                for name, model in (order if i % 2 == 0 else order[::-1]):
                    before = read_launches()
                    t0 = time.perf_counter()
                    model.fit(x, y, epochs=1, verbose=False)
                    times[name].append(time.perf_counter() - t0)
                    if name == "imported":
                        d = launch_delta(before)
                        launches = {k: launches[k] + d[k] for k in d}
            peak = torch.cuda.max_memory_allocated() / 2**30
            want_l = dict(flash_attn_fwd=L * FRONT_STEPS,
                          flash_attn_bwd=L * FRONT_STEPS,
                          fused_adam=FRONT_STEPS, flash_lse_fwd=0,
                          flash_lse_bwd=0)
            print(f"[frontends] (a) imported encoder, {FRONT_STEPS} steps: "
                  f"launches {launches} (expected {want_l})")
            check(launches == want_l, "(a) the imported model's training "
                  "steps did not launch K1, K2 and K4 as expected")
            out["train"] = launches
        else:
            for _ in range(FRONT_STEPS):
                ff.fit(x, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
        runs.append((list(ff.epoch_losses),
                     {f"{op}/{pn}": host_copy(t)
                      for op, sub in ff.params.items()
                      for pn, t in sub.items()}))
        if run == 0:
            # after the snapshot: the profiled steps train on
            prof = profile_train(ff, x, y, label="[frontends] (a) imported "
                                 "encoder, 2 train steps")
            nprof = profile_train(native, x, y, label="[frontends] (a) "
                                  "native BERT-proxy, 2 train steps")
            out["replay"] = check_replay_launches(
                "[frontends] (a) imported encoder", prof, 2,
                dict(flash_attn_fwd=L, flash_attn_bwd=L, fused_adam=1))
            busy = {k: (sum(p[0].values()) / p[2] if p else None)
                    for k, p in (("imported", prof), ("native", nprof))}
            p50 = {k: statistics.median(v) for k, v in times.items()}
            out["p50_ms"] = {k: v * 1e3 for k, v in p50.items()}
            out["busy"] = busy
            out["peak_gib"] = peak
            print(f"[frontends] (a) step p50 (fit of one step, host clock, "
                  f"{FRONT_STEPS} interleaved steps each): imported "
                  f"{p50['imported'] * 1e3:.3f} ms, native create_transformer"
                  f" {p50['native'] * 1e3:.3f} ms (imported/native "
                  f"{p50['imported'] / p50['native']:.3f}); device busy "
                  + ", ".join(f"{k} " + (f"{100 * v:.1f}%" if v is not None
                                         else "not measured")
                              for k, v in busy.items())
                  + f"; peak allocated {peak:.2f} GiB with both models on "
                  f"the card ({card})")
            del native
        del ff
        release()
    (l0, p0), (l1, p1) = runs
    print(f"[frontends] (a) losses, run 1 (Adam alpha {FRONT_ALPHA}): "
          + ", ".join(f"{v:.6f}" for v in l0) + f" ({card})")
    check(all(np.isfinite(l0)) and l0[-1] < l0[0],
          "(a) the imported model's loss did not fall")
    differ = sum(1 for k in p0 if not np.array_equal(p0[k], p1[k]))
    print(f"[frontends] (a) run 2 from the same weights: losses "
          f"{'equal' if l0 == l1 else 'differ'}, {differ} of {len(p0)} "
          f"parameter leaves differ (want 0)")
    check(l0 == l1 and differ == 0, "(a) two runs are not bit-equal")
    del module
    release()

    # --- (b) GPT-2 small's widths, plain torch ops ---
    g = GPT2
    gshape = (g["batch"], g["n_ctx"], g["n_embd"])
    gmod = frontend_gpt2()
    grs = np.random.RandomState(FRONT_SEED + 1)
    gx = grs.randn(*gshape).astype(np.float32)
    gy = grs.randn(*gshape).astype(np.float32)
    gwant = module_forward(gmod, gx)
    t0 = time.perf_counter()
    ffb, copied, secs = import_module(gmod, gshape, mixed=True)
    got = ffb.predict(gx)
    gap = rel_gap(got, gwant)
    kinds = sorted({l.op_type.name for l in ffb.layers})
    print(f"[frontends] (b) GPT-2 small widths, {g['layers']} layers, batch "
          f"{g['batch']}: {len(ffb.layers)} layers of kinds {kinds}; bf16 "
          f"predict vs the eager forward: {gap:.3e} of max (tol "
          f"{GPT2_BF16_RTOL:.3e}) ({card})")
    check(np.isfinite(got).all() and gap <= GPT2_BF16_RTOL,
          "(b) bf16 predict disagrees with torch")
    check({"BATCHMATMUL", "RESHAPE", "TRANSPOSE", "CONST", "EW_ADD",
           "SPLIT"} <= set(kinds), f"(b) graph lacks a 9c op: {kinds}")
    del ffb
    release()
    ffb, copied, secs = import_module(gmod, gshape, mixed=False,
                                      optimizer=SGDOptimizer(lr=GPT2_LR))
    got = ffb.predict(gx)
    gap = rel_gap(got, gwant)
    loss0 = float(((got - gy) ** 2).mean())
    crit = torch.nn.MSELoss()
    tx, ty = torch.from_numpy(gx).cuda(), torch.from_numpy(gy).cuda()
    with torch.no_grad():
        loss_t0 = float(crit(gmod(tx), ty))
    opt = torch.optim.SGD(gmod.parameters(), lr=GPT2_LR)
    gmod.train()
    crit(gmod(tx), ty).backward()
    opt.step()
    gmod.eval()
    with torch.no_grad():
        loss_t1 = float(crit(gmod(tx), ty))
    ffb.fit(gx, gy, epochs=1, verbose=False)
    loss1 = float(((ffb.predict(gx) - gy) ** 2).mean())
    print(f"[frontends] (b) f32 predict vs the eager forward: {gap:.3e} of "
          f"max (tol {MODEL_F32_RTOL}); MSE before the step: port "
          f"{loss0:.7f}, torch {loss_t0:.7f}; after one SGD step (lr "
          f"{GPT2_LR}): port {loss1:.7f}, torch autograd {loss_t1:.7f} "
          f"(rel {abs(loss1 - loss_t1) / loss_t1:.3e}, tol {GPT2_LOSS_RTOL}); "
          f"{time.perf_counter() - t0:.1f} s for the leg ({card})")
    check(gap <= MODEL_F32_RTOL, "(b) f32 predict disagrees with torch")
    check(abs(loss0 - loss_t0) <= GPT2_LOSS_RTOL * loss_t0
          and abs(loss1 - loss_t1) <= GPT2_LOSS_RTOL * loss_t1
          and loss1 != loss0, "(b) one SGD step differs from torch's")
    del ffb, gmod, tx, ty, opt
    release()

    # --- (c) the reference tests' Keras CNN and ONNX conv net ---
    from flexflow_tpu_torch.keras import Sequential
    from flexflow_tpu_torch.keras.layers import (Conv2D, Dense, Flatten,
                                                 Input, MaxPooling2D)
    import torch.nn.functional as F

    krs = np.random.RandomState(0)
    kx = krs.randn(32, 1, 12, 12).astype(np.float32)
    ky = krs.randint(0, 3, (32, 1)).astype(np.int32)
    km = Sequential([Input((1, 12, 12)), Conv2D(4, 3, activation="relu"),
                     MaxPooling2D(2), Flatten(),
                     Dense(3, activation="softmax")])
    km.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
               metrics=["accuracy"], batch_size=16)
    check(km.ff.device.type == "cuda" and all(
        t.is_cuda for sub in km.ff.params.values() for t in sub.values()),
        "(c) the Keras model is not on the card")
    hist = km.fit(kx, ky, epochs=1, verbose=False)
    kp = km.predict(kx)
    (ck, cb), (dk, db) = [l.get_weights() for l in km.layers
                          if l._param_names()]
    h = F.max_pool2d(F.relu(F.conv2d(torch.from_numpy(kx).cuda(),
                                     torch.from_numpy(ck).cuda(),
                                     torch.from_numpy(cb).cuda())), 2)
    kwant = torch.softmax(h.flatten(1) @ torch.from_numpy(dk).cuda()
                          + torch.from_numpy(db).cuda(), -1).cpu().numpy()
    kgap = rel_gap(kp, kwant)
    print(f"[frontends] (c) Keras CNN on {km.ff.device} "
          f"({km.ff.executor.compute_dtype}): one epoch, loss "
          f"{hist['loss'][0]:.6f}; predict {kp.shape} vs torch ops on its "
          f"weights {kgap:.3e} of max (tol {TOL['bfloat16']['o']}) "
          f"({card})")
    check(kp.shape == (32, 3) and np.isfinite(hist["loss"][0])
          and kgap <= TOL["bfloat16"]["o"], "(c) Keras CNN")
    del km

    from flexflow_tpu_torch import FFConfig, FFModel, LossType
    from flexflow_tpu_torch.onnx import ONNXModel
    from flexflow_tpu_torch.onnx.proto import encode_model, encode_node

    torch.manual_seed(1)
    conv = torch.nn.Conv2d(3, 8, 3, stride=1, padding=1).cuda()
    fc = torch.nn.Linear(8 * 4 * 4, 5).cuda()
    nodes = [
        encode_node("Conv", ["x", "cw", "cb"], ["c"], kernel_shape=[3, 3],
                    strides=[1, 1], pads=[1, 1, 1, 1]),
        encode_node("Relu", ["c"], ["r"]),
        encode_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                    strides=[2, 2]),
        encode_node("Flatten", ["p"], ["f"]),
        encode_node("Gemm", ["f", "fw", "fb"], ["out"], alpha=1.0, beta=1.0,
                    transB=1)]
    inits = {k: v.detach().cpu().numpy() for k, v in
             (("cw", conv.weight), ("cb", conv.bias), ("fw", fc.weight),
              ("fb", fc.bias))}
    om = ONNXModel(encode_model(nodes, inits, inputs={"x": (4, 3, 8, 8)},
                                outputs={"out": (4, 5)}))
    off = FFModel(FFConfig(batch_size=4))
    om.apply(off, {"x": off.create_tensor((4, 3, 8, 8))})
    off.compile(SGDOptimizer(lr=0.01), LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                [])
    check(om.copy_weights_to(off) == 4 and off.device.type == "cuda",
          "(c) ONNX weights not copied or the model not on the card")
    ox = np.random.RandomState(3).randn(4, 3, 8, 8).astype(np.float32)
    with torch.no_grad():
        h = F.max_pool2d(torch.relu(conv(torch.from_numpy(ox).cuda())), 2, 2)
        owant = fc(h.flatten(1)).cpu().numpy()
    op = off.predict(ox)
    ogap = rel_gap(op, owant)
    off.fit(ox, np.random.RandomState(5).randn(4, 5).astype(np.float32),
            epochs=1, verbose=False)
    print(f"[frontends] (c) ONNX conv net (the port's writer, "
          f"{len(nodes)} nodes) on {off.device} "
          f"({off.executor.compute_dtype}): predict vs torch {ogap:.3e} of "
          f"max (tol {TOL['bfloat16']['o']}); one epoch, loss "
          f"{off._last_loss:.6f} ({card})")
    check(ogap <= TOL["bfloat16"]["o"] and np.isfinite(off._last_loss),
          "(c) ONNX conv net")
    del off, conv, fc
    release()
    return out


# [lint]: the phase's budget on the card, printed beside its [time] line
LINT_BUDGET_S = 150.0
# the in-process run of the example's model: its steps (the first one
# captures the step; the launches are counted over the rest)
LINT_STEPS = 4
LINT_CHILD_TIMEOUT_S = 300
LINT_CLI_TIMEOUT_S = 300


def phase_lint(strategy_dir, obs_trace_dir, costmodel_files):
    """[lint] static analysis and the example scripts on the card
    (``analysis/``, ``compile(lint=)``, the fflint and explain CLIs,
    ``examples_torch/``). (1) ``examples_torch/transformer.py --lint error
    -b 8 --import-strategy`` (the kernel path's strategy file) as a child
    process at the reference config: ``mesh:`` and the throughput line,
    exit 0; then the same model in-process, ``compile(lint="error")`` and
    LINT_STEPS steps, twice from one seed: no error, every pass ok or
    skipped with its reason, K1/K2/K4 by the counters and by name in
    profiled replays, the two runs bit-equal. (2) The full-width
    BERT-proxy searched with ``--search-measure-ops`` on [costmodel]'s
    learned table and calibration file, ``lint="error"``: "learned", the
    calibration pass on platform gpu without FFL703, the attention's
    einsum and flash rows in the measured table (different), the lint's
    wall time beside the compile's; and the two-linear graph the
    substitution engine fuses, searched: ``rewrite_verification``
    recorded and ok. (3) The reference test's batch-6 MLP with a
    ``data=8`` strategy file: ``compile(lint="error")`` raises ValueError
    "fflint" with ``torch.cuda.memory_allocated()`` unchanged. (4) ``python
    -m flexflow_tpu_torch.scripts.fflint --model <m> --json`` for the ten
    zoo models that are not MoE (exit 0, one device), and ``explain
    --model transformer --budget 2 --measure-ops --trace-dir`` [obs]'s
    trace dir: the three artifacts, the merged trace with the ``sim:*``
    and the devtrace's ``device:*`` lanes. Returns the in-process run's
    launches."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import FFConfig, LossType, MetricsType
    from flexflow_tpu_torch import analysis
    from flexflow_tpu_torch.model import host_copy
    from flexflow_tpu_torch.models.mlp import create_mlp
    from flexflow_tpu_torch.models.transformer import (TransformerConfig,
                                                       create_transformer)
    from flexflow_tpu_torch.optimizers import AdamOptimizer, SGDOptimizer
    from flexflow_tpu_torch.scripts import fflint as fflint_cli
    from flexflow_tpu_torch.search import native, profile

    card = nvidia_smi_line()
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    cfg = TransformerConfig()
    work = os.path.join(strategy_dir, "lint")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "strategy.json")
    write_strategy(create_transformer(cfg, FFConfig(), device="cuda"), path,
                   kernel_path())

    # ---- (1) the example script, a child process at the reference config
    cmd = [sys.executable, os.path.join(root, "examples_torch",
                                        "transformer.py"),
           "--lint", "error", "-b", str(cfg.batch_size),
           "--import-strategy", path]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=LINT_CHILD_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"[lint] (1) transformer.py: {line}")
    check(proc.returncode == 0, f"examples_torch/transformer.py exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    thr = re.findall(r"ELAPSED TIME = ([0-9.]+)s, THROUGHPUT = ([0-9.]+) "
                     r"samples/s", proc.stdout)
    check(any(l.startswith("mesh: ") for l in proc.stdout.splitlines())
          and len(thr) == 1, "the example printed no mesh or throughput")
    out["example_samples_s"] = float(thr[0][1])
    print(f"[lint] (1) examples_torch/transformer.py --lint error -b "
          f"{cfg.batch_size} --import-strategy (12 layers, hidden 1024, 16 "
          f"heads, S 512): {float(thr[0][1]):.2f} samples/s over its timed "
          f"steps ({float(thr[0][0]):.4f} s), {secs:.1f} s with the "
          f"process's start and compile ({card})")

    # ---- (1) the same model in-process, twice from one seed -------------
    rs = np.random.RandomState(FFConfig().seed)
    x = rs.randn(cfg.batch_size, cfg.seq_length,
                 cfg.hidden_size).astype(np.float32)
    y = rs.randn(cfg.batch_size, cfg.seq_length, 1).astype(np.float32)
    L = cfg.num_layers
    runs = []
    for run in range(2):
        ff = create_transformer(cfg, FFConfig(batch_size=cfg.batch_size),
                                device="cuda")
        ff.config.import_strategy_file = path
        t0 = time.perf_counter()
        ff.compile(AdamOptimizer(alpha=1e-4),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [MetricsType.MEAN_SQUARED_ERROR], lint="error")
        compile_s = time.perf_counter() - t0
        rep = ff.lint_report
        check(rep is not None and not rep.has_errors(),
              f"(1) the lint found errors: {rep and rep.format_human()}")
        check(all(v == "ok" or v.startswith("skipped: ")
                  for v in rep.passes.values()),
              f"(1) a pass neither ran nor stated its skip: {rep.passes}")
        if run == 0:
            print(f"[lint] (1) in-process compile(lint=\"error\") in "
                  f"{compile_s:.2f} s: {rep.context}; "
                  f"{len(rep.errors)} errors, {len(rep.warnings)} warnings")
            for name, status in rep.passes.items():
                print(f"[lint] (1)   pass {name:22s} {status}")
        ff.fit(x, y, epochs=1, verbose=False)  # the capture
        reset_launches()
        for _ in range(LINT_STEPS - 1):
            ff.fit(x, y, epochs=1, verbose=False)
        torch.cuda.synchronize()
        launches = read_launches()
        runs.append((list(ff.epoch_losses),
                     {f"{op}/{pn}": host_copy(t)
                      for op, sub in ff.params.items()
                      for pn, t in sub.items()}))
        if run == 0:
            n = LINT_STEPS - 1
            want_l = dict(flash_attn_fwd=L * n, flash_attn_bwd=L * n,
                          fused_adam=n, flash_lse_fwd=0, flash_lse_bwd=0)
            print(f"[lint] (1) steps 2-{LINT_STEPS}: launches {launches} "
                  f"(expected {want_l}); losses {runs[0][0]}")
            check(launches == want_l, "(1) the steps did not launch K1, K2 "
                  "and K4 as expected")
            out["launches"] = launches
            prof = profile_train(ff, x, y, label="[lint] (1) the example's "
                                 "model, 2 train steps")
            out["replay"] = check_replay_launches(
                "[lint] (1) the example's model", prof, 2,
                dict(flash_attn_fwd=L, flash_attn_bwd=L, fused_adam=1))
        del ff
        release()
    (la, pa), (lb, pb) = runs
    differ = [k for k in pa if not np.array_equal(pa[k], pb[k])]
    print(f"[lint] (1) two runs from one seed: losses equal "
          f"{la == lb}; {len(pa)} leaves, {len(differ)} differ")
    check(la == lb and not differ and np.isfinite(la).all(),
          "(1) two runs from one seed differ")

    # ---- (2) the searched lint at full width ----------------------------
    env_keys = ("FFS_COSTMODEL_FILE", "FFS_CALIBRATION_FILE")
    env_before = {k: os.environ.get(k) for k in env_keys}
    files = {}
    for name, text in costmodel_files.items():
        files[name] = os.path.join(work, name)
        with open(files[name], "w") as f:
            f.write(text)
    seen = []
    real = native.native_optimize
    real_lint = analysis.lint_model
    lint_s = []

    def spy(req):
        seen.append(req)
        return real(req)

    def timed_lint(ff, **kw):
        t = time.perf_counter()
        try:
            return real_lint(ff, **kw)
        finally:
            lint_s.append(time.perf_counter() - t)

    os.environ["FFS_COSTMODEL_FILE"] = files["COSTMODEL_GPU.json"]
    os.environ["FFS_CALIBRATION_FILE"] = files["CALIBRATION_GPU.json"]
    profile._CACHE.clear()  # the compile measures its ops afresh
    native.native_optimize = spy
    analysis.lint_model = timed_lint
    try:
        fcfg = FFConfig(batch_size=cfg.batch_size)
        check(fcfg.parse_args(["--budget", str(SEARCH_BUDGET),
                               "--search-measure-ops"]) == [],
              "unread search flags")
        ff = create_transformer(cfg, fcfg, device="cuda")
        t0 = time.perf_counter()
        ff.compile(AdamOptimizer(alpha=1e-4, state_dtype=torch.bfloat16),
                   LossType.MEAN_SQUARED_ERROR_AVG_REDUCE,
                   [MetricsType.MEAN_SQUARED_ERROR], lint="error")
        compile_s = time.perf_counter() - t0
        rep = ff.lint_report
        info = ff.search_info
        print(f"[lint] (2) full-width search (budget {SEARCH_BUDGET}, "
              f"--search-measure-ops, cost model {info['cost_model']}): "
              f"compile(lint=\"error\") {compile_s:.2f} s, of it the lint "
              f"{lint_s[-1]:.3f} s; {rep.to_json()['counts']} ({card})")
        for d in rep.diagnostics:
            print(f"[lint] (2)   {d.format()}")
        for name, status in rep.passes.items():
            print(f"[lint] (2)   pass {name:22s} {status}")
        check(info["cost_model"] == "learned",
              f"(2) the search priced {info['cost_model']}")
        check(rep.passes["calibration"] == "ok"
              and not rep.by_rule("FFL703") and not rep.has_errors(),
              "(2) the calibration pass did not audit the card's file")
        measured = seen[-1]["measured"]
        att = [n.op.guid for n in ff.executor.nodes
               if n.op.op_type.name == "MULTIHEAD_ATTENTION"]
        rows = {g: (measured.get(f"{g}:fwd"), measured.get(f"{g}:fwd:flash"),
                    measured.get(f"{g}:bwd"), measured.get(f"{g}:bwd:flash"))
                for g in att}
        g0 = att[0]
        # the same rows before the calibration file's drift corrections
        # (the cache holds them: no op is timed again)
        raw = profile.microbenchmark(ff.executor.nodes,
                                     machine_spec=ff.machine_spec,
                                     device=ff.device,
                                     dtype=ff.executor.compute_dtype,
                                     drift_corrections=False)
        print(f"[lint] (2) the measured table's attention rows (s, the "
              f"search's, drift-corrected): einsum fwd {rows[g0][0]}, bwd "
              f"{rows[g0][2]}; flash fwd {rows[g0][1]}, bwd {rows[g0][3]}; "
              f"as timed: einsum fwd {raw[f'{g0}:fwd']}, bwd "
              f"{raw[f'{g0}:bwd']}; flash fwd {raw[f'{g0}:fwd:flash']}, bwd "
              f"{raw[f'{g0}:bwd:flash']} ({len(att)} ops, {card})")
        check(all(None not in r and r[0] != r[1] and r[2] != r[3]
                  for r in rows.values()),
              "(2) the measured table lacks an attention core's rows")
        out["measured_attention_s"] = {
            k: raw[f"{g0}:{leg}"] for k, leg in (
                ("einsum_fwd", "fwd"), ("flash_fwd", "fwd:flash"),
                ("einsum_bwd", "bwd"), ("flash_bwd", "bwd:flash"))}
        out["search_lint_s"] = lint_s[-1]
        out["search_compile_s"] = compile_s
        del ff
        release()
        # the two-linear graph the substitution engine fuses
        fuse = fusion_model()
        fuse.compile(SGDOptimizer(lr=0.1),
                     LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [],
                     outputs=fuse.outputs, lint="error")
        rv = fuse.search_info.get("rewrite_verification")
        print(f"[lint] (2) two linears on one input, searched: "
              f"{len(fuse.search_info['rewrites'])} rewrites, ops "
              f"{[n.op.op_type.name for n in fuse.executor.nodes]}; "
              f"rewrite_verification {rv}")
        check(rv is not None and rv["ok"] and "error" not in rv,
              "(2) no rewrite verification recorded")
        del fuse
    finally:
        native.native_optimize = real
        analysis.lint_model = real_lint
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    # ---- (3) the seeded refusal on the card -----------------------------
    bad = os.path.join(work, "data8.json")
    with open(bad, "w") as f:
        json.dump(dict(version=1, mesh=dict(data=8), ops={
            "mlp_0": dict(choice=None, outputs=[["data"]], params={})}), f)
    mcfg = FFConfig(batch_size=6)
    mcfg.import_strategy_file = bad
    mlp = create_mlp(batch_size=6, in_dim=64, hidden_dims=(128,),
                     out_dim=10, ff_config=mcfg, device="cuda")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    raised = None
    try:
        mlp.compile(SGDOptimizer(lr=0.01),
                    LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [],
                    lint="error")
    except ValueError as e:
        raised = str(e)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    print(f"[lint] (3) batch-6 MLP, a data=8 strategy file, "
          f"compile(lint=\"error\"): {raised!r}; rules "
          f"{sorted({d.rule for d in mlp.lint_report.errors})}; "
          f"memory_allocated {before} -> {after} bytes")
    check(raised is not None and "fflint" in raised and before == after
          and mlp.params == {}, "(3) the illegal strategy was not refused "
          "before allocation")
    del mlp

    # ---- (4) the CLIs on the card ---------------------------------------
    # the twelve fflint runs and explain, all started together
    models = list(fflint_cli.ZOO)
    out_dir = os.path.join(work, "explain")
    t0 = time.perf_counter()
    procs = {m: subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.fflint",
         "--model", m, "--json"], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for m in models}
    procs["explain"] = subprocess.Popen(
        [sys.executable, "-m", "flexflow_tpu_torch.scripts.explain",
         "--model", "transformer", "--budget", "2", "--measure-ops",
         "--trace-dir", obs_trace_dir, "--out-dir", out_dir],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    texts = {}
    try:
        for m, p in procs.items():
            texts[m] = p.communicate(timeout=LINT_CLI_TIMEOUT_S)
            if m in models:
                fflint_s = time.perf_counter() - t0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    explain_s = time.perf_counter() - t0
    docs = {}
    for m in models:
        so, se = texts[m]
        check(procs[m].returncode == 0, f"(4) fflint --model {m} exited "
              f"{procs[m].returncode}: {se[-2000:]}")
        docs[m] = json.loads(so)
    for m, d in docs.items():
        print(f"[lint] (4) fflint --model {m} --json: mesh "
              f"{d['context']['mesh_axes']}, {d['context']['num_ops']} ops, "
              f"{d['counts']}")
        check(d["context"]["mesh_axes"] == {"data": 1},
              f"(4) fflint {m} planned {d['context']['mesh_axes']}")
    print(f"[lint] (4) the {len(models)} fflint runs (in parallel, beside "
          f"explain) in {fflint_s:.1f} s ({card})")
    explain_out, explain_err = texts["explain"]
    check(procs["explain"].returncode == 0, f"(4) explain exited "
          f"{procs['explain'].returncode}: {explain_err[-3000:]}")
    st_path = os.path.join(out_dir, "SEARCH_TRACE.json")
    with open(st_path) as f:
        st = json.load(f)
    check(os.path.exists(os.path.join(out_dir, "EXPLAIN.md"))
          and os.path.exists(st["merged_trace"]), "(4) an artifact is missing")
    with open(st["merged_trace"]) as f:
        merged = json.load(f)
    labels = sorted({e["args"]["name"] for e in merged["traceEvents"]
                     if e.get("name") == "thread_name"})
    check(any(l.endswith(":sim:compute") for l in labels)
          and any(l.endswith(":device:compute") for l in labels),
          f"(4) the merged trace's lanes {labels}")
    m = st["measured_ops"]
    att = [r for r in st["corpus"] if r["type"] == "MULTIHEAD_ATTENTION"]
    check(att and all(f"{r['guid']}:fwd" in m for r in att),
          "(4) explain's measured table has no attention row")
    flash_rows = [r["guid"] for r in att if f"{r['guid']}:fwd:flash" in m]
    print(f"[lint] (4) explain --model transformer --budget 2 --measure-ops "
          f"--trace-dir [obs]: {explain_s:.1f} s with the process's start; "
          f"{explain_out.strip()}; {len(st['corpus'])} corpus rows; merged "
          f"lanes {labels}; attention einsum rows "
          f"{[m[str(r['guid']) + ':fwd'] for r in att]} s, flash rows "
          f"{[m[str(g) + ':fwd:flash'] for g in flash_rows]} s (the zoo "
          f"transformer's head_dim 32 is outside the kernel's 64/128, so "
          f"it has none; (2) holds both at full width) ({card})")
    check(not flash_rows, "(4) a flash row for a head_dim the kernel "
          "does not take")
    out["explain_s"] = explain_s
    out["fflint_moe"] = {m: docs[m] for m in models if m.startswith("moe")}
    return out


# [moe]: the phase's budget on the card, printed beside its [time] line
MOE_BUDGET_S = 200.0
# (a) the flat MoE at the roofline CLI's card configuration
MOE_FLAT = dict(batch_size=16, input_dim=1024, num_exp=16, num_select=2,
                hidden_size=1024, num_classes=1000)
MOE_FLAT_STEPS = 3
MOE_EXAMPLE_TIMEOUT_S = 300
# (b) the slice's full-width path: the MoE encoder at the BERT-proxy's
# widths (12 layers, hidden 1024, 16 heads, seq 512, batch 8), 8 experts,
# top-2, capacity factor 2.0: capacity 2048 over 4096 tokens
MOE_ENC = dict(batch_size=8, seq_length=512, hidden_size=1024,
               num_attention_heads=16, num_exp=8, num_select=2, alpha=2.0,
               lambda_bal=0.04, num_encoder_layers=12)
MOE_ALPHA = 1e-4
MOE_STEPS = 4        # fit steps after the capturing one
MOE_GRAPH_STEPS = 2  # compiled steps against eager ones
MOE_AUX_RTOL = 1e-3  # the loss difference against the recomputed term


def moe_flat_run(fused):
    """The flat MoE (MOE_FLAT) from its config's seed, MOE_FLAT_STEPS
    ``fit`` steps on one seeded batch: (losses, every leaf after them,
    the train step's captures and replays, the step times)."""
    import numpy as np
    import torch
    from flexflow_tpu_torch import FFConfig, LossType
    from flexflow_tpu_torch.models import MoEConfig, create_moe
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    mc = MoEConfig(**MOE_FLAT)
    ff = create_moe(mc, FFConfig(batch_size=mc.batch_size), device="cuda",
                    fused=fused)
    ff.compile(AdamOptimizer(alpha=1e-3),
               LossType.SPARSE_CATEGORICAL_CROSSENTROPY, [])
    rs = np.random.RandomState(0)
    x = rs.randn(mc.batch_size, mc.input_dim).astype(np.float32)
    y = rs.randint(0, mc.num_classes, (mc.batch_size, 1)).astype(np.int32)
    losses, times = [], []
    for _ in range(MOE_FLAT_STEPS):
        t0 = time.perf_counter()
        ff.fit(x, y, epochs=1, verbose=False)
        times.append(time.perf_counter() - t0)
        losses.append(ff._last_loss)
    torch.cuda.synchronize()
    sg = ff.executor.step_graphs["train_step"]
    kinds = sorted({n.op.op_type.name for n in ff.executor.nodes})
    leaves = [t.clone() for t in flatten_leaves((ff.params, ff.opt_state,
                                                 ff.state))]
    return losses, leaves, (sg.captures, sg.replays), times, kinds


def moe_choice(kind_name):
    """A strategy file's choice by op type: the kernel path
    (``kernel_path``) or the plain one (the einsum core, plain Adam)."""
    from flexflow_tpu_torch import OperatorType

    if kind_name == "kernel":
        return kernel_path()
    return lambda kind: ("dp_k:einsum"
                         if kind == OperatorType.MULTIHEAD_ATTENTION
                         else "dp")


def build_moe_encoder(strategy_dir, path_kind):
    """The MoE encoder (MOE_ENC) on the card, random weights from the
    config's seed, compiled for training (Adam MOE_ALPHA, bf16 moments,
    MSE) through a strategy file of ``path_kind`` ("kernel" or
    "plain")."""
    import torch
    from flexflow_tpu_torch import FFConfig, LossType
    from flexflow_tpu_torch.models import MoEConfig, create_moe_encoder
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    mc = MoEConfig(**MOE_ENC)
    ff = create_moe_encoder(mc, FFConfig(batch_size=mc.batch_size),
                            device="cuda")
    path = os.path.join(strategy_dir, f"moe_{path_kind}.json")
    write_strategy(ff, path, moe_choice(path_kind))
    ff.config.import_strategy_file = path
    ff.compile(AdamOptimizer(alpha=MOE_ALPHA, state_dtype=torch.bfloat16),
               LossType.MEAN_SQUARED_ERROR_AVG_REDUCE, [])
    return ff, mc


def moe_batch(mc, seed=0):
    import numpy as np

    rs = np.random.RandomState(seed)
    x = rs.randn(mc.batch_size, mc.seq_length,
                 mc.hidden_size).astype(np.float32)
    y = rs.rand(mc.batch_size, mc.seq_length,
                mc.num_classes).astype(np.float32)
    return x, y


def moe_layer_parts_ms(mc):
    """Device ms of one MoE layer's parts at the encoder's shapes, each
    its forward and backward as the train step runs them, back to back
    between CUDA events (``time_calls``): building the dispatch and
    combine tensors, the dispatch and combine einsums (f32), and the
    experts' FFN (f32 batched einsums, bias, ReLU)."""
    import torch
    from flexflow_tpu_torch.ops.moe import (expert_capacity,
                                            make_dispatch_tensors)
    from flexflow_tpu_torch.ops.reduce import top_k

    b = mc.batch_size * mc.seq_length
    e, k, d, h = mc.num_exp, mc.num_select, mc.hidden_size, mc.hidden_size
    c = expert_capacity(b, k, e, mc.alpha)
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, grad=False):
        t = torch.randn(*shape, device="cuda", generator=g)
        return t.requires_grad_() if grad else t

    gate = torch.softmax(randn(b, e), -1).bfloat16()
    vals, assign = top_k(gate, k)
    dispatch, combine = make_dispatch_tensors(assign, vals.float(), e, c)
    xf, cb, o = randn(b, d, grad=True), combine.clone().requires_grad_(), \
        randn(e, c, d, grad=True)
    g_grouped, g_y = randn(e, c, d), randn(b, d)

    def build():
        make_dispatch_tensors(assign, vals.float(), e, c)

    def route():
        grouped = torch.einsum("bd,bkec->ecd", xf, dispatch)
        y = torch.einsum("bkec,ecd->bd", cb, o)
        torch.autograd.grad([grouped, y], [xf, cb, o], [g_grouped, g_y])

    grouped = randn(e, c, d, grad=True)
    w_h, b_h = randn(e, d, h, grad=True), randn(e, h, grad=True)
    w_o, b_o = randn(e, h, d, grad=True), randn(e, d, grad=True)
    g_o = randn(e, c, d)

    def ffn():
        hid = torch.relu(torch.einsum("ecd,edh->ech", grouped, w_h)
                         + b_h[:, None, :])
        out = torch.einsum("ech,ehd->ecd", hid, w_o) + b_o[:, None, :]
        torch.autograd.grad(out, [grouped, w_h, b_h, w_o, b_o], g_o)

    parts = {name: time_calls(fn, target_ms=100.0)[0]
             for name, fn in (("dispatch build", build),
                              ("dispatch/combine einsums", route),
                              ("expert FFN", ffn))}
    route_flop = 5 * 2 * b * e * c * d  # 2 forward einsums, 3 backward GEMMs
    ffn_flop = 3 * 2 * (2 * e * c * d * h)
    print(f"[moe] (b) one layer's parts at B*S {b}, E {e}, top-{k}, C {c}, "
          f"D {d}, H {h}, forward and backward, device ms a call: "
          + ", ".join(f"{n} {ms:.4f}" for n, ms in parts.items())
          + f"; the route einsums {route_flop / 1e9:.1f} GFLOP "
          f"({route_flop / parts['dispatch/combine einsums'] / 1e9:.1f} "
          f"TFLOP/s), the FFN {ffn_flop / 1e9:.1f} GFLOP "
          f"({ffn_flop / parts['expert FFN'] / 1e9:.1f} TFLOP/s), f32 "
          f"without TF32")
    del dispatch, combine, xf, cb, o, grouped, w_h, b_h, w_o, b_o
    return parts


def phase_moe(strategy_dir, fflint_moe):
    """[moe] mixture of experts on the card (``ops/{moe,experts}.py``,
    ``models/moe_model.py``, the op-emitted load-balance loss). (a) The
    flat MoE at the roofline CLI's card configuration, fused and unfused,
    MOE_FLAT_STEPS steps each, two runs from one seed bit-equal; and
    ``examples_torch/moe.py -b 64`` as a child process, exit 0. (b) The
    MoE encoder at the BERT-proxy's widths (MOE_ENC) through the kernel
    path's strategy file: ``predict`` (a capture, a replay bit-equal, K1
    12 a call by name), ``serve()``'s full batch equal to ``predict`` of
    the same batch (an MoE row depends on its batch-mates), 1 +
    MOE_STEPS ``fit`` steps (K1 12, K2 12, K4 1 a step; step p50; peak
    memory), two replays profiled (the kernels by name, busy share,
    device time by kind), MOE_GRAPH_STEPS compiled steps against eager
    ones bit for bit, the loss at lambda_bal 0.04 minus the loss at 0
    against the load-balance term recomputed from the router's
    probabilities, the plain path's losses (einsum core, plain Adam)
    within TRAJECTORY_RTOL, and one layer's parts timed apart for the
    split of the step's device time. (c) [lint]'s fflint reports of the
    two MoE zoo models: one device, no error."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention
    from flexflow_tpu_torch.ops.experts import Experts

    card = nvidia_smi_line()
    root = os.path.dirname(os.path.abspath(__file__))
    out = {}

    # ---- (a) the flat MoE, and the example ------------------------------
    example = subprocess.Popen(
        [sys.executable, os.path.join("examples_torch", "moe.py"), "-b",
         "64"], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        for fused in (True, False):
            form = "fused" if fused else "unfused"
            runs = [moe_flat_run(fused) for _ in range(2)]
            (l1, v1, g1, t1, kinds), (l2, v2, g2, _, _) = runs
            same = sum(1 for a, b in zip(v1, v2) if torch.equal(a, b))
            print(f"[moe] (a) flat MoE {MOE_FLAT}, {form} ({', '.join(kinds)}"
                  f"): losses {l1} / {l2}; {same} of {len(v1)} leaves "
                  f"bit-equal; captures, replays {g1} / {g2}; steps "
                  + ", ".join(f"{t * 1e3:.2f}" for t in t1) + f" ms ({card})")
            check(l1 == l2 and same == len(v1) and np.all(np.isfinite(l1))
                  and g1 == (1, MOE_FLAT_STEPS - 1),
                  f"(a) the {form} flat MoE's two runs differ")
            check(("EXPERTS" in kinds) == fused
                  and ("GROUP_BY" in kinds) != fused,
                  f"(a) the {form} graph's op types {kinds}")
            del runs, v1, v2
        so, se = example.communicate(timeout=MOE_EXAMPLE_TIMEOUT_S)
    finally:
        if example.poll() is None:
            example.kill()
            example.wait()
    lines = [l for l in so.splitlines() if l.startswith(("mesh:",
                                                         "ELAPSED"))]
    print(f"[moe] (a) examples_torch/moe.py -b 64: exit "
          f"{example.returncode}; " + "; ".join(lines))
    check(example.returncode == 0 and len(lines) == 2,
          f"(a) the example exited {example.returncode}: {se[-2000:]}")
    out["example"] = lines[-1]
    release()

    # ---- (b) the MoE encoder at full width ------------------------------
    t0 = time.perf_counter()
    ff, mc = build_moe_encoder(strategy_dir, "kernel")
    compile_s = time.perf_counter() - t0
    ex = ff.executor
    cores = sorted({ff._selected_impl(n.op, ex.comp_mode)
                    for n in ex.nodes if isinstance(n.op, MultiHeadAttention)})
    n_att = sum(1 for n in ex.nodes if isinstance(n.op, MultiHeadAttention))
    n_exp = sum(1 for n in ex.nodes if isinstance(n.op, Experts))
    n_par = sum(t.numel() for sub in ff.params.values()
                for t in sub.values())
    print(f"[moe] (b) MoE encoder {MOE_ENC}: {len(ex.nodes)} ops, "
          f"{n_att} attentions ({cores}), {n_exp} Experts, {n_par:,} "
          f"parameters; compiled in {compile_s:.1f} s; {memory_line()}")
    check(cores == ["flash"] and n_att == n_exp
          == MOE_ENC["num_encoder_layers"], "(b) the graph or its cores")
    x, y = moe_batch(mc)

    # predict: a capture, then a replay, bit-equal; K1 by name
    reset_launches()
    t0 = time.perf_counter()
    first = ff.predict(x)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = ff.predict(x)
    replay_s = time.perf_counter() - t0
    k1 = read_launches()["flash_attn_fwd"]
    prof = profile_steps("[moe] (b) two replayed predicts",
                         lambda: ff.predict(x), steps=2)
    per_predict = check_replay_launches("[moe] (b) predict", prof, 2,
                                        dict(flash_attn_fwd=n_att))
    print(f"[moe] (b) predict: {first.shape}, finite "
          f"{bool(np.isfinite(first).all())}, the replay bit-equal "
          f"{np.array_equal(first, again)}; the capturing call "
          f"{first_s * 1e3:.1f} ms, a replay {replay_s * 1e3:.3f} ms with "
          f"its host copy; K1 launches over the two calls {k1} (want "
          f"{2 * n_att})")
    check(np.isfinite(first).all() and np.array_equal(first, again)
          and k1 == 2 * n_att, "(b) predict")
    out["predict"] = dict(launches=k1, replay=per_predict,
                          profile=prof[0] if prof else None)

    # serve(): the full batch through the engine equals predict of it
    engine = ff.serve(batch_buckets=[mc.batch_size])

    def serve_batch():
        reqs = [engine.submit([x[i]]) for i in range(mc.batch_size)]
        engine.pump()
        return np.stack([r.wait(120) for r in reqs])

    reset_launches()
    rows = serve_batch()
    served = read_launches()["flash_attn_fwd"]
    prof = profile_steps("[moe] (b) a served batch", serve_batch, steps=1)
    per_serve = check_replay_launches("[moe] (b) serve", prof, 1,
                                      dict(flash_attn_fwd=n_att))
    print(f"[moe] (b) serve(): {mc.batch_size} requests as one batch, rows "
          f"equal to predict of the same batch {np.array_equal(rows, first)}"
          f"; K1 launches {served}")
    check(np.array_equal(rows, first) and served >= n_att,
          "(b) the served rows differ from predict")
    out["serve"] = served
    del engine

    # training through the kernel path's strategy file
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s = [], []
    for _ in range(1 + MOE_STEPS):
        t0 = time.perf_counter()
        ff.fit(x, y, epochs=1, verbose=False)
        step_s.append(time.perf_counter() - t0)
        losses.append(ff._last_loss)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    p50, p90 = p50_p90(step_s[1:])
    steps = 1 + MOE_STEPS
    print(f"[moe] (b) fit through dp_k:flash / dp_k:fused: losses "
          + ", ".join(f"{v:.6f}" for v in losses)
          + f"; the capturing step {step_s[0]:.2f} s, replayed steps p50 "
          f"{p50 * 1e3:.3f} ms, p90 {p90 * 1e3:.3f} ms "
          f"({mc.batch_size / p50:.2f} samples/s, "
          f"{mc.batch_size * mc.seq_length / p50:.0f} tokens/s); launches "
          f"over {steps} steps {launches}; peak allocated {peak:.2f} GiB, "
          f"graph pool {pool_gib(ff):.2f} GiB ({card})")
    check(np.all(np.isfinite(losses))
          and launches["flash_attn_fwd"] == n_att * steps
          and launches["flash_attn_bwd"] == n_att * steps
          and launches["fused_adam"] == steps
          and launches["flash_lse_fwd"] == launches["flash_lse_bwd"] == 0,
          "(b) the kernel path's launches or losses")
    prof = profile_train(ff, x, y, steps=2,
                         label="[moe] (b) two replayed steps")
    per_step = check_replay_launches(
        "[moe] (b) train", prof, 2,
        dict(flash_attn_fwd=n_att, flash_attn_bwd=n_att, fused_adam=1))
    graph_vs_eager(ff, x, y, MOE_GRAPH_STEPS, "[moe] (b)")

    # the load-balance term in the objective: the loss at lambda_bal
    # against the loss at 0 from one state, and the term recomputed from
    # each layer's router probabilities
    inputs, labels = ff._stage_inputs([x]), ff._stage_labels(y)
    gates = []
    real = Experts.forward_with_aux

    def spy(self, params, args, ctx):
        gates.append((args[1].detach().float(), self))
        return real(self, params, args, ctx)

    Experts.forward_with_aux = spy
    try:
        loss_on = float(ex.grads_of(ff.params, ff.state, inputs, labels)[0])
    finally:
        Experts.forward_with_aux = real
    experts = [op for _, op in gates]
    for op in experts:
        op.lambda_bal = 0.0
    try:
        loss_off = float(ex.grads_of(ff.params, ff.state, inputs,
                                     labels)[0])
    finally:
        for op in experts:
            op.lambda_bal = MOE_ENC["lambda_bal"]
    term = 0.0
    for g, op in gates:
        idx = torch.sort(g, dim=-1, descending=True,
                         stable=True).indices[:, :op.k]
        f = torch.zeros(op.n_experts, device=g.device).scatter_add_(
            0, idx.reshape(-1), torch.ones(idx.numel(), device=g.device)
        ) / idx.numel()
        term += op.lambda_bal * op.n_experts * float((f * g.mean(0)).sum())
    gap = abs((loss_on - loss_off) - term) / term
    print(f"[moe] (b) the objective: loss at lambda_bal "
          f"{MOE_ENC['lambda_bal']} {loss_on:.6f}, at 0 {loss_off:.6f}, "
          f"difference {loss_on - loss_off:.6f} against the recomputed "
          f"load-balance term {term:.6f} over {len(gates)} layers "
          f"(relative gap {gap:.2e}, tol {MOE_AUX_RTOL})")
    check(len(gates) == n_exp and term > 0 and gap <= MOE_AUX_RTOL,
          "(b) the load-balance term is not the loss's difference")
    del gates, experts, inputs, labels
    kinds = prof[0] if prof else {}
    busy_step = sum(kinds.values()) / 2
    wall_step = prof[2] / 2 if prof else 0.0
    del ff, ex
    release()

    # the plain path from the same weights: einsum core, plain Adam
    plain, _ = build_moe_encoder(strategy_dir, "plain")
    reset_launches()
    plain_losses = []
    for _ in range(1 + MOE_STEPS):
        plain.fit(x, y, epochs=1, verbose=False)
        plain_losses.append(plain._last_loss)
    plain_launches = read_launches()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
    print(f"[moe] (b) plain path losses "
          + ", ".join(f"{v:.6f}" for v in plain_losses)
          + f"; kernel path vs plain: worst {max(rel):.3e} relative (tol "
          f"{TRAJECTORY_RTOL}); its launches {plain_launches}")
    check(max(rel) <= TRAJECTORY_RTOL
          and not any(plain_launches.values()),
          "(b) the kernel path's losses leave the plain path's")
    del plain
    release()

    # where a replayed step's device time goes
    parts = moe_layer_parts_ms(mc)
    layers = MOE_ENC["num_encoder_layers"]
    attention = (kinds.get("flash_attn_fwd", 0.0)
                 + kinds.get("flash_attn_bwd", 0.0)) / 2
    split = {"attention kernels (K1, K2)": attention,
             "dispatch/combine einsums": layers * parts[
                 "dispatch/combine einsums"],
             "dispatch build": layers * parts["dispatch build"],
             "expert FFN": layers * parts["expert FFN"]}
    split["the rest"] = busy_step - sum(split.values())
    print(f"[moe] (b) a replayed step: wall {wall_step:.3f} ms, device busy "
          f"{busy_step:.3f} ms; by part (attention by name from the "
          f"profile, the MoE parts x{layers} layers timed apart, the rest "
          f"the difference): "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy_step:.1f}%)"
                      for k, v in split.items()) + f" ({card})")
    out.update(train=launches, replay=per_step, step_p50_ms=p50 * 1e3,
               peak_gib=peak, split=split, serve_replay=per_serve)

    # ---- (c) the fflint reports of the two MoE zoo models ---------------
    for m, d in sorted(fflint_moe.items()):
        print(f"[moe] (c) fflint --model {m} --json ([lint] (4)): mesh "
              f"{d['context']['mesh_axes']}, {d['context']['num_ops']} ops, "
              f"{d['counts']}")
        check(d["context"]["mesh_axes"] == {"data": 1}
              and d["counts"]["error"] == 0, f"(c) fflint {m}")
    check(sorted(fflint_moe) == ["moe", "moe_encoder"],
          f"(c) the MoE reports {sorted(fflint_moe)}")
    return out


# [loop]: the phase's budget on the card, printed beside its [time] line
LOOP_BUDGET_S = 60.0
LOOP_BATCHES = 4      # the staged dataset, in batches of the BERT-proxy's
LOOP_RESUME = dict(num_layers=2)  # the resume leg's model (widths kept)
LOOP_SEQS = (256, 100)  # seq_length of the bucketed loop: buckets 256, 128
LOOP_BUCKET_STEPS = 2


def h2d_bytes(fn):
    """(bytes, copies) that a call of ``fn`` moved host to device, from
    the profiler's memcpy events (their ``bytes``): the session opens
    with LEAD_IN_CALLS calls (``profile_steps``) and counts the copies
    that start after MEASURED_RANGE opens around the measured call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN_CALLS):
            fn()
        torch.cuda.synchronize()
        with record_function(MEASURED_RANGE):
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="ff_h2d_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    opened = [e["ts"] for e in events if e.get("name") == MEASURED_RANGE
              and e.get("cat") == "user_annotation"]
    check(len(opened) == 1, f"the H2D profile holds {len(opened)} measured "
                            f"ranges, want 1")
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "") and e["ts"] >= opened[0]]
    return sum(int((e.get("args") or {}).get("bytes", 0))
               for e in copies), len(copies)


def loop_data(cfg, batches, seed):
    import numpy as np

    rs = np.random.RandomState(seed)
    n = batches * cfg.batch_size
    return (rs.randn(n, cfg.seq_length, cfg.hidden_size).astype(np.float32),
            rs.randn(n, cfg.seq_length, 1).astype(np.float32))


def phase_loop(strategy_dir):
    """[loop] ``fit_loader`` (``dataloader.py``) and the sequence-length
    buckets on the card. (1) The full-width BERT-proxy through the
    kernel path's strategy file (K1, K2, K4): ``fit`` and, from the same
    seed, ``fit_loader`` over the same LOOP_BATCHES batches, 2 epochs:
    the losses and every leaf bit-equal, the launches equal; the
    host-to-device bytes of a steady-state epoch of each, by the
    profiler's memcpy events (``fit_loader``: 0). (2) The resume: the
    model at LOOP_RESUME's depth, 3-batch epochs, saves every 2 steps,
    cut after the step-2 save; a fresh model resumes through
    ``on_resume``: one seek to batch 2, the 4 uncovered batches fetched,
    the losses and leaves of the uninterrupted run. (3) The ``set_batch``
    / ``forward(seq_length)`` / ``backward`` / ``update`` loop at
    LOOP_SEQS on (1)'s trained model: the bucket each length runs, its
    attention core, K1/K2 12 a step, each step's loss against the plain
    path's (the einsum core and plain Adam from the same state) within
    TRAJECTORY_RTOL."""
    import shutil

    import numpy as np
    import torch
    from flexflow_tpu_torch import create_data_loaders
    from flexflow_tpu_torch.ckpt.manifest import list_steps
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    card = nvidia_smi_line()
    out = {}
    cfg = TransformerConfig()
    x, y = loop_data(cfg, LOOP_BATCHES, seed=3)

    # ---- (1) fit_loader against fit -------------------------------------
    a = compile_for_training(cfg, strategy_dir)
    reset_launches()
    a.fit(x, y, epochs=2, verbose=False)
    fit_launches = read_launches()
    fit_losses = list(a.epoch_losses)
    want = [t.clone() for t in flatten_leaves((a.params, a.opt_state,
                                               a.state))]
    t0 = time.perf_counter()
    fit_h2d = h2d_bytes(lambda: a.fit(x, y, epochs=1, verbose=False))
    want_h2d = x[:cfg.batch_size].nbytes + y[:cfg.batch_size].nbytes
    fit_epoch_s = time.perf_counter() - t0
    del a
    release()
    b = compile_for_training(cfg, strategy_dir)
    loaders = create_data_loaders(b, x, y)
    on_card = all(l.on_device for l in loaders.input_loaders
                  + [loaders.label_loader])
    reset_launches()
    b.fit_loader(loaders, epochs=2, verbose=False)
    loader_launches = read_launches()
    loader_losses = list(b.epoch_losses)
    got = flatten_leaves((b.params, b.opt_state, b.state))
    differ = sum(1 for u, w in zip(got, want) if not torch.equal(u, w))
    n_leaves = len(got)
    t0 = time.perf_counter()
    loader_h2d = h2d_bytes(lambda: b.fit_loader(loaders, epochs=1,
                                                verbose=False))
    loader_epoch_s = time.perf_counter() - t0
    del want, got
    print(f"[loop] (1) full-width BERT-proxy, {LOOP_BATCHES} batches x 2 "
          f"epochs: fit losses {fit_losses}, fit_loader {loader_losses}; "
          f"{differ} of {n_leaves} leaves differ (want 0); launches fit "
          f"{fit_launches}, "
          f"fit_loader {loader_launches}; the dataset staged on the card "
          f"{on_card}; host-to-device a steady-state step: fit "
          f"{fit_h2d[0] / LOOP_BATCHES:.0f} bytes in "
          f"{fit_h2d[1] / LOOP_BATCHES:.1f} copies (x and y: {want_h2d}), "
          f"fit_loader "
          f"{loader_h2d[0] / LOOP_BATCHES:.0f} bytes in "
          f"{loader_h2d[1] / LOOP_BATCHES:.1f} copies (want 0); the "
          f"profiled calls {fit_epoch_s:.3f} / {loader_epoch_s:.3f} s "
          f"({card})")
    check(fit_losses == loader_losses and differ == 0
          and fit_launches == loader_launches
          and fit_launches["flash_attn_fwd"] == 12 * 2 * LOOP_BATCHES
          and fit_launches["fused_adam"] == 2 * LOOP_BATCHES,
          "(1) fit_loader is not fit on the same batches")
    check(on_card and loader_h2d == (0, 0)
          and fit_h2d[0] >= want_h2d * LOOP_BATCHES,
          "(1) fit_loader moved host bytes to the card in steady state")
    out.update(launches=loader_launches, h2d_step=loader_h2d[0]
               / LOOP_BATCHES, fit_h2d_step=fit_h2d[0] / LOOP_BATCHES)

    # ---- (3) the bucketed loop on (1)'s trained model -------------------
    # the plain path through a strategy file, so that its buckets, made
    # from the strategy, keep the einsum core too
    plain = compile_for_training(cfg, strategy_dir,
                                 choice_of=moe_choice("plain"))
    with torch.no_grad():
        for s, d in ((b.params, plain.params), (b.state, plain.state)):
            for u, w in zip(flatten_leaves(s), flatten_leaves(d)):
                w.copy_(u)
        for u, w in zip(flatten_leaves(b.opt_state),
                        flatten_leaves(plain.opt_state)):
            w.copy_(u.to(w.dtype))
    xb, yb = x[:cfg.batch_size], y[:cfg.batch_size]
    bucket_launches = dict.fromkeys(read_launches(), 0)
    for seq in LOOP_SEQS:
        bucket = b._seq_bucket(seq)
        rows = []
        for ff in (b, plain):
            reset_launches()
            losses = []
            for _ in range(LOOP_BUCKET_STEPS):
                ff.set_batch(xb, yb)
                ff.forward(seq_length=seq)
                ff.zero_gradients()
                ff.backward()
                ff.update()
                losses.append(ff._last_loss)
            rows.append((losses, read_launches()))
        ex = b._seq_execs[bucket]
        cores = sorted({b._selected_impl(n.op, ex.comp_mode)
                        for n in ex.nodes
                        if isinstance(n.op, MultiHeadAttention)})
        (kl, kn), (pl, pn) = rows
        rel = max(abs(u - w) / abs(w) for u, w in zip(kl, pl))
        print(f"[loop] (3) seq_length {seq}: bucket {bucket}, attention "
              f"core {cores}; kernel path losses {kl}, launches {kn}; "
              f"plain path {pl}, launches {pn}; worst {rel:.3e} relative "
              f"(tol {TRAJECTORY_RTOL})")
        check(bucket is not None and bucket < cfg.seq_length
              and cores == ["flash"]
              and kn["flash_attn_fwd"] == 12 * LOOP_BUCKET_STEPS
              and kn["flash_attn_bwd"] == 12 * LOOP_BUCKET_STEPS
              and not pn["flash_attn_fwd"] and rel <= TRAJECTORY_RTOL,
              f"(3) the bucket of seq_length {seq}")
        for k, v in kn.items():
            bucket_launches[k] += v
    print(f"[loop] (3) bucket executors {sorted(b._seq_execs)}; "
          f"{memory_line()}")
    out["bucket_launches"] = bucket_launches
    del b, plain, loaders
    release()

    # ---- (2) the resume through on_resume --------------------------------
    cfg2 = TransformerConfig(**LOOP_RESUME)
    x2, y2 = loop_data(cfg2, 3, seed=5)
    ref = compile_for_training(cfg2, strategy_dir)
    ref.fit_loader(create_data_loaders(ref, x2, y2), epochs=2,
                   verbose=False)
    want = [t.clone() for t in flatten_leaves((ref.params, ref.opt_state,
                                               ref.state))]
    ref_losses = list(ref.epoch_losses)
    del ref
    ck = os.path.join(strategy_dir, "loop_ckpt")
    cut = compile_for_training(cfg2, strategy_dir)
    cut.fit_loader(create_data_loaders(cut, x2, y2), epochs=2,
                   verbose=False, checkpoint_dir=ck, checkpoint_every=2)
    del cut
    for step, path, _ in list_steps(ck):
        if step > 2:
            shutil.rmtree(path)
    res = compile_for_training(cfg2, strategy_dir)
    loaders = create_data_loaders(res, x2, y2)
    fetches, seeks = [], []
    fetch, seek = loaders.next_batch, loaders.seek
    loaders.next_batch = lambda: (fetches.append(1), fetch())[1]
    loaders.seek = lambda i: (seeks.append(i), seek(i))[1]
    res.fit_loader(loaders, epochs=2, verbose=False, checkpoint_dir=ck,
                   resume=True)
    got = flatten_leaves((res.params, res.opt_state, res.state))
    differ = sum(1 for u, w in zip(got, want) if not torch.equal(u, w))
    print(f"[loop] (2) resume at {LOOP_RESUME}: seeks {seeks} (want [2]), "
          f"{len(fetches)} batches fetched (want 4), losses "
          f"{list(res.epoch_losses)} against the uninterrupted run's "
          f"{ref_losses}; {differ} of {len(want)} leaves differ")
    check(seeks == [2] and len(fetches) == 4 and differ == 0
          and res.epoch_losses == ref_losses,
          "(2) the resumed fit_loader did not land on the right batch")
    del res, loaders, got, want
    shutil.rmtree(ck, ignore_errors=True)
    release()
    return out


# [mesh]: the phase's budget on the card, printed beside its [time] line
MESH_BUDGET_S = 150.0
MESH_AXES = {"data": 2, "model": 2}
MESH_STEPS = 3
MESH_CHILD_TIMEOUT_S = 130
# the per-step losses against the one-rank run: the script's plain-path
# bound (the ranks' bf16 partial sums round where one device's product
# rounds once)
MESH_LOSS_RTOL = 2e-2
# the parameters after MESH_STEPS Adam steps against the one-rank run's
# (PERF.md section 6): an Adam step moves an element by about
# alpha at most in these first steps, so two runs whose gradients differ
# in a sign stay within 2 alpha a step of each other (MESH_PARAM_ATOL,
# every element); and the whole model's update (after - before) within
# MESH_UPDATE_RTOL of the one-rank update's norm (relative L2), which a
# wrong gradient (a missing all-reduce, a misplaced box) takes to ~1
MESH_ALPHA = 1e-4
MESH_PARAM_ATOL = 2 * MESH_ALPHA * MESH_STEPS
MESH_UPDATE_RTOL = 0.25


def mesh_strategy(cfg, axes):
    """The strategy file body of the BERT-proxy ``cfg`` over ``axes``:
    attention ``dp_head_k:flash`` (wq/wk/wv/wo head-sharded on 'model'),
    ffn1 ``dp_col_k:fused``, ffn2 ``dp_row_k:fused``, every other op
    ``dp_k:fused`` (the residual adds ``dp``)."""
    dp3 = ["data", None, None]
    ops = {}
    for i in range(cfg.num_layers):
        for n in (f"ln1_{i}", f"ln2_{i}"):
            ops[n] = dict(choice="dp_k:fused", outputs=[dp3], params={})
        for n in (f"res1_{i}", f"res2_{i}"):
            ops[n] = dict(choice="dp", outputs=[dp3], params={})
        ops[f"attn_{i}"] = dict(
            choice="dp_head_k:flash", outputs=[dp3],
            params={w: ["model", None, None]
                    for w in ("wq", "wk", "wv", "wo")})
        ops[f"ffn1_{i}"] = dict(choice="dp_col_k:fused",
                                outputs=[["data", None, "model"]],
                                params=dict(kernel=[None, "model"],
                                            bias=["model"]))
        ops[f"ffn2_{i}"] = dict(choice="dp_row_k:fused", outputs=[dp3],
                                params=dict(kernel=["model", None]))
    ops["head"] = dict(choice="dp_k:fused", outputs=[dp3], params={})
    return dict(version=1, mesh=dict(axes), ops=ops)


def mesh_kernel_checks(ff, axes=MESH_AXES, label="[mesh]"):
    """K1, K2 and K4 at this rank's shapes (attention's local ``[B/dp,
    H/mp, S, D]`` block over ``axes``; the rank's fused leaves, under
    weight-update sharding its shards) against their plain versions,
    before the counted run; -> [name, shape, max_abs_err]."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_bwd,
                                                        flash_bwd_reference,
                                                        flash_fwd,
                                                        flash_fwd_reference)
    from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                     fused_adam_reference)
    from flexflow_tpu_torch.optimizers import AdamOptimizer

    attn = next(n.op for n in ff.executor.nodes
                if n.op.op_type.name == "MULTIHEAD_ATTENTION")
    b, s, _ = attn.input_shapes[0]
    bh = (b // axes.get("data", 1)) * (attn.num_heads // axes.get("model", 1))
    d = attn.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    rows = []
    o, lse = flash_fwd(q, k, v, False)
    ro, rlse = flash_fwd_reference(q.float(), k.float(), v.float(), False)
    err = (o.float() - ro).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    check(err <= TOL["bfloat16"]["o"] and err_lse <= TOL["bfloat16"]["lse"],
          f"{label} K1 disagrees with its plain version at BH {bh}: o {err}, "
          f"lse {err_lse}")
    rows.append(["flash_attn_fwd", [bh, s, d], err])
    got = flash_bwd(q, k, v, o, lse, do, False)
    want = flash_bwd_reference(q.float(), k.float(), v.float(), o.float(),
                               lse, do.float(), False)
    errs = [(g.float() - w).abs().max().item() / w.abs().max().item()
            for g, w in zip(got, want)]
    check(max(errs) <= BWD_TOL["bfloat16"],
          f"{label} K2 disagrees with its plain version at BH {bh}: {errs}")
    rows.append(["flash_attn_bwd", [bh, s, d], max(errs)])
    leaves = [ff.params[op][pn] for op in sorted(ff.executor.fused_update_ops)
              if op in ff.params for pn in sorted(ff.params[op])]
    ps = [torch.randn(t.shape, generator=gen, device="cuda") for t in leaves]
    gs = [(torch.randn(t.shape, generator=gen, device="cuda") * 1e-2)
          .bfloat16() for t in leaves]
    ms = [(torch.randn(t.shape, generator=gen, device="cuda") * 1e-2)
          .bfloat16() for t in leaves]
    vs = [(torch.randn(t.shape, generator=gen, device="cuda") * 1e-2)
          .pow(2).bfloat16() for t in leaves]
    _, alpha_t = AdamOptimizer(alpha=MESH_ALPHA).step_scalars(
        torch.tensor(0, dtype=torch.int32, device="cuda"))
    want = fused_adam_reference(ps, gs, ms, vs, alpha_t, wd=0.0, **ADAM_KW)
    kp = [p.clone() for p in ps]
    fused_adam_multi(kp, gs, ms, vs, alpha_t, wd=0.0, **ADAM_KW)
    torch.cuda.synchronize()
    differ = sum(int((a != b).sum()) for got, w in zip(zip(kp, ms, vs), want)
                 for a, b in zip(got, w))
    check(differ == 0, f"{label} K4 is not bit-equal to its plain version "
                       f"over this rank's {len(leaves)} leaves")
    rows.append(["fused_adam", [len(leaves), sum(t.numel() for t in leaves)],
                 differ])
    return rows


def mesh_kernel_times(one):
    """K1, K2 and K4 at a [mesh] rank's shapes, timed in this process on
    the card alone (the ranks share it): K1 and K2 at BH 32 (8/2 x
    16/2), S 512, D 64, bf16, kernel and library back to back, plain
    beside; K1's plain version also at BH 16 and 64 (the serving
    buckets' row); K4 over one rank's fused leaves (``one``'s leaves cut
    by MESH_AXES' specs), beside ``torch.optim.Adam(fused=True)``. ->
    {kernel name: entry fields}."""
    import torch
    from flexflow_tpu_torch.ops.flash_attention import (flash_bwd,
                                                        flash_bwd_reference,
                                                        flash_fwd,
                                                        flash_fwd_reference)
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                     fused_adam_reference)

    attn = next(n.op for n in one.executor.nodes
                if n.op.op_type.name == "MULTIHEAD_ATTENTION")
    b, s, _ = attn.input_shapes[0]
    heads, d = attn.num_heads // MESH_AXES["model"], attn.head_dim
    b //= MESH_AXES["data"]
    bh = b * heads
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    shape = f"BH={bh} S={s} D={d} bfloat16 causal=False"
    out = {}
    fwd_bound, fwd_by = flash_bound(bh, s, d, 2, False, H100_SXM_PEAKS)
    view = lambda x: x.view(b, heads, s, d)
    kernel = lambda: flash_fwd(q, k, v, False)
    lib = lambda: sdpa(view(q), view(k), view(v))
    # at this size a call takes about as long on the host as on the card:
    # the profiler's device time beside back to back
    out["flash_attn_fwd"] = dict(
        shape=shape, ms=profiled_ms(kernel), b2b_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: flash_fwd_reference(q, k, v, False)),
        library_ms=profiled_ms(lib), library_b2b_ms=time_ms(lib),
        bound_ms=fwd_bound * 1e3, bound_by=fwd_by,
        timed_by="profiled device time",
        plain_ms_bh16_bh64=[
            time_ms(lambda: flash_fwd_reference(x, x, x, False))
            for x in (torch.randn(n, s, d, generator=gen, device="cuda")
                      .bfloat16() for n in (16, 64))])
    o, lse = flash_fwd(q, k, v, False)
    lq, lk, lv = (view(x).detach().requires_grad_() for x in (q, k, v))
    node = sdpa(lq, lk, lv).grad_fn
    bwd_bound_s, bwd_by = bwd_bound(bh, s, d, 2, False, False,
                                    H100_SXM_PEAKS)
    kernel = lambda: flash_bwd(q, k, v, o, lse, do, False)
    lib = lambda: node(view(do))
    out["flash_attn_bwd"] = dict(
        shape=shape, ms=profiled_ms(kernel), b2b_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: flash_bwd_reference(q, k, v, o, lse, do,
                                                     False)),
        library_ms=profiled_ms(lib), library_b2b_ms=time_ms(lib),
        bound_ms=bwd_bound_s * 1e3, bound_by=bwd_by,
        timed_by="profiled device time (back to back through flash_bwd "
                 "beside)")
    specs = mesh_strategy(TransformerConfig(), MESH_AXES)["ops"]
    shapes = []
    for op in sorted(one.executor.fused_update_ops):
        for pn, t in sorted(one.params.get(op, {}).items()):
            spec = specs[op]["params"].get(pn) or []
            shapes.append(tuple(
                n // (MESH_AXES[a] if a else 1)
                for n, a in zip(t.shape, list(spec) + [None] * t.dim())))
    rnd = lambda shp, k=1.0: torch.randn(shp, generator=gen,
                                         device="cuda") * k
    fp = [rnd(x) for x in shapes]
    fg = [rnd(x, 1e-2).bfloat16() for x in shapes]
    fm = [rnd(x, 1e-2).bfloat16() for x in shapes]
    fv = [(rnd(x, 1e-2) ** 2).bfloat16() for x in shapes]
    alpha_t = torch.tensor(MESH_ALPHA, device="cuda")
    n = sum(p.numel() for p in fp)
    lib_params = [torch.nn.Parameter(p.clone()) for p in fp]
    for lp, g in zip(lib_params, fg):
        lp.grad = g.float()
    lib = torch.optim.Adam(lib_params, lr=MESH_ALPHA, fused=True)
    adam_bound_s, adam_by = adam_bound(n, 2, 2, H100_SXM_PEAKS)
    out["fused_adam"] = dict(
        shape=f"{len(shapes)} leaves, {n} elements, p f32, g/m/v bf16",
        ms=time_ms(lambda: fused_adam_multi(fp, fg, fm, fv, alpha_t, wd=0.0,
                                            **ADAM_KW)),
        plain_ms=time_ms(lambda: fused_adam_reference(
            fp, fg, fm, fv, alpha_t, wd=0.0, **ADAM_KW)),
        library_ms=time_ms(lib.step), bound_ms=adam_bound_s * 1e3,
        bound_by=adam_by, timed_by="back to back")
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    for name, e in out.items():
        b2b = (lambda key: f" (b2b {fmt(e[key])})" if key in e else "")
        print(f"[mesh] {name} at a rank's shape ({e['shape']}): kernel "
              f"{fmt(e['ms'])}{b2b('b2b_ms')}, plain {e['plain_ms']:.4f} ms, "
              f"library {fmt(e['library_ms'])}{b2b('library_b2b_ms')}, bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']}); {e['timed_by']}")
    return out


def mesh_collective_checks(comm, device="cuda"):
    """Each collective of ``parallel/comm.py`` once on CUDA tensors over
    every rank, f32 and bf16, against its known values (small integers,
    exact in both): whether gloo takes CUDA tensors for it. -> {"<kind>
    <dtype>": "ok"}; a wrong value or a refusal fails the rank."""
    import torch

    axes = tuple(a for a in comm.mesh.axis_names if comm.mesh.shape[a] > 1)
    n, r = comm.size(axes), comm.block(axes)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        mk = lambda v: torch.as_tensor(v, dtype=dt, device=device)
        cases = {
            "all-reduce": (lambda: comm.all_reduce(mk([[r + 1.0] * 4] * 4),
                                                   axes),
                           mk([[n * (n + 1) / 2] * 4] * 4)),
            "all-gather": (lambda: comm.all_gather(mk([[r + 1.0] * 4]), axes,
                                                   0),
                           mk([[s + 1.0] * 4 for s in range(n)])),
            "reduce-scatter": (
                lambda: comm.reduce_scatter(
                    mk([[float(i)] * 4 for i in range(n)]) * (r + 1), axes,
                    0),
                mk([[r * n * (n + 1) / 2] * 4])),
            "all-to-all": (
                lambda: comm.all_to_all(
                    mk([[10.0 * (r + 1) + j] * 4 for j in range(n)]), axes,
                    0, 0),
                mk([[10.0 * (s + 1) + r] * 4 for s in range(n)])),
        }
        for kind, (fn, want) in cases.items():
            got = fn()
            check(got.device == want.device and got.dtype == dt
                  and torch.equal(got, want),
                  f"[mesh] {kind} over gloo on CUDA {dt}: {got} != {want}")
            out[f"{kind} {str(dt)[6:]}"] = "ok"
    return out


def rank_world(flag, world, root, label, timeout, also=None,
               also_ranks=0):
    """Start ``world`` ranks of this script's ``flag`` mode over ``root``
    and wait for them; -> each rank's last ``[label child]`` JSON line,
    and with ``also`` a pair of those and the last ``[also child]`` line
    of each of the lowest ``also_ranks`` ranks. Fails the run if a rank
    exits non-zero or prints none of its lines."""
    cmd = [sys.executable, os.path.abspath(__file__), flag]
    procs = [subprocess.Popen(cmd + [str(r), str(world), root],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    children, more = [], []
    tag, also_tag = f"[{label} child] ", f"[{also} child] "
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [l for l in out.splitlines() if l.startswith(tag)]
        extra = [l for l in out.splitlines() if l.startswith(also_tag)]
        ok = p.returncode == 0 and lines and (extra or r >= also_ranks)
        if not ok:
            for line in err.splitlines()[-20:]:
                print(f"[{label} rank {r} stderr] {line}")
        check(ok, f"[{label}] rank {r} exited {p.returncode}")
        children.append(json.loads(lines[-1][len(tag):]))
        if r < also_ranks:
            more.append(json.loads(extra[-1][len(also_tag):]))
    return (children, more) if also else children


def mesh_child(argv):
    """``chip_smoke.py --mesh-child RANK WORLD DIR``: one rank of the
    [mesh] phase, over the gloo group the caller names (ranks sharing the
    one card). Trains the full-width BERT-proxy MESH_STEPS steps on
    MESH_AXES through ``DIR/strategy.json``, after holding its K1, K2 and
    K4 at its shapes against their plain versions; rank 0 writes the
    gathered parameters to ``DIR/final.pt``. Prints one ``[mesh child]``
    JSON line."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.weights import to_jax_params

    rank, world, root = int(argv[0]), int(argv[1]), argv[2]
    distributed.initialize(store=dist.FileStore(os.path.join(root, "store"),
                                                world),
                           world_size=world, rank=rank, backend="gloo",
                           timeout_s=MESH_CHILD_TIMEOUT_S)
    try:
        cfg = TransformerConfig()
        ff = compile_for_training(cfg, alpha=MESH_ALPHA, strategy_file=(
            os.path.join(root, "strategy.json")))
        check(dict(ff.mesh.shape) == MESH_AXES and ff.executor.multi_rank,
              f"[mesh] rank {rank} runs {ff.mesh.shape}")
        rows = mesh_kernel_checks(ff)
        collectives = mesh_collective_checks(ff.executor.comm)
        x, y = training_batch(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps = []
        for _ in range(MESH_STEPS):
            t0 = time.perf_counter()
            ff.fit(x, y, epochs=1, verbose=False)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        launches = read_launches()
        record = {}
        for kind, axes, nbytes in ff.executor.comm.step_record:
            e = record.setdefault(f"{kind} {'+'.join(axes)}", [0, 0])
            e[0] += 1
            e[1] += nbytes
        peak = torch.cuda.max_memory_allocated()
        ev = ff.evaluate(x, y)["loss"]
        pred = ff.predict(x)
        final = to_jax_params(ff)
        if rank == 0:
            torch.save(dict(final=final, pred=pred), os.path.join(
                root, "final.pt"))
        print("[mesh child] " + json.dumps(dict(
            rank=rank, losses=list(ff.epoch_losses), steps_s=steps,
            launches=launches, record=record, peak_bytes=peak,
            evaluate=ev, kernels=rows, collectives=collectives,
            local_leaves=sum(t.numel() for sub in ff.params.values()
                             for t in sub.values()),
            pred_finite=bool(np.isfinite(pred).all()))), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def phase_mesh(strategy_dir):
    """[mesh] the full-width BERT-proxy on MESH_AXES = {"data": 2,
    "model": 2}: 4 ranks (``--mesh-child``) share the one card over a
    gloo group the script names (NCCL refuses two ranks on one card), so
    the ranks' kernels and numerics are real and the transport is
    gloo's host copies, not NVLink. First one rank on one device trains
    the same MESH_STEPS steps from the same seed through the same
    kernel choices (train (b)'s file). Checks: every rank's K1, K2 and K4
    at its shapes against their plain versions; every rank's launches
    (K1 12, K2 12, K4 1 a step); each rank's losses within MESH_LOSS_RTOL
    of the one-rank run's and equal across ranks; the gathered
    parameters (MESH_PARAM_ATOL an element, the update within
    MESH_UPDATE_RTOL); ``evaluate`` and ``predict`` on the mesh against
    the one-rank model's. Returns {"launches": [per-rank launches],
    "kernels": [per-rank checks], ...}."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig()
    x, y = training_batch(cfg)
    # the one-rank run, through the kernel path's one-device file
    one = compile_for_training(cfg, strategy_dir, alpha=MESH_ALPHA)
    before = {op: {pn: t.detach().float().cpu()
                   for pn, t in sub.items()} for op, sub in one.params.items()}
    one.fit(x, y, epochs=MESH_STEPS, verbose=False)
    one_losses = list(one.epoch_losses)
    one_eval = one.evaluate(x, y)["loss"]
    one_pred = one.predict(x)
    after = {op: {pn: t.detach().float().cpu() for pn, t in sub.items()}
             for op, sub in one.params.items()}
    # each leaf's master, m and v bytes on the one device ([wus] holds a
    # rank's shards against them)
    one_bytes = {f"{op}/{pn}": [t.numel() * t.element_size()
                                for t in (one.params[op][pn],
                                          one.opt_state["m"][op][pn],
                                          one.opt_state["v"][op][pn])]
                 for op, sub in one.params.items() for pn in sub}
    leaf_shapes = {op: [tuple(t.shape) for _, t in sorted(sub.items())]
                   for op, sub in one.params.items()}
    times = mesh_kernel_times(one)
    del one
    release()
    world = math.prod(MESH_AXES.values())
    with tempfile.TemporaryDirectory(prefix="ff_mesh_") as root:
        with open(os.path.join(root, "strategy.json"), "w") as f:
            json.dump(mesh_strategy(cfg, MESH_AXES), f)
        children = rank_world("--mesh-child", world, root, "mesh",
                              MESH_CHILD_TIMEOUT_S)
        final = torch.load(os.path.join(root, "final.pt"),
                           weights_only=False)
    want = dict(flash_attn_fwd=12 * MESH_STEPS,
                flash_attn_bwd=12 * MESH_STEPS, fused_adam=MESH_STEPS)
    for c in children:
        got = {k: c["launches"][k] for k in want}
        check(got == want, f"[mesh] rank {c['rank']} launches {got}, want "
                           f"{want}")
        check(c["losses"] == children[0]["losses"],
              f"[mesh] rank {c['rank']}'s losses differ from rank 0's")
        check(c["pred_finite"], f"[mesh] rank {c['rank']}: non-finite "
                                f"predict")
    rel = [abs(a - b) / abs(b) for a, b in zip(children[0]["losses"],
                                               one_losses)]
    ev_rel = abs(children[0]["evaluate"] - one_eval) / abs(one_eval)
    pred_rel = rel_gap(final["pred"], one_pred)
    worst = num = den = 0.0
    for op, sub in after.items():
        for pn, a in sub.items():
            got = torch.from_numpy(np.asarray(final["final"][op][pn]))
            worst = max(worst, float((got - a).abs().max()))
            num += float(((got - before[op][pn]) - (a - before[op][pn]))
                         .pow(2).sum())
            den += float((a - before[op][pn]).pow(2).sum())
    upd_rel = math.sqrt(num / den)
    p50 = [statistics.median(c["steps_s"]) * 1e3 for c in children]
    print(f"[mesh] {nvidia_smi_line()}; {world} ranks on MESH_AXES "
          f"{MESH_AXES}, one card, gloo: per-step losses "
          + ", ".join(f"{v:.6f}" for v in children[0]["losses"])
          + " against one rank's " + ", ".join(f"{v:.6f}" for v in
                                              one_losses)
          + f" (worst {max(rel):.3e} relative, tol {MESH_LOSS_RTOL}); "
          f"evaluate {children[0]['evaluate']:.6f} against {one_eval:.6f} "
          f"({ev_rel:.3e}); predict within {pred_rel:.3e} of max; "
          f"parameters after {MESH_STEPS} steps: max |diff| {worst:.3e} "
          f"(tol {MESH_PARAM_ATOL:.1e}), update within {upd_rel:.3e} "
          f"relative L2 (tol {MESH_UPDATE_RTOL})")
    print("[mesh] " + json.dumps(dict(
        transport="gloo over host copies, 4 ranks sharing one card: not a "
                  "multi-GPU number",
        step_p50_ms=p50, steps_s=[c["steps_s"] for c in children],
        peak_gib=[c["peak_bytes"] / 2**30 for c in children],
        collectives_a_step=children[0]["record"],
        launches=[c["launches"] for c in children],
        kernel_checks=[c["kernels"] for c in children],
        gloo_cuda_collectives=children[0]["collectives"],
        local_param_elems=[c["local_leaves"] for c in children])))
    check(max(rel) <= MESH_LOSS_RTOL, "[mesh] the ranks' losses leave the "
                                      "one-rank run's")
    check(ev_rel <= MESH_LOSS_RTOL and pred_rel <= MODEL_RTOL,
          "[mesh] evaluate or predict leave the one-rank model's")
    check(worst <= MESH_PARAM_ATOL and upd_rel <= MESH_UPDATE_RTOL,
          "[mesh] the gathered parameters leave the one-rank run's")
    return dict(launches=[c["launches"] for c in children],
                kernels=[c["kernels"] for c in children], times=times,
                one=dict(losses=one_losses, before=before, after=after,
                         bytes=one_bytes, leaf_shapes=leaf_shapes))


# [wus]: the phase's budget on the card, printed beside its [time] line
WUS_BUDGET_S = 270.0
WUS_AXES = {"data": 4}
WUS_STEPS = MESH_STEPS
WUS_BUCKET_MB = 2
WUS_CHILD_TIMEOUT_S = 220
# the checkpoint leg: (b)'s fit saves at this step (checkpoint_every), a
# fresh model resumes it in the same processes and steps to WUS_STEPS, and
# a world of WUS_ELASTIC_RANKS resumes it after a search in its group
WUS_SAVE_STEP = 2
WUS_ELASTIC_RANKS = 2
# the search a user with a budget runs in the group ([search train]'s)
WUS_SEARCH_BUDGET = SEARCH_BUDGET


def wus_strategy(cfg):
    """The strategy file body of the pick of the port's own search for
    the full-width BERT-proxy on 4 H100s (``graph_optimize`` on
    ``MachineSpec(chip="h100-sxm", chips_per_slice=4)``, substitutions
    and pipelines off): ``{"data": 4}``, the attentions
    ``dp_wus_ovl_k:flash``, the FFN dense layers ``dp_wus_ovl_k:fused``,
    the LayerNorms, residual adds and head ``dp``."""
    dp3 = ["data", None, None]
    ops = {}
    for i in range(cfg.num_layers):
        for n in (f"ln1_{i}", f"ln2_{i}", f"res1_{i}", f"res2_{i}"):
            ops[n] = dict(choice="dp", outputs=[dp3], params={})
        ops[f"attn_{i}"] = dict(choice="dp_wus_ovl_k:flash", outputs=[dp3],
                                params={})
        for n in (f"ffn1_{i}", f"ffn2_{i}"):
            ops[n] = dict(choice="dp_wus_ovl_k:fused", outputs=[dp3],
                          params={})
    ops["head"] = dict(choice="dp", outputs=[dp3], params={})
    return dict(version=1, mesh=dict(WUS_AXES), ops=ops)


def wus_shard_shape(shape, degree):
    """A leaf's WUS shard over ``degree`` data ranks on a strategy that
    shards no parameter: its first dim the degree divides, cut."""
    for d, n in enumerate(shape):
        if n % degree == 0:
            return shape[:d] + (n // degree,) + shape[d + 1:]
    return shape


def wus_k4_times(fused_shapes):
    """K4 over a [wus] rank's shards of the leaves its ``_k:fused`` ops
    update (``fused_shapes``, their whole shapes), timed in this process
    on the card alone (the ranks share it): profiled device time and
    back to back, beside its plain version, its bound and
    ``torch.optim.Adam(fused=True)`` on the same shards back to back
    (f32 moments and grads: not the same function; the profiler saw
    less device time for its step than its own bytes need)."""
    import torch
    from flexflow_tpu_torch.ops.fused_update import (fused_adam_multi,
                                                     fused_adam_reference)

    shapes = [wus_shard_shape(s, WUS_AXES["data"]) for s in fused_shapes]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rnd = lambda shp, k=1.0: torch.randn(shp, generator=gen,
                                         device="cuda") * k
    fp = [rnd(x) for x in shapes]
    fg = [rnd(x, 1e-2).bfloat16() for x in shapes]
    fm = [rnd(x, 1e-2).bfloat16() for x in shapes]
    fv = [(rnd(x, 1e-2) ** 2).bfloat16() for x in shapes]
    alpha_t = torch.tensor(MESH_ALPHA, device="cuda")
    n = sum(p.numel() for p in fp)
    lib_params = [torch.nn.Parameter(p.clone()) for p in fp]
    for lp, g in zip(lib_params, fg):
        lp.grad = g.float()
    lib = torch.optim.Adam(lib_params, lr=MESH_ALPHA, fused=True)
    bound_s, bound_by = adam_bound(n, 2, 2, H100_SXM_PEAKS)
    kernel = lambda: fused_adam_multi(fp, fg, fm, fv, alpha_t, wd=0.0,
                                      **ADAM_KW)
    out = dict(
        shape=f"{len(shapes)} leaves, {n} elements, p f32, g/m/v bf16",
        elements=n, leaves=len(shapes), ms=profiled_ms(kernel),
        b2b_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: fused_adam_reference(
            fp, fg, fm, fv, alpha_t, wd=0.0, **ADAM_KW)),
        library_ms=time_ms(lib.step), bound_ms=bound_s * 1e3,
        bound_by=bound_by,
        timed_by="profiled device time (back to back beside); library "
                 "back to back")
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    print(f"[wus] fused_adam at a rank's shards ({out['shape']}): kernel "
          f"{fmt(out['ms'])} device (b2b {fmt(out['b2b_ms'])}), plain "
          f"{out['plain_ms']:.4f} ms, library {out['library_ms']:.4f} ms "
          f"b2b, bound {out['bound_ms']:.4f} ms ({bound_by})")
    return out


def wus_state(ff):
    """{op/param: [master, m, v bytes on this rank, whether WUS shards
    the leaf]}."""
    ex = ff.executor
    wus = ex.wus_leaves()
    return {f"{op}/{pn}": [t.numel() * t.element_size()
                           for t in (ff.params[op][pn],
                                     ff.opt_state["m"][op][pn],
                                     ff.opt_state["v"][op][pn])]
            + [(op, pn) in wus]
            for op, sub in ff.params.items() for pn in sub}


def wus_leaves_of(ff):
    """Clones of every tensor leaf of a model's parameters and optimizer
    state (this rank's shards), in tree order."""
    import torch
    from flexflow_tpu_torch.ckpt.tree import flatten_tree

    return [v.detach().clone() for _, v in flatten_tree(
        (ff.params, ff.opt_state)) if isinstance(v, torch.Tensor)]


def wus_box_bytes(ff):
    """(bytes of every box this rank holds, of the boxes it writes, of
    its WUS shards' master and moments) of the saved state."""
    from flexflow_tpu_torch.ckpt.sharded import (_capture_state, _rank_boxes,
                                                 flatten_tree)
    boxes = _rank_boxes(ff)
    held = written = 0
    for key, v in flatten_tree(_capture_state(ff)):
        if key in boxes:
            n = v.numel() * v.element_size()
            held += n
            written += n if boxes[key][3] else 0
    wus = ff.executor.wus_leaves()
    shards = sum(t.numel() * t.element_size()
                 for op, pn in wus for t in (ff.params[op][pn],
                                             ff.opt_state["m"][op][pn],
                                             ff.opt_state["v"][op][pn]))
    return held, written, shards


def wus_save_record(ff):
    """The [wus] save's figures on this rank from the registry: the
    snapshot (the training thread's stall), the writer's shard and index
    files, the commit (the wait for every rank's index and the manifest),
    the writer's whole time, and the bytes written beside the bytes of
    the boxes it writes."""
    from flexflow_tpu_torch.obs.registry import get_registry

    d = get_registry().to_dict()
    obs = d["observations"]
    held, written, shards = wus_box_bytes(ff)
    return dict(
        snapshot_s=obs["fit/ckpt_save_stall_s"]["sum"],
        write_s=obs["ckpt/shard_write_s"]["sum"],
        commit_s=obs["ckpt/commit_s"]["sum"],
        writer_s=obs["fit/ckpt_async_write_s"]["sum"],
        bytes_written=d["counters"]["fit/ckpt_bytes_written"],
        box_bytes_written=written, box_bytes_held=held,
        wus_shard_bytes=shards)


def wus_resume(cfg, x, y, strategy_path, ck, uninterrupted, losses):
    """[wus]'s resume leg on this rank: a fresh model compiled in the
    same process through (b)'s file resumes (b)'s checkpoint of step
    WUS_SAVE_STEP through ``fit(resume=True)`` and steps to WUS_STEPS;
    its parameters and moments against (b)'s after WUS_STEPS, bit for
    bit; its launches (K1, K2 and K4 on the shards) after the restore;
    then K1, K2 and K4 at its shapes against their plain versions."""
    import torch
    from flexflow_tpu_torch.obs.registry import get_registry

    reg = get_registry()
    t0 = time.perf_counter()
    ff = compile_for_training(cfg, alpha=MESH_ALPHA,
                              strategy_file=strategy_path,
                              overlap_bucket_mb=str(WUS_BUCKET_MB))
    compile_s = time.perf_counter() - t0
    read0 = reg.get("ckpt/restore_read_bytes")
    skipped0 = reg.get("ckpt/restore_skipped_bytes")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    ff.fit(x, y, epochs=WUS_STEPS, verbose=False, checkpoint_dir=ck,
           resume=True)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    got = wus_leaves_of(ff)
    differ = sum(int(not torch.equal(a, b))
                 for a, b in zip(got, uninterrupted))
    held, _, shards = wus_box_bytes(ff)
    rows = mesh_kernel_checks(ff, WUS_AXES, "[wus resume]")
    return dict(
        compile_s=compile_s, fit_s=fit_s,
        restore_s=reg.get("fit/ckpt_restore_s"),
        read_bytes=reg.get("ckpt/restore_read_bytes") - read0,
        skipped_bytes=reg.get("ckpt/restore_skipped_bytes") - skipped0,
        box_bytes_held=held, wus_shard_bytes=shards, launches=launches,
        losses=list(ff.epoch_losses), want_losses=losses[WUS_SAVE_STEP:],
        leaves=len(got), leaves_differ=differ
        + abs(len(got) - len(uninterrupted)), kernels=rows,
        iteration=ff._iter)


def restored_differ(ff, step_dir):
    """(leaves compared, keys of those that differ): this rank's
    parameters, Adam's m and v and its step count, bit for bit, against
    the checkpoint under ``step_dir`` put together whole from every
    rank's shard rows and cut by the executor's own placement
    (``local_box``, the cut of the weights at compile time). A restore
    that put a re-cut leaf in another box, or left a moment at zero,
    shows here before any step reads it."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.ckpt import manifest as mf
    from flexflow_tpu_torch.ckpt.sharded import read_shard_row

    manifest = mf.read_json(os.path.join(step_dir, mf.MANIFEST_NAME))
    rows = {}
    for name in manifest["index_files"]:
        index = mf.read_json(os.path.join(step_dir, name))
        for key, rs in index["shards"].items():
            rows.setdefault(key, []).extend((index["shards_file"], r)
                                            for r in rs)
    files = {f: np.load(os.path.join(step_dir, f))
             for f in {f for rs in rows.values() for f, _ in rs}}

    def saved(key):
        meta = manifest["leaves"][key]
        whole = np.empty(meta["shape"], np.dtype(meta["saved_dtype"]))
        for f, r in rows[key]:
            whole[tuple(slice(a, b) for a, b in r["index"])] = \
                read_shard_row(files[f], r, verify=False)
        # same-width signed ints: torch cuts them as any tensor
        return torch.from_numpy(whole.view(f"int{8 * whole.itemsize}"))

    def same(live, want):
        return torch.equal(live.detach().cpu().reshape(-1)
                           .view(torch.uint8),
                           want.contiguous().reshape(-1).view(torch.uint8))

    ex, opt = ff.executor, ff.opt_state
    differ, compared = [], 0
    try:
        for op, leaves in ff.params.items():
            for pn, t in leaves.items():
                for key, live in ((f"params/{op}/{pn}", t),
                                  (f"opt_state/m/{op}/{pn}",
                                   opt["m"][op][pn]),
                                  (f"opt_state/v/{op}/{pn}",
                                   opt["v"][op][pn])):
                    compared += 1
                    if not same(live, ex.local_box(op, pn, saved(key))):
                        differ.append(key)
        compared += 1
        if not same(opt["t"], saved("opt_state/t")):
            differ.append("opt_state/t")
    finally:
        for f in files.values():
            f.close()
    return compared, differ


def wus_elastic(rank, world, root):
    """[wus]'s elastic leg on rank ``rank`` of ``world``, run by the
    lowest ranks of the 4-rank world once they have left its group: a
    group of ``world`` over a new FileStore plans the resume of the
    4-rank checkpoint of step WUS_SAVE_STEP under ``DIR/ckpt``, compiles
    the full-width BERT-proxy with a search in the group, restores the
    checkpoint onto the boxes of its pick (``restored_differ`` holds each
    leaf to the checkpoint) and takes the step after it. Prints one
    ``[wus elastic child]`` JSON line."""
    import collections

    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.ckpt import load_manifest, plan_resume
    from flexflow_tpu_torch.ckpt import manifest as mf
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.obs.registry import get_registry

    t_world = time.perf_counter()
    distributed.initialize(store=dist.FileStore(os.path.join(
        root, "store_elastic"), world), world_size=world, rank=rank,
        backend="gloo", timeout_s=WUS_CHILD_TIMEOUT_S)
    try:
        reg = get_registry()
        read0 = reg.get("ckpt/restore_read_bytes")
        skipped0 = reg.get("ckpt/restore_skipped_bytes")
        cfg = TransformerConfig()
        x, y = training_batch(cfg)
        step_dir = os.path.join(root, "ckpt",
                                mf.step_dir_name(WUS_SAVE_STEP))
        plan = plan_resume(load_manifest(step_dir),
                           distributed.process_count())
        t0 = time.perf_counter()
        ff = compile_for_training(cfg, alpha=MESH_ALPHA,
                                  search_budget=WUS_SEARCH_BUDGET,
                                  enable_substitution=False,
                                  enable_pipeline_parallel=False)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        it = ff.load_checkpoint(step_dir)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        compared, differ = restored_differ(ff, step_dir)
        reset_launches()
        ff.fit(x, y, epochs=1, verbose=False)
        launches = read_launches()
        print("[wus elastic child] " + json.dumps(dict(
            rank=rank, plan=plan, iteration=it, mesh=dict(ff.mesh.shape),
            choices=dict(collections.Counter(
                ff.strategy[n.op.guid].choice for n in ff.executor.nodes)),
            wus=ff.executor.weight_update_sharding, compile_s=compile_s,
            restore_s=restore_s, leaves=compared, leaves_differ=differ,
            read_bytes=reg.get("ckpt/restore_read_bytes") - read0,
            skipped_bytes=reg.get("ckpt/restore_skipped_bytes") - skipped0,
            loss=ff._last_loss, launches=launches,
            world_s=time.perf_counter() - t_world)), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def wus_child(argv):
    """``chip_smoke.py --wus-child RANK WORLD DIR``: one rank of the [wus]
    phase, over the gloo group the caller names (ranks sharing the one
    card). (a) compiles the full-width BERT-proxy with a search budget
    (rank 0 searches on the machine of ``devices_to_run``, every rank
    takes the pick; graph rewrites and pipelines, which later slices
    execute over ranks, off) and takes one step; (b) trains WUS_STEPS steps through
    ``DIR/strategy.json`` with weight-update sharding and the overlap at
    WUS_BUCKET_MB, after holding K1, K2 and K4 at its shapes (K4 on its
    shards) against their plain versions, its step WUS_SAVE_STEP's fit
    checkpointing into ``DIR/ckpt``; (r) a fresh model resumes that
    checkpoint and steps to WUS_STEPS (``wus_resume``); (c) the same as
    (b) without the overlap. Rank 0 writes (b)'s gathered parameters to
    ``DIR/final.pt``. Prints one ``[wus child]`` JSON line; then the
    ranks below WUS_ELASTIC_RANKS run the elastic leg (``wus_elastic``)
    in a group of their own."""
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import distributed
    from flexflow_tpu_torch.models.transformer import TransformerConfig
    from flexflow_tpu_torch.parallel import comm
    from flexflow_tpu_torch.weights import to_jax_params

    rank, world, root = int(argv[0]), int(argv[1]), argv[2]
    distributed.initialize(store=dist.FileStore(os.path.join(root, "store"),
                                                world),
                           world_size=world, rank=rank, backend="gloo",
                           timeout_s=WUS_CHILD_TIMEOUT_S)
    try:
        cfg = TransformerConfig()
        x, y = training_batch(cfg)
        # (a) the port's own search in the group
        t0 = time.perf_counter()
        ff = compile_for_training(cfg, alpha=MESH_ALPHA,
                                  search_budget=WUS_SEARCH_BUDGET,
                                  enable_substitution=False,
                                  enable_pipeline_parallel=False)
        ex = ff.executor
        searched = dict(
            compile_s=time.perf_counter() - t0, mesh=dict(ff.mesh.shape),
            choices=dict(collections.Counter(
                ff.strategy[n.op.guid].choice for n in ex.nodes)),
            overlap_info=(ff.search_info or {}).get("overlap"),
            wus=ex.weight_update_sharding, overlap=ex.grad_overlap,
            bucket_bytes=ex.overlap_bucket_bytes,
            wus_ops=len(ex.wus_ops) if ex.wus_ops is not None else None)
        ff.fit(x, y, epochs=1, verbose=False)
        searched["loss"] = ff._last_loss
        check(np.isfinite(searched["loss"]),
              f"[wus] rank {rank}: the searched strategy's step is not "
              f"finite")
        del ff, ex
        release()
        # (b) the file's strategy, overlapped
        path = os.path.join(root, "strategy.json")
        ff = compile_for_training(cfg, alpha=MESH_ALPHA, strategy_file=path,
                                  overlap_bucket_mb=str(WUS_BUCKET_MB))
        ex = ff.executor
        check(dict(ff.mesh.shape) == WUS_AXES and ex.multi_rank
              and ex.weight_update_sharding and ex.grad_overlap
              and ex.overlap_bucket_bytes == WUS_BUCKET_MB * 10**6,
              f"[wus] rank {rank} runs {ff.mesh.shape}, WUS "
              f"{ex.weight_update_sharding}, overlap {ex.grad_overlap} "
              f"({ex.overlap_bucket_bytes} bytes)")
        rows = mesh_kernel_checks(ff, WUS_AXES, "[wus]")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        steps = []
        ck = os.path.join(root, "ckpt")
        for i in range(WUS_STEPS):
            # the step WUS_SAVE_STEP's fit checkpoints through its manager
            # (every rank its shards, rank 0 the commit) before it returns
            kw = (dict(checkpoint_dir=ck, checkpoint_every=WUS_SAVE_STEP)
                  if i + 1 == WUS_SAVE_STEP else {})
            t0 = time.perf_counter()
            ff.fit(x, y, epochs=1, verbose=False, **kw)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            if kw:
                save = wus_save_record(ff)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        record = {}
        for kind, axes, nbytes in ex.comm.step_record:
            e = record.setdefault(f"{kind} {'+'.join(axes)}", [0, 0])
            e[0] += 1
            e[1] += nbytes
        wus = ex.wus_leaves()
        # the all-reduces a step issues without one of a WUS leaf: the
        # loss, each metric and each leaf WUS leaves whole
        plain = [k for k in ex._leaf_layout() if k not in wus]
        want_ar = 1 + len(ff.metrics) + sum(
            1 for op, _ in plain if ex._by_name[op].grad_axes)
        state = wus_state(ff)
        losses = list(ff.epoch_losses)
        shards = [t.clone() for sub in ff.params.values()
                  for t in sub.values()]
        overlap_record = list(ex.overlap_record)
        final = to_jax_params(ff)
        if rank == 0:
            torch.save(dict(final=final), os.path.join(root, "final.pt"))
        uninterrupted = wus_leaves_of(ff)
        del ff, ex, final
        release()
        resumed = wus_resume(cfg, x, y, path, ck, uninterrupted, losses)
        del uninterrupted
        release()
        # (c) the same without the overlap: bit for bit
        ff = compile_for_training(cfg, alpha=MESH_ALPHA, strategy_file=path,
                                  overlap_bucket_mb="off")
        check(ff.executor.weight_update_sharding
              and not ff.executor.grad_overlap,
              f"[wus] rank {rank}: overlap_bucket_mb='off' left the overlap "
              f"on")
        ff.fit(x, y, epochs=WUS_STEPS, verbose=False)
        sync_same = (list(ff.epoch_losses) == losses and all(
            torch.equal(a, b) for a, b in zip(
                shards, [t for sub in ff.params.values()
                         for t in sub.values()])))
        print("[wus child] " + json.dumps(dict(
            rank=rank, searched=searched, losses=losses, steps_s=steps,
            launches=launches, record=record, want_all_reduces=want_ar,
            peak_bytes=peak, kernels=rows, state=state,
            overlap_record=overlap_record, sync_losses=list(
                ff.epoch_losses), sync_same=sync_same, save=save,
            resumed=resumed)), flush=True)
        del ff, shards
        release()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    # the elastic leg: the lowest ranks leave the 4-rank group and form
    # a smaller one, the others stop
    comm._COMMS.clear()
    if rank < WUS_ELASTIC_RANKS:
        wus_elastic(rank, WUS_ELASTIC_RANKS, root)
    return 0


def phase_wus(one):
    """[wus] weight-update sharding and the comms-compute overlap: 4 ranks
    (``--wus-child``) share the one card over a gloo group the script
    names, as in [mesh], and train the full-width BERT-proxy through the
    strategy file of the port's own pick for 4 H100s (``wus_strategy``)
    with 2-MB overlap buckets, beside [mesh]'s one-rank run (``one``, the
    same seed and batch). Checks: the pick of a search in the group
    compiles and steps; every rank's K1, K2 and K4 at its shapes (K4 on
    its shards) against their plain versions and its launches (K1 12, K2
    12, K4 1 a step); each rank's losses within MESH_LOSS_RTOL of one
    rank's and equal across ranks; the gathered parameters (MESH_PARAM_
    ATOL an element, the update within MESH_UPDATE_RTOL); the master
    and moment bytes of every WUS leaf at a quarter of one rank's; the
    step's record (reduce-scatters and all-gathers over 'data', no
    all-reduce of a WUS leaf); the overlap off bit-equal to it on. The
    checkpoint leg (``wus_checkpoint_checks``): (b)'s fit saves at step
    WUS_SAVE_STEP, a fresh model in the same 4 processes resumes it and
    steps on bit-equal; then the lowest WUS_ELASTIC_RANKS of the
    processes leave the group, form one of their own and resume it after
    a search in that group (``wus_elastic``).
    Returns {"launches": [per-rank launches], "kernels": [per-rank
    checks], "k4": K4's times at a rank's shards, "ckpt": the leg's
    figures, ...}."""
    import numpy as np
    import torch
    from flexflow_tpu_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig()
    body = wus_strategy(cfg)
    k4 = wus_k4_times([shp for op, o in body["ops"].items()
                       if o["choice"].endswith("_k:fused")
                       for shp in one["leaf_shapes"][op]])
    release()
    world = math.prod(WUS_AXES.values())
    with tempfile.TemporaryDirectory(prefix="ff_wus_") as root:
        with open(os.path.join(root, "strategy.json"), "w") as f:
            json.dump(body, f)
        # the elastic leg's lines come from the lowest ranks
        children, elastic = rank_world("--wus-child", world, root, "wus",
                                       WUS_CHILD_TIMEOUT_S,
                                       also="wus elastic",
                                       also_ranks=WUS_ELASTIC_RANKS)
        elastic_s = max(e["world_s"] for e in elastic)
        final = torch.load(os.path.join(root, "final.pt"),
                           weights_only=False)["final"]
    c0 = children[0]
    s = c0["searched"]
    print(f"[wus] the search in the group ({WUS_SEARCH_BUDGET} budget, "
          f"{s['compile_s']:.1f} s to compile) picks mesh {s['mesh']}, "
          f"choices {s['choices']}, overlap {s['overlap_info']}: WUS "
          f"{s['wus']} ({s['wus_ops']} ops), overlap {s['overlap']} "
          f"({s['bucket_bytes']} bytes); its step's loss {s['loss']:.6f}")
    want = dict(flash_attn_fwd=12 * WUS_STEPS,
                flash_attn_bwd=12 * WUS_STEPS, fused_adam=WUS_STEPS)
    for c in children:
        got = {k: c["launches"][k] for k in want}
        check(got == want, f"[wus] rank {c['rank']} launches {got}, want "
                           f"{want}")
        check(c["losses"] == c0["losses"],
              f"[wus] rank {c['rank']}'s losses differ from rank 0's")
        check(c["sync_same"], f"[wus] rank {c['rank']}: the overlap off is "
                              f"not bit-equal to it on")
        check(c["searched"]["mesh"] == s["mesh"]
              and c["searched"]["choices"] == s["choices"],
              f"[wus] rank {c['rank']} took another pick than rank 0")
    rel = [abs(a - b) / abs(b) for a, b in zip(c0["losses"], one["losses"])]
    worst = num = den = 0.0
    for op, sub in one["after"].items():
        for pn, a in sub.items():
            b = one["before"][op][pn]
            got = torch.from_numpy(np.asarray(final[op][pn]))
            worst = max(worst, float((got - a).abs().max()))
            num += float(((got - b) - (a - b)).pow(2).sum())
            den += float((a - b).pow(2).sum())
    upd_rel = math.sqrt(num / den)
    # each WUS leaf's master, m and v bytes against one rank's
    quarter = [leaf for leaf, (*nb, sharded) in c0["state"].items()
               if sharded and [n * world for n in nb] == one["bytes"][leaf]]
    sharded = [leaf for leaf, e in c0["state"].items() if e[3]]
    whole = [leaf for leaf, e in c0["state"].items() if not e[3]]
    rank_bytes = sum(sum(e[:3]) for e in c0["state"].values())
    one_bytes = sum(sum(v) for v in one["bytes"].values())
    rec = c0["record"]
    n_ar = sum(v[0] for k, v in rec.items() if k.startswith("all-reduce"))
    print(f"[wus] {nvidia_smi_line()}; {world} ranks on {WUS_AXES}, one "
          f"card, gloo, bucket {WUS_BUCKET_MB} MB: per-step losses "
          + ", ".join(f"{v:.6f}" for v in c0["losses"])
          + " against one rank's " + ", ".join(f"{v:.6f}" for v in
                                              one["losses"])
          + f" (worst {max(rel):.3e} relative, tol {MESH_LOSS_RTOL}); "
          f"parameters after {WUS_STEPS} steps: max |diff| {worst:.3e} (tol "
          f"{MESH_PARAM_ATOL:.1e}), update within {upd_rel:.3e} relative L2 "
          f"(tol {MESH_UPDATE_RTOL}); overlap off bit-equal on every rank: "
          f"{all(c['sync_same'] for c in children)}; master + moments "
          f"{rank_bytes} bytes a rank against one rank's {one_bytes} "
          f"({len(quarter)} of {len(sharded)} WUS leaves at a quarter, "
          f"{len(whole)} leaves whole: {whole}); all-reduces a step "
          f"{n_ar} (the loss, the metric and the whole leaves': "
          f"{c0['want_all_reduces']})")
    print("[wus] " + json.dumps(dict(
        transport="gloo over host copies, 4 ranks sharing one card: not a "
                  "multi-GPU number",
        step_p50_ms=[statistics.median(c["steps_s"]) * 1e3
                     for c in children],
        steps_s=[c["steps_s"] for c in children],
        peak_gib=[c["peak_bytes"] / 2**30 for c in children],
        collectives_a_step=rec, overlap_buckets=c0["overlap_record"],
        launches=[c["launches"] for c in children],
        kernel_checks=[c["kernels"] for c in children],
        master_moment_bytes_a_rank=rank_bytes,
        master_moment_bytes_one_rank=one_bytes, k4_at_a_rank=k4)))
    check(s["mesh"] and np.isfinite(s["loss"]),
          "[wus] the searched strategy did not step")
    check(max(rel) <= MESH_LOSS_RTOL,
          "[wus] the ranks' losses leave the one-rank run's")
    check(worst <= MESH_PARAM_ATOL and upd_rel <= MESH_UPDATE_RTOL,
          "[wus] the gathered parameters leave the one-rank run's")
    check(sharded and len(quarter) == len(sharded),
          "[wus] a WUS leaf's master or moments are not a quarter of one "
          "rank's")
    check(rec.get("reduce-scatter data", [0])[0] == len(sharded)
          and rec.get("all-gather data", [0])[0] == len(sharded)
          and n_ar == c0["want_all_reduces"],
          f"[wus] the step's record {rec}: want {len(sharded)} "
          f"reduce-scatters and all-gathers over 'data' and "
          f"{c0['want_all_reduces']} all-reduces")
    ckpt = wus_checkpoint_checks(children, elastic, elastic_s, one)
    return dict(launches=[c["launches"] for c in children],
                kernels=[c["kernels"] for c in children], k4=k4,
                searched=s, ckpt=ckpt)


def wus_checkpoint_checks(children, elastic, elastic_s, one):
    """[wus]'s checkpoint leg, from the 4 ranks' and the elastic ranks'
    lines: each rank wrote the boxes it owns (its quarter of every WUS
    leaf's master and moments) and read back its own on the resume; the
    resumed parameters and moments bit-equal to the uninterrupted run's
    at step WUS_STEPS, its loss equal; K1 12, K2 12 and K4 1 launched
    after the restore (K4 on the shards) and each held against its plain
    version; the elastic plan ``research``, every restored parameter,
    m, v and step count bit-equal to the checkpoint at the pick's boxes
    (``restored_differ``), and its step's loss within MESH_LOSS_RTOL of
    one rank's. Prints the seconds of each part."""
    card = nvidia_smi_line()
    want = dict(flash_attn_fwd=12, flash_attn_bwd=12, fused_adam=1)
    for c in children:
        sv, rs = c["save"], c["resumed"]
        got = {k: rs["launches"][k] for k in want}
        print(f"[wus ckpt] rank {c['rank']} ({card}): save at step "
              f"{WUS_SAVE_STEP}: snapshot {sv['snapshot_s']:.3f} s, shard + "
              f"index write {sv['write_s']:.3f} s, commit "
              f"{sv['commit_s']:.3f} s (writer {sv['writer_s']:.3f} s), "
              f"{int(sv['bytes_written'])} bytes written against its WUS "
              f"shards' {sv['wus_shard_bytes']} (a quarter of the master and "
              f"moments) and its owned boxes' {sv['box_bytes_written']}; "
              f"resume: compile {rs['compile_s']:.1f} s, restore "
              f"{rs['restore_s']:.3f} s, {int(rs['read_bytes'])} bytes read "
              f"against its boxes' {rs['box_bytes_held']} "
              f"({int(rs['skipped_bytes'])} skipped), step {WUS_STEPS} "
              f"loss {rs['losses']} against {rs['want_losses']}, "
              f"{rs['leaves_differ']} of {rs['leaves']} leaves differ, "
              f"launches after the restore {got}")
        # a rank writes the boxes it owns: its WUS shards, and on rank 0
        # the replicated leaves too (Adam's step count)
        check(sv["bytes_written"] == sv["box_bytes_written"]
              and (sv["box_bytes_written"] >= sv["wus_shard_bytes"]
                   if c["rank"] == 0 else
                   sv["box_bytes_written"] == sv["wus_shard_bytes"]),
              f"[wus] rank {c['rank']} wrote {sv['bytes_written']} bytes, "
              f"not its quarter {sv['wus_shard_bytes']}")
        check(rs["read_bytes"] == rs["box_bytes_held"]
              and rs["skipped_bytes"] > 0,
              f"[wus] rank {c['rank']} read {rs['read_bytes']} bytes on the "
              f"resume, not its own boxes' {rs['box_bytes_held']}")
        check(rs["iteration"] == WUS_STEPS and rs["leaves_differ"] == 0
              and rs["losses"] == rs["want_losses"],
              f"[wus] rank {c['rank']}: the resumed run is not the "
              f"uninterrupted one at step {WUS_STEPS}")
        check(got == want, f"[wus] rank {c['rank']}: launches after the "
                           f"restore {got}, want {want}")
    e0 = elastic[0]
    one_loss = one["losses"][WUS_STEPS - 1]
    rel = abs(e0["loss"] - one_loss) / abs(one_loss)
    print(f"[wus ckpt] elastic ({card}): {WUS_ELASTIC_RANKS} ranks plan "
          f"{e0['plan']}; the search in their group picks mesh "
          f"{e0['mesh']} ({e0['choices']}, WUS {e0['wus']}) in "
          f"{e0['compile_s']:.1f} s; restore "
          + ", ".join(f"{e['restore_s']:.3f} s ({int(e['read_bytes'])} bytes "
                      f"read, {int(e['skipped_bytes'])} skipped)"
                      for e in elastic)
          + "; leaves differing from the checkpoint (parameters, m, v, t "
          "at the pick's boxes): " + ", ".join(
              f"{len(e['leaves_differ'])} of {e['leaves']}" for e in elastic)
          + f"; step {WUS_STEPS} loss {e0['loss']:.6f} against one rank's "
          f"{one_loss:.6f} ({rel:.3e} relative, tol {MESH_LOSS_RTOL}); "
          f"launches {e0['launches']}; the group {elastic_s:.1f} s")
    for e in elastic:
        check(e["plan"]["action"] == "research"
              and e["plan"]["saved_devices"] == math.prod(WUS_AXES.values())
              and e["plan"]["num_devices"] == WUS_ELASTIC_RANKS
              and e["iteration"] == WUS_SAVE_STEP
              and math.prod(e["mesh"].values()) == WUS_ELASTIC_RANKS
              and e["loss"] == e0["loss"],
              f"[wus] elastic rank {e['rank']}: plan {e['plan']}, iteration "
              f"{e['iteration']}, mesh {e['mesh']}, loss {e['loss']}")
        check(e["leaves"] == 1 + 3 * len(children[0]["state"])
              and not e["leaves_differ"],
              f"[wus] elastic rank {e['rank']}: {len(e['leaves_differ'])} "
              f"of {e['leaves']} restored leaves differ from the "
              f"checkpoint: {e['leaves_differ'][:6]}")
    check(rel <= MESH_LOSS_RTOL, "[wus] the elastic resume's loss leaves "
                                 "one rank's")
    return dict(ranks=[dict(save=c["save"], resumed=c["resumed"])
                       for c in children], elastic=elastic,
                elastic_s=elastic_s)


def fusion_model():
    """Two linears on one input, summed, batch 64 x 256 -> 128, on the
    card with a search budget: the substitution engine fuses them into one
    wide LINEAR and a SPLIT (``tests/test_torch_port_search.py``)."""
    from flexflow_tpu_torch import FFConfig, FFModel

    ff = FFModel(FFConfig(batch_size=64, search_budget=3,
                          enable_parameter_parallel=False), device="cuda")
    t = ff.create_tensor((64, 256))
    a = ff.dense(t, 128, name="qa")
    b = ff.dense(t, 128, name="qb")
    ff.outputs = ff.add(a, b)
    return ff


def budgeted_phase(label, budget_s, run_phase, fn, *args):
    """``run_phase(label, fn, *args)``, then its time against ``budget_s``
    as a ``[time]`` line; over the budget fails the run."""
    t0 = time.perf_counter()
    result = run_phase(label, fn, *args)
    took = time.perf_counter() - t0
    print(f"[time] {label} budget: {budget_s:.0f} s, used {took:.1f} s ("
          + ("within" if took <= budget_s else "OVER") + " its budget)")
    check(took <= budget_s,
          f"[{label}] took {took:.1f} s, over its {budget_s:.0f} s budget")
    return result


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: no CUDA device (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 1
    if argv[:1] == ["--ckpt-child"]:
        return ckpt_child(argv[1:])
    if argv[:1] == ["--mesh-child"]:
        return mesh_child(argv[1:])
    if argv[:1] == ["--wus-child"]:
        return wus_child(argv[1:])
    def run_phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
        return result

    t_start = time.perf_counter()
    try:
        device_name = run_phase("card", phase_card)
        run_phase("build", phase_build)
        fwd = run_phase("kernels", phase_kernels)
        bwd, bwd_k3, llama_k2 = run_phase("kernels bwd", phase_kernels_bwd)
        lse_fwd, lse_bwd = run_phase("kernels lse", phase_kernels_lse)
        serve_launches, serve_replay = run_phase("serve", phase_serve)
        run_phase("f32 model", check_f32_model)
        with tempfile.TemporaryDirectory(prefix="ff_strategy_") as tmp:
            ff, batch, train_b, losses = run_phase("train b", phase_train_b,
                                                   tmp)
            plain_losses = run_phase("train trajectory",
                                     phase_train_trajectory, losses, tmp)
            run_phase("train grads", phase_train_grads, ff, batch, tmp)
            adam = run_phase("kernels adam", phase_kernels_adam, ff)
            del ff
            release()
            graph = run_phase("graph train", phase_graph_train, tmp)
        search_train, analytic_predicted = run_phase(
            "search train", phase_search_train, plain_losses)
        search_serve = run_phase("search serve", phase_search_serve)
        train_a = run_phase("train a", phase_train_a)
        ring = run_phase("ring", phase_ring)
        train_c = run_phase("train c", phase_train_c, {}, "full width",
                            timed=True)
        train_c_causal = run_phase("train c causal", phase_train_c,
                                   TRAIN_C_CAUSAL, "causal S 2048")
        llama, x, out, fingerprint, llama_serve = run_phase(
            "llama serve", phase_llama_serve)
        gen, pre, dec, _ = run_phase("llama decode", phase_llama_decode,
                                     llama)
        del llama
        run_phase("llama reference", phase_llama_reference, x, out, gen,
                  pre, dec, fingerprint)
        llama_k4 = run_phase("llama k4", llama_k4_row, LLAMA_TRAIN_LAYERS)
        with tempfile.TemporaryDirectory(prefix="ff_strategy_") as tmp:
            run_phase("llama train grads", phase_llama_train_grads, tmp)
            llama_train = run_phase("llama train", phase_llama_train, tmp)
        run_phase("llama search", phase_llama_search)
        zoo = {}
        with tempfile.TemporaryDirectory(prefix="ff_strategy_") as tmp:
            for model in ZOO_MODELS:
                zoo[model] = run_phase(f"zoo {model}", phase_zoo, model, tmp)
                if model in ("resnext", "inception"):
                    zoo[model]["nchw"] = run_phase(
                        f"layout {model}", layout_pair, model,
                        zoo[model]["rows"]["D"])
            zoo.update(run_phase("zoo bn", phase_zoo_bn, tmp))
            ckpt = run_phase("ckpt", phase_ckpt, tmp)
            obs = run_phase("obs", phase_obs, tmp, analytic_predicted,
                            trace_root=tmp)
            costmodel = run_phase("costmodel", phase_costmodel,
                                  obs["trace_dir"])
            frontends = run_phase("frontends", phase_frontends, tmp)
            t_lint = time.perf_counter()
            lint = run_phase("lint", phase_lint, tmp, obs["trace_dir"],
                             costmodel["files"])
            t_lint = time.perf_counter() - t_lint
            print(f"[time] lint budget: {LINT_BUDGET_S:.0f} s, used "
                  f"{t_lint:.1f} s ("
                  + ("within" if t_lint <= LINT_BUDGET_S else "OVER")
                  + " its budget)")
            check(t_lint <= LINT_BUDGET_S,
                  f"[lint] took {t_lint:.1f} s, over its "
                  f"{LINT_BUDGET_S:.0f} s budget")
            moe = budgeted_phase("moe", MOE_BUDGET_S, run_phase, phase_moe,
                                 tmp, lint["fflint_moe"])
            loop = budgeted_phase("loop", LOOP_BUDGET_S, run_phase,
                                  phase_loop, tmp)
            mesh = budgeted_phase("mesh", MESH_BUDGET_S, run_phase,
                                  phase_mesh, tmp)
            wus = budgeted_phase("wus", WUS_BUDGET_S, run_phase, phase_wus,
                                 mesh.pop("one"))
        print(f"[time] all phases: {time.perf_counter() - t_start:.1f} s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1
    fwd["launches"] = train_b["flash_attn_fwd"]
    fwd["launches_by_path"] = dict(serve=serve_launches,
                                   train_b=train_b["flash_attn_fwd"],
                                   train_a=train_a["launches"][
                                       "flash_attn_fwd"],
                                   search_train=search_train["flash_attn_fwd"],
                                   search_serve=search_serve,
                                   llama_serve=llama_serve["launches"])
    fwd["launches_by_path"].update(
        llama_train=llama_train["plain"]["launches"]["flash_attn_fwd"],
        llama_train_remat=llama_train["remat"]["launches"]["flash_attn_fwd"],
        ckpt_resume=ckpt["a"]["launches"]["flash_attn_fwd"],
        obs_measure=obs["measure"]["flash_attn_fwd"],
        obs_traced=obs["traced"]["launches"]["flash_attn_fwd"],
        costmodel_corpus=costmodel["corpus_launches"]["flash_attn_fwd"],
        costmodel_learned=costmodel["learned_launches"]["flash_attn_fwd"],
        frontends_predict=frontends["serve_predict"],
        frontends_serve=frontends["serve"],
        frontends_train=frontends["train"]["flash_attn_fwd"],
        lint_train=lint["launches"]["flash_attn_fwd"],
        moe_predict=moe["predict"]["launches"], moe_serve=moe["serve"],
        moe_train=moe["train"]["flash_attn_fwd"],
        loop_fit_loader=loop["launches"]["flash_attn_fwd"],
        loop_buckets=loop["bucket_launches"]["flash_attn_fwd"])
    bwd["launches"] = train_b["flash_attn_bwd"]
    bwd["launches_by_path"] = dict(
        train_b=train_b["flash_attn_bwd"],
        search_train=search_train["flash_attn_bwd"],
        llama_train=llama_train["plain"]["launches"]["flash_attn_bwd"],
        llama_train_remat=llama_train["remat"]["launches"]["flash_attn_bwd"],
        ckpt_resume=ckpt["a"]["launches"]["flash_attn_bwd"],
        obs_measure=obs["measure"]["flash_attn_bwd"],
        obs_traced=obs["traced"]["launches"]["flash_attn_bwd"],
        costmodel_corpus=costmodel["corpus_launches"]["flash_attn_bwd"],
        costmodel_learned=costmodel["learned_launches"]["flash_attn_bwd"],
        frontends_train=frontends["train"]["flash_attn_bwd"],
        lint_train=lint["launches"]["flash_attn_bwd"],
        moe_train=moe["train"]["flash_attn_bwd"],
        loop_fit_loader=loop["launches"]["flash_attn_bwd"],
        loop_buckets=loop["bucket_launches"]["flash_attn_bwd"])
    bwd["llama_train"] = dict(
        llama_k2, launches=llama_train["plain"]["launches"]["flash_attn_bwd"])
    bwd_k3["launches"] = train_a["launches"]["flash_attn_bwd"]
    adam["launches"] = train_b["fused_adam"]
    adam["launches_by_path"] = dict(
        train_b=train_b["fused_adam"], search_train=search_train["fused_adam"],
        llama_train=llama_train["plain"]["launches"]["fused_adam"],
        llama_train_remat=llama_train["remat"]["launches"]["fused_adam"],
        ckpt_resume=ckpt["a"]["launches"]["fused_adam"],
        obs_traced=obs["traced"]["launches"]["fused_adam"],
        frontends_train=frontends["train"]["fused_adam"],
        lint_train=lint["launches"]["fused_adam"],
        moe_train=moe["train"]["fused_adam"],
        loop_fit_loader=loop["launches"]["fused_adam"],
        loop_buckets=loop["bucket_launches"]["fused_adam"])
    # the [mesh] ranks' launches (each rank's own counters) and their
    # kernel checks at the per-rank shapes
    for entry, key in ((fwd, "flash_attn_fwd"), (bwd, "flash_attn_bwd"),
                       (adam, "fused_adam")):
        entry["launches_by_path"]["mesh_ranks"] = [
            r[key] for r in mesh["launches"]]
        entry["mesh_checks"] = [next(row for row in rank_rows
                                     if row[0] == key)
                                for rank_rows in mesh["kernels"]]
        entry["mesh_rank_shape"] = mesh["times"][key]
        # the [wus] ranks' (K1 and K2 at [mesh]'s BH 32; K4 on shards)
        entry["launches_by_path"]["wus_ranks"] = [
            r[key] for r in wus["launches"]]
        entry["wus_checks"] = [next(row for row in rank_rows
                                    if row[0] == key)
                               for rank_rows in wus["kernels"]
                               + [r["resumed"]["kernels"]
                                  for r in wus["ckpt"]["ranks"]]]
        # [wus]'s checkpoint leg: the step after the restore on each of
        # the 4 ranks (each also held against its plain version), and on
        # each rank of the elastic group
        entry["launches_by_path"]["wus_resume_ranks"] = [
            r["resumed"]["launches"][key] for r in wus["ckpt"]["ranks"]]
        entry["launches_by_path"]["wus_elastic_ranks"] = [
            e["launches"][key] for e in wus["ckpt"]["elastic"]]
    adam["wus_rank_shards"] = wus["k4"]
    adam["llama_train"] = llama_k4
    adam["launches_by_path"].update(
        {f"zoo_{n}": z["k4"]["launches"] for n, z in zoo.items()})
    adam["zoo"] = {n: z["k4"] for n, z in zoo.items()}
    for entry, key in ((lse_fwd, "flash_lse_fwd"), (lse_bwd, "flash_lse_bwd")):
        entry["launches"] = train_c["launches"][key]
        entry["launches_by_path"] = dict(
            train_c=train_c["launches"][key],
            train_c_causal=train_c_causal["launches"][key],
            search_train=search_train[key],
            **({f"ring_{k}": v for k, v in ring.items()}
               if key == "flash_lse_fwd" else {}))
    # each kernel's launches a replayed step, counted on the device by
    # kernel name, and its device time a launch inside a replayed graph
    # (the profiles of two replayed steps; serving: of one batch)
    for entry, kind, prof, key in (
            (fwd, "flash_attn_fwd", graph, "flash_attn_fwd"),
            (bwd, "flash_attn_bwd", graph, "flash_attn_bwd"),
            (adam, "fused_adam", graph, "fused_adam"),
            (lse_fwd, "flash_attn_fwd", train_c, "flash_lse_fwd"),
            (lse_bwd, "flash_attn_bwd", train_c, "flash_lse_bwd")):
        per_replay = prof["replay_launches"][key]
        entry["launches_a_replay"] = per_replay
        entry["graph_ms"] = prof["kinds"][kind] / (2 * per_replay)
    fwd["launches_a_replay_by_path"] = dict(
        train_b=graph["replay_launches"]["flash_attn_fwd"],
        train_a=train_a["replay_launches"]["flash_attn_fwd"],
        serve=serve_replay, llama_serve=llama_serve["replay"],
        llama_train=llama_train["plain"]["replay"]["flash_attn_fwd"],
        llama_train_remat=llama_train["remat"]["replay"]["flash_attn_fwd"],
        frontends_train=frontends["replay"]["flash_attn_fwd"],
        lint_train=lint["replay"]["flash_attn_fwd"],
        moe_predict=moe["predict"]["replay"]["flash_attn_fwd"],
        moe_serve=moe["serve_replay"]["flash_attn_fwd"],
        moe_train=moe["replay"]["flash_attn_fwd"])
    bwd["launches_a_replay_by_path"] = dict(
        train_b=graph["replay_launches"]["flash_attn_bwd"],
        llama_train=llama_train["plain"]["replay"]["flash_attn_bwd"],
        llama_train_remat=llama_train["remat"]["replay"]["flash_attn_bwd"],
        frontends_train=frontends["replay"]["flash_attn_bwd"],
        lint_train=lint["replay"]["flash_attn_bwd"],
        moe_train=moe["replay"]["flash_attn_bwd"])
    adam["launches_a_replay_by_path"] = dict(
        train_b=graph["replay_launches"]["fused_adam"],
        llama_train=llama_train["plain"]["replay"]["fused_adam"],
        llama_train_remat=llama_train["remat"]["replay"]["fused_adam"],
        frontends_train=frontends["replay"]["fused_adam"],
        lint_train=lint["replay"]["fused_adam"],
        moe_train=moe["replay"]["fused_adam"])
    fwd["llama_serve"] = llama_serve["k1"]
    bwd_k3["launches_a_replay"] = train_a["replay_launches"]["flash_attn_bwd"]
    print("[kernels] earlier times, not measured by this run (the mma.sync "
          "kernels' chip runs, NVIDIA H100 80GB HBM3, 700 W; the forward by "
          "profiled device time, the rest one call between two CUDA "
          "events): "
          + ", ".join(f"{n} {t} ms" for n, t in EARLIER_MS.items()))
    print(json.dumps({"kernels": [fwd, bwd, bwd_k3, adam, lse_fwd,
                                  lse_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
