#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, then the kernels' build
   (one ``nvcc`` per source for ``sm_90a``, all started together, linked
   into ``build/kernels/``) with its time, and each compiled kernel's
   registers, static shared memory and spills (``-Xptxas -v``); beside
   the build, on the host, the synthetic client writes its 32
   mixed-quality JFIF files once (every serving phase reads them through
   ``--jpeg-dir``) and the decode pool's cold start is timed;
2. every kernel of the serving and training paths against its plain
   PyTorch version on the card, at the paths' own shapes (full
   ``jpeg-resnet``; the serving kernels at 16 bands and batch 4, the block
   transforms at the training batch of 8: the data encode and stage 0's
   factored decode and encode; flash attention at ``smollm-360m``'s
   prefill in bf16 and fp32, ``mistral-nemo-12b``'s heads, and a window of
   256 and a non-causal S != T case, each in bf16 (the tensor-core
   kernel) and fp32 (the FFMA kernel); ``granite-moe-3b-a800m``'s prefill
   and ``mixtral-8x7b``'s 4096 window at a prompt of 4608, in bf16;
   ``whisper-small``'s encoder (S = T = 1500, in bf16 and fp32) and
   cross-attention (448 over 1500), ``internvl2-1b``'s prefill (14 heads
   over 2), in bf16): error, kernel ms, plain ms, the least
   time the card could take (bound) and, where one PyTorch call computes
   the same function, that call's ms (``library_ms``, a yardstick the
   port never calls); ASM also at the served walk's s2 and s3 row counts
   and a ragged one, where it and the q50 data encode also print the
   kernel's device time from ``torch.profiler`` beside the host's time to
   issue a call; then, outside inference mode, the attention backward
   kernels at the same attention cases (bf16 the tensor-core dK/dV and dQ
   kernels, fp32 the FFMA ones): dq, dk and dv against the plain
   backward fed by an fp32 ``attention_lse_plain`` (fp32 within
   ``ATTN_BWD_RTOL`` of the largest |gradient|, bf16 at most
   ``BF16_FACTOR`` × the bf16 plain backward's error), with ms, the plain
   backward's ms, the bound and SDPA's backward through autograd as the
   library time;
3. the compiled server: full ``jpeg-resnet`` from the client's JPEG bytes
   at 16 bands, batch 4, decode double-buffered against the device; every
   batch's logits are held against the same plan run on the plain path;
4. the per-layer walk (``--no-compiled``), held the same way;
5. one full-width training step (batch 8, 64 bands) on the kernel path
   against the same step on the plain path, from the same weights and
   batch: the loss and every gradient tensor;
6. the trainer (``launch/train.py``'s ``train_loop``) at full width, batch
   8, four steps, a checkpoint after step 2 and at the end, and the plan
   export; then one batch served from the exported plan through the
   compiled path, held against the plain path;
7. ``serve --qos --ingest bytes``: full ``jpeg-resnet`` built at 40 bands
   (``QOS_BANDS``) into a ``--plan-dir``, the default ladder (top, 48, 32,
   24; b48 shares the top's schedule), batch 8, buckets 1, 2, 4, 8 (one
   CUDA graph a cell), 32 single-image byte requests as one burst under
   ``--profile-grid --hw-profile h100`` (every warmed cell's predicted
   and measured capacity before traffic, every ``device-dispatch`` span
   carrying its cell's ``predicted_us``): every
   served request's logits held against its tier's plain path, no
   capture after warmup, a replayed graph for every tier served; each
   distinct tier's bucket-1 and bucket-8 cells of the grid that served,
   replayed (no new capture) and timed against the same forward run
   eagerly, bucket 8 on served images held against the plain path; then a
   restart from the same ``--plan-dir``, 48 requests under a deadline at
   pass 1's p95 latency, and the tier policy stepping down; then a third
   pass, ``serve --qos --chaos`` from the same directory, 48 requests at
   the reference's chaos defaults (rate 0.2, seed 1234, a decode worker
   killed before batch 3, 2 executor faults) with ``--metrics-out`` and
   ``--jax-profile`` on: every healthy request served within
   ``LOGIT_RTOL`` of its tier's plain path, every corrupted one failed
   with a typed codec error, the pool restarted, the breaker walked open
   → half-open → closed, no capture after warmup, a metrics snapshot per
   interval, and the profiler trace holding device events (our kernels
   by name where the trace names them).  Printed: images/s, latency
   percentiles, ingest and device walls and the share of ingest that
   overlapped the device (from the flight recorder), the ladder's device
   bytes, and phases 3-4 beside them.  Launches: the wrappers' counts
   (eager runs: each cell's warm-up before its capture, the top-tier
   probe) plus each cell's per-replay launches, recorded at its capture,
   times its replays;
8. the paper's conversion at full width: random ``jpeg-resnet`` weights
   from seed 0 as a torch-layout dict, read back by ``from_torch_layout``;
   (a) ``convert_and_verify`` on 4 images at φ = 14 and 64 bands, the
   spatial side cuDNN in fp32, the JPEG side on the kernels, gated at
   max(1e-4, 10 × the plain path's own deviation); (b) ``convert(
   fuse_bn=False)`` → ``jpeg_apply_precomputed`` against (a); (c)
   ``compile_for_inference(bands=40)`` → ``apply_compiled`` (stage 0
   fused) against the same plan's plain path; (d) ``convert(bands=
   "auto")`` probed on 4 client files with their ``IngestStats`` profile,
   the autotuned plan on the kernels against the 64-band reference path
   within the sweep's ``tol``; (e) ``fold_patch_embed`` on block-DCT
   coefficients against the pixel-patch projection;
9. plan introspection on the ``h100`` roofline profile: ``python -m
   repro_torch.launch.inspect`` once (16 bands, batch 8, executor auto,
   its report validated), then ``predicted_vs_measured`` on one batch of
   8 at 16 bands (s0b0-s1b1 fused) and at 40 bands (s0 fused) for (i) the
   ``cuda`` plan (the kernels), (ii) the same weights compiled on the
   ``reference`` path (the spatial lowering: decode, cuDNN fp32, encode,
   for the stem and each fused block; plain versions elsewhere) and (iii)
   the ``cuda`` plan under ``executor="gemm"`` and a ``reference`` config
   (the kernels' plain twin): each report validated, logits bit-identical
   under profiling, per-step walls within ``RECONCILE_TOL`` of the
   unprofiled wall, the steps' FLOPs within ``FLOPS_TOL`` of one counted
   whole walk, (i) and (ii) within ``LOGIT_RTOL`` of (iii); printed per
   step: FLOPs, bytes, predicted and measured µs, and per fused step the
   banded kernels beside the spatial lowering; then one cuDNN fp32 3×3
   conv at each stage's shape, on the heuristic's algorithm and on
   ``cudnn.benchmark``'s;
10. LM serving, fp32: full-width ``smollm-360m`` (random weights from seed
   0) prefills 4 prompts of 2048 tokens (cache grown to 2048 + 32) and
   decodes 32 steps, on the kernel path and on the plain path, both fed
   the plain path's greedy tokens: logits and the prefill's KV cache held
   within 1e-3 of the largest |value|, top-1 agreeing wherever the plain
   path's top-2 gap exceeds twice the logit error;
11. the same in bf16 (the published dtype) from the same weights: the
   kernel path's logit error against step 10's fp32 plain path at most 1.5×
   the bf16 plain path's; prefill and decode tokens/s, 32 kernel launches
   per prefill and none per decode step, and a ``torch.profiler``
   breakdown of one prefill and one decode step;
12. ``repro_torch.launch.serve --arch smollm-360m`` at the reference's
   defaults but 8 requests (``LM_SERVE_REQUESTS``): all completed and its
   report line;
13. LM training: (a) one ``loss_fn`` gradient of ``smollm-360m`` at full
   width cut to ``LM_STEP_LAYERS`` layers (batch 2, seq 2048) on the
   kernel path against the plain path: fp32 loss within
   ``LM_LOSS_RTOL``, each gradient leaf within max(``LM_GRAD_FLOOR``,
   ``LM_GRAD_FACTOR`` × the plain path's fp32-against-fp64 error) of its
   largest entry; bf16 each leaf's error against the fp32 plain path at
   most ``BF16_FACTOR`` × the bf16 plain path's; ``remat="full"`` giving
   the gradients of ``"none"`` with the forward launched twice a layer;
   (b) ``launch/train.py`` at full depth (batch 4, seq 2048, 4 AdamW
   steps, checkpoints every 2): finite losses, the attention forward and
   backward launched once a layer a step, a resume from step 2 repeating
   steps 3-4's losses within ``LM_RESUME_RTOL``; tokens/s, step ms, host
   batch time, and a ``torch.profiler`` split of one step (each backward
   kernel seen once a layer, dK/dV and dQ timed apart, no FFMA backward
   kernel launched) with the device's idle share; (a) also holds two bf16
   gradient calls to the same bits;
14. MoE serving: full ``granite-moe-3b-a800m`` (32 layers, 40 experts,
   top-8; 3.3 B parameters, random from seed 0) through phases 10-11's
   gates at the same batch, prompt and decode steps (every leaf of the
   prefill cache held; 32 kernel launches a prefill, none a decode step),
   prefill and decode tokens/s, a ``torch.profiler`` split of one bf16
   prefill and decode step by the MoE's ranges (``moe_route``,
   ``moe_experts``, ``moe_combine``), flash attention and the rest; then
   ``serve --arch granite-moe-3b-a800m`` with ``LM_SERVE_REQUESTS``
   requests, all completed;
15. ``mixtral-8x7b`` at full width cut to ``MIXTRAL_LAYERS`` layers, one
   prompt of ``MIXTRAL_PROMPT`` tokens (past the 4096 window and not a
   multiple of it), ``MIXTRAL_DECODE`` steps: first the repaired ring
   cache (fp32 plain path: decode equals ``forward`` over the whole
   sequence), then the gates of 14 (the kernel's window path at hd 128)
   and a profiled bf16 prefill;
16. ``jamba-v0.1-52b`` at full width cut to ``JAMBA_LAYERS`` layers (one
   period: Mamba mixers but attention at layer 4, MoE at the odd layers;
   13.3 B parameters, 53 GB in fp32, cast to bf16 leaf by leaf), one
   prompt of ``JAMBA_PROMPT``, ``JAMBA_DECODE`` steps, the gates of 14
   (Mamba's conv and SSM states among the cache leaves) and a profiled
   bf16 prefill;
17. phase 13 (a)'s gradient check on ``granite-moe-3b-a800m`` cut to
   ``LM_STEP_LAYERS`` layers (the kernel path's calls counted), the aux
   term finite on both paths and within ``LM_LOSS_RTOL``;
18. ``rwkv6-7b`` in full (32 layers, d 4096; 7.58 B parameters drawn in
   fp32, 28 GiB): 4 prompts of 2048 tokens, then 33 decode steps fed the
   next tokens, against ``forward`` over all 2081 (a length the reference
   cannot run) within 1e-3 of the largest |logit|, every state leaf
   finite; then bf16 (cast leaf by leaf), its relative-norm error against
   fp32 printed, and its logits against fp32 at most 1.5 × the plain
   scan's error (relative norm) at full depth over the first 256 tokens
   and at 4 layers over the prompts; prefill and decode tokens/s and a
   profiled prefill and decode step split by the WKV scan's range
   (``rwkv_wkv``) against the products and the rest; then ``serve --arch rwkv6-7b``, 4 requests;
19. ``internvl2-1b`` in full: each of 4 prompts one random 256² image,
   block-DCT encoded by the kernel into 256 vision embeddings through
   ``fold_patch_embed``, then 1792 tokens; its fp32 logits within 1e-3
   of those on the pixel patch embedding (the reference's integration
   test); phases 10-11's gates on that prefix (32 decode steps), a
   profiled bf16 prefill, then ``serve --arch internvl2-1b``, 4 requests;
20. ``whisper-small`` in full (12 + 12 layers) on 4 × 1500 random frames
   and 448 decoder tokens (its published ``max_target_positions``): the
   encoder and the whole ``forward`` under phases 10-11's gates, 32 decode
   steps from index 0 against the cross cache written from the encoder
   output (``cross_cache``) equal to ``forward``'s first positions, a
   profiled bf16 forward, then ``serve --arch whisper-small``, 4 requests;
21. training: phase 13 (a)'s gradient check at full depth for
   ``internvl2-1b`` and ``whisper-small`` (the plain path's layers
   recomputed in its backward, so its dense scores fit); ``launch/
   train.py`` on each for 4 steps at batch 4 × 2048 tokens (whisper:
   448), finite losses, the attention forward and backward launched once
   an attention call a step; ``rwkv6-7b`` cut to ``LM_STEP_LAYERS``
   layers, its fp32 gradient against the same code in fp64 (beside the
   plain path's over 512 tokens, whose WKV scan is the step recurrence:
   the floor) and two bf16 gradients bit-identical;
22. the mesh path (``launch/steps.py:build_train_step``) on a world of
   one over NCCL: ``smollm-360m`` at full width and depth, bf16, batch
   8 × 2048, ``grad_accum`` 4, ZeRO-1, ``remat="full"``: the first step's
   loss and gradients against ``launch/train.py``'s ``make_step``
   gradient on the same batch (fp32 at phase 13's gates, bf16 at its
   bf16 gate), then 4 steps with compression ``none`` and ``bf16``;
   ``granite-moe-3b-a800m`` cut to 4 layers: the expert-parallel path's
   logits (one shard, one group) against the global path's within 1e-5
   in fp32, then bf16 steps; full ``jpeg-resnet`` at batch 8, 64 bands;
   step ms and tokens/s (images/s);
23. four ranks sharing the one card over gloo (2 data × 2 model; the
   pipeline's point-to-point sends staged through the host, counted):
   ``smollm-360m`` at full width cut to 4 layers (15/5 heads: attention
   gathered, the FFN Megatron), ``granite-moe-3b-a800m`` cut to 2 (24/8
   heads: Megatron attention; the expert-parallel MoE with ZeRO-3
   experts), ``jamba-v0.1-52b`` cut to its first layer (a Mamba mixer
   with its dense FFN: each rank its half of ``d_inner``, ``in_proj``'s
   product moved by an all-to-all), ``rwkv6-7b`` cut to 2 (each rank
   32 of the 64 heads and half of d_ff), ``whisper-small`` cut to 2
   encoder and 2 decoder layers (Megatron self- and cross-attention and
   gelu MLP, the embedding and head cut by vocab), ``jpeg-resnet`` at
   batch 8,
   each against the same run on one rank (losses and gathered
   parameters); ``pipelined_apply`` over 4
   stages of one full-width ``smollm-360m`` layer each, 8 microbatches,
   against the stages run in turn.  Every rank must launch each
   workload's kernels.  Multi-device speed is not measured;
24. the dry-run (``launch/dryrun.py``): (a) the production cells of
   DRYRUN_CELLS traced with no card visible, one process a cell, each
   ``status ok``, its per-rank bytes printed against the card's 80 GB
   and its collective bytes by group (PERF.md holds the prediction), its
   kernel launch counts unchanged; (b) the same trace of phase 22's
   ``smollm-360m`` step on a world of one against that step run for real
   on the card over NCCL under the same counter and tracker: counted
   FLOPs and bytes within DRY_COUNT_RTOL, the predicted peak within
   DRY_PEAK_RTOL of the allocator's; (c) four ranks sharing the card over
   gloo (2 data × 2 model): ``smollm-360m`` at full width cut to
   SERVE4_LAYERS layers, fp32, prefill and decode over a sequence-sharded
   cache against one rank within SERVE4_RTOL, every rank launching the
   attention forward in prefill; then ``jamba-v0.1-52b`` and
   ``rwkv6-7b`` at full width cut to SSM4_LAYERS layers, fp32, each rank
   prefilling its row with its own slice of the Mamba and RWKV layers
   (logits and state slices against one rank's prefill within
   SERVE4_RTOL), then decoding on from those states, each rank stepping
   its own state slice, against one rank's decode within SERVE4_RTOL;
   then WIDE4_RUNS on the same ranks, each against one rank within
   SERVE4_RTOL and launching the attention forward in prefill:
   ``whisper-small`` at full width cut to 2 + 2 layers on 2 × 2 (the
   encoder over 1500 frames, then decode steps against its cross cache)
   and ``starcoder2-3b`` at full width cut to 2 layers on 1 × 4, whose
   ``model`` does not divide its 2 key/value heads: each rank's 6 query
   heads read a head of 128 columns that two ranks hold (prefill, then 4
   decode steps);
25. the paper's own formulation in ``core/``, fp32 with TF32 off, each
   card result against the same function on CPU copies (the plain
   versions): (a) Algorithm 1 at CIFAR size: ``explode_full`` (a 1.07 GB
   operator at stride 1) then ``apply_full`` on 8 images of 16 channels,
   32² pixels, a 16 → 16 3×3 kernel, strides 1 and 2, against
   ``jpeg_conv`` (the banded-conv kernel) and the spatial conv of the
   decoded images (the block transforms), within 1e-4 of the largest
   |output|; (b) ``jpeg_conv`` with a bias (the kernel's DC shift) against
   its plain version and the spatial conv with that bias; (c) the paper's
   Fig. 4a protocol on 65,536 box-upscaled random blocks: ASM's and APX's
   RMSE against the exact ReLU for φ = 1..14, ASM at most APX at every φ,
   both curves printed, each output within 1e-5 of the CPU's (an ASM mask
   may differ only where the approximation is within rounding of 0);
   (d) JPEG-scaled ASM (a q50 table) against decode → ReLU → encode and
   ``asm_piecewise(LEAKY_RELU)`` against leaky ReLU on the decoded pixels,
   at φ = 14; (e) ``jpeg_encode``/``jpeg_decode`` (q50, a caller's table),
   ``jpeg_round_trip_lossy`` within 1e-4 of the pixel range, and J at 16²
   against ``jpeg_encode``;
26. the port's six examples (``repro_torch.examples``, the reference's
   ``examples/`` scripts) on the card through their ``main``, at their
   defaults but ``train_e2e --steps 60`` and ``serve_qos --requests 32``
   (EXAMPLES), checkpoints in a temporary directory: each returns its own
   check passed (quickstart's JPEG logits within 1e-4 of the spatial ones
   with the same top-1, the restored plan's logits bit for bit, every
   request served, every healthy QoS request served, a falling loss for
   both trainers) and launches its kernels; each prints its seconds and
   device memory peak;
27. one ``{"kernels": [...]}`` line, with each kernel's launches in phases
   3, 4, 6-26 but 5 (each path driven with the counts set to 0 just
   before it and read just after), then the ``{"ok": true, ...}`` line
   last.  Its bounds and phase 9's roofline read one count of each
   kernel's work (``repro_torch.introspect.opcount``).  Every phase prints
   its seconds (phases 5-26 also their device memory peak), and the
   script its total.

It imports neither JAX nor the reference package, exits non-zero without
CUDA, and needs one card.
"""
import atexit
import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO_SRC = os.path.join(ROOT, "src")

BANDS, BATCH = 16, 4
#: the synthetic client's files, made once for every serving phase
CLIENT_IMAGES = 32
#: phase 7's plan: the widest budget at which stage 0's Ξ (64 → 64
#: channels, 9 block offsets: 36,864·b² elements) fits the materialise
#: limit of 64 Mi elements, so every tier fuses s0 and runs s1b0's
#: projection through jpeg_conv; at 48 or 64 bands every conv but the
#: stem is factored, and a tier keeps a factored layer factored
QOS_BANDS = 40
#: phase 7's bursts: pass 1, and the restart under a deadline (the chaos
#: pass takes the restart's size)
QOS_REQUESTS, QOS_RESTART_REQUESTS = 32, 48
#: the chaos pass: the reference's defaults (``serve --chaos``), and the
#: metrics snapshot interval
CHAOS_RATE, CHAOS_SEED, METRICS_INTERVAL = 0.2, 1234, 0.5
#: phase 8: images held spatial against JPEG, and the reference's
#: conversion contract (``convert_and_verify``'s ``atol``)
CONVERT_IMAGES, CONVERT_ATOL = 4, 1e-4
#: phase 8's autotune: client files in the probe, and the parity sweep's
#: own tolerance (``plan.autotune_bands``'s ``tol``)
AUTOTUNE_PROBE, AUTOTUNE_TOL = 4, 5e-2
#: phase 8's fold: ViT-B's patch and width; an exact fold, fp32 sums over
#: 768 terms, relative to the largest |value|
PATCH, PATCH_DIM, FOLD_RTOL = 16, 768, 1e-4
#: the training batch (the reference trainer's default)
TRAIN_BATCH = 8
#: kernel vs plain: fp32 sums in another order over up to 18,432 terms
CONV_RTOL = 1e-4
#: ASM: 64- and 128-term sums
ASM_RTOL = 2e-5
#: block DCT/IDCT: 64-term sums
BLOCK_RTOL = 1e-5
#: served logits vs the plain path, relative to the largest logit
LOGIT_RTOL = 1e-4
#: phase 9: per-step walls against the unprofiled wall (the reference's CI
#: bound), and the steps' counted FLOPs against one counted whole walk
RECONCILE_TOL, FLOPS_TOL = 0.10, 0.05
#: training step, kernel path vs plain path: the loss (relative), and each
#: gradient tensor by relative norm — fp32 sums in another order through
#: 20 layers, and ASM masks that may flip on pre-activations within
#: rounding of zero; a tensor may exceed TRAIN_GRAD_RTOL only within
#: TRAIN_FLOOR_FACTOR × the plain path's own change under rounding-level
#: input noise (see train_step_check)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_FLOOR_FACTOR = 10.0
#: flash attention against its plain version: fp32 absolute (the
#: reference's own test); bf16: the kernel's error against the plain
#: version on fp32 copies at most BF16_FACTOR × the bf16 plain version's
ATTN_ATOL = 2e-4
BF16_FACTOR = 1.5
#: LM serving (smollm-360m): batch, prompt tokens, decode steps, and the
#: fp32 kernel-vs-plain bound on logits and KV cache, relative to the
#: largest |value|
LM_ARCH, LM_BATCH, LM_PROMPT, LM_DECODE = "smollm-360m", 4, 2048, 32
LM_RTOL = 1e-3
#: phase 12's requests (the reference's default is 16)
LM_SERVE_REQUESTS = 8
#: phases 18-20's servers: one batch of 4 (the run's time is held near
#: what it was before them)
FAMILY_SERVE_REQUESTS = 4
#: the attention backward against its plain version in fp32, relative to
#: the largest |gradient|: sums of up to T terms in another order
ATTN_BWD_RTOL = 1e-4
#: phase 13 (a): the one-step check's depth cut (the plain path's dense
#: scores must fit) and batch; the loss's relative bound; each gradient
#: leaf's bound relative to its largest entry: max(floor, factor × the
#: plain path's own fp32-against-fp64 error)
LM_STEP_LAYERS, LM_STEP_BATCH = 4, 2
LM_LOSS_RTOL, LM_GRAD_FLOOR, LM_GRAD_FACTOR = 1e-5, 1e-4, 10.0
#: remat="full" against "none": the same ops, but the embedding's
#: backward may sum its rows in another order
LM_REMAT_RTOL = 1e-6
#: phase 13 (b): trainer steps, checkpoint interval, and the resumed
#: losses' relative bound against the straight run
LM_TRAIN_STEPS, LM_CKPT_EVERY, LM_RESUME_RTOL = 4, 2, 1e-5
#: phases 14-17, the MoE and Mamba-hybrid LMs: granite-moe-3b-a800m at full
#: width and depth (LM_BATCH prompts of LM_PROMPT tokens, LM_DECODE steps)
#: and its gradient at LM_STEP_LAYERS layers; mixtral-8x7b at full width
#: cut to MIXTRAL_LAYERS layers (the whole model, ~93 GB in bf16, does not
#: fit), one prompt longer than its 4096 window and not a multiple of it;
#: jamba-v0.1-52b at full width cut to JAMBA_LAYERS layers, one period of
#: its pattern (attention at layer 4, MoE at the odd layers)
MOE_ARCH = "granite-moe-3b-a800m"
MIXTRAL_LAYERS, MIXTRAL_PROMPT, MIXTRAL_DECODE = 2, 4608, 16
JAMBA_LAYERS, JAMBA_PROMPT, JAMBA_DECODE = 8, 2048, 16
#: the MoE FFN's profiler ranges (src/repro_torch/models/moe.py)
MOE_RANGES = ("moe_route", "moe_experts", "moe_combine")
#: phases 18-21, the RWKV, VLM and audio families at full width and depth:
#: rwkv6-7b's RWKV_DECODE teacher-forced steps after LM_PROMPT tokens (the
#: forward over both ends in a ragged chunk); internvl2-1b's vision prefix
#: from one VLM_IMAGE² image a prompt (256 patches of PATCH), its logits
#: on the JPEG-domain prefix against the pixel one within VLM_FOLD_RTOL
#: (the reference's integration test); whisper-small's encoder over
#: WHISPER_FRAMES frames and WHISPER_TOKENS decoder tokens (its published
#: max_target_positions)
RWKV_ARCH, VLM_ARCH, AUDIO_ARCH = "rwkv6-7b", "internvl2-1b", "whisper-small"
RWKV_DECODE = 33
#: phase 18's bf16 gates, each the chunked scan's logits against fp32 at
#: most BF16_FACTOR × the plain scan's (relative norms): the full depth
#: over the first RWKV_GATE_TOKENS tokens, and the first RWKV_GATE_LAYERS
#: layers over the whole prompt (where the drift is not saturated);
#: phase 21's plain-scan floor is taken over RWKV_FLOOR_SEQ tokens
RWKV_GATE_TOKENS, RWKV_GATE_LAYERS, RWKV_FLOOR_SEQ = 256, 4, 512
VLM_IMAGE, VLM_FOLD_RTOL = 256, 1e-3
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
#: the RWKV time mix's profiler range (src/repro_torch/models/rwkv.py)
RWKV_RANGES = ("rwkv_wkv",)
#: a routing choice that differs between two fp32 paths must sit at a
#: near-tie: the plain path's k-th and (k+1)-th router probabilities
#: closer than this (fp32 noise moves them ~1e-7; typical gaps are ~1e-2)
FLIP_GAP = 1e-4
#: phases 22-23, training on a mesh.  Phase 22, a world of one over NCCL:
#: smollm-360m at full width and depth, bf16, MESH_BATCH × MESH_SEQ,
#: grad_accum MESH_ACCUM, ZeRO-1, remat full, MESH_STEPS steps a
#: compression, AdamW at a constant MESH_LR; the MoE's expert-parallel
#: logits against its global path's, relative to the largest |logit|.
MESH_BATCH, MESH_SEQ, MESH_ACCUM, MESH_STEPS, MESH_LR = 8, 2048, 4, 4, 1e-4
MESH_MOE_RTOL = 1e-5
#: phase 23, four ranks sharing the card (2 data × 2 model, gloo):
#: MESH4_BATCH × MESH4_SEQ (one row a data rank a microbatch), MESH4_STEPS
#: steps, the depth cuts, the MoE's capacity factor (no shard drops, so
#: one rank runs the same computation; the CPU tests hold the drops), and
#: AdamW's eps at MESH_EPS (at 1e-8 a near-zero gradient's rounding moves
#: its weight by up to the rate).  Each run against one rank: losses
#: MESH_LOSS_RTOL relative, each parameter leaf after the steps
#: MESH_PARAM_RTOL of its largest |value| (fp32 sums in another order);
#: jpeg-resnet's update by relative norm under phase 5's rule (its ASM
#: masks flip within rounding: at most TRAIN_GRAD_RTOL or
#: TRAIN_FLOOR_FACTOR × its own change under a 1e-6 nudge of the batch);
#: the pipeline (PP_STAGES stages of one full-width layer, PP_MICRO
#: microbatches of PP_MB × PP_SEQ) MESH_PIPE_RTOL of the largest |value|.
MESH4_BATCH, MESH4_SEQ, MESH4_ACCUM, MESH4_STEPS = 4, 512, 2, 2
MESH4_SMOLLM_LAYERS, MESH4_GRANITE_LAYERS, MESH4_MOE_CF = 4, 2, 5.0
#: phase 23's Mamba and RWKV runs at full width, each cut to its depth.
#: A leaf drawn at zero holds only AdamW's updates after the steps: their
#: fp32 rounding, over ``eps``, is 1e-5 to 4e-5 of its largest |value|
#: whatever the layout (RWKV's ``ln_b`` at d 1024 on the CPU: 3.4e-5 on 4
#: data ranks with no model cut; at full width on 2 × 2 on the card,
#: 3.2e-5), so such leaves start at MESH4_OFF_ZERO × N(0, 1)
MESH4_SSM_LAYERS = (("jamba-v0.1-52b", 1), ("rwkv6-7b", 2))
#: phase 23's whisper-small run at full width, cut to this many encoder
#: and decoder layers (12 heads and d_ff 3072 over 2 model ranks: the
#: Megatron split of its self- and cross-attention and gelu MLP; the
#: frames zero, as the trainer feeds them)
MESH4_WHISPER_LAYERS = 2
MESH4_OFF_ZERO = 0.1
MESH_EPS, MESH_LOSS_RTOL, MESH_PARAM_RTOL, MESH_PIPE_RTOL = \
    1e-3, 1e-5, 1e-5, 1e-6
PP_STAGES, PP_MICRO, PP_MB, PP_SEQ = 4, 8, 1, 512
JPEG_KERNELS = ("fused_block", "jpeg_conv", "asm_relu", "block_dct",
                "block_idct")
KERNELS = JPEG_KERNELS + ("flash_attention", "flash_attention_bwd")
#: the kernels each of phase 23's workloads must launch on every rank
#: (the Mamba layer and RWKV run no hand-written kernel: their scans are
#: torch ops, as the reference's are jnp)
MESH4_KERNELS = {
    "smollm-360m": ("flash_attention", "flash_attention_bwd"),
    "granite-moe-3b-a800m": ("flash_attention", "flash_attention_bwd"),
    "jamba-v0.1-52b": (), "rwkv6-7b": (),
    "whisper-small": ("flash_attention", "flash_attention_bwd"),
    "jpeg-resnet": ("jpeg_conv", "asm_relu", "block_dct", "block_idct"),
    "pipeline": ("flash_attention",)}
#: phase 23's training runs, in order
MESH4_RUNS = tuple(k for k in MESH4_KERNELS if k != "pipeline")
#: phase 24 (a): production cells traced with no card (arch, shape, mesh)
DRYRUN_CELLS = (("smollm-360m", "train_4k", "single"),
                ("mixtral-8x7b", "decode_32k", "single"),
                ("jamba-v0.1-52b", "long_500k", "multi"),
                ("jpeg-resnet", "train_4k", "single"),
                ("rwkv6-7b", "prefill_32k", "single"),
                # microbatches of 16 rows over 2 × 16 batch ranks
                ("jamba-v0.1-52b", "train_4k", "multi"))
#: phase 24 (b): the trace against the real step on a world of one:
#: counted FLOPs and bytes, and the predicted peak against the allocator's
DRY_COUNT_RTOL, DRY_PEAK_RTOL = 0.005, 0.10
CARD_BYTES = 80e9
#: phase 24 (c): smollm-360m at full width cut to SERVE4_LAYERS layers,
#: fp32, a prompt of SERVE4_BATCH × SERVE4_PROMPT tokens, then
#: SERVE4_DECODE steps into a cache of SERVE4_SLOTS slots
SERVE4_LAYERS, SERVE4_BATCH, SERVE4_PROMPT, SERVE4_SLOTS, SERVE4_DECODE = \
    4, 2, 512, 1024, 8
SERVE4_RTOL = 1e-5
#: phase 24 (c)'s sliced Mamba and RWKV prefill and decode: each arch at
#: full width cut to SSM4_LAYERS layers (jamba's two are Mamba mixers, the
#: second with its MoE FFN at capacity factor SSM4_CAPACITY, so neither a
#: shard nor one rank drops a token), fp32, SERVE4_BATCH prompts of
#: SSM4_PROMPT tokens prefilled on four ranks, then SSM4_DECODE steps on
#: from those states, each against one rank within SERVE4_RTOL
SSM4_ARCHS = ("jamba-v0.1-52b", "rwkv6-7b")
SSM4_LAYERS, SSM4_PROMPT, SSM4_DECODE, SSM4_CAPACITY = 2, 512, 2, 8.0
#: phase 24 (c)'s model-axis runs on the same four ranks, each at full
#: width cut to WIDE4_LAYERS layers (whisper's: encoder and decoder
#: layers each), fp32, against one rank within SERVE4_RTOL:
#: ``whisper-small`` on 2 × 2 (the encoder over SERVE4_BATCH × 1500
#: frames as its prefill, then WIDE4_DECODE steps against the cross cache
#: of its output), and ``starcoder2-3b`` on 1 × 4, where ``model`` does
#: not divide its 2 key/value heads (each rank's 6 query heads read a
#: head of 128 columns that two ranks hold): a prefill of SERVE4_BATCH ×
#: SERVE4_PROMPT, then WIDE4_DECODE steps
WIDE4_RUNS = ((AUDIO_ARCH, (2, 2)), ("starcoder2-3b", (1, 4)))
WIDE4_LAYERS, WIDE4_DECODE = 2, 4
WIDE4_HELD = ("prefill_out", "prefill_cache", "decode_logits",
              "decode_cache")
#: phase 25: Algorithm 1 at CIFAR size (PAPER_BATCH images of PAPER_CH
#: channels, PAPER_IMAGE² pixels, a PAPER_CH → PAPER_CH 3×3 kernel: a 1.07
#: GB operator at stride 1) and Fig. 4a's PAPER_BLOCKS blocks; the convs
#: within PAPER_RTOL, ASM within PAPER_ASM_RTOL of the largest |value|,
#: and an ASM mask may differ from the CPU's only where the approximation
#: is within PAPER_TIE of the largest |approximation| from 0
PAPER_BATCH, PAPER_CH, PAPER_IMAGE, PAPER_BLOCKS = 8, 16, 32, 65536
PAPER_RTOL, PAPER_ASM_RTOL, PAPER_TIE = 1e-4, 1e-5, 1e-5
#: phase 26: the port's six examples (``repro_torch.examples``) through
#: their ``main``, at their defaults but these flags, each with the kernels
#: it must launch
EXAMPLES = (
    ("quickstart", (), ("jpeg_conv", "asm_relu", "block_dct",
                        "block_idct")),
    ("convert_pretrained", (), ("jpeg_conv", "asm_relu", "block_dct",
                                "block_idct")),
    ("serve_jpeg", (), JPEG_KERNELS),
    ("serve_qos", ("--requests", "32"), JPEG_KERNELS),
    ("train_e2e", ("--steps", "60"), ("jpeg_conv", "asm_relu", "block_dct",
                                      "block_idct")),
    ("lm_train", (), ("flash_attention", "flash_attention_bwd")))
#: the attention cases of phase 2, forward and backward: label, b, s, t,
#: h, kvh, hd, causal, window, bf16 (else fp32)
ATTN_CASES = (
    ("smollm-360m prefill bf16", 4, 2048, 2048, 15, 5, 64, True, None,
     True),
    ("smollm-360m prefill fp32", 4, 2048, 2048, 15, 5, 64, True, None,
     False),
    ("mistral-nemo-12b heads bf16 (plain: chunked)", 1, 4096, 4096, 32, 8,
     128, True, None, True),
    ("window 256 bf16", 2, 1000, 1000, 15, 5, 64, True, 256, True),
    ("window 256 fp32", 2, 1000, 1000, 15, 5, 64, True, 256, False),
    ("not causal, S != T, bf16", 2, 300, 1000, 24, 2, 128, False, None,
     True),
    ("not causal, S != T, fp32", 2, 300, 1000, 24, 2, 128, False, None,
     False),
    ("granite-moe-3b-a800m prefill bf16", 4, 2048, 2048, 24, 8, 64, True,
     None, True),
    ("mixtral-8x7b window 4096 bf16 (plain: chunked)", 1, 4608, 4608, 32, 8,
     128, True, 4096, True),
    ("whisper-small encoder bf16", 4, 1500, 1500, 12, 12, 64, False, None,
     True),
    ("whisper-small encoder fp32", 4, 1500, 1500, 12, 12, 64, False, None,
     False),
    ("whisper-small cross-attention bf16", 4, 448, 1500, 12, 12, 64, False,
     None, True),
    ("internvl2-1b prefill bf16 (G = 7)", 4, 2048, 2048, 14, 2, 64, True,
     None, True),
)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with seconds since the start."""
    print(f"[chip_smoke {time.perf_counter() - _T0:6.1f}s] {msg}",
          flush=True)


def cuda_ms(fn, reps: int = 10, trials: int = 3, warmup: int = 2) -> float:
    """Device time of one call of ``fn``: CUDA events around ``reps``
    back-to-back calls, so the host's dispatch overlaps the device's work;
    the median of ``trials`` such runs, over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


#: device kernels of csrc/, longest name first (one contains another)
DEVICE_KERNELS = ("flash_attention_tc_kernel", "flash_attention_kernel",
                  "attn_bwd_preprocess_kernel", "attn_bwd_dkdv_tc_kernel",
                  "attn_bwd_dq_tc_kernel", "attn_bwd_dkdv_kernel",
                  "attn_bwd_dq_kernel", "banded_conv_kernel",
                  "block_matmul_kernel", "asm_kernel")
#: the bf16 attention backward's kernels (tensor cores) and the fp32 ones
#: (FFMA), which a bf16 step must never launch
BWD_TC_KERNELS = ("attn_bwd_preprocess_kernel", "attn_bwd_dkdv_tc_kernel",
                  "attn_bwd_dq_tc_kernel")
BWD_FFMA_KERNELS = ("attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel")


def ptxas_report(text: str) -> list[str]:
    """One line per compiled kernel from ``nvcc -Xptxas -v``: registers,
    static shared memory and spills (dynamic shared memory is set at
    launch: ``conv_smem_bytes`` and the kernels' own formulas)."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = next((k for k in DEVICE_KERNELS if k in mangled), mangled)
            args = re.search(base + r"I(\w+?)E(?:v|P|S|i|f)", mangled)
            targs = re.findall(r"L[ib](\d+)E|(f|13__nv_bfloat16)",
                               args.group(1)) if args else []
            names = [n or ("bf16" if "bfloat" in t else "float")
                     for n, t in targs]
            name = base + (f"<{', '.join(names)}>" if names else "")
            spill = ""
        elif "spill" in line:
            spill = line.split(":", 1)[-1].strip() if ":" in line \
                else line.strip()
        elif "Used" in line and name:
            used = line.split("Used", 1)[1].strip()
            out.append(f"{name}: used {used}; {spill}")
            name = None
    return out


def split_cost(label: str, fn, kernel: str, calls: int = 50) -> None:
    """Tell a wrapper's fixed cost from its kernel's time: the kernel's
    device time a launch from a ``torch.profiler`` trace of ``calls``
    calls, the events' time a call (``cuda_ms``), and the host's time to
    issue one call (wall clock around ``calls`` calls, no synchronise
    inside)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    event_ms = cuda_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and kernel in e.key:
            total += next((v for v in (getattr(e, a, 0) for a in (
                "self_device_time_total", "device_time_total",
                "self_cuda_time_total", "cuda_time_total")) if v), 0.0)
            n += e.count
    device = f"{total / n / 1e3:.4f} ms" if n else "not measured"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    log(f"{label}: kernel device time {device} a launch ({n} launches "
        f"traced), events {event_ms:.4f} ms a call, host {host_ms:.4f} ms "
        f"to issue a call")


def compare(name: str, got, want, rtol: float) -> float:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} "
             f"or non-finite output")
    err = float((got - want).abs().max())
    tol = rtol * max(1.0, float(want.abs().max()))
    if not err <= tol:
        fail(f"{name}: max abs err {err:.3e} > tolerance {tol:.3e}")
    return err


def counts() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    from repro_torch import kernels

    return kernels.launch_counts()


def reset_counts() -> None:
    from repro_torch import kernels

    kernels.set_launch_counts({k: 0 for k in kernels.launch_counts()})


def drive(path: str, required, launches: dict, fn, replayed=None):
    """Run one path of the port with the counts set to 0 just before it,
    add its counts to ``launches`` and fail if a kernel in ``required``
    was not launched.  ``replayed(out)`` adds the launches that CUDA graph
    replays made, which the wrappers' counters do not see."""
    reset_counts()
    out = fn()
    got = counts()
    for k, v in (replayed(out) if replayed else {}).items():
        got[k] += v
    for k, v in got.items():
        launches[k] += v
    missing = [k for k in required if got[k] <= 0]
    if missing:
        fail(f"{path}: kernels {missing} were never launched ({got})")
    log(f"{path}: launches {got}")
    return out


def hold_logits(phase: str, seen, classes: int, plain_fn):
    """Hold every served batch's logits against ``plain_fn`` on the same
    input; returns the errors and the top-1 agreement (fails below 1.0)."""
    import torch

    errs, agree, n = [], 0, 0
    with torch.inference_mode():
        for x, lg in seen:
            ref = plain_fn(x)
            if lg.shape != (lg.shape[0], classes):
                fail(f"{phase}: logits shape {tuple(lg.shape)}")
            errs.append(compare(f"{phase} logits", lg, ref, LOGIT_RTOL))
            agree += int((lg.argmax(-1) == ref.argmax(-1)).sum())
            n += lg.shape[0]
    top1 = agree / n
    if top1 != 1.0:
        fail(f"{phase}: top-1 agreement {top1} < 1.0")
    return errs, top1


def train_step_check(cfg, dev) -> None:
    """Phase 5: one full-width step's loss and gradients, kernel path
    against plain path, from the same weights and batch.

    Every ReLU's gradient is a 0/1 mask, so a pre-activation within
    rounding of zero passes its gradient on one path and not on the other;
    a batch-norm vector's gradient sums ~500k such terms per channel with
    much cancellation.  So beside the kernel-vs-plain error the phase
    measures the plain path's own sensitivity: the same step on the batch
    times (1 + 1e-6·noise), rounding-level.  A gradient tensor fails if
    its kernel-vs-plain error exceeds both ``TRAIN_GRAD_RTOL`` and
    ``TRAIN_FLOOR_FACTOR`` times that floor."""
    import torch

    from repro_torch.core import dispatch as dsp
    from repro_torch.data.pipeline import jpeg_iterator
    from repro_torch.models.registry import build_model
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths

    kernel_model = build_model(cfg)
    plain_model = build_model(
        cfg, dispatch=dsp.DispatchConfig(path="reference"))
    bundle = kernel_model.init_params(torch.Generator().manual_seed(0), dev)
    batch = next(jpeg_iterator(0, TRAIN_BATCH, cfg.image_size,
                               cfg.in_channels, cfg.num_classes, device=dev))
    coef = batch["coefficients"]
    noise = torch.randn(coef.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    nudged = dict(batch, coefficients=coef * (1 + 1e-6 * noise))
    out = {}
    for name, model, b in (("kernel", kernel_model, batch),
                           ("plain", plain_model, batch),
                           ("plain, nudged batch", plain_model, nudged)):
        def step():
            return value_and_grad(lambda p, bt: model.loss_fn(p, bt)[0],
                                  bundle, b)
        step()  # warm-up: allocator and cuDNN's choices
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        out[name] = (float(loss), grads, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2 ** 30)
    (lk, gk, tk, mk), (lp, gp, tp, mp), (_, gq, _, _) = out.values()
    if not (abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp) and lk == lk):
        fail(f"training step: loss {lk} (kernel path) vs {lp} (plain)")

    def rel(a, b):
        nb = float(b.norm())
        return float((a - b).norm()) / nb if nb else float(a.norm())

    worst = (0.0, 0.0, "")
    worst_floor = (0.0, "")
    for (path, a), (_, b), (_, q) in zip(leaves_with_paths(gk),
                                         leaves_with_paths(gp),
                                         leaves_with_paths(gq)):
        if not bool(torch.isfinite(a).all()):
            fail(f"training step: non-finite gradient at {path}")
        err, floor = rel(a, b), rel(q, b)
        if err > max(TRAIN_GRAD_RTOL, TRAIN_FLOOR_FACTOR * floor):
            fail(f"training step: gradient at {path} differs by {err:.3e} "
                 f"relative norm (> {TRAIN_GRAD_RTOL} and > "
                 f"{TRAIN_FLOOR_FACTOR} × the plain path's own "
                 f"{floor:.3e})")
        worst = max(worst, (err, floor, path))
        worst_floor = max(worst_floor, (floor, path))
    log(f"training step, full width, batch {TRAIN_BATCH}: loss {lk:.6f} "
        f"(kernel) vs {lp:.6f} (plain); worst gradient relative-norm error "
        f"{worst[0]:.3e} at {worst[2]} (plain path's own floor there "
        f"{worst[1]:.3e}; largest floor {worst_floor[0]:.3e} at "
        f"{worst_floor[1]}); value_and_grad {tk * 1e3:.1f} ms kernel path, "
        f"{tp * 1e3:.1f} ms plain path; peak memory {mk:.2f} / {mp:.2f} GiB")
    del out, gk, gp, gq
    profile_step("training step (kernel path)", lambda: value_and_grad(
        lambda p, bt: kernel_model.loss_fn(p, bt)[0], bundle, batch))
    torch.cuda.empty_cache()


#: device kernels grouped by name, for the training step's breakdown
#: (first match wins; cuDNN's FFT engine runs complex GEMMs and FFTs)
KERNEL_GROUPS = (("attention backward dK/dV", ("attn_bwd_dkdv",)),
                 ("attention backward dQ", ("attn_bwd_dq",)),
                 ("attention backward D", ("attn_bwd_preprocess",)),
                 ("flash attention kernels", ("flash_attention",)),
                 ("block transforms", ("block_matmul_kernel",)),
                 ("ASM kernel", ("asm_kernel",)),
                 ("jpeg_conv kernel", ("banded_conv_kernel",)),
                 ("cuDNN conv", ("cudnn", "implicit_gemm", "fprop", "dgrad",
                                 "wgrad", "fft", "cf32", "complex")),
                 ("cuBLAS GEMM", ("gemm", "cutlass", "nvjet", "xmma")),
                 ("elementwise, copies, reductions",
                  ("elementwise", "copy", "reduce", "vectorized")))


def profile_step(label: str, step, ranges=()
                 ) -> tuple[dict[str, int], dict[str, float]]:
    """Device time of one call of ``step`` by kernel group, from a
    ``torch.profiler`` trace, and the device's idle share of its wall;
    prints "not measured" where the trace has no device time.  With
    ``ranges`` (``record_function`` names) also the device time inside
    each, the flash-attention kernels' and the rest.  Returns each device
    kernel's launches and device µs in the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel: dict[str, float] = {}
    calls: dict[str, int] = {}
    span = {r: 0.0 for r in ranges}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = next((v for v in (getattr(e, a, 0) for a in (
            "self_device_time_total", "device_time_total",
            "self_cuda_time_total", "cuda_time_total")) if v), 0.0)
        if e.key in MOE_RANGES + RWKV_RANGES \
                or getattr(e, "is_user_annotation", False):
            if e.key in span:  # a range's extent on the device, not a kernel
                span[e.key] += t
            continue
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t
        calls[e.key] = calls.get(e.key, 0) + e.count
    def group(name: str) -> str:
        low = name.lower()
        return next((g for g, keys in KERNEL_GROUPS
                     if any(k in low for k in keys)), "other")

    # the kernels each range launched: up each launching op's parents
    in_range = {r: 0.0 for r in ranges}
    gemm_in_range = 0.0
    for ev in prof.events() if ranges else ():
        kernels = getattr(ev, "kernels", None)
        up = ev
        while kernels and up is not None and up.name not in in_range:
            up = up.cpu_parent
        if kernels and up is not None:
            in_range[up.name] += sum(k.duration for k in kernels)
            gemm_in_range += sum(k.duration for k in kernels
                                 if group(k.name) == "cuBLAS GEMM")
    busy = sum(per_kernel.values())
    if busy <= 0:
        log(f"{label} profile: device time not measured (the trace holds "
            f"no device events)")
        return calls, per_kernel
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for name, t in per_kernel.items():
        groups[group(name)] += t
    log(f"{label} profile (torch.profiler): wall "
        f"{wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, idle "
        f"share {max(0.0, 1 - busy / wall_us):.3f}; by group (ms, share of "
        f"busy): " + ", ".join(f"{g} {t / 1e3:.2f} ({t / busy:.3f})"
                               for g, t in groups.items()))
    if ranges:
        attn = sum(t for name, t in per_kernel.items()
                   if "flash_attention" in name)
        rest = busy - attn - sum(in_range.values())
        products = groups["cuBLAS GEMM"] - gemm_in_range
        log(f"{label} split (ms of kernel time, share of busy; the range's "
            f"extent on the device in brackets): "
            + ", ".join(f"{r} {t / 1e3:.2f} ({t / busy:.3f}) "
                        f"[{span[r] / 1e3:.2f}]" for r, t in in_range.items())
            + f", flash attention {attn / 1e3:.2f} ({attn / busy:.3f}), "
            f"the rest {rest / 1e3:.2f} ({rest / busy:.3f}): its dense "
            f"products {products / 1e3:.2f} ({products / busy:.3f}), "
            f"norms and elementwise {(rest - products) / 1e3:.2f}"
            + ("" if all(in_range.values()) else
               "; a range with 0 ms: its kernel time not measured"))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, t in top:
        log(f"  {t / 1e3:8.3f} ms  {name[:110]}")
    return calls, per_kernel


def train_and_serve(cfg, dev, ckpt_dir: str, launches: dict,
                    jpeg_dir: str) -> None:
    """Phase 6: ``train_loop`` at full width, then one batch served from
    the exported plan through the compiled path."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.launch import serve, train

    args = train.parse_args(
        ["--arch", "jpeg-resnet", "--steps", "4", "--batch",
         str(TRAIN_BATCH), "--ckpt-every", "2", "--log-every", "1",
         "--ckpt-dir", ckpt_dir, "--seed", "0"])
    result = drive("train", ("jpeg_conv", "asm_relu", "block_dct",
                             "block_idct"), launches,
                   lambda: train.train_loop(args))
    losses = [v for _, v in result["losses"]]
    if len(losses) != 4 or not all(v == v and abs(v) < 1e30
                                   for v in losses):
        fail(f"train: losses {losses}")
    steps = CheckpointManager(ckpt_dir).steps()
    if steps != [2, 4]:
        fail(f"train: checkpoints {steps}, want [2, 4]")
    step_ms = [t * 1e3 for t in result["step_s"]]
    steady = statistics.median(step_ms[1:])
    data_ms = [t * 1e3 for t in result["data_s"]]
    log(f"train: full jpeg-resnet, batch {TRAIN_BATCH}, 64 bands: step ms "
        f"{[round(t, 1) for t in step_ms]} (first includes warm-up), "
        f"median after the first {steady:.1f} ms = "
        f"{TRAIN_BATCH / steady * 1e3:.1f} images/s, of which the batch "
        f"(host synthesis, device encode) {[round(t, 1) for t in data_ms]} "
        f"ms; losses {losses}; "
        f"loop wall {result['wall_s']:.2f} s incl. checkpoints and export; "
        f"checkpoints {steps}; plan -> {result['plan_dir']}")

    plan = planlib.load_plan(result["plan_dir"], device=dev)
    cp = planlib.load_compiled_plan(
        os.path.join(result["plan_dir"], "compiled"), device=dev)
    sargs = serve.parse_args(["--arch", "jpeg-resnet", "--ingest", "bytes",
                              "--batch",
                              str(TRAIN_BATCH), "--requests",
                              str(TRAIN_BATCH), "--max-new", "1",
                              "--jpeg-dir", jpeg_dir, "--seed", "1"])
    seen = []
    info = {"bands": plan.bands, "compiled": True, "path": cp.meta["path"]}
    report = drive(
        "serve exported plan", ("asm_relu", "block_dct", "block_idct"),
        launches,
        lambda: serve.serve_jpeg_resnet(
            sargs, prepared=(plan, cp, info),
            on_batch=lambda x, lg: seen.append((x.clone(), lg.clone()))))
    ref_cfg = dsp.DispatchConfig(path="reference")
    errs, top1 = hold_logits(
        "exported plan", seen, cfg.num_classes,
        lambda x: planlib.apply_compiled_packed(cp, x, ref_cfg))
    log(f"exported plan (step {result['final_step']}): served "
        f"{report['images']} images in {report['batches']} batch, forward "
        f"{report['forward_s'] * 1e3:.1f} ms; logits vs plain path: max abs "
        f"err {max(errs):.3e}, top-1 agreement {top1}")
    del plan, cp
    torch.cuda.empty_cache()


def attention_checks(dev, record) -> None:
    """Phase 2, flash attention: the kernel against its plain version at
    the LM path's shapes and the mask cases; library_ms is SDPA (GQA,
    causal flag or a boolean mask for the window).  The training forward
    (which also writes lse and, in bf16, the output's rounding residual)
    is timed beside the serving one."""
    import torch
    import torch.nn.functional as F

    from repro_torch.introspect.opcount import PEAK_BF16_FLOPS, \
        PEAK_FP32_FLOPS, attention_pairs, attention_work
    from repro_torch.kernels import flash_attention as kfa

    bf16, fp32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, b, s, t, h, kvh, hd, causal, window, is16 in ATTN_CASES:
        dtype = bf16 if is16 else fp32
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, t, kvh, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, t, kvh, hd), generator=gen, device=dev).to(dtype)
        kw = dict(causal=causal, window=window)
        got = kfa.flash_attention(q, k, v, **kw)
        exact = kfa.attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != dtype \
                or not bool(torch.isfinite(got).all()):
            fail(f"flash_attention {label}: shape {tuple(got.shape)}, "
                 f"dtype {got.dtype} or non-finite output")
        err = float((got.float() - exact).abs().max())
        if dtype == fp32:
            tol = ATTN_ATOL
        else:
            plain = kfa.attention_plain(q, k, v, **kw).float()
            tol = BF16_FACTOR * float((plain - exact).abs().max())
            del plain
        if not err <= tol:
            fail(f"flash_attention {label}: max abs err {err:.3e} > "
                 f"tolerance {tol:.3e}")
        del got, exact
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = sdpa_mask(s, t, causal, window, dev)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        work = attention_work(b, h, hd,
                              attention_pairs(s, t, causal, window),
                              q.element_size(), q.numel(), k.numel())
        serve_ms = cuda_ms(lambda: kfa.flash_attention(q, k, v, **kw))
        train_ms = cuda_ms(lambda: kfa.flash_attention_lse(q, k, v, **kw))
        log(f"flash_attention {label}: serving forward {serve_ms:.4f} ms, "
            f"training forward (lse{', out_lo' if is16 else ''}) "
            f"{train_ms:.4f} ms")
        record("flash_attention",
               f"{label} q{tuple(q.shape)} kv{tuple(k.shape)} (tol "
               f"{tol:.2e})", err, serve_ms,
               cuda_ms(lambda: kfa.attention_plain(q, k, v, **kw), reps=3),
               work, cuda_ms(library),
               PEAK_BF16_FLOPS if dtype == bf16 else PEAK_FP32_FLOPS)
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()


def sdpa_mask(s: int, t: int, causal: bool, window, dev):
    """SDPA's boolean mask for a window (None otherwise: the causal flag
    or no mask)."""
    import torch

    if window is None:
        return None
    qpos = torch.arange(s, device=dev)[:, None]
    kpos = torch.arange(t, device=dev)[None, :]
    return (kpos > qpos - window) & (kpos <= qpos if causal else True)


def attention_backward_checks(dev, record) -> None:
    """Phase 2, the attention backward kernels at the forward's cases: dq,
    dk and dv from ``flash_attention_backward`` (fed by the kernel's own
    forward and lse) against ``attention_backward_plain`` fed by an fp32
    ``attention_lse_plain`` on fp32 copies.  fp32: within
    ``ATTN_BWD_RTOL`` of the largest |gradient|; bf16: at most
    ``BF16_FACTOR`` × the error of the plain backward run from the bf16
    inputs and their bf16 plain forward.  library_ms is SDPA's backward
    through autograd (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.introspect.opcount import PEAK_BF16_FLOPS, \
        PEAK_FP32_FLOPS, attention_bwd_work, attention_pairs
    from repro_torch.kernels import flash_attention as kfa

    gen = torch.Generator(device=dev).manual_seed(4)
    for label, b, s, t, h, kvh, hd, causal, window, is16 in ATTN_CASES:
        dtype = torch.bfloat16 if is16 else torch.float32
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                       for shape in ((b, s, h, hd), (b, t, kvh, hd),
                                     (b, t, kvh, hd), (b, s, h, hd)))
        kw = dict(causal=causal, window=window)
        out, lse, lo = kfa.flash_attention_lse(q, k, v, **kw)

        def kernel():
            return kfa.flash_attention_backward(q, k, v, out, do, lse,
                                                out_lo=lo, **kw)

        got = kernel()
        f32 = [x.float() for x in (q, k, v, do)]
        o32, l32 = kfa.attention_lse_plain(*f32[:3], **kw)
        exact = kfa.attention_backward_plain(*f32[:3], o32, f32[3], l32,
                                             **kw)
        del o32, l32
        o_p, l_p = kfa.attention_lse_plain(q, k, v, **kw)

        def plain():
            return kfa.attention_backward_plain(q, k, v, o_p, do, l_p, **kw)

        torch.cuda.synchronize()
        errs, tols = [], []
        for name, g, want, p in zip("qkv", got, exact,
                                    plain() if is16 else exact):
            if g.shape != want.shape or g.dtype != dtype \
                    or not bool(torch.isfinite(g).all()):
                fail(f"flash_attention backward {label}: d{name} shape "
                     f"{tuple(g.shape)}, dtype {g.dtype} or non-finite")
            err = float((g.float() - want).abs().max())
            tol = BF16_FACTOR * float((p.float() - want).abs().max()) \
                if is16 else ATTN_BWD_RTOL * float(want.abs().max())
            if not err <= tol:
                fail(f"flash_attention backward {label}: d{name} max abs "
                     f"err {err:.3e} > tolerance {tol:.3e}")
            errs.append(err)
            tols.append(tol)
        del got, exact, f32
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=sdpa_mask(s, t, causal, window, dev),
            is_causal=causal and window is None, enable_gqa=True)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, leaves, dot,
                                       retain_graph=True)

        work = attention_bwd_work(b, h, hd,
                                  attention_pairs(s, t, causal, window),
                                  q.element_size(), q.numel(), k.numel(),
                                  lse.numel())
        record("flash_attention_bwd",
               f"{label} q{tuple(q.shape)} kv{tuple(k.shape)} (dq, dk, dv "
               f"errs {', '.join(f'{e:.2e}' for e in errs)}; tols "
               f"{', '.join(f'{x:.2e}' for x in tols)})", max(errs),
               cuda_ms(kernel), cuda_ms(plain, reps=3), work,
               cuda_ms(library), PEAK_BF16_FLOPS if is16 else PEAK_FP32_FLOPS)
        del q, k, v, do, out, lse, lo, o_p, l_p, leaves, lib_out, dot
        torch.cuda.empty_cache()


def logged_routing(log: list, force: list | None = None):
    """A context in which every MoE call appends its routing to ``log``:
    each token's top-k experts as a sorted set (T, k), which of them kept
    a slot (T, k), and the gap between its k-th and (k+1)-th router
    probability (T,).  With ``force`` (another run's log) each call routes
    every token to the experts the same call chose there, weighted by its
    own probabilities.  It wraps ``models.moe._routing``, which
    ``moe_ffn`` looks up at each call."""
    import torch

    from repro_torch.models import moe

    real = moe._routing

    def routing(probs, cfg, cap):
        k = cfg.experts_per_token
        vals = torch.sort(probs, dim=-1, descending=True).values
        gap = vals[:, k - 1] - vals[:, k]
        own = probs
        if force is not None:  # the chosen set ranks first, in own order
            probs = probs + torch.zeros_like(probs).scatter_(
                1, force[len(log)][0], 2.0)
        out = real(probs, cfg, cap)
        idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1]
        if force is not None:
            w = own.gather(1, idx[:, :k])
            out = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9),) \
                + out[1:]
        order = idx[:, :k].argsort(-1)
        kept = out[2] < cfg.n_experts * cap
        log.append((idx[:, :k].gather(-1, order), kept.gather(-1, order),
                    gap.detach()))
        return out

    @contextlib.contextmanager
    def patched():
        moe._routing = routing
        try:
            yield
        finally:
            moe._routing = real

    return patched()


def first_divergence(plain: list, kern: list, b: int, s: int, label: str):
    """Each row's first position whose MoE routing differs between two
    runs of ``lm_run`` (logs from :func:`logged_routing`; ``s`` + decode
    steps where none does), and the counts of choices that differ.  A
    token's state depends only on its row's earlier tokens and its own
    routing, so the positions before its row's first divergence compare
    continuously.  Fails unless each row's first divergence is explained:
    a top-k set that differs (a flip) where the plain path's k-th and
    (k+1)-th probabilities are within ``FLIP_GAP``, or a kept slot that
    differs under the same set (a displacement) behind a flip at a lower
    token of the same call (an expert's slots go in token order)."""
    import torch

    if len(plain) != len(kern):
        fail(f"{label}: {len(plain)} MoE calls on the plain path, "
             f"{len(kern)} on the kernel path")
    n_prefill = sum(e.shape[0] == b * s for e, _, _ in plain)  # MoE layers
    events = []  # (row, position, call, token, is a flip, gap, explained)
    flips = displaced = 0
    for c, ((ea, ka, gap), (eb, kb, _)) in enumerate(zip(plain, kern)):
        flip = (ea != eb).any(-1)
        disp = ~flip & (ka != kb).any(-1)
        flips += int(flip.sum())
        displaced += int(disp.sum())
        first_flip = int(flip.nonzero()[0, 0]) if bool(flip.any()) \
            else ea.shape[0]
        for t in (flip | disp).nonzero()[:, 0].tolist():
            if c < n_prefill:
                row, pos = divmod(t, s)
            else:
                row, pos = t, s + (c - n_prefill) // n_prefill
            ok = float(gap[t]) < FLIP_GAP if bool(flip[t]) \
                else first_flip < t
            events.append((row, pos, c, t, bool(flip[t]), float(gap[t]), ok))
    first = torch.full((b,), 10 ** 9, dtype=torch.long)
    for row in range(b):
        mine = sorted(e for e in events if e[0] == row)
        if not mine:
            continue
        _, pos, c, t, is_flip, g, ok = mine[0]
        if not ok:
            fail(f"{label}: row {row}'s first routing difference (position "
                 f"{pos}, MoE call {c}, token {t}) is "
                 + (f"a flip at a top-k gap of {g:.3e} (>= {FLIP_GAP})"
                    if is_flip else "a displacement behind no earlier flip"))
        first[row] = pos
    return first, flips, displaced


def lm_run(model, params, prompts, decode: int = LM_DECODE, feed=None,
           routing: list | None = None, force: list | None = None,
           vision=None) -> dict:
    """Prefill ``prompts`` (B, S) (a VLM's after its ``vision`` embeddings
    (B, Sv, D); cache grown by ``decode`` slots), then ``decode`` decode
    steps, each fed ``feed[:, i]`` or, without ``feed``, the greedy token
    of the step before.  Returns the logits of every position (B, 1 +
    decode, V), every leaf of the prefill's cache (copies keyed
    ``pos{j}/name``; keys and values cut to Sv + S slots) and the cache
    after the last step, the tokens fed, wall times and flash-attention
    launches of each part; with ``routing`` every MoE call's routing is
    appended to it (``force``: the experts another run's log chose, as
    :func:`logged_routing` says)."""
    import torch

    from repro_torch.kernels import flash_attention as kfa

    batch = {"tokens": prompts}
    if vision is not None:
        batch["vision_embeds"] = vision
    s = prompts.shape[1] + (0 if vision is None else vision.shape[1])
    with torch.inference_mode(), (logged_routing(routing, force) if routing
                                  is not None else contextlib.nullcontext()):
        torch.cuda.synchronize()
        n0 = kfa.LAUNCHES
        t0 = time.perf_counter()
        last, cache = model.prefill(params, batch, pad_to=s + decode)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = kfa.LAUNCHES
        kv = {f"{pos}/{n}": (x[:, :, :s] if n in ("k", "v") else x).clone()
              for pos, c in cache.items() if pos.startswith("pos")
              for n, x in c.items()}
        logits, fed = [last[:, 0]], []
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for i in range(decode):
            tok = feed[:, i] if feed is not None else logits[-1].argmax(-1)
            fed.append(tok)
            step, cache = model.decode_step(params, cache,
                                            {"tokens": tok[:, None]})
            logits.append(step[:, 0])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    return {"logits": torch.stack(logits, 1), "kv": kv, "cache": cache,
            "fed": torch.stack(fed, 1), "prefill_s": t1 - t0,
            "decode_s": t3 - t2, "prefill_launches": n1 - n0,
            "decode_launches": kfa.LAUNCHES - n1}


def cast_in_place(tree: dict, dtype) -> None:
    """Cast ``tree``'s leaves as ``cast_params`` does (norms, router,
    a_log and d_skip stay fp32), one leaf at a time, so each fp32 leaf is
    freed before the next is cast: a model whose fp32 and bf16 weights do
    not fit side by side."""
    from repro_torch.models import transformer as T

    for k in list(tree):
        if isinstance(tree[k], dict):
            cast_in_place(tree[k], dtype)
        else:
            tree[k] = tree[k].to(T.leaf_dtype(k, dtype))


def lm_gates(label: str, cfg16, params, prompts, decode: int, card: str,
             launches: dict, vision=None) -> dict:
    """Prefill and decode of one LM on the kernel path against the plain
    path: in fp32 (``params``, cast here to bf16 in place afterwards) the
    logits and every leaf of the prefill cache within ``LM_RTOL`` of the
    largest |value|, top-1 agreeing wherever the plain path's top-2 gap
    exceeds twice the logit error; in bf16 the kernel path's logit error
    against the fp32 plain path at most ``BF16_FACTOR`` × the bf16 plain
    path's.  Both paths are fed the fp32 plain path's greedy tokens; the
    kernel path launches flash attention once an attention layer a
    prefill and never in decode.  A VLM's prompts follow its ``vision``
    embeddings (fp32, cast by the model).

    An MoE's routing is discontinuous: where two experts' router
    probabilities tie within the paths' rounding, the paths may pick
    different experts, and that token and its row's later ones part by
    O(1).  So in fp32 the positions from each row's first routing
    difference on (explained by :func:`first_divergence`, or the phase
    fails) are left out of the max-abs gates, as are the Mamba states of
    such a row; and in bf16, where both paths flip thousands of choices
    against fp32, an MoE's errors are relative norms over every logit,
    not a maximum set by whichever token flipped.  Returns the bf16
    kernel path's run."""
    import torch

    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.models.registry import build_model

    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    plain_cfg = DispatchConfig(path="reference")
    n_attn = attn_calls(cfg16)
    b, s = prompts.shape
    if vision is not None:
        s += vision.shape[1]
    dev = prompts.device
    shape = f"batch {b}, prompt {s}, {decode} decode steps"

    def kernel_run(phase, cfg, feed, routing=None, force=None):
        def fn():
            out = lm_run(build_model(cfg), params, prompts, decode, feed,
                         routing, force, vision)
            if out["prefill_launches"] != n_attn \
                    or out["decode_launches"] != 0:
                fail(f"{phase}: {out['prefill_launches']} flash_attention "
                     f"launches in the prefill (want {n_attn}) and "
                     f"{out['decode_launches']} in {decode} decode steps "
                     f"(want 0)")
            return out
        return drive(phase, ("flash_attention",), launches, fn)

    def max_err(a, c) -> float:
        return float((a - c).abs().max())

    # fp32, kernel path against plain path
    r_plain, r_kern = [], []
    p32 = lm_run(build_model(cfg32, dispatch=plain_cfg), params, prompts,
                 decode, routing=r_plain, vision=vision)
    if p32["prefill_launches"] or p32["decode_launches"]:
        fail(f"{label}: the plain path launched the flash-attention kernel")
    k32 = kernel_run(f"{label} fp32 (kernel path)", cfg32, p32["fed"],
                     r_kern)
    first, flips, displaced = first_divergence(r_plain, r_kern, b, s,
                                               f"{label} fp32")
    want = p32["logits"]

    def hold_cache(run, first, what) -> dict:
        """Every prefill cache leaf of ``run`` within LM_RTOL of the
        plain path's at the positions before each row's ``first``
        routing difference (a row's Mamba states: its whole prompt)."""
        errs = {}
        for n, x in p32["kv"].items():
            y = run["kv"][n]
            if n.endswith(("/k", "/v")):   # (n_periods, B, T, KVH, hd)
                t = x.shape[2]  # a window's ring: position p in slot p % t
                at = (s - t) + (torch.arange(t, device=dev) - (s - t)) % t
                m = (at[None] < first[:, None])[None, :, :, None, None]
            else:
                m = (first >= s).view((1, b) + (1,) * (x.dim() - 2))
            m = m.expand_as(x)
            if not bool(m.any()):
                continue
            e, sc = float((y - x).abs()[m].max()), float(x.abs().max())
            if not e <= LM_RTOL * sc:
                fail(f"{label} fp32{what}: prefill cache {n} differs by "
                     f"{e:.3e} (> {LM_RTOL} × {sc:.3e})")
            errs[n] = e / sc if sc else 0.0
        return errs

    routing_note = ""
    if flips + displaced:
        first = first.to(dev)
        held = torch.arange(s, device=dev)[None] < first[:, None]
        free = hold_cache(k32, first, " (own routing)")
        routing_note = (
            f"; own routing: {flips} choices flipped at near-ties and "
            f"{displaced} displaced behind them, rows part at positions "
            f"{[p if p < s + decode else None for p in first.tolist()]}, "
            f"prefill cache held at the {int(held.sum())} of {held.numel()} "
            f"positions before, relative err "
            + ", ".join(f"{n} {e:.2e}" for n, e in free.items())
            + "; the gates below: the kernel path given the plain path's "
            "expert choices")
        del k32
        k32 = kernel_run(f"{label} fp32 (kernel path, the plain path's "
                         f"expert choices)", cfg32, p32["fed"], [], r_plain)
    del r_plain, r_kern
    if not bool(torch.isfinite(k32["logits"]).all()):
        fail(f"{label} fp32: non-finite logits on the kernel path")
    err = max_err(k32["logits"], want)
    scale = float(want.abs().max())
    pos_err = (k32["logits"] - want).abs().amax(-1)
    if not err <= LM_RTOL * scale:
        fail(f"{label} fp32: logits differ by {err:.3e} (> {LM_RTOL} × "
             f"{scale:.3e}); positions (batch, step) past it: "
             f"{(pos_err > LM_RTOL * scale).nonzero().tolist()[:16]}")
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    agree = k32["logits"].argmax(-1) == want.argmax(-1)
    if not bool(agree[decided].all()):
        fail(f"{label} fp32: top-1 differs at "
             f"{int((~agree & decided).sum())} positions whose top-2 gap "
             f"exceeds 2 × {err:.3e}")
    cache_errs = hold_cache(k32, torch.full((b,), s, device=dev), "")
    log(f"{label} fp32, {shape} [{card}]: logits max abs err {err:.3e} of "
        f"max |logit| {scale:.3e} ({err / scale:.2e} relative); top-1 "
        f"agrees at {int(agree.sum())} of {agree.numel()} positions "
        f"({int(decided.sum())} decided by a gap > 2 × err, all agree); "
        f"prefill cache relative err "
        + ", ".join(f"{n} {e:.2e}" for n, e in cache_errs.items())
        + f"; kernel path prefill {k32['prefill_s'] * 1e3:.1f} ms, decode "
        f"{k32['decode_s'] * 1e3:.1f} ms; plain path prefill "
        f"{p32['prefill_s'] * 1e3:.1f} ms, decode "
        f"{p32['decode_s'] * 1e3:.1f} ms{routing_note}")
    del k32, p32["kv"]

    # bf16 from the same weights
    cast_in_place(params, torch.bfloat16)
    torch.cuda.empty_cache()
    p16 = lm_run(build_model(cfg16, dispatch=plain_cfg), params, prompts,
                 decode, p32["fed"], vision=vision)
    k16 = kernel_run(f"{label} bf16 (kernel path)", cfg16, p32["fed"])
    e_k, e_p = max_err(k16["logits"], want), max_err(p16["logits"], want)
    what = "max abs"
    if cfg16.n_experts:
        n_k, n_p = (float((x["logits"] - want).norm() / want.norm())
                    for x in (k16, p16))
        what = (f"relative norm (max abs {e_k:.3e} kernel path, {e_p:.3e} "
                f"bf16 plain path)")
        e_k, e_p = n_k, n_p
    if not (bool(torch.isfinite(k16["logits"]).all())
            and e_k <= BF16_FACTOR * e_p):
        fail(f"{label} bf16: kernel path's logit error {e_k:.3e} against "
             f"the fp32 plain path > {BF16_FACTOR} × the bf16 plain path's "
             f"{e_p:.3e} ({what})")
    agree16 = int((k16["logits"].argmax(-1) == want.argmax(-1)).sum())
    log(f"{label} bf16, {shape} [{card}]: logit err vs the fp32 plain path "
        f"{e_k:.3e} (kernel path) vs {e_p:.3e} (bf16 plain path), {what}; "
        f"top-1 "
        f"agrees with fp32 at {agree16} of {want.shape[0] * want.shape[1]}; "
        f"kernel path prefill {k16['prefill_s'] * 1e3:.1f} ms = "
        f"{b * s / k16['prefill_s']:.0f} tokens/s, decode "
        f"{k16['decode_s'] * 1e3:.1f} ms for {decode} steps = "
        f"{b * decode / k16['decode_s']:.1f} tokens/s "
        f"({k16['decode_s'] / decode * 1e3:.2f} ms a step); plain path "
        f"prefill {p16['prefill_s'] * 1e3:.1f} ms, decode "
        f"{p16['decode_s'] * 1e3:.1f} ms")
    del p16, p32, want
    torch.cuda.empty_cache()
    return k16


def lm_phases(dev, card: str, launches: dict) -> None:
    """Phases 10-12: smollm-360m prefill and decode on the kernel path
    against the plain path in fp32 and in bf16, then the LM server."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg16 = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg32).init_params(gen, dev)
    prompts = torch.randint(0, cfg16.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)

    # --- phases 10 and 11: fp32 and bf16, kernel path against plain path --
    lm_gates(LM_ARCH, cfg16, params, prompts, LM_DECODE, card, launches)
    model = build_model(cfg16)
    with torch.inference_mode():
        profile_step("lm bf16 prefill (kernel path)", lambda: model.prefill(
            params, {"tokens": prompts}, pad_to=LM_PROMPT + LM_DECODE))
        _, cache = model.prefill(params, {"tokens": prompts},
                                 pad_to=LM_PROMPT + LM_DECODE)
        tok = prompts[:, -1:]
        profile_step("lm bf16 decode step", lambda: model.decode_step(
            params, cache, {"tokens": tok}))
    del params, cache, model
    torch.cuda.empty_cache()

    # --- phase 12: the LM server at the reference's defaults --------------
    serve_phase(LM_ARCH, card, launches)
    torch.cuda.empty_cache()

def attn_calls(cfg) -> int:
    """Full-sequence attention calls of one forward: each attention layer
    of the decoder, and an encoder-decoder's encoder layers and its
    decoder's cross-attentions."""
    from repro_torch.models import transformer as T

    n = sum(m == "attn" for m, _ in T.layer_kinds(cfg))
    return n + (cfg.n_encoder_layers + cfg.n_layers
                if cfg.encoder_decoder else 0)


def lm_grad_check(dev, card: str, arch: str = LM_ARCH,
                  launches: dict | None = None,
                  layers: int | None = LM_STEP_LAYERS,
                  seq: int | None = None, plain_remat: str = "none") -> None:
    """Phase 13 (a) (``smollm-360m``), 17 (``granite-moe-3b-a800m``) and
    21 (a) (``internvl2-1b``, ``whisper-small``): one ``loss_fn`` gradient
    of ``arch`` at full width cut to ``layers`` layers (None: full depth)
    on ``LM_STEP_BATCH`` sequences of ``seq`` tokens (default
    ``LM_PROMPT``; the trainer's batch: a VLM's sinusoidal vision
    prefix, an encoder-decoder's zero frames), kernel
    path against plain path, in fp32 (beside the plain path on fp64
    parameters: its own rounding) and in bf16, ``remat="full"`` against
    ``"none"``, and two bf16 calls giving the same bits.  An MoE's aux
    term must be finite on both paths and agree within ``LM_LOSS_RTOL``.
    With ``launches`` the kernel path's calls are driven (their launches
    counted).  ``plain_remat="full"`` recomputes the plain path's layers
    in its backward (the same gradients), so that its dense attention
    scores are kept one layer at a time; an MoE's runs keep "none", since
    a recomputed forward would route, and log its routing, again."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.data.pipeline import token_iterator
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths, tree_map

    full = get_config(arch)
    depth = layers or full.n_layers
    seq = seq or LM_PROMPT
    cfg32 = dataclasses.replace(full, dtype="float32", n_layers=depth)
    cfg16 = dataclasses.replace(full, n_layers=depth)
    plain = DispatchConfig(path="reference")
    params32 = build_model(cfg32).init_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    batch = train.to_model_batch(full, next(token_iterator(
        0, LM_STEP_BATCH, seq, full.vocab_size)), dev)

    label = f"lm grad ({arch})"
    peak = [0.0]

    def grads(cfg, params, dispatch=None, remat="none", routing=None,
              force=None):
        if dispatch is not None:
            remat = plain_remat
        model = build_model(cfg, remat=remat, dispatch=dispatch)
        metrics = {}

        def loss_of(p, b):
            loss, metrics["m"] = model.loss_fn(p, b)
            return loss

        def run():
            n_fwd, n_bwd = kfa.LAUNCHES, kfa.BWD_LAUNCHES
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with (logged_routing(routing, force) if routing is not None
                  else contextlib.nullcontext()):
                loss, g = value_and_grad(loss_of, params, batch)
            torch.cuda.synchronize()
            gib = torch.cuda.max_memory_allocated() / 2 ** 30
            peak[0] = max(peak[0], gib)
            return {"loss": float(loss), "grads": leaves_with_paths(g),
                    "aux": float(metrics["m"]["aux"].detach()),
                    "ms": (time.perf_counter() - t0) * 1e3, "gib": gib,
                    "fwd": kfa.LAUNCHES - n_fwd,
                    "bwd": kfa.BWD_LAUNCHES - n_bwd}

        if launches is None or dispatch is not None:
            return run()
        return drive(f"{label} {cfg.dtype} remat={remat} (kernel path)",
                     ("flash_attention", "flash_attention_bwd"), launches,
                     run)

    def amax(x) -> float:
        return float(x.abs().max())

    def rel(a, b) -> float:
        return float((a.float() - b.float()).norm()) / float(b.float().norm())

    grads(cfg32, params32)  # warm-up
    # an MoE's expert choices may flip at near-ties between any two fp32
    # runs (lm_gates): the kernel path and the fp64 floor are given the
    # plain path's, and the kernel path's own run is held to remat="full"
    moe_log = [] if full.n_experts else None

    def forced() -> dict:
        return dict(routing=[], force=moe_log) if full.n_experts else {}

    ref = grads(cfg32, params32, plain, routing=moe_log)
    kern = grads(cfg32, params32, **forced())
    own_log = []
    own = grads(cfg32, params32, routing=own_log) if full.n_experts \
        else kern
    flipped = sum(int((a[0] != b[0]).any(-1).sum())
                  for a, b in zip(own_log, moe_log or ()))
    n_attn = attn_calls(cfg32)
    if (kern["fwd"], kern["bwd"], ref["fwd"], ref["bwd"]) \
            != (n_attn, n_attn, 0, 0):
        fail(f"lm grad fp32: attention launches {kern['fwd']}/{kern['bwd']}"
             f" (kernel path) and {ref['fwd']}/{ref['bwd']} (plain path); "
             f"want {n_attn} each and 0")
    if not abs(kern["loss"] - ref["loss"]) <= LM_LOSS_RTOL * abs(ref["loss"]):
        fail(f"lm grad fp32: loss {kern['loss']} (kernel path) vs "
             f"{ref['loss']} (plain path)")
    if full.n_experts and not (
            math.isfinite(kern["aux"]) and math.isfinite(ref["aux"])
            and abs(kern["aux"] - ref["aux"]) <= LM_LOSS_RTOL * ref["aux"]):
        fail(f"{label} fp32: aux {kern['aux']} (kernel path) vs "
             f"{ref['aux']} (plain path)")
    f64 = grads(cfg32, tree_map(lambda x: x.double(), params32), plain,
                **forced())
    worst = (0.0, 0.0, "")
    for (path, a), (_, b), (_, c) in zip(kern["grads"], ref["grads"],
                                         f64["grads"]):
        if not bool(torch.isfinite(a).all()):
            fail(f"lm grad fp32: non-finite gradient at {path}")
        scale = amax(b)
        err = amax(a - b) / scale
        floor = float((b.double() - c).abs().max()) / amax(c)
        if not err <= max(LM_GRAD_FLOOR, LM_GRAD_FACTOR * floor):
            fail(f"lm grad fp32: gradient at {path} differs by {err:.3e} of "
                 f"its largest entry (> {LM_GRAD_FLOOR} and > "
                 f"{LM_GRAD_FACTOR} × the plain path's fp32-vs-fp64 "
                 f"{floor:.3e})")
        worst = max(worst, (err, floor, path))
    del f64
    remat = grads(cfg32, params32, remat="full")
    if (remat["fwd"], remat["bwd"]) != (2 * n_attn, n_attn):
        fail(f"lm grad remat=full: {remat['fwd']} forward and "
             f"{remat['bwd']} backward launches, want {2 * n_attn} and "
             f"{n_attn}")
    remat_err = max(amax(a - b) / amax(b) for (_, a), (_, b)
                    in zip(remat["grads"], own["grads"]))
    identical = all(torch.equal(a, b) for (_, a), (_, b)
                    in zip(remat["grads"], own["grads"]))
    if not (remat["loss"] == own["loss"] and remat_err <= LM_REMAT_RTOL):
        fail(f"lm grad remat=full: loss {remat['loss']} vs {own['loss']}, "
             f"gradients differ by {remat_err:.3e} of their largest entry")
    log(f"{label} fp32, full width, {depth} layers, "
        f"batch {LM_STEP_BATCH}, seq {seq} [{card}]: loss "
        f"{kern['loss']:.6f} (kernel) vs {ref['loss']:.6f} (plain), aux "
        f"{kern['aux']:.6f} vs {ref['aux']:.6f}"
        + (f" (the kernel path given the plain path's expert choices; on "
           f"its own it flipped {flipped} of "
           f"{sum(a[0].shape[0] for a in own_log)} token-layer choices, "
           f"loss {own['loss']:.6f})" if full.n_experts else "")
        + "; worst "
        f"gradient error {worst[0]:.3e} of its largest entry at {worst[2]} "
        f"(plain path's fp32-vs-fp64 there {worst[1]:.3e}); value_and_grad "
        f"{kern['ms']:.1f} ms kernel path, {ref['ms']:.1f} ms plain path, "
        f"peak {kern['gib']:.2f} / {ref['gib']:.2f} GiB; remat=full: "
        f"{remat['fwd']} forward launches, gradients "
        f"{'bit-identical' if identical else f'within {remat_err:.3e}'}, "
        f"{remat['ms']:.1f} ms, peak {remat['gib']:.2f} GiB")
    del remat, kern

    params16 = T.cast_params(params32, torch.bfloat16)
    del params32
    k16 = grads(cfg16, params16)
    again = grads(cfg16, params16)
    p16 = grads(cfg16, params16, plain)
    differ = [path for (path, a), (_, b) in zip(k16["grads"], again["grads"])
              if not torch.equal(a.view(torch.int16), b.view(torch.int16))]
    if differ or again["loss"] != k16["loss"]:
        fail(f"{label} bf16: two calls differ: loss {k16['loss']} vs "
             f"{again['loss']}, gradients at {differ[:8]}")
    del again
    if full.n_experts and not (math.isfinite(k16["aux"])
                               and math.isfinite(p16["aux"])):
        fail(f"{label} bf16: aux {k16['aux']} (kernel path) vs "
             f"{p16['aux']} (plain path)")
    worst16 = (0.0, 0.0, "")
    for (path, a), (_, b), (_, c) in zip(k16["grads"], p16["grads"],
                                         ref["grads"]):
        e_k, e_p = rel(a, c), rel(b, c)
        if not (bool(torch.isfinite(a).all()) and e_k <= BF16_FACTOR * e_p):
            fail(f"lm grad bf16: gradient at {path}: kernel path's error "
                 f"{e_k:.3e} (relative norm, against the fp32 plain path) > "
                 f"{BF16_FACTOR} × the bf16 plain path's {e_p:.3e}")
        worst16 = max(worst16, (e_k / e_p, e_k, path))
    log(f"{label} bf16 [{card}]: loss {k16['loss']:.6f} (kernel) vs "
        f"{p16['loss']:.6f} (bf16 plain) vs {ref['loss']:.6f} (fp32 plain); "
        f"aux {k16['aux']:.6f} vs {p16['aux']:.6f}; "
        f"largest ratio of the kernel path's gradient error to the bf16 "
        f"plain path's {worst16[0]:.3f} at {worst16[2]} (kernel error "
        f"{worst16[1]:.3e}); two kernel-path calls bit-identical; "
        f"value_and_grad {k16['ms']:.1f} ms kernel path, "
        f"{p16['ms']:.1f} ms plain path; peak over the gradient calls "
        f"{peak[0]:.2f} GiB")
    del k16, p16, ref, params16
    torch.cuda.empty_cache()


def lm_train_phase(dev, card: str, launches: dict) -> None:
    """Phase 13: the gradient check, then ``launch/train.py`` on
    full-depth ``smollm-360m`` (bf16, AdamW with fp32 master weights),
    checkpointed, resumed, and one step profiled."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_iterator
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.optim import make_optimizer, make_schedule

    t_phase = time.perf_counter()
    lm_grad_check(dev, card)
    cfg = get_config(LM_ARCH)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_lm_train_")
    argv = ["--arch", LM_ARCH, "--seq", str(LM_PROMPT), "--batch",
            str(LM_BATCH), "--steps", str(LM_TRAIN_STEPS), "--ckpt-every",
            str(LM_CKPT_EVERY), "--log-every", "1", "--ckpt-dir", ckpt,
            "--seed", "0"]

    def run(label, steps_run):
        result = drive(label, ("flash_attention", "flash_attention_bwd"),
                       launches, lambda: train.main(argv))
        got = counts()
        want = cfg.n_layers * steps_run
        if result["steps_run"] != steps_run or got["flash_attention"] != want \
                or got["flash_attention_bwd"] != want:
            fail(f"{label}: {result['steps_run']} steps, attention launches "
                 f"{got['flash_attention']} forward and "
                 f"{got['flash_attention_bwd']} backward; want {want} each")
        losses = [v for _, v in result["losses"]]
        if len(losses) != steps_run or not all(
                v == v and abs(v) < 1e30 for v in losses):
            fail(f"{label}: losses {losses}")
        return result, losses

    try:
        straight, losses = run("train lm", LM_TRAIN_STEPS)
        mgr = CheckpointManager(ckpt)
        if mgr.steps() != [LM_CKPT_EVERY, LM_TRAIN_STEPS]:
            fail(f"train lm: checkpoints {mgr.steps()}")
        size = sum(f.stat().st_size for f in os.scandir(
            os.path.join(ckpt, f"step_{LM_TRAIN_STEPS}")))
        shutil.rmtree(os.path.join(ckpt, f"step_{LM_TRAIN_STEPS}"))
        t0 = time.perf_counter()
        resumed, again = run("train lm (resumed from step 2)",
                             LM_TRAIN_STEPS - LM_CKPT_EVERY)
        resume_s = time.perf_counter() - t0
        tail = losses[LM_CKPT_EVERY:]
        if not all(abs(a - b) <= LM_RESUME_RTOL * abs(b)
                   for a, b in zip(again, tail)):
            fail(f"train lm: resumed losses {again} vs straight {tail}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    step_ms = [t * 1e3 for t in straight["step_s"]]
    steady = statistics.median(step_ms[1:])
    tokens = LM_BATCH * LM_PROMPT
    log(f"train lm, {LM_ARCH} full depth, bf16, batch {LM_BATCH}, seq "
        f"{LM_PROMPT} [{card}]: step ms {[round(t, 1) for t in step_ms]} "
        f"(first includes warm-up), median after the first {steady:.1f} ms "
        f"= {tokens / steady * 1e3:.0f} tokens/s; host batch ms "
        f"{[round(t * 1e3, 1) for t in straight['data_s']]}; losses "
        f"{losses}; resumed from step {LM_CKPT_EVERY}: {again} "
        f"(bit-identical: {again == tail}); loop wall "
        f"{straight['wall_s']:.2f} s incl. checkpoints of "
        f"{size / 2 ** 30:.2f} GiB; resumed run {resume_s:.2f} s incl. the "
        f"restore")
    del straight, resumed

    # one step of the trainer's own step function, profiled
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(1),
                               dev)
    opt = make_optimizer("adamw")
    state = opt.init(params)
    step = train.make_step(model, opt, make_schedule(
        "cosine", 1e-3, 1, LM_TRAIN_STEPS), 1.0)
    batch = train.to_model_batch(cfg, next(token_iterator(
        2, LM_BATCH, LM_PROMPT, cfg.vocab_size)), dev)
    params, state, _, _ = step(params, state, batch)  # warm-up
    calls, device_us = profile_step("lm train step (kernel path)",
                                    lambda: step(params, state, batch))
    names = BWD_TC_KERNELS + BWD_FFMA_KERNELS + ("flash_attention_tc_kernel",)
    seen = {k: sum(n for name, n in calls.items() if k in name)
            for k in names}
    ms = {k: sum(t for name, t in device_us.items() if k in name) / 1e3
          for k in names}
    if calls and (any(seen[k] != cfg.n_layers for k in BWD_TC_KERNELS
                      + ("flash_attention_tc_kernel",))
                  or any(seen[k] for k in BWD_FFMA_KERNELS)):
        fail(f"lm train step profile: attention kernel launches {seen}, "
             f"want {cfg.n_layers} each of the tensor-core kernels and "
             f"none of the FFMA backward")
    log(f"lm train step profile: launches by kernel {seen}; backward "
        f"device ms: dK/dV {ms['attn_bwd_dkdv_tc_kernel']:.3f}, dQ "
        f"{ms['attn_bwd_dq_tc_kernel']:.3f}, D "
        f"{ms['attn_bwd_preprocess_kernel']:.3f} (per layer "
        f"{ms['attn_bwd_dkdv_tc_kernel'] / cfg.n_layers:.3f}, "
        f"{ms['attn_bwd_dq_tc_kernel'] / cfg.n_layers:.3f}, "
        f"{ms['attn_bwd_preprocess_kernel'] / cfg.n_layers:.3f})")
    del params, state, batch, model
    torch.cuda.empty_cache()
    log(f"lm training phase: {time.perf_counter() - t_phase:.2f} s")


def timed(label: str, card: str, fn) -> None:
    """Run one phase, then print its seconds and the device memory peak
    since its start (a phase that resets the peak itself prints its
    calls' own)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    log(f"{label}: {time.perf_counter() - t0:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")


def moe_serving_phase(dev, card: str, launches: dict) -> None:
    """Phase 14: full ``granite-moe-3b-a800m`` (32 MoE layers, random
    weights from seed 0) through ``lm_gates`` at LM_BATCH prompts of
    LM_PROMPT tokens and LM_DECODE steps, a profiled bf16 prefill and
    decode step (split by the MoE's ranges), then ``serve --arch``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg16 = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(dataclasses.replace(cfg16, dtype="float32")
                         ).init_params(gen, dev)
    prompts = torch.randint(0, cfg16.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=dev)
    lm_gates(MOE_ARCH, cfg16, params, prompts, LM_DECODE, card, launches)
    model = build_model(cfg16)
    with torch.inference_mode():
        profile_step(f"{MOE_ARCH} bf16 prefill (kernel path)",
                     lambda: model.prefill(params, {"tokens": prompts},
                                           pad_to=LM_PROMPT + LM_DECODE),
                     MOE_RANGES)
        _, cache = model.prefill(params, {"tokens": prompts},
                                 pad_to=LM_PROMPT + LM_DECODE)
        tok = prompts[:, -1:]
        profile_step(f"{MOE_ARCH} bf16 decode step",
                     lambda: model.decode_step(params, cache,
                                               {"tokens": tok}), MOE_RANGES)
    del params, cache, model
    torch.cuda.empty_cache()
    serve_phase(MOE_ARCH, card, launches)
    torch.cuda.empty_cache()


def ring_check(cfg16, params, prompts, decode: int, card: str) -> None:
    """The repaired sliding-window ring at full width, fp32 plain path:
    after a prompt longer than the window and not a multiple of it, each
    decode step's logits equal ``forward``'s over the whole sequence at
    that position, within ``LM_RTOL`` of the largest |logit|.  A decode
    step routes its token with its own capacity and the forward its S
    tokens with theirs, so both get a capacity of T (capacity_factor =
    E / k: nothing dropped); and prefill and decode take the forward's
    expert choices (:func:`logged_routing`), which their other attention
    numerics could flip at near-ties."""
    import torch

    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(
        cfg16, dtype="float32",
        capacity_factor=cfg16.n_experts / cfg16.experts_per_token)
    model = build_model(cfg, dispatch=DispatchConfig(path="reference"))
    b, s = prompts.shape
    feed = torch.randint(0, cfg16.vocab_size, (b, decode),
                         generator=torch.Generator(device=prompts.device
                                                   ).manual_seed(3),
                         device=prompts.device)
    fwd_log = []
    with torch.inference_mode(), logged_routing(fwd_log):
        full, _ = model.forward(params, {"tokens": torch.cat(
            [prompts, feed], 1)})
    force = [(e.view(b, s + decode, -1)[:, :s].reshape(b * s, -1),)
             for e, _, _ in fwd_log]
    for i in range(decode):
        force += [(e.view(b, s + decode, -1)[:, s + i],)
                  for e, _, _ in fwd_log]
    run = lm_run(model, params, prompts, decode, feed, [], force)
    want = full[:, s - 1:s - 1 + decode]
    err, scale = float((run["logits"][:, :decode] - want).abs().max()), \
        float(want.abs().max())
    if not err <= LM_RTOL * scale:
        fail(f"ring cache: decode after a prompt of {s} (window "
             f"{cfg16.sliding_window}) differs from forward by {err:.3e} (> "
             f"{LM_RTOL} × {scale:.3e})")
    log(f"ring cache, window {cfg16.sliding_window}, prompt {s}, {decode} "
        f"decode steps [{card}]: decode against forward max abs err "
        f"{err:.3e} of max |logit| {scale:.3e}")
    del full, run, fwd_log, force


def moe_cut_phase(arch: str, layers: int, prompt: int, decode: int, dev,
                  card: str, launches: dict) -> None:
    """Phases 15 and 16: ``arch`` at full width cut to ``layers`` layers,
    batch 1, random weights from seed 0 (fp32, cast in place to bf16 by
    ``lm_gates``: jamba's do not fit side by side), a windowed config's
    ring checked first; then a profiled bf16 prefill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves

    cfg16 = dataclasses.replace(get_config(arch), n_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(dataclasses.replace(cfg16, dtype="float32")
                         ).init_params(gen, dev)
    prompts = torch.randint(0, cfg16.vocab_size, (1, prompt), generator=gen,
                            device=dev)
    n = sum(x.numel() for x in leaves(params))
    log(f"{arch}, {layers} layers at full width: {n / 1e9:.3f} B "
        f"parameters, {n * 4 / 2 ** 30:.2f} GiB in fp32 [{card}]")
    if cfg16.sliding_window:
        ring_check(cfg16, params, prompts, decode, card)
    lm_gates(f"{arch} ({layers} layers)", cfg16, params, prompts, decode,
             card, launches)
    model = build_model(cfg16)
    with torch.inference_mode():
        profile_step(f"{arch} ({layers} layers) bf16 prefill (kernel path)",
                     lambda: model.prefill(params, {"tokens": prompts},
                                           pad_to=prompt + decode),
                     MOE_RANGES)
    del params, model
    torch.cuda.empty_cache()


def rwkv_phase(dev, card: str, launches: dict) -> None:
    """Phase 18: full ``rwkv6-7b`` (32 layers, random weights from seed 0,
    drawn in fp32): LM_BATCH prompts of LM_PROMPT tokens, then RWKV_DECODE
    decode steps fed the next tokens, held against ``forward`` over all
    LM_PROMPT + RWKV_DECODE tokens within LM_RTOL of the largest |logit|,
    every state leaf finite; then bf16 from the same weights (cast leaf by
    leaf): its relative-norm error against fp32 printed, and two gates
    (:func:`rwkv_bf16_gate`, RWKV_GATE_TOKENS at full depth and
    RWKV_GATE_LAYERS layers over the prompt); tokens/s, a profiled bf16
    prefill and decode step (the WKV scan's range against the products
    and the rest); then ``serve --arch rwkv6-7b``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves, leaves_with_paths, tree_map

    def cut(p, layers):  # the first ``layers`` layers, as views
        return {**p, "blocks": tree_map(lambda x: x[:layers], p["blocks"])}

    cfg16 = get_config(RWKV_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg32).init_params(gen, dev)
    n = sum(x.numel() for x in leaves(params))
    total = LM_PROMPT + RWKV_DECODE
    tokens = torch.randint(0, cfg16.vocab_size, (LM_BATCH, total),
                           generator=gen, device=dev)
    prompts, feed = tokens[:, :LM_PROMPT], tokens[:, LM_PROMPT:]
    model = build_model(cfg32)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full, _ = model.forward(params, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        want = full[:, LM_PROMPT - 1:].clone()
        want_head = full[:, :RWKV_GATE_TOKENS].clone()
        del full
        cfg_cut = dataclasses.replace(cfg32, n_layers=RWKV_GATE_LAYERS)
        want_cut, _ = build_model(cfg_cut).forward(
            cut(params, RWKV_GATE_LAYERS), {"tokens": prompts})
    r32 = drive(f"{RWKV_ARCH} fp32", (), launches,
                lambda: lm_run(model, params, prompts, RWKV_DECODE, feed))
    got = r32["logits"]
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    bad = [p for p, x in leaves_with_paths(r32["cache"])
           if x.is_floating_point() and not bool(torch.isfinite(x).all())]
    if not (bool(torch.isfinite(got).all()) and err <= LM_RTOL * scale) \
            or bad:
        fail(f"{RWKV_ARCH} fp32: prefill + {RWKV_DECODE} decode steps "
             f"against forward over {total} tokens: max abs err {err:.3e} "
             f"(> {LM_RTOL} × {scale:.3e}?), non-finite states {bad}")
    log(f"{RWKV_ARCH} fp32, {n / 1e9:.3f} B parameters "
        f"({n * 4 / 2 ** 30:.2f} GiB), batch {LM_BATCH}, prompt "
        f"{LM_PROMPT}, {RWKV_DECODE} decode steps [{card}]: logits against "
        f"forward over {total} tokens max abs err {err:.3e} of max |logit| "
        f"{scale:.3e} ({err / scale:.2e} relative); every state leaf "
        f"finite; forward {fwd_s * 1e3:.1f} ms, prefill "
        f"{r32['prefill_s'] * 1e3:.1f} ms, decode "
        f"{r32['decode_s'] / RWKV_DECODE * 1e3:.2f} ms a step")
    del r32, model
    cast_in_place(params, torch.bfloat16)
    torch.cuda.empty_cache()
    model = build_model(cfg16)
    r16 = drive(f"{RWKV_ARCH} bf16", (), launches,
                lambda: lm_run(model, params, prompts, RWKV_DECODE, feed))
    rel = float((r16["logits"] - want).norm() / want.norm())
    if not bool(torch.isfinite(r16["logits"]).all()):
        fail(f"{RWKV_ARCH} bf16: non-finite logits")
    agree = int((r16["logits"].argmax(-1) == want.argmax(-1)).sum())
    positions = want.shape[0] * want.shape[1]
    rwkv_bf16_gate(f"{RWKV_ARCH} bf16, {cfg16.n_layers} layers, first "
                   f"{RWKV_GATE_TOKENS} tokens", cfg16, params,
                   prompts[:, :RWKV_GATE_TOKENS], want_head, card)
    rwkv_bf16_gate(f"{RWKV_ARCH} bf16, first {RWKV_GATE_LAYERS} layers, "
                   f"{LM_PROMPT} tokens",
                   dataclasses.replace(cfg16, n_layers=RWKV_GATE_LAYERS),
                   cut(params, RWKV_GATE_LAYERS), prompts, want_cut, card)
    del want_head, want_cut
    log(f"{RWKV_ARCH} bf16 [{card}]: logits' relative-norm error against "
        f"fp32 {rel:.3e} (prefill's last position and the decode steps), "
        f"top-1 agrees at {agree} of {positions}; prefill "
        f"{r16['prefill_s'] * 1e3:.1f} ms = "
        f"{LM_BATCH * LM_PROMPT / r16['prefill_s']:.0f} tokens/s, decode "
        f"{r16['decode_s'] * 1e3:.1f} ms for {RWKV_DECODE} steps = "
        f"{LM_BATCH * RWKV_DECODE / r16['decode_s']:.1f} tokens/s "
        f"({r16['decode_s'] / RWKV_DECODE * 1e3:.2f} ms a step)")
    del r16, want
    with torch.inference_mode():
        profile_step(f"{RWKV_ARCH} bf16 prefill", lambda: model.prefill(
            params, {"tokens": prompts}), RWKV_RANGES)
        _, cache = model.prefill(params, {"tokens": prompts})
        profile_step(f"{RWKV_ARCH} bf16 decode step", lambda: model.decode_step(
            params, cache, {"tokens": feed[:, :1]}), RWKV_RANGES)
    del params, cache, model
    torch.cuda.empty_cache()
    serve_phase(RWKV_ARCH, card, launches, FAMILY_SERVE_REQUESTS)


def rwkv_bf16_gate(label: str, cfg16, params, tokens, want,
                   card: str) -> None:
    """The bf16 ``forward`` over ``tokens`` on the chunked scan and on the
    plain scan (``reference`` dispatch: the one-step recurrence), each
    against the fp32 logits ``want``: the chunked scan's relative-norm
    error at most BF16_FACTOR × the plain scan's."""
    import torch

    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.models.registry import build_model

    errs, secs = [], []
    with torch.inference_mode():
        for dispatch in (None, DispatchConfig(path="reference")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _ = build_model(cfg16, dispatch=dispatch).forward(
                params, {"tokens": tokens})
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(got).all()):
                fail(f"{label}: non-finite logits "
                     f"({'plain' if dispatch else 'chunked'} scan)")
            errs.append(float((got.float() - want).norm() / want.norm()))
            del got
    if not errs[0] <= BF16_FACTOR * errs[1]:
        fail(f"{label}: the chunked scan's logit error against fp32 "
             f"{errs[0]:.3e} > {BF16_FACTOR} × the plain scan's {errs[1]:.3e}"
             f" (relative norm)")
    log(f"{label} [{card}]: logits' relative-norm error against fp32 "
        f"{errs[0]:.3e} (chunked scan) vs {errs[1]:.3e} (plain scan), "
        f"within {BF16_FACTOR} ×; forward {secs[0] * 1e3:.1f} / "
        f"{secs[1] * 1e3:.1f} ms")


def serve_phase(arch: str, card: str, launches: dict,
                requests: int = LM_SERVE_REQUESTS) -> None:
    """``serve --arch`` at the reference's defaults but ``requests``
    requests: all completed."""
    from repro_torch.launch import serve

    report = drive(f"serve lm {arch}", (), launches,
                   lambda: serve.main(["--arch", arch, "--requests",
                                       str(requests)]))
    if report["completed"] != requests or report["decode_tokens"] <= 0:
        fail(f"serve lm {arch}: completed {report['completed']} of "
             f"{requests}")
    log(f"serve lm ({arch}, bf16, batch 4, ctx 256, {requests} "
        f"requests) [{card}]: {report['decode_tokens']} decode tokens in "
        f"{report['wall_s']:.3f} s = {report['tokens_per_s']:.1f} tokens/s")


def vlm_phase(dev, card: str, launches: dict) -> None:
    """Phase 19: full ``internvl2-1b`` (24 layers, random weights from seed
    0): each of LM_BATCH prompts one random VLM_IMAGE² image, encoded by
    the ``block_dct`` kernel (``coefficient_patches``) into its 256 vision
    embeddings through ``fold_patch_embed`` of a random patch projection,
    then LM_PROMPT - 256 tokens; the fp32 logits on that prefix within
    VLM_FOLD_RTOL of those on the pixel patch embedding
    (``unfold_patches_to_blocks @ w``); then ``lm_gates`` on the JPEG
    prefix, a profiled bf16 prefill, and ``serve --arch internvl2-1b``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import transform_linear as tl
    from repro_torch.models.registry import build_model

    cfg16 = get_config(VLM_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg32).init_params(gen, dev)
    sv, ch = cfg16.vision_prefix_len, 3
    prompts = torch.randint(0, cfg16.vocab_size, (LM_BATCH, LM_PROMPT - sv),
                            generator=gen, device=dev)
    images = torch.randn((LM_BATCH, ch, VLM_IMAGE, VLM_IMAGE), generator=gen,
                         device=dev) * 0.3
    w = torch.randn((ch * PATCH * PATCH, cfg16.d_model), generator=gen,
                    device=dev) * 0.02
    model = build_model(cfg32)

    def jpeg_prefix():
        with torch.inference_mode():
            vis = tl.coefficient_patches(images, PATCH, 50) @ \
                tl.fold_patch_embed(w, PATCH, ch, quality=50, scaled=True)
            logits, _ = model.forward(params, {"tokens": prompts,
                                               "vision_embeds": vis})
        return vis, logits

    vis, jpeg_logits = drive(f"{VLM_ARCH} JPEG-domain vision prefix",
                             ("block_dct", "flash_attention"), launches,
                             jpeg_prefix)
    if vis.shape != (LM_BATCH, sv, cfg16.d_model):
        fail(f"{VLM_ARCH}: vision prefix of shape {tuple(vis.shape)}")
    with torch.inference_mode():
        pixel = tl.unfold_patches_to_blocks(images, PATCH) @ w
        pixel_logits, _ = model.forward(params, {"tokens": prompts,
                                                 "vision_embeds": pixel})
    err = compare(f"{VLM_ARCH} logits on the JPEG-domain prefix against the "
                  f"pixel one", jpeg_logits, pixel_logits, VLM_FOLD_RTOL)
    e_emb = float((vis - pixel).abs().max())
    log(f"{VLM_ARCH} fp32, {LM_BATCH} images of {VLM_IMAGE}² through "
        f"block_dct and fold_patch_embed (patch {PATCH}, q50) [{card}]: "
        f"embeddings max abs err {e_emb:.3e} of "
        f"{float(pixel.abs().max()):.4f}; logits max abs err {err:.3e} of "
        f"max |logit| {float(pixel_logits.abs().max()):.3e}")
    del jpeg_logits, pixel_logits, pixel, model
    torch.cuda.empty_cache()
    lm_gates(VLM_ARCH, cfg16, params, prompts, LM_DECODE, card, launches,
             vision=vis)
    model = build_model(cfg16)
    with torch.inference_mode():
        profile_step(f"{VLM_ARCH} bf16 prefill (kernel path)",
                     lambda: model.prefill(params, {"tokens": prompts,
                                                    "vision_embeds": vis},
                                           pad_to=LM_PROMPT + LM_DECODE))
    del params, model, vis
    torch.cuda.empty_cache()
    serve_phase(VLM_ARCH, card, launches, FAMILY_SERVE_REQUESTS)


def audio_phase(dev, card: str, launches: dict) -> None:
    """Phase 20: full ``whisper-small`` (12 + 12 layers, random weights from
    seed 0) on LM_BATCH × WHISPER_FRAMES random frames and WHISPER_TOKENS
    decoder tokens: the encoder (``prefill``) and the whole ``forward`` on
    the kernel path against the plain path, fp32 within LM_RTOL of the
    largest |value|, bf16 at most BF16_FACTOR × the bf16 plain path's
    error against fp32 (one flash-attention launch an encoder layer, and
    two a decoder layer); LM_DECODE decode steps from index 0 against a
    cross cache written from the kernel path's encoder output
    (``cross_cache``), equal to ``forward``'s first positions within
    LM_RTOL and launching no kernel; a profiled bf16 forward; then
    ``serve --arch whisper-small`` (decoding against the zero cross cache,
    as the reference's server does)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg16 = get_config(AUDIO_ARCH)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg32).init_params(gen, dev)
    frames = torch.randn((LM_BATCH, WHISPER_FRAMES, cfg16.d_model),
                         generator=gen, device=dev)
    tokens = torch.randint(0, cfg16.vocab_size, (LM_BATCH, WHISPER_TOKENS),
                           generator=gen, device=dev)
    n_enc, n_all = cfg16.n_encoder_layers, attn_calls(cfg16)

    def run(cfg, dispatch=None):
        model = build_model(cfg, dispatch=dispatch)
        with torch.inference_mode():
            torch.cuda.synchronize()
            n0, t0 = kfa.LAUNCHES, time.perf_counter()
            enc, cache = model.prefill(params, {"frames": frames})
            torch.cuda.synchronize()
            n1, t1 = kfa.LAUNCHES, time.perf_counter()
            logits, _ = model.forward(params, {"tokens": tokens,
                                               "frames": frames})
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        if cache is not None:
            fail(f"{AUDIO_ARCH}: prefill returned a cache")
        return {"enc": enc, "logits": logits, "enc_s": t1 - t0,
                "fwd_s": t2 - t1, "launches": (n1 - n0, kfa.LAUNCHES - n1)}

    def kernel(label, cfg):
        out = drive(label, ("flash_attention",), launches, lambda: run(cfg))
        if out["launches"] != (n_enc, n_all):
            fail(f"{label}: flash_attention launches {out['launches']} "
                 f"(encoder, forward), want {(n_enc, n_all)}")
        return out

    def decode(cfg, enc, steps):
        model = build_model(cfg)
        with torch.inference_mode():
            cache = model.init_cache(LM_BATCH, WHISPER_TOKENS, dev)
            cache["cross"] = T.cross_cache(params, cfg, enc)
            torch.cuda.synchronize()
            n0, t0 = kfa.LAUNCHES, time.perf_counter()
            out = []
            for i in range(steps):
                step, cache = model.decode_step(
                    params, cache, {"tokens": tokens[:, i:i + 1]})
                out.append(step[:, 0])
            torch.cuda.synchronize()
        if kfa.LAUNCHES != n0:
            fail(f"{AUDIO_ARCH}: decode launched the flash-attention kernel")
        return torch.stack(out, 1), time.perf_counter() - t0

    plain = DispatchConfig(path="reference")
    p32 = run(cfg32, plain)
    if p32["launches"] != (0, 0):
        fail(f"{AUDIO_ARCH}: the plain path launched the kernel")
    k32 = kernel(f"{AUDIO_ARCH} fp32 (kernel path)", cfg32)
    errs = []
    for key in ("enc", "logits"):
        want, got = p32[key], k32[key]
        e, sc = float((got - want).abs().max()), float(want.abs().max())
        if not (bool(torch.isfinite(got).all()) and e <= LM_RTOL * sc):
            fail(f"{AUDIO_ARCH} fp32 {key}: kernel path differs by {e:.3e} "
                 f"(> {LM_RTOL} × {sc:.3e})")
        errs.append(f"{key} {e:.3e} of {sc:.3e}")
    dec, dec_s = decode(cfg32, k32["enc"], LM_DECODE)
    want = k32["logits"][:, :LM_DECODE]
    e_dec, sc = float((dec - want).abs().max()), float(want.abs().max())
    if not e_dec <= LM_RTOL * sc:
        fail(f"{AUDIO_ARCH} fp32: {LM_DECODE} decode steps against forward "
             f"differ by {e_dec:.3e} (> {LM_RTOL} × {sc:.3e})")
    log(f"{AUDIO_ARCH} fp32, batch {LM_BATCH}, {WHISPER_FRAMES} frames, "
        f"{WHISPER_TOKENS} tokens [{card}]: kernel path against plain path, "
        f"max abs err {', '.join(errs)}; {LM_DECODE} decode steps against "
        f"the cross cache of the encoder output vs forward: max abs err "
        f"{e_dec:.3e} of {sc:.3e}; kernel path encoder "
        f"{k32['enc_s'] * 1e3:.1f} ms, forward {k32['fwd_s'] * 1e3:.1f} ms; "
        f"plain path {p32['enc_s'] * 1e3:.1f} and "
        f"{p32['fwd_s'] * 1e3:.1f} ms")
    del k32, dec, want
    cast_in_place(params, torch.bfloat16)
    torch.cuda.empty_cache()
    p16 = run(cfg16, plain)
    k16 = kernel(f"{AUDIO_ARCH} bf16 (kernel path)", cfg16)
    errs = []
    for key in ("enc", "logits"):
        e_k = float((k16[key].float() - p32[key]).abs().max())
        e_p = float((p16[key].float() - p32[key]).abs().max())
        if not (bool(torch.isfinite(k16[key]).all())
                and e_k <= BF16_FACTOR * e_p):
            fail(f"{AUDIO_ARCH} bf16 {key}: kernel path's error {e_k:.3e} "
                 f"against the fp32 plain path > {BF16_FACTOR} × the bf16 "
                 f"plain path's {e_p:.3e}")
        errs.append(f"{key} {e_k:.3e} (kernel) vs {e_p:.3e} (plain)")
    dec16, dec16_s = decode(cfg16, k16["enc"], LM_DECODE)
    e16 = float((dec16.float() - p32["logits"][:, :LM_DECODE]).abs().max())
    log(f"{AUDIO_ARCH} bf16 [{card}]: error against the fp32 plain path "
        f"{', '.join(errs)}; encoder {k16['enc_s'] * 1e3:.1f} ms = "
        f"{LM_BATCH * WHISPER_FRAMES / k16['enc_s']:.0f} frames/s, forward "
        f"{k16['fwd_s'] * 1e3:.1f} ms = "
        f"{LM_BATCH * WHISPER_TOKENS / k16['fwd_s']:.0f} decoder tokens/s; "
        f"decode {dec16_s / LM_DECODE * 1e3:.2f} ms a step = "
        f"{LM_BATCH * LM_DECODE / dec16_s:.1f} tokens/s (logits max abs err "
        f"{e16:.3e} against fp32); plain path encoder "
        f"{p16['enc_s'] * 1e3:.1f} ms, forward {p16['fwd_s'] * 1e3:.1f} ms")
    del p16, k16, p32, dec16
    model = build_model(cfg16)
    with torch.inference_mode():
        profile_step(f"{AUDIO_ARCH} bf16 forward (kernel path)",
                     lambda: model.forward(params, {"tokens": tokens,
                                                    "frames": frames}))
    del params, model
    torch.cuda.empty_cache()
    serve_phase(AUDIO_ARCH, card, launches, FAMILY_SERVE_REQUESTS)


def rwkv_grad_check(dev, card: str) -> None:
    """Phase 21 (c): one ``loss_fn`` gradient of ``rwkv6-7b`` at full width
    cut to LM_STEP_LAYERS layers (batch LM_STEP_BATCH × LM_PROMPT), fp32
    against the same code on fp64 parameters: the loss within
    LM_LOSS_RTOL, each gradient leaf within max(LM_GRAD_FLOOR,
    LM_GRAD_FACTOR × its floor) of its largest entry, the floor being the
    same error of the plain path (``reference`` dispatch: the WKV scan as
    the one-step recurrence, token by token) over the first RWKV_FLOOR_SEQ
    tokens of each sequence (the token loop is slow, and its rounding is
    what the floor measures); then two bf16 calls give the same bits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.dispatch import DispatchConfig
    from repro_torch.data.pipeline import token_iterator
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.optim import value_and_grad
    from repro_torch.tree import leaves_with_paths, tree_map

    full = get_config(RWKV_ARCH)
    cfg32 = dataclasses.replace(full, dtype="float32",
                                n_layers=LM_STEP_LAYERS)
    cfg16 = dataclasses.replace(full, n_layers=LM_STEP_LAYERS)
    params = build_model(cfg32).init_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    batch = train.to_model_batch(full, next(token_iterator(
        0, LM_STEP_BATCH, LM_PROMPT, full.vocab_size)), dev)

    def grads(cfg, p, dispatch=None, batch=batch):
        model = build_model(cfg, dispatch=dispatch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, g = value_and_grad(lambda q, b: model.loss_fn(q, b)[0], p,
                                 batch)
        torch.cuda.synchronize()
        return {"loss": float(loss), "grads": leaves_with_paths(g),
                "ms": (time.perf_counter() - t0) * 1e3,
                "gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    def against_fp64(label, dispatch=None, batch=batch
                     ) -> tuple[dict, list, list]:
        """fp32 and fp64 runs of one path → (timings, each leaf's error
        relative to its largest entry, finiteness)."""
        a = grads(cfg32, params, dispatch, batch)
        c = grads(cfg32, tree_map(lambda x: x.double(), params), dispatch,
                  batch)
        if not abs(a["loss"] - c["loss"]) <= LM_LOSS_RTOL * abs(c["loss"]):
            fail(f"{RWKV_ARCH} grad ({label}): fp32 loss {a['loss']} vs "
                 f"fp64 {c['loss']}")
        errs = [float((x.double() - y).abs().max()) / float(y.abs().max())
                for (_, x), (_, y) in zip(a["grads"], c["grads"])]
        finite = [bool(torch.isfinite(x).all()) for _, x in a["grads"]]
        info = {"loss": c["loss"], "ms": (a["ms"], c["ms"]),
                "gib": max(a["gib"], c["gib"]),
                "paths": [path for path, _ in a["grads"]]}
        return info, errs, finite

    chunked, errs, finite = against_fp64("chunked scan")
    plain, floors, _ = against_fp64(
        "plain scan", DispatchConfig(path="reference"),
        {k: v[:, :RWKV_FLOOR_SEQ] for k, v in batch.items()})
    worst = (0.0, 0.0, "")
    for path, err, floor, ok in zip(chunked["paths"], errs, floors, finite):
        if not (ok and err <= max(LM_GRAD_FLOOR, LM_GRAD_FACTOR * floor)):
            fail(f"{RWKV_ARCH} grad fp32: {path} differs from fp64 by "
                 f"{err:.3e} of its largest entry (> {LM_GRAD_FLOOR} and > "
                 f"{LM_GRAD_FACTOR} × the plain scan's {floor:.3e}), or is "
                 f"non-finite")
        worst = max(worst, (err, floor, path))
    log(f"{RWKV_ARCH} grad, full width, {LM_STEP_LAYERS} layers, batch "
        f"{LM_STEP_BATCH}, seq {LM_PROMPT} [{card}]: loss "
        f"{chunked['loss']:.6f} (fp64), fp32 within {LM_LOSS_RTOL}; worst "
        f"gradient error against fp64 {worst[0]:.3e} of its largest entry "
        f"at {worst[2]} (the plain scan's there {worst[1]:.3e}); "
        f"value_and_grad fp32 / fp64 {chunked['ms'][0]:.1f} / "
        f"{chunked['ms'][1]:.1f} ms (plain scan over {RWKV_FLOOR_SEQ} "
        f"tokens {plain['ms'][0]:.1f} / {plain['ms'][1]:.1f} ms), peak {chunked['gib']:.2f} GiB (plain "
        f"scan {plain['gib']:.2f})")
    params = T.cast_params(params, torch.bfloat16)
    torch.cuda.empty_cache()
    a, b = grads(cfg16, params), grads(cfg16, params)
    differ = [path for (path, x), (_, y) in zip(a["grads"], b["grads"])
              if not torch.equal(x.view(torch.int16), y.view(torch.int16))]
    finite16 = all(bool(torch.isfinite(x).all()) for _, x in a["grads"])
    if differ or a["loss"] != b["loss"] or not finite16:
        fail(f"{RWKV_ARCH} grad bf16: two calls differ (loss {a['loss']} vs "
             f"{b['loss']}, gradients at {differ[:8]}) or non-finite")
    log(f"{RWKV_ARCH} grad bf16 [{card}]: loss {a['loss']:.6f}, two calls "
        f"bit-identical, value_and_grad {a['ms']:.1f} / {b['ms']:.1f} ms, "
        f"peak {a['gib']:.2f} GiB")
    del a, b, params
    torch.cuda.empty_cache()


def lm_family_train_phase(dev, card: str, launches: dict) -> None:
    """Phase 21: (a) phase 13 (a)'s gradient check at full depth for
    ``internvl2-1b`` (batch LM_STEP_BATCH × LM_PROMPT tokens after its
    sinusoidal vision prefix) and ``whisper-small`` (× WHISPER_TOKENS
    tokens, zero frames), the plain path's layers recomputed in its
    backward; (b)
    ``launch/train.py`` on each for LM_TRAIN_STEPS steps at batch
    LM_BATCH × LM_PROMPT (whisper: WHISPER_TOKENS): finite losses, the
    attention forward and backward launched once an attention call a
    step; (c) :func:`rwkv_grad_check`."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    lm_grad_check(dev, card, VLM_ARCH, launches, layers=None,
                  plain_remat="full")
    lm_grad_check(dev, card, AUDIO_ARCH, launches, layers=None,
                  seq=WHISPER_TOKENS, plain_remat="full")
    for arch, seq in ((AUDIO_ARCH, WHISPER_TOKENS), (VLM_ARCH, LM_PROMPT)):
        cfg = get_config(arch)
        ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_family_")
        argv = ["--arch", arch, "--seq", str(seq), "--batch", str(LM_BATCH),
                "--steps", str(LM_TRAIN_STEPS), "--ckpt-every", "0",
                "--log-every", "1", "--ckpt-dir", ckpt, "--seed", "0"]
        try:
            result = drive(f"train {arch}", ("flash_attention",
                                             "flash_attention_bwd"),
                           launches, lambda: train.main(argv))
            got = counts()
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        want = attn_calls(cfg) * LM_TRAIN_STEPS
        losses = [v for _, v in result["losses"]]
        if result["steps_run"] != LM_TRAIN_STEPS \
                or got["flash_attention"] != want \
                or got["flash_attention_bwd"] != want \
                or len(losses) != LM_TRAIN_STEPS \
                or not all(math.isfinite(v) for v in losses):
            fail(f"train {arch}: {result['steps_run']} steps, losses "
                 f"{losses}, attention launches {got['flash_attention']} "
                 f"forward and {got['flash_attention_bwd']} backward; want "
                 f"{want} each")
        step_ms = [t * 1e3 for t in result["step_s"]]
        steady = statistics.median(step_ms[1:])
        positions = seq + cfg.vision_prefix_len
        log(f"train {arch}, full depth, bf16, batch {LM_BATCH}, seq {seq}"
            + (f" after {cfg.vision_prefix_len} vision positions"
               if cfg.vision_prefix_len else
               f" against {cfg.encoder_context_len} frames"
               if cfg.encoder_decoder else "")
            + f" [{card}]: step ms {[round(t, 1) for t in step_ms]}, median "
            f"after the first {steady:.1f} ms = "
            f"{LM_BATCH * seq / steady * 1e3:.0f} tokens/s "
            f"({LM_BATCH * positions / steady * 1e3:.0f} decoder positions/s)"
            f"; losses {losses}; loop wall {result['wall_s']:.2f} s incl. "
            f"the final checkpoint")
    rwkv_grad_check(dev, card)


def trace_overlap(path: str) -> tuple[float, float, float]:
    """Seconds of ingest decode, of device dispatch, and of their overlap
    in a flight-recorder trace (``serve --trace-out``)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]

    def union(name):
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("name") == name)
        out = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    ing, dev = union("ingest-decode"), union("device-dispatch")
    both = sum(max(0.0, min(b, d) - max(a, c)) for a, b in ing
               for c, d in dev)
    return (sum(b - a for a, b in ing) / 1e6,
            sum(b - a for a, b in dev) / 1e6, both / 1e6)


def make_client(cfg, directory: str, out: dict) -> None:
    """The synthetic client's bytes, made once for every serving phase:
    ``CLIENT_IMAGES`` mixed-quality JFIF files written to ``directory``
    (the phases serve them through ``--jpeg-dir``); then the decode pool's
    cold start, timed on a batch of them.  Runs beside the kernels'
    build; ``out`` gets the timings, or the exception."""
    try:
        from repro_torch.codec import ingest as ingestlib
        from repro_torch.launch import serve

        t0 = time.perf_counter()
        make = serve.jpeg_byte_requests(TRAIN_BATCH, cfg, 0)
        datas = []
        for step in range(CLIENT_IMAGES // TRAIN_BATCH):
            datas += make(step)
        for i, d in enumerate(datas):
            with open(os.path.join(directory, f"client_{i:03d}.jpg"),
                      "wb") as f:
                f.write(d)
        out["encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = cfg.image_size // 8
        ingestlib.ingest_batch(datas[:TRAIN_BATCH], quality=50, grid=(n, n),
                               channels=cfg.in_channels, with_stats=False)
        out["pool_start_s"] = time.perf_counter() - t0
        out["workers"] = ingestlib.ingest_workers()
    except BaseException as e:  # re-raised by the main thread
        out["error"] = e


def qos_phase(cfg, dev, launches: dict, slot_reports: dict,
              jpeg_dir: str) -> None:
    """Phase 7: ``serve --qos --ingest bytes`` at full width (see the
    module docstring), two passes over one ``--plan-dir``."""
    import numpy as np
    import torch

    from repro_torch.codec import ingest as ingestlib
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.launch import serve

    plan_dir = tempfile.mkdtemp(prefix="chip_smoke_qos_")
    grid = cfg.image_size // 8
    plain = dsp.DispatchConfig(path="reference")
    try:
        base = ["--arch", "jpeg-resnet", "--qos", "--ingest", "bytes",
                "--bands", str(QOS_BANDS), "--batch", str(TRAIN_BATCH),
                "--batch-buckets", "1,2,4,8", "--plan-dir", plan_dir,
                "--jpeg-dir", jpeg_dir, "--seed", "0"]
        served = {}

        def run(label, extra, on_served=None):
            args = serve.parse_args(base + extra)
            t0 = time.perf_counter()
            out = drive(label, JPEG_KERNELS, launches,
                        lambda: serve.serve_jpeg_resnet(
                            args, on_served=on_served),
                        replayed=lambda r: r["qos"]["graph_launches"])
            log(f"{label}: entry point took {time.perf_counter() - t0:.2f} "
                f"s (plan and ladder "
                f"{'restored' if not out['plan']['built'] else 'built'}, "
                f"{out['qos']['grid']['cells']} graphs captured in "
                f"{out['qos']['warmup_s']:.2f} s); replay launches "
                f"{out['qos']['graph_launches']}")
            return out

        def hold(ladder, reqs, grid_engine):
            # every served request against its tier's plain path, while
            # the grid's cells are alive
            served.update(ladder=ladder, grid=grid_engine)
            errs, agree, n = [], 0, 0
            tiers = {t.name: t for t in ladder.tiers}
            with torch.inference_mode():
                for name in sorted({r.tier for _, _, r in reqs}):
                    group = [(p, r) for _, p, r in reqs if r.tier == name]
                    cp = tiers[name].compiled
                    x, _ = ingestlib.ingest_batch(
                        [p for p, _ in group],
                        quality=ladder.base.spec.quality, grid=(grid, grid),
                        channels=cfg.in_channels, pack_width=cp.stem.w_in,
                        with_stats=False)
                    want = planlib.apply_compiled_packed(
                        cp, torch.as_tensor(x).to(dev), plain)
                    got = torch.as_tensor(
                        np.stack([r.result() for _, r in group])).to(dev)
                    errs.append(compare(f"qos {name} logits vs plain", got,
                                        want, LOGIT_RTOL))
                    agree += int((got.argmax(-1) == want.argmax(-1)).sum())
                    n += len(group)
            served.update(errs=errs, agree=agree, n=n,
                          x8=[p for _, p, _ in reqs[:TRAIN_BATCH]])

        trace1 = os.path.join(plan_dir, "trace1.json")
        r1 = run("serve --qos", ["--requests", str(QOS_REQUESTS),
                                 "--trace-out", trace1, "--profile-grid",
                                 "--hw-profile", "h100"], on_served=hold)
        q = r1["qos"]
        if r1["completed"] != QOS_REQUESTS or q["compiles_post_warmup"] != 0:
            fail(f"qos: {r1['completed']} of {QOS_REQUESTS} served, "
                 f"{q['compiles_post_warmup']} captures after warmup")
        profile_grid_gates(r1, served["grid"], trace1)
        # a tier that shares an earlier tier's schedule replays its cells
        column = {t.name: served["ladder"].tiers[t.shared_with].name
                  if t.shared_with is not None else t.name
                  for t in served["ladder"].tiers}
        for tier in q["per_tier"]:
            if not any(k.startswith(column[tier] + "/")
                       for k in q["cell_replays"]):
                fail(f"qos: tier {tier} served with no graph replayed")
        if served["agree"] != served["n"] or served["n"] != QOS_REQUESTS:
            fail(f"qos: top-1 agreement {served['agree']}/{served['n']} "
                 f"< 1.0")
        ing_s, dev_s, both_s = trace_overlap(trace1)
        lad = q["ladder"]
        dir_bytes = sum(os.path.getsize(os.path.join(r, f))
                        for r, _, fs in os.walk(plan_dir) for f in fs)
        log(f"qos pass 1: {r1['images_per_s']:.2f} images/s over "
            f"{r1['wall_s']:.3f} s, latency {r1['latency_ms']}; ingest "
            f"{q['ingest_wall_s']:.3f} s + device {q['device_wall_s']:.3f} s "
            f"(trace: ingest {ing_s:.3f} s, device {dev_s:.3f} s, overlap "
            f"{both_s:.3f} s = {both_s / max(ing_s, 1e-9):.3f} of ingest); "
            f"batches by tier { {k: v['batches'] for k, v in q['per_tier'].items()} }, "
            f"switches {[(e['from'], e['to'], e['reason']) for e in q['tier_switches']]}; "
            f"ladder device bytes {lad['device_bytes']} (top tier alone "
            f"{lad['top_tier_bytes']}); plan directory {dir_bytes} bytes; "
            f"tiers "
            f"{[(t['name'], t['bands'], t['fused']) for t in q['tiers']]}; "
            f"logits vs each tier's plain path: max abs err "
            f"{max(served['errs']):.3e}, top-1 agreement "
            f"{served['agree'] / served['n']}")

        # each distinct tier's bucket-1 and bucket-8 cells, replayed by the
        # grid that served (no new capture): the replay against the same
        # forward run eagerly, and bucket 8 on served images held against
        # the plain path
        ladder, grid_engine = served["ladder"], served["grid"]
        with torch.inference_mode():
            for tier, col in zip(ladder.tiers, grid_engine.columns):
                if tier.shared_with is not None:
                    continue
                cp = tier.compiled
                rows, _ = ingestlib.ingest_batch(
                    served["x8"], quality=ladder.base.spec.quality,
                    grid=(grid, grid), channels=cfg.in_channels,
                    pack_width=cp.stem.w_in, with_stats=False)
                for bucket in (1, 8):
                    cell = col.cells[("bytes", bucket)]
                    x = torch.as_tensor(rows[:bucket]).to(dev)
                    if bucket == 8:
                        compare(f"{tier.name} b8 graph vs plain",
                                cell(rows).clone(),
                                planlib.apply_compiled_packed(cp, x, plain),
                                LOGIT_RTOL)
                    graph = cell.time_wall(iters=5) * 1e3
                    eager = cuda_ms(lambda: planlib.apply_compiled_packed(
                        cp, x), reps=3, warmup=1)
                    t0 = time.perf_counter()
                    for _ in range(3):
                        planlib.apply_compiled_packed(cp, x)
                    host = (time.perf_counter() - t0) / 3 * 1e3
                    torch.cuda.synchronize()
                    log(f"{tier.name} bucket {bucket}: graph replay "
                        f"{graph:.3f} ms, eager forward {eager:.3f} ms "
                        f"(host {host:.3f} ms to issue it), "
                        f"{sum(cell.graph_launches.values())} kernel "
                        f"launches a replay {cell.graph_launches}")
        del ladder, grid_engine, served["ladder"], served["grid"]
        torch.cuda.empty_cache()

        # pass 2: restart from the same --plan-dir with a longer burst
        # under a deadline at pass 1's p95 latency: the burst's tail is
        # shed, and the policy steps down (queue depth, deadline slack)
        deadline = r1["latency_ms"]["p95_ms"]
        r2 = run("serve --qos restart",
                 ["--requests", str(QOS_RESTART_REQUESTS),
                  "--deadline-ms", f"{deadline:.1f}"])
        q2 = r2["qos"]
        if r2["plan"]["built"] or not q2["ladder"]["restored"]:
            fail("qos restart: the plan or the ladder was built again")
        if not q2["tier_switches"]:
            fail(f"qos restart: no tier switch under a {deadline:.1f} ms "
                 f"deadline")
        log(f"qos pass 2 (deadline {deadline:.1f} ms): "
            f"{r2['images_per_s']:.2f} images/s, latency "
            f"{r2['latency_ms']}, completed {r2['completed']} of "
            f"{QOS_RESTART_REQUESTS}, shed {q2['deadline_shed']}, misses "
            f"{q2['deadline_misses']}; batches by tier "
            f"{ {k: v['batches'] for k, v in q2['per_tier'].items()} }; "
            f"switches {[(e['from'], e['to'], e['reason']) for e in q2['tier_switches']]}")
        for phase in ("compiled", "per-layer"):
            r = slot_reports[phase]
            log(f"beside it, phase 3-4 {phase} (16 bands, batch 4, no "
                f"graphs): {r['images_per_s']:.2f} images/s, ingest wait "
                f"{r['ingest_s']:.3f} s + forward {r['forward_s']:.3f} s")

        chaos_pass(run, plan_dir, cfg, dev)
    finally:
        shutil.rmtree(plan_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def profile_grid_gates(report: dict, grid_engine, trace_path: str) -> None:
    """Phase 7 pass 1's ``--profile-grid --hw-profile h100``: every warmed
    cell has a predicted and a measured capacity, and every
    ``device-dispatch`` span of the flight recorder carries its cell's
    ``predicted_us``."""
    pg = report["profile_grid"]
    rows = {c["cell"]: c for c in pg["cells"]}
    want = {c.name for c in grid_engine.cells()}
    if set(rows) != want or pg["hw_profile"]["name"] != "h100" or not all(
            c["predicted_req_s"] > 0 and c["measured_req_s"] > 0
            for c in rows.values()):
        fail(f"qos --profile-grid: cells {sorted(rows)} against the "
             f"warmed {sorted(want)}, profile {pg['hw_profile']}")
    with open(trace_path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e["name"] == "device-dispatch"]
    bare = [e for e in spans if not e.get("args", {}).get("predicted_us")]
    if not spans or bare:
        fail(f"qos --profile-grid: {len(bare)} of {len(spans)} "
             f"device-dispatch spans without predicted_us")
    log(f"qos --profile-grid (h100 profile): sweep {pg['seconds']:.2f} s "
        f"over {len(rows)} cells; predicted / measured images/s: "
        + ", ".join(f"{k} {c['predicted_req_s']:.1f} / "
                    f"{c['measured_req_s']:.1f}"
                    for k, c in sorted(rows.items()))
        + f"; {len(spans)} device-dispatch spans annotated")


def chaos_pass(run, plan_dir: str, cfg, dev) -> None:
    """Phase 7's third pass: ``serve --qos --chaos`` from the same
    ``--plan-dir`` at the reference's chaos defaults, with
    ``--metrics-out`` and ``--jax-profile`` on (see the module
    docstring)."""
    import numpy as np
    import torch

    from repro_torch import serving
    from repro_torch.codec import CodecError
    from repro_torch.codec import ingest as ingestlib
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib

    grid = cfg.image_size // 8
    plain = dsp.DispatchConfig(path="reference")
    metrics_path = os.path.join(plan_dir, "metrics.prom")
    prof_dir = os.path.join(plan_dir, "profile")
    trace3 = os.path.join(plan_dir, "trace3.json")
    held = {}

    def hold(ladder, reqs, grid_engine):
        # the drill's corruption is a function of (seed, index) alone
        inj = serving.FaultInjector(serving.FaultSpec(
            seed=CHAOS_SEED, corrupt_rate=CHAOS_RATE))
        for i, p, _ in reqs:
            inj.corrupt(i, p)
        bad = set(inj.corrupted)
        for i, _, r in reqs:
            e = r.error()
            if i in bad:
                if r.tier is not None or not (
                        isinstance(e, serving.RequestFailed)
                        and e.stage == "codec"
                        and isinstance(e.__cause__, CodecError)):
                    fail(f"chaos: corrupted request {i} was served or "
                         f"failed untyped ({r.tier}, {e!r})")
            elif e is not None:
                fail(f"chaos: healthy request {i} failed: {e!r}")
        tiers = {t.name: t for t in ladder.tiers}
        errs, agree, n = [], 0, 0
        with torch.inference_mode():
            for name in sorted({r.tier for _, _, r in reqs} - {None}):
                group = [(p, r) for _, p, r in reqs if r.tier == name]
                cp = tiers[name].compiled
                x, _ = ingestlib.ingest_batch(
                    [p for p, _ in group], quality=ladder.base.spec.quality,
                    grid=(grid, grid), channels=cfg.in_channels,
                    pack_width=cp.stem.w_in, with_stats=False)
                want = planlib.apply_compiled_packed(
                    cp, torch.as_tensor(x).to(dev), plain)
                got = torch.as_tensor(
                    np.stack([r.result() for _, r in group])).to(dev)
                errs.append(compare(f"chaos {name} logits vs plain", got,
                                    want, LOGIT_RTOL))
                agree += int((got.argmax(-1) == want.argmax(-1)).sum())
                n += len(group)
        held.update(errs=errs, agree=agree, n=n, bad=len(bad))

    r3 = run("serve --qos --chaos",
             ["--requests", str(QOS_RESTART_REQUESTS), "--chaos",
              "--chaos-rate", str(CHAOS_RATE), "--chaos-seed",
              str(CHAOS_SEED), "--metrics-out", metrics_path,
              "--metrics-interval", str(METRICS_INTERVAL),
              "--jax-profile", prof_dir, "--trace-out", trace3],
             on_served=hold)
    q3, c3 = r3["qos"], r3["chaos"]
    if r3["plan"]["built"] or not q3["ladder"]["restored"]:
        fail("qos chaos: the plan or the ladder was built again")
    if c3["healthy_completed"] != c3["healthy_total"] \
            or c3["corrupted"] != held["bad"] \
            or c3["failed_by_stage"].get("codec") != c3["corrupted"]:
        fail(f"qos chaos: {c3}")
    if held["agree"] != held["n"]:
        fail(f"qos chaos: top-1 agreement {held['agree']}/{held['n']}")
    if c3["killed_worker_pid"] is None or q3["pool_restarts"] < 1:
        fail(f"qos chaos: no decode worker killed and respawned "
             f"({c3['killed_worker_pid']}, {q3['pool_restarts']})")
    hops = [(e["from"], e["to"]) for e in q3["breaker_timeline"]]
    walk = [("closed", "open"), ("open", "half_open"),
            ("half_open", "closed")]
    if hops[:3] != walk or r3["health"]["breaker"]["state"] != "closed":
        fail(f"qos chaos: breaker walk {hops}, state "
             f"{r3['health']['breaker']['state']}")
    if q3["compiles_post_warmup"] != 0:
        fail(f"qos chaos: {q3['compiles_post_warmup']} captures after "
             f"warmup")
    due = int(r3["metrics_window_s"] / METRICS_INTERVAL)
    with open(metrics_path) as f:
        families = sum(1 for ln in f if ln.startswith("# TYPE"))
    if r3["metrics_writes"] < due or not families:
        fail(f"qos chaos: {r3['metrics_writes']} metrics snapshots over "
             f"{r3['metrics_window_s']:.2f} s at {METRICS_INTERVAL} s")
    with open(r3["profile"]) as f:
        events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset")]
    ours = {k: sum(1 for e in device if k in e.get("name", ""))
            for k in DEVICE_KERNELS}
    if not device:
        fail("qos chaos: the profiler trace holds no device events")
    named = {k: v for k, v in ours.items() if v}
    # the decode batch that met the killed worker carries the respawn
    with open(trace3) as f:
        spans = sorted(e["dur"] / 1e6 for e in json.load(f)["traceEvents"]
                       if e.get("ph") == "X"
                       and e.get("name") == "ingest-decode")
    log(f"qos pass 3 (chaos, under torch.profiler and the faults): "
        f"{r3['images_per_s']:.2f} images/s (not comparable with pass 1), "
        f"completed {r3['completed']} of {QOS_RESTART_REQUESTS}; chaos "
        f"{c3}; failures {q3['failures_total']}; breaker {hops}; pool "
        f"restarts {q3['pool_restarts']}; healthy logits vs their tier's "
        f"plain path: max abs err {max(held['errs']):.3e}, top-1 "
        f"{held['agree']}/{held['n']}; metrics {r3['metrics_writes']} "
        f"snapshots over {r3['metrics_window_s']:.2f} s ({families} "
        f"families); profiler trace {len(events)} events, {len(device)} "
        f"on the device, our kernels by name "
        f"{named or 'none (graph replays hide them)'}; ingest-decode spans "
        f"(flight recorder): {len(spans)}, longest {spans[-1]:.3f} s, "
        f"median {statistics.median(spans):.3f} s, sum {sum(spans):.3f} s; "
        f"wall {r3['wall_s']:.3f} s, device {q3['device_wall_s']:.3f} s")


def torch_layout_weights(spec, seed: int = 0) -> dict:
    """Random full-width weights as a torch training run would export them
    (``{name: array}``, OIHW convs, batch norms as (γ, β, μ, σ²)), drawn by
    numpy from ``seed``: He-normal convs, batch norms around the identity
    (so the fold carries real scales and shifts), the head scaled by
    ``sqrt(1/C)``."""
    import numpy as np

    from repro_torch.core import resnet

    rng = np.random.default_rng(seed)
    out: dict = {}

    def conv(name, cout, cin, r):
        out[name] = (rng.standard_normal((cout, cin, r, r))
                     * np.sqrt(2.0 / (cin * r * r))).astype(np.float32)

    def bn(name, c):
        out[f"{name}.weight"] = (1.0 + 0.2 * rng.standard_normal(c)
                                 ).astype(np.float32)
        out[f"{name}.bias"] = (0.1 * rng.standard_normal(c)).astype(
            np.float32)
        out[f"{name}.running_mean"] = (0.1 * rng.standard_normal(c)
                                       ).astype(np.float32)
        out[f"{name}.running_var"] = (1.0 + 0.3 * rng.uniform(size=c)
                                      ).astype(np.float32)

    conv("stem.weight", spec.widths[0], spec.in_channels, 3)
    bn("stem_bn", spec.widths[0])
    for name, s, cin, w in resnet._stages(spec):
        conv(f"{name}.conv1.weight", w, cin, 3)
        conv(f"{name}.conv2.weight", w, w, 3)
        if s != 1 or cin != w:
            conv(f"{name}.proj.weight", w, cin, 1)
        bn(f"{name}.bn1", w)
        bn(f"{name}.bn2", w)
    c = spec.widths[-1]
    out["head.weight"] = (rng.standard_normal((spec.num_classes, c))
                          / np.sqrt(c)).astype(np.float32)
    out["head.bias"] = np.zeros(spec.num_classes, np.float32)
    return out


def conversion_phase(cfg, dev, launches: dict, jpeg_dir: str) -> None:
    """Phase 8: the paper's conversion at full width (see the module
    docstring), parts (a)-(e)."""
    import math

    import numpy as np
    import torch

    from repro_torch.codec import ingest as ingestlib
    from repro_torch.configs.jpeg_resnet import spec_of
    from repro_torch.core import convert
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import jpeg as jpeglib
    from repro_torch.core import plan as planlib
    from repro_torch.core import resnet
    from repro_torch.core import transform_linear as tl
    from repro_torch.data.pipeline import list_jpeg_files
    from repro_torch.data.synthetic import image_batch

    t_phase = time.perf_counter()
    spec = spec_of(cfg)
    tensors = torch_layout_weights(spec, seed=0)
    params, state = convert.from_torch_layout(tensors, spec, device=dev)
    images = torch.as_tensor(image_batch(0, 0, CONVERT_IMAGES,
                                         cfg.image_size, cfg.in_channels,
                                         cfg.num_classes)["images"]).to(dev)
    ref_cfg = dsp.DispatchConfig(path="reference")
    jpeg_kernels = ("jpeg_conv", "asm_relu", "block_dct", "block_idct")

    # (a) convert_and_verify at φ = 14, 64 bands: first the plain path's
    # own deviation, which sets the gate, then the kernels
    t0 = time.perf_counter()
    with dsp.override(path="reference"):
        _, plain_dev = convert.convert_and_verify(params, state, spec,
                                                  images, atol=math.inf)
    gate = max(CONVERT_ATOL, 10.0 * plain_dev)

    def verify():
        model, dev_k = convert.convert_and_verify(params, state, spec,
                                                  images, atol=gate)
        with torch.inference_mode():
            coef = dsp.block_dct(jpeglib.block_channels_last(images),
                                 spec.quality, model.dispatch)
            return model, dev_k, coef, model(coef)

    try:
        model, dev_k, coef, logits_a = drive(
            "convert_and_verify", jpeg_kernels, launches, verify)
    except ValueError as e:
        fail(f"convert_and_verify: {e} (gate max({CONVERT_ATOL}, 10 x the "
             f"plain path's {plain_dev:.3e}))")
    with torch.inference_mode():
        spatial, _ = resnet.spatial_apply(params, state, images,
                                          training=False, spec=spec)
    big = float(spatial.abs().max())
    log(f"convert (a) full jpeg-resnet, {CONVERT_IMAGES} images, phi 14, 64 "
        f"bands: spatial (cuDNN fp32) vs JPEG (kernels) max logit deviation "
        f"{dev_k:.3e}, largest |logit| {big:.4f}, ratio {dev_k / big:.3e}; "
        f"the plain path's own deviation {plain_dev:.3e}; gate "
        f"{gate:.3e}; fused ops {model.plan.cfg}, "
        f"{time.perf_counter() - t0:.2f} s")

    # (b) unfused operators, per-step batch norm
    t0 = time.perf_counter()
    unfused = convert.convert(params, state, spec, fuse_bn=False)

    def unfused_fwd():
        with torch.inference_mode():
            return resnet.jpeg_apply_precomputed(
                params, state, unfused.operators, coef, spec=spec,
                dispatch=unfused.dispatch)

    logits_b = drive("convert fuse_bn=False", jpeg_kernels, launches,
                     unfused_fwd)
    err_b = compare("unfused vs fused conversion", logits_b, logits_a,
                    LOGIT_RTOL)
    del unfused
    log(f"convert (b) fuse_bn=False -> jpeg_apply_precomputed: max abs err "
        f"{err_b:.3e} against (a)'s JPEG logits, "
        f"{time.perf_counter() - t0:.2f} s")

    # (c) the compiled schedule at 40 bands: stage 0 fused
    t0 = time.perf_counter()
    cp = resnet.compile_for_inference(params, state, spec, bands=QOS_BANDS)
    if "s0b0" not in cp.meta["fused"] or cp.meta["path"] != "cuda":
        fail(f"compile_for_inference: {cp.meta['fused']} fused on "
             f"{cp.meta['path']}")

    def compiled_fwd():
        with torch.inference_mode():
            return planlib.apply_compiled(cp, coef)

    logits_c = drive("compile_for_inference", JPEG_KERNELS, launches,
                     compiled_fwd)
    with torch.inference_mode():
        want_c = planlib.apply_compiled(cp, coef, ref_cfg)
    err_c = compare("compiled conversion vs plain", logits_c, want_c,
                    LOGIT_RTOL)
    top1_c = float((logits_c.argmax(-1) == want_c.argmax(-1)).float().mean())
    if top1_c != 1.0:
        fail(f"compile_for_inference: top-1 agreement {top1_c}")
    log(f"convert (c) compile_for_inference(bands={QOS_BANDS}) -> "
        f"apply_compiled: fused {cp.meta['fused']}, per-layer "
        f"{sorted(cp.meta['layers'])}; max abs err {err_c:.3e} vs the same "
        f"plan's plain path, top-1 {top1_c}, "
        f"{time.perf_counter() - t0:.2f} s")
    del cp
    torch.cuda.empty_cache()

    # (d) autotuned bands, probed on the client's JFIF files
    t0 = time.perf_counter()
    n = cfg.image_size // 8
    datas = []
    for path in list_jpeg_files(jpeg_dir)[:AUTOTUNE_PROBE]:
        with open(path, "rb") as f:
            datas.append(f.read())
    probe_np, stats = ingestlib.ingest_batch(
        datas, quality=spec.quality, grid=(n, n), channels=cfg.in_channels)
    probe = torch.as_tensor(probe_np).to(dev)
    forwards = [0]
    real_apply = planlib.apply_plan

    def counting(*a, **kw):
        forwards[0] += 1
        return real_apply(*a, **kw)

    planlib.apply_plan = counting
    try:
        tuned = convert.convert(params, state, spec, bands="auto",
                                probe_coef=probe, profile=stats.energy,
                                occupancy=stats.occupancy)
    finally:
        planlib.apply_plan = real_apply
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    full = planlib.build_plan(params, state, spec,
                              dispatch=dsp.DispatchConfig(path="reference",
                                                          bands=64))

    def tuned_fwd():
        with torch.inference_mode():
            return tuned(probe)

    logits_d = drive("convert bands=auto", ("jpeg_conv", "asm_relu"),
                     launches, tuned_fwd)
    with torch.inference_mode():
        want_d = planlib.apply_plan(full, probe)
        plain_d = planlib.apply_plan(tuned.plan, probe, ref_cfg)
    err_d = float((logits_d - want_d).abs().max())
    # the sweep accepted the assignment on the plain path; the kernels add
    # their own fp32 rounding to that margin
    sweep_d = float((plain_d - want_d).abs().max())
    kern_d = float((logits_d - plain_d).abs().max())
    top1_d = float((logits_d.argmax(-1) == want_d.argmax(-1)).float().mean())
    if not (err_d <= AUTOTUNE_TOL and top1_d == 1.0):
        fail(f"autotuned plan on the kernels vs the 64-band reference path: "
             f"max abs err {err_d:.3e} (tol {AUTOTUNE_TOL}), top-1 {top1_d}")
    log(f"convert (d) bands=auto, probe of {len(datas)} client JFIF files "
        f"(profile: IngestStats.energy): per-layer bands {tuned.plan.bands}; "
        f"provenance {tuned.plan.provenance}; {forwards[0]} probe forwards "
        f"on the plain path in {sweep_s:.2f} s (with the build); served on "
        f"the kernels: max abs err {err_d:.3e} vs the 64-band reference "
        f"path (tol {AUTOTUNE_TOL}), top-1 {top1_d}; the same plan on the "
        f"plain path {sweep_d:.3e} (the sweep's margin "
        f"{AUTOTUNE_TOL - sweep_d:.3e}), kernels vs plain {kern_d:.3e}, "
        f"largest |logit| {float(want_d.abs().max()):.4f}")
    del tuned, full
    torch.cuda.empty_cache()

    # (e) a ViT patch embedding folded onto the kernel's coefficients
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    w = torch.as_tensor((rng.standard_normal(
        (cfg.in_channels * PATCH * PATCH, PATCH_DIM)) * 0.02).astype(
        np.float32)).to(dev)

    def folded():
        with torch.inference_mode():
            c = tl.coefficient_patches(images, PATCH, 50)
            return c @ tl.fold_patch_embed(w, PATCH, cfg.in_channels,
                                           quality=50, scaled=True)

    got_e = drive("fold_patch_embed", ("block_dct",), launches, folded)
    with torch.inference_mode():
        want_e = tl.unfold_patches_to_blocks(images, PATCH) @ w
    err_e = float((got_e - want_e).abs().max())
    big_e = float(want_e.abs().max())
    if not err_e <= FOLD_RTOL * big_e:
        fail(f"fold_patch_embed: max abs err {err_e:.3e} > {FOLD_RTOL} x "
             f"{big_e:.3e}")
    log(f"convert (e) fold_patch_embed (patch {PATCH}, d {PATCH_DIM}, q50) "
        f"on block_dct coefficients vs the pixel-patch projection: max abs "
        f"err {err_e:.3e} of {big_e:.4f} (relative {err_e / big_e:.3e}), "
        f"{time.perf_counter() - t0:.2f} s")
    del params, state, model, coef
    torch.cuda.empty_cache()
    log(f"conversion phase: {time.perf_counter() - t_phase:.2f} s")


def introspection_phase(cfg, dev, launches: dict) -> None:
    """Phase 9: ``launch.inspect`` once, then ``predicted_vs_measured`` on
    the ``h100`` profile at 16 and 40 bands for (i) the ``cuda`` plan
    (the kernels), (ii) the same weights compiled on the ``reference``
    path (the spatial lowering for the stem and fused steps, the plain
    versions elsewhere) and (iii) the ``cuda`` plan under
    ``executor="gemm"`` and a ``reference`` config (the kernels' plain
    twin); each report validated, its logits bit-identical under
    profiling, its walls reconciled within ``RECONCILE_TOL``, its steps'
    FLOPs within ``FLOPS_TOL`` of the whole walk's, and (i) and (ii)
    within ``LOGIT_RTOL`` of (iii); then :func:`cudnn_probe`."""
    import torch

    from repro_torch import introspect
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.data.pipeline import jpeg_iterator
    from repro_torch.launch import inspect as inspectlib
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    hw = introspect.PROFILES["h100"]
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_inspect_"),
                        "report.json")
    atexit.register(shutil.rmtree, os.path.dirname(path), True)
    drive("inspect CLI", JPEG_KERNELS, launches, lambda: inspectlib.main(
        ["--arch", "jpeg-resnet", "--batch", str(TRAIN_BATCH), "--bands",
         str(BANDS), "--executor", "auto", "--hw-profile", "h100",
         "--report-out", path]))
    with open(path) as f:
        summary = introspect.validate_report(json.load(f))
    log(f"inspect CLI (16 bands, batch {TRAIN_BATCH}, executor auto = the "
        f"kernels): {summary}")

    x = next(jpeg_iterator(0, TRAIN_BATCH, cfg.image_size, cfg.in_channels,
                           cfg.num_classes, device=dev))["coefficients"]
    for bands in (BANDS, QOS_BANDS):
        args = serve.parse_args(["--arch", "jpeg-resnet", "--bands",
                                 str(bands), "--seed", "0"])
        _, cp, _ = serve.prepare_plan(args, cfg, dev)
        args.dispatch = "reference"
        _, cp_ref, _ = serve.prepare_plan(args, cfg, dev)
        plain = cp._replace(cfg=dsp.DispatchConfig(path="reference",
                                                   bands=bands))
        runs = (("kernels", cp, None, JPEG_KERNELS),
                ("spatial", cp_ref, None, ()),
                ("gemm twin", plain, "gemm", ()))
        reports, logits = {}, {}
        for label, plan_, executor, required in runs:
            rep = drive(f"introspect {bands} bands, {label}", required,
                        launches, lambda: introspect.predicted_vs_measured(
                            plan_, x, executor=executor, hw=hw))
            introspect.validate_report(rep)
            t = rep["totals"]
            if not t["logits_match"] \
                    or abs(t["reconciliation"] - 1) > RECONCILE_TOL \
                    or abs(t["static_flops_ratio"] - 1) > FLOPS_TOL:
                fail(f"introspect {bands} bands, {label}: logits_match "
                     f"{t['logits_match']}, reconciliation "
                     f"{t['reconciliation']:.4f}, steps' FLOPs / whole "
                     f"{t['static_flops_ratio']:.4f}")
            with torch.inference_mode():
                logits[label] = planlib.apply_compiled(plan_, x,
                                                       executor=executor)
            reports[label] = rep
            log(f"introspect {bands} bands, {label} "
                f"(executor {executor}): predicted "
                f"{t['predicted_us']:.1f} us, measured "
                f"{t['measured_us']:.1f} us, unprofiled wall "
                f"{t['unprofiled_wall_us']:.1f} us, reconciliation "
                f"{t['reconciliation']:.4f}, steps' FLOPs / whole "
                f"{t['static_flops_ratio']:.6f}, worst ratio "
                f"{introspect.worst_ratio(rep):.2f}")
            for b in rep["blocks"]:
                log(f"  {b['name']:<5} {b['kind']:<6} {b['executor']:<7} "
                    f"flops {b['flops']:.4g} bytes {b['bytes']:.4g} "
                    f"smem {b['vmem_bytes']} predicted "
                    f"{b['predicted_us']:.1f} us ({b['term']}) measured "
                    f"{b['measured_us']:.1f} us ratio {b['ratio']:.2f}")
        for label in ("kernels", "spatial"):
            err = compare(f"introspect {bands} bands, {label} vs gemm twin",
                          logits[label], logits["gemm twin"], LOGIT_RTOL)
            log(f"introspect {bands} bands: {label} logits vs the gemm "
                f"twin's: max abs err {err:.3e}")
        by_step = {label: {b["name"]: b for b in rep["blocks"]}
                   for label, rep in reports.items()}
        for name in cp.meta["fused"]:
            k, sp = by_step["kernels"][name], by_step["spatial"][name]
            log(f"introspect {bands} bands, fused {name}: banded kernels "
                f"{k['measured_us']:.1f} us (predicted "
                f"{k['predicted_us']:.1f}) vs spatial lowering (cuDNN) "
                f"{sp['measured_us']:.1f} us (predicted "
                f"{sp['predicted_us']:.1f}); plain gemm twin "
                f"{by_step['gemm twin'][name]['measured_us']:.1f} us")
        del cp, cp_ref, plain, logits
        torch.cuda.empty_cache()
    cudnn_probe(dev)
    log(f"introspection phase: {time.perf_counter() - t_phase:.2f} s")


def cudnn_probe(dev) -> None:
    """Phase 9's yardstick for the spatial lowering: one cuDNN fp32 3×3
    conv (no TF32) at each stage's width and size, batch 8, on the
    algorithm cuDNN's heuristic picks (what every walk runs) and on the
    one ``cudnn.benchmark`` picks, beside the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.introspect.opcount import bound

    gen = torch.Generator(device=dev).manual_seed(7)
    for c, px in ((64, 256), (128, 128), (256, 64), (512, 32)):
        x = torch.randn((TRAIN_BATCH, c, px, px), generator=gen, device=dev)
        w = torch.randn((c, c, 3, 3), generator=gen, device=dev)
        with torch.inference_mode():
            heuristic = cuda_ms(lambda: F.conv2d(x, w, padding=1))
            prev = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True
            try:
                tuned = cuda_ms(lambda: F.conv2d(x, w, padding=1))
            finally:
                torch.backends.cudnn.benchmark = prev
        ms, by = bound(2.0 * x.numel() * c * 9, 4.0 * (2 * x.numel()
                                                       + w.numel()))
        log(f"cuDNN fp32 3x3 conv {c}->{c} at {px}x{px}, batch "
            f"{TRAIN_BATCH}: heuristic {heuristic:.3f} ms, benchmark-picked "
            f"{tuned:.3f} ms, bound {ms:.3f} ms ({by})")
        del x, w


def mesh_run_config(cfg, batch: int, seq: int, accum: int, comp: str = "none",
                    eps: float = 1e-8, data: int = 1, model: int = 1):
    """The mesh phases' ``RunConfig``: ZeRO-1, remat full, AdamW at a
    constant MESH_LR (the cosine warm-up's first rate is 0)."""
    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig)

    return RunConfig(model=cfg, shape=ShapeConfig("mesh", seq, batch,
                                                  "train"),
                     train=TrainConfig(grad_accum=accum, zero1=True,
                                       remat="full", grad_compression=comp,
                                       learning_rate=MESH_LR, eps=eps,
                                       schedule="constant"),
                     mesh=MeshConfig(data=data, model=model))


def mesh_train(model, run, mesh, full_params, batches):
    """``build_train_step`` from ``full_params`` (the whole tree, or a
    function that draws it, whose tree is freed once this rank has its
    slices), one step a batch → (losses, parameters (this rank's), spec
    tree, step ms)."""
    import torch

    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import build_train_step

    b = build_train_step(model, run, mesh, make_axis_rules(run.mesh))
    full = full_params() if callable(full_params) else full_params
    params = b.init_fns[0](full)
    del full
    torch.cuda.empty_cache()
    opt = b.init_fns[1](params)
    losses, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = b.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    if not all(math.isfinite(v) for v in losses):
        fail(f"mesh train {model.cfg.name}: losses {losses}")
    del opt
    return losses, params, b.in_shardings[0], ms


def mesh_one_phase(dev, card: str, launches: dict, mesh) -> None:
    """Phase 22: the mesh path on a world of one over NCCL
    (``MeshConfig(data=1, model=1)``).  (a) ``smollm-360m`` at full width
    and depth: the first step's loss and gradients (``grad_fn``, MESH_ACCUM
    microbatches of MESH_BATCH × MESH_SEQ) against ``launch/train.py``'s
    ``make_step`` gradient (``value_and_grad`` of the loss over the whole
    batch), in fp32 at phase 13's gates and in bf16 at its bf16 gate (the
    mesh path's error against the fp32 gradient at most BF16_FACTOR × the
    bf16 ``make_step``'s); then MESH_STEPS bf16 steps with compression
    ``none`` and ``bf16``; (b) ``granite-moe-3b-a800m`` cut to
    LM_STEP_LAYERS layers, fp32: the forward on the expert-parallel path
    (one shard, one group) against the global path within MESH_MOE_RTOL,
    then bf16 steps; (c) full ``jpeg-resnet``, batch TRAIN_BATCH, 64 bands,
    through ``build_train_step``.  Step ms and tokens/s (images/s)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_iterator
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.optim import value_and_grad
    from repro_torch.parallel.sharding import AxisRules, sharding_rules
    from repro_torch.tree import leaves, leaves_with_paths

    def amax(x) -> float:
        return float(x.abs().max())

    def rel(a, b) -> float:
        return float((a.float() - b.float()).norm()) / float(b.float().norm())

    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = build_model(cfg32).init_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    batch = train.to_model_batch(cfg, next(token_iterator(
        0, MESH_BATCH, MESH_SEQ, cfg.vocab_size)), dev)
    tokens = MESH_BATCH * MESH_SEQ

    def grads(model, params, label):
        run = mesh_run_config(model.cfg, MESH_BATCH, MESH_SEQ, MESH_ACCUM)
        from repro_torch.launch.mesh import make_axis_rules
        from repro_torch.launch.steps import build_train_step

        b = build_train_step(model, run, mesh, make_axis_rules(run.mesh))
        local = b.init_fns[0](params)
        mesh_out = drive(f"mesh grad {label}", ("flash_attention",
                                                "flash_attention_bwd"),
                         launches, lambda: b.grad_fn(local, batch))
        del local
        step_out = value_and_grad(lambda p, x: model.loss_fn(p, x)[0],
                                  params, batch)
        return mesh_out, step_out

    m32 = build_model(cfg32, remat="full")
    (lm, gm), (ls, gs) = grads(m32, params32, "fp32")
    if not abs(float(lm) - float(ls)) <= LM_LOSS_RTOL * abs(float(ls)):
        fail(f"mesh grad fp32: loss {float(lm)} vs make_step's {float(ls)}")
    worst = (0.0, "")
    for (path, a), b in zip(leaves_with_paths(gm), leaves(gs)):
        err = amax(a - b) / amax(b)
        if not (bool(torch.isfinite(a).all()) and err <= LM_GRAD_FLOOR):
            fail(f"mesh grad fp32: {path} differs from make_step's by "
                 f"{err:.3e} of its largest entry (> {LM_GRAD_FLOOR})")
        worst = max(worst, (err, path))
    del gm
    params16 = T.cast_params(params32, torch.bfloat16)
    m16 = build_model(cfg, remat="full")
    (lm16, gm16), (ls16, gs16) = grads(m16, params16, "bf16")
    loss_gate = max(BF16_FACTOR * abs(float(ls16) - float(ls)),
                    2 ** -8 * abs(float(ls)))
    if not abs(float(lm16) - float(ls)) <= loss_gate:
        fail(f"mesh grad bf16: loss {float(lm16)} vs fp32 {float(ls)} "
             f"(bf16 make_step {float(ls16)})")
    worst16 = (0.0, "")
    for (path, a), b, c in zip(leaves_with_paths(gm16), leaves(gs16),
                               leaves(gs)):
        e_m, e_s = rel(a, c), rel(b, c)
        if not (bool(torch.isfinite(a).all()) and e_m <= BF16_FACTOR * e_s):
            fail(f"mesh grad bf16: {path}: the mesh path's error {e_m:.3e} "
                 f"(relative norm, against fp32) > {BF16_FACTOR} × "
                 f"make_step's bf16 {e_s:.3e}")
        worst16 = max(worst16, (e_m / e_s, path))
    log(f"mesh grad, world of one over NCCL, {LM_ARCH} full width and "
        f"depth, {MESH_ACCUM} microbatches of {MESH_BATCH // MESH_ACCUM} × "
        f"{MESH_SEQ} [{card}]: fp32 loss {float(lm):.6f} vs make_step "
        f"{float(ls):.6f}, worst gradient {worst[0]:.3e} of its largest "
        f"entry at {worst[1]}; bf16 loss {float(lm16):.6f} vs "
        f"{float(ls16):.6f}, largest ratio of the mesh path's gradient "
        f"error to make_step's bf16 {worst16[0]:.3f} at {worst16[1]}")
    del gm16, gs16, gs, params32, m32
    torch.cuda.empty_cache()

    batches = [train.to_model_batch(cfg, next(token_iterator(
        s + 1, MESH_BATCH, MESH_SEQ, cfg.vocab_size)), dev)
        for s in range(MESH_STEPS)]
    for comp in ("none", "bf16"):
        run = mesh_run_config(cfg, MESH_BATCH, MESH_SEQ, MESH_ACCUM, comp)
        losses, _, _, ms = drive(
            f"mesh train {LM_ARCH} bf16 compression={comp}",
            ("flash_attention", "flash_attention_bwd"), launches,
            lambda: mesh_train(m16, run, mesh, params16, batches))
        steady = statistics.median(ms[1:])
        log(f"mesh train, world of one, {LM_ARCH} full depth, bf16, batch "
            f"{MESH_BATCH} × {MESH_SEQ}, grad_accum {MESH_ACCUM}, ZeRO-1, "
            f"remat full, compression {comp} [{card}]: step ms "
            f"{[round(t, 1) for t in ms]}, median after the first "
            f"{steady:.1f} ms = {tokens / steady * 1e3:.0f} tokens/s; "
            f"losses {losses}")
    del params16, batches
    torch.cuda.empty_cache()

    # (b) the MoE on the expert-parallel path: one shard, one group
    gcfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=LM_STEP_LAYERS,
                               dtype="float32")
    gp = build_model(gcfg).init_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    gbatch = train.to_model_batch(gcfg, next(token_iterator(
        0, LM_STEP_BATCH, LM_PROMPT, gcfg.vocab_size)), dev)
    with torch.no_grad():
        want = T.forward(gp, gcfg, gbatch)[0]
        with sharding_rules(AxisRules.default(False, data=1,
                                              model=1).with_mesh(mesh)):
            got = T.forward(gp, gcfg, gbatch)[0]
    err = amax(got - want)
    if not err <= MESH_MOE_RTOL * amax(want):
        fail(f"mesh moe: the expert-parallel path's logits differ from the "
             f"global path's by {err:.3e} (> {MESH_MOE_RTOL} × "
             f"{amax(want):.3e})")
    log(f"mesh moe, {MOE_ARCH} full width, {LM_STEP_LAYERS} layers, fp32, "
        f"{LM_STEP_BATCH} × {LM_PROMPT} tokens: expert-parallel logits vs "
        f"the global path's: max abs err {err:.3e} (bit-identical: "
        f"{bool(torch.equal(got, want))})")
    del got, want
    g16 = dataclasses.replace(gcfg, dtype="bfloat16")
    gp16 = T.cast_params(gp, torch.bfloat16)
    del gp
    gbatches = [train.to_model_batch(g16, next(token_iterator(
        s + 1, MESH_BATCH, MESH_SEQ, g16.vocab_size)), dev)
        for s in range(3)]
    run = mesh_run_config(g16, MESH_BATCH, MESH_SEQ, MESH_ACCUM)
    losses, _, _, ms = drive(
        f"mesh train {MOE_ARCH} ({LM_STEP_LAYERS} layers) bf16",
        ("flash_attention", "flash_attention_bwd"), launches,
        lambda: mesh_train(build_model(g16, remat="full"), run, mesh, gp16,
                           gbatches))
    steady = statistics.median(ms[1:])
    log(f"mesh train, world of one, {MOE_ARCH} full width, "
        f"{LM_STEP_LAYERS} layers, bf16, batch {MESH_BATCH} × {MESH_SEQ}, "
        f"grad_accum {MESH_ACCUM} [{card}]: step ms "
        f"{[round(t, 1) for t in ms]}, median after the first "
        f"{steady:.1f} ms = {tokens / steady * 1e3:.0f} tokens/s; losses "
        f"{losses}")
    del gp16, gbatches
    torch.cuda.empty_cache()

    # (c) jpeg-resnet, batch TRAIN_BATCH, 64 bands
    jcfg = get_config("jpeg-resnet")
    jm = build_model(jcfg)
    jp = jm.init_params(torch.Generator().manual_seed(0), dev)
    it = train.build_iterator(jcfg, TRAIN_BATCH, 0, 0, dev)
    jbatches = [train.to_model_batch(jcfg, next(it), dev) for _ in range(3)]
    run = mesh_run_config(jcfg, TRAIN_BATCH, jcfg.image_size, 1)
    losses, _, _, ms = drive(
        "mesh train jpeg-resnet", ("jpeg_conv", "asm_relu", "block_dct",
                                   "block_idct"), launches,
        lambda: mesh_train(jm, run, mesh, jp, jbatches))
    steady = statistics.median(ms[1:])
    log(f"mesh train, world of one, jpeg-resnet full, batch {TRAIN_BATCH}, "
        f"64 bands [{card}]: step ms {[round(t, 1) for t in ms]}, median "
        f"after the first {steady:.1f} ms = "
        f"{TRAIN_BATCH / steady * 1e3:.2f} images/s; losses {losses}")
    del jp, jbatches
    torch.cuda.empty_cache()


def mesh4_workloads(dev):
    """Phase 23's runs, one at a time: (name, model, run config on 2×2, a
    function that draws the full parameters, batches).  ``smollm-360m`` cut to MESH4_SMOLLM_LAYERS
    layers (15/5 heads: attention gathered), ``granite-moe-3b-a800m`` cut
    to MESH4_GRANITE_LAYERS (24/8 heads: Megatron; experts on the
    expert-parallel path with ZeRO-3 storage; capacity factor
    MESH4_MOE_CF, so no shard drops and one rank runs the same
    computation), ``jamba-v0.1-52b`` and ``rwkv6-7b`` cut as
    MESH4_SSM_LAYERS says (drawn on the card: each rank runs the model
    axis's slice of their Mamba and RWKV layers; the leaves they draw at
    zero, Mamba's ``conv_b`` and RWKV's ``ln_b``, moved off it by
    MESH4_OFF_ZERO), ``whisper-small`` cut to MESH4_WHISPER_LAYERS
    encoder and decoder layers (drawn the same way: its biases start at
    zero), fp32, AdamW eps MESH_EPS; full ``jpeg-resnet`` at batch
    TRAIN_BATCH (batch norm statistics over every rank's rows)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import token_iterator
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.tree import leaves

    def off_zero(params):
        noise = torch.Generator(device=dev).manual_seed(1)
        for leaf in leaves(params):
            if not leaf.any():
                leaf.copy_(MESH4_OFF_ZERO * torch.randn(
                    leaf.shape, generator=noise, device=dev))
        return params

    for arch, layers in ((LM_ARCH, MESH4_SMOLLM_LAYERS),
                         (MOE_ARCH, MESH4_GRANITE_LAYERS)) \
            + MESH4_SSM_LAYERS + ((AUDIO_ARCH, MESH4_WHISPER_LAYERS),):
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  dtype="float32")
        if cfg.encoder_decoder:
            cfg = dataclasses.replace(cfg, n_encoder_layers=layers)
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=MESH4_MOE_CF)
        model = build_model(cfg, remat="full")
        batches = [train.to_model_batch(cfg, next(token_iterator(
            s, MESH4_BATCH, MESH4_SEQ, cfg.vocab_size)), dev)
            for s in range(MESH4_STEPS)]
        draw = (lambda m=model: off_zero(m.init_params(
            torch.Generator(device=dev).manual_seed(0), dev))) \
            if cfg.ssm_kind or cfg.encoder_decoder \
            else (lambda m=model: m.init_params(
                torch.Generator().manual_seed(0), dev))
        yield (arch, model, mesh_run_config(
            cfg, MESH4_BATCH, MESH4_SEQ, MESH4_ACCUM, eps=MESH_EPS, data=2,
            model=2), draw, batches)
    cfg = get_config("jpeg-resnet")
    model = build_model(cfg)
    it = train.build_iterator(cfg, TRAIN_BATCH, 0, 0, dev)
    batches = [train.to_model_batch(cfg, next(it), dev)
               for _ in range(MESH4_STEPS)]
    yield ("jpeg-resnet", model, mesh_run_config(
        cfg, TRAIN_BATCH, cfg.image_size, 1, eps=MESH_EPS, data=2, model=2),
        lambda: model.init_params(torch.Generator().manual_seed(0), dev),
        batches)


def pipeline_inputs(dev):
    """Phase 23's pipeline: MESH4 stages, each one full-width
    ``smollm-360m`` layer (fp32, seed 0), PP_MICRO microbatches of
    PP_MB × PP_SEQ."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=PP_STAGES,
                              dtype="float32")
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0),
                                          dev)
    stages = [T._layer(params["blocks"], 0, i) for i in range(PP_STAGES)]
    mb = torch.randn((PP_MICRO, PP_MB, PP_SEQ, cfg.d_model),
                     generator=torch.Generator().manual_seed(1)).to(dev)
    pos = torch.arange(PP_SEQ, device=dev)[None].expand(PP_MB, PP_SEQ)

    def stage_fn(p, h):
        with torch.no_grad():
            return T._apply_layer(h, p, cfg, ("attn", "dense"), pos)[0]

    return stages, mb, stage_fn


def mesh4_reference(dev, mesh, path: str) -> None:
    """Phase 23's runs on one rank (the world of one), saved to ``path``
    for the four ranks to hold theirs against."""
    import torch

    from repro_torch.parallel.sharding import gather_full
    from repro_torch.tree import leaves_with_paths, tree_map

    ref = {}
    for name, model, run, params, batches in mesh4_workloads(dev):
        run = dataclasses.replace(run, mesh=dataclasses.replace(
            run.mesh, data=1, model=1))
        losses, p, specs, ms = mesh_train(model, run, mesh, params, batches)
        full = tree_map(lambda x, s: gather_full(x, s, mesh), p, specs)
        ref[name] = {"losses": losses, "ms": ms, "params": {
            k: v.cpu() for k, v in leaves_with_paths(full)}}
        if name == "jpeg-resnet":
            # its own sensitivity: the batch times (1 + 1e-6·noise)
            gen = torch.Generator(device=dev).manual_seed(3)
            nudged = [dict(b, coefficients=b["coefficients"] * (
                1 + 1e-6 * torch.randn(b["coefficients"].shape,
                                       device=dev, generator=gen)))
                for b in batches]
            _, q, _, _ = mesh_train(model, run, mesh, params, nudged)
            ref[name]["nudged"] = {k: v.cpu() for k, v in leaves_with_paths(
                tree_map(lambda x, s: gather_full(x, s, mesh), q, specs))}
        del p, full, params, batches
        torch.cuda.empty_cache()
    stages, mb, stage_fn = pipeline_inputs(dev)
    seq = mb
    for p in stages:
        seq = torch.stack([stage_fn(p, x) for x in seq])
    ref["pipeline"] = seq.cpu()
    torch.save(ref, path)
    torch.cuda.empty_cache()


def mesh4_rank(mesh):
    """One of phase 23's four ranks (gloo, sharing the one card): each
    workload on the 2 (data) × 2 (model) mesh, its losses and gathered
    parameters held against the one-rank run; then the pipeline over a
    4-stage mesh against the stages run in turn on one rank.  Returns the
    errors, step times, launches and staged collectives."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.pipeline import bubble_fraction, \
        pipelined_apply, stack_stage_params
    from repro_torch.parallel.sharding import P, gather_full, local_slice
    from repro_torch.tree import leaves_with_paths, tree_map

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    ref = torch.load(os.environ["CHIP_SMOKE_MESH_REF"])
    out = {}
    for name, model, run, params, batches in mesh4_workloads(dev):
        reset_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, p, specs, ms = mesh_train(model, run, mesh, params, batches)
        launched = counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev.type == "cuda" else 0.0
        full = tree_map(lambda x, s: gather_full(x, s, mesh), p, specs)
        want = ref[name]
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(losses, want["losses"]))
        worst = (0.0, "")
        p0 = dict(leaves_with_paths(params())) if "nudged" in want else {}
        for path, x in leaves_with_paths(full):
            w = want["params"][path].to(x.device)
            if "nudged" in want:
                # jpeg-resnet: the update by relative norm against the
                # floor of phase 5's rule (ASM masks flip on
                # pre-activations within rounding of zero)
                d0 = w - p0[path]
                nd = float(d0.norm()) or 1.0
                err = float((x - w).norm()) / nd
                floor = float((want["nudged"][path].to(x.device) - w)
                              .norm()) / nd
                worst = max(worst, (err / max(TRAIN_GRAD_RTOL,
                                              TRAIN_FLOOR_FACTOR * floor),
                                    path, err, floor))
            else:
                worst = max(worst, (float((x - w).abs().max())
                                    / max(float(w.abs().max()), 1e-30),
                                    path))
        out[name] = {"losses": losses, "loss_err": loss_err,
                     "param_err": worst, "ms": ms, "peak_gib": peak,
                     "one_rank_ms": want["ms"], "launches": launched}
        del p, full, params, batches
        torch.cuda.empty_cache()
    stages, mb, stage_fn = pipeline_inputs(dev)
    pmesh = make_mesh((PP_STAGES,), ("stage",), mesh.device_type)
    mine = tree_map(lambda x: local_slice(
        x, P("stage", *([None] * (x.dim() - 1))), pmesh),
        stack_stage_params(stages))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = pipelined_apply(stage_fn, mine, mb, pmesh)
    torch.cuda.synchronize()
    pp_ms = (time.perf_counter() - t0) * 1e3
    launched = counts()
    want = ref["pipeline"].to(dev)
    out["pipeline"] = {
        "err": float((got - want).abs().max()) / float(want.abs().max()),
        "identical": bool(torch.equal(got, want)), "ms": pp_ms,
        "bubble": bubble_fraction(PP_STAGES, PP_MICRO),
        "launches": launched}
    out["staged"] = dict(C.STAGED)
    out["rank"] = dist.get_rank()
    return out


def mesh_phases(dev, card: str, launches: dict) -> None:
    """Phases 22 and 23: the mesh path on a world of one over NCCL, then
    on four ranks sharing the one card over gloo (NCCL refuses two ranks
    on one device), each held against the same computation on one rank.
    Multi-device speed is not measured: every rank shares one H100."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, make_mesh, run_local

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        timed("phase 22", card, lambda: mesh_one_phase(dev, card, launches,
                                                       mesh))
        t0 = time.perf_counter()
        path = os.path.join(ref_dir, "one_rank.pt")
        mesh4_reference(dev, mesh, path)
        log(f"phase 23: the one-rank runs in {time.perf_counter() - t0:.2f}"
            f" s")
    finally:
        dist.destroy_process_group()
    try:
        os.environ["CHIP_SMOKE_MESH_REF"] = path
        t0 = time.perf_counter()
        ranks = run_local(mesh4_rank, (2, 2), ("data", "model"),
                          backend="gloo", device="cuda", timeout=600)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    wall = time.perf_counter() - t0
    for r in ranks:
        for name in MESH4_RUNS:
            res = r[name]
            bound = 1.0 if name == "jpeg-resnet" else MESH_PARAM_RTOL
            if not (res["loss_err"] <= MESH_LOSS_RTOL
                    and res["param_err"][0] <= bound):
                fail(f"mesh 2x2 rank {r['rank']} {name}: losses "
                     f"{res['losses']} differ from one rank's by "
                     f"{res['loss_err']:.3e} (> {MESH_LOSS_RTOL}) or the "
                     f"parameters at {res['param_err'][1]}: "
                     f"{res['param_err']} (> {bound})")
        if not r["pipeline"]["err"] <= MESH_PIPE_RTOL:
            fail(f"mesh pipeline rank {r['rank']}: {r['pipeline']}")
        for name, required in MESH4_KERNELS.items():
            got = r[name]["launches"]
            missing = [k for k in required if got[k] <= 0]
            if missing:
                fail(f"mesh 2x2 rank {r['rank']} {name}: kernels {missing} "
                     f"were never launched ({got})")
            for k, v in got.items():
                launches[k] += v
    r0 = ranks[0]
    for name in MESH4_RUNS:
        res = r0[name]
        pe = res["param_err"]
        held = (f"parameters {pe[0]:.3e} of the leaf's largest (at "
                f"{pe[1]})") if len(pe) == 2 else (
            f"the update's relative norm {pe[2]:.3e} at {pe[1]} (its own "
            f"floor there {pe[3]:.3e}; {pe[0]:.3f} of the gate)")
        log(f"mesh 2x2 (data × model, 4 ranks on one card, gloo) {name} "
            f"[{card}]: losses {res['losses']}, against one rank: losses "
            f"{res['loss_err']:.3e}, {held}; step ms "
            f"{[round(t, 1) for t in res['ms']]} (one rank "
            f"{[round(t, 1) for t in res['one_rank_ms']]}); rank 0's peak "
            f"{res['peak_gib']:.2f} GiB")
    pp = r0["pipeline"]
    staged = {k: sum(r["staged"].get(k, 0) for r in ranks)
              for k in sorted({k for r in ranks for k in r["staged"]})}
    log(f"mesh pipeline, {PP_STAGES} stages of one full-width {LM_ARCH} "
        f"layer, {PP_MICRO} microbatches of {PP_MB} × {PP_SEQ} [{card}]: "
        f"against the stages in turn on one rank {pp['err']:.3e} "
        f"(bit-identical: {pp['identical']}), {pp['ms']:.1f} ms, bubble "
        f"fraction {pp['bubble']:.3f}")
    summed = {k: sum(r[n]["launches"][k] for r in ranks
                     for n in MESH4_KERNELS) for k in KERNELS}
    log(f"phase 23: 4 ranks in {wall:.2f} s (spawn and CUDA start "
        f"included); every rank launched each workload's kernels "
        f"(MESH4_KERNELS), launches summed over the ranks {summed}; "
        f"point-to-point sends staged through the host (gloo with CUDA "
        f"tensors), summed over the ranks: {staged}")


def world_one_run(cfg_name: str = LM_ARCH):
    """Phase 22's ``smollm-360m`` step (bf16, MESH_BATCH × MESH_SEQ,
    MESH_ACCUM microbatches, ZeRO-1, remat full) as the dry-run builds it
    for a world of one: (model, run config, mesh config)."""
    from repro_torch.configs import (MeshConfig, RunConfig, ShapeConfig,
                                     TrainConfig, get_config)
    from repro_torch.models.registry import build_model

    cfg = get_config(cfg_name)
    mc = MeshConfig(data=1, model=1)
    run = RunConfig(model=cfg, shape=ShapeConfig("world1", MESH_SEQ,
                                                 MESH_BATCH, "train"),
                    train=TrainConfig(remat="full", grad_accum=MESH_ACCUM),
                    mesh=mc)
    return build_model(cfg, remat="full"), run, mc


def dryrun_worker(arch: str, shape: str, mesh: str, out_dir: str,
                  started: float) -> None:
    """One dry-run cell in this process (no card): the production cell, or
    ``world1`` (:func:`world_one_run` on a world of one).  Prints the
    kernels' launch counts before and after, and the process's seconds
    since ``started`` (its first statement's ``time.time()``), as one
    JSON line."""
    from repro_torch import kernels
    from repro_torch.launch.dryrun import run_cell

    before = kernels.launch_counts()
    if shape == "world1":
        _, run, mc = world_one_run(arch)
        rec = run_cell(arch, shape, mesh, out_dir, shape=run.shape,
                       mesh_cfg=mc)
    else:
        rec = run_cell(arch, shape, mesh, out_dir)
    print(json.dumps({"launches_before": before,
                      "launches_after": kernels.launch_counts(),
                      "status": rec["status"],
                      "wall_s": time.time() - started}), flush=True)


def serve4_inputs(dev):
    """Phase 24 (c): smollm-360m at full width, SERVE4_LAYERS layers,
    fp32, seed 0; the prompt and the decode tokens (seed 5)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=SERVE4_LAYERS,
                              dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE4_BATCH, SERVE4_PROMPT),
                           generator=gen, dtype=torch.int32)
    toks = [torch.randint(0, cfg.vocab_size, (SERVE4_BATCH, 1),
                          generator=gen, dtype=torch.int32)
            for _ in range(SERVE4_DECODE)]
    return cfg, model, params, {"tokens": prompt.to(dev)}, \
        [t.to(dev) for t in toks]


def ssm4_inputs(arch: str):
    """Phase 24 (c)'s sliced prefill and decode of ``arch``: the config cut to
    SSM4_LAYERS layers, fp32, the model, the prompt and the decode tokens
    (seed 6); the parameters come from :func:`ssm4_params`."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=SSM4_LAYERS,
                              dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=SSM4_CAPACITY)
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE4_BATCH, SSM4_PROMPT),
                           generator=gen, dtype=torch.int32)
    toks = [torch.randint(0, cfg.vocab_size, (SERVE4_BATCH, 1),
                          generator=gen, dtype=torch.int32)
            for _ in range(SSM4_DECODE)]
    return cfg, build_model(cfg), prompt, toks


def ssm4_params(model, dev):
    """The whole parameters, drawn on the card from seed 0 (the same on
    every rank)."""
    import torch

    return model.init_params(torch.Generator(device=dev).manual_seed(0), dev)


def ssm4_reference(dev) -> dict:
    """Each of SSM4_ARCHS on one rank: the prefill's logits and cache, the
    states after the prompt in a decode cache of SERVE4_SLOTS slots, each
    decode step's logits and the cache after them, on the host."""
    import torch

    from repro_torch.tree import tree_map

    out = {}
    for arch in SSM4_ARCHS:
        cfg, model, prompt, toks = ssm4_inputs(arch)
        params = ssm4_params(model, dev)
        with torch.no_grad():
            logits, cache = model.prefill(params,
                                          {"tokens": prompt.to(dev)})
            dcache = model.init_cache(SERVE4_BATCH, SERVE4_SLOTS, dev)
            for j, c in cache.items():
                if j == "index":
                    dcache["index"].copy_(c)
                    continue
                for n, x in c.items():  # keys and values: the first slots
                    dcache[j][n][:, :, :x.shape[2]] = x
            one = tree_map(lambda x: x.clone(), dcache)
            outs = []
            for t in toks:
                lg, one = model.decode_step(params, one,
                                            {"tokens": t.to(dev)})
                outs.append(lg)
        out[arch] = tree_map(lambda x: x.cpu(), {
            "prefill_logits": logits, "prefill_cache": cache,
            "decode_cache": dcache, "decode_logits": torch.stack(outs),
            "decode_cache_after": one})
        del params, cache, dcache, one
        torch.cuda.empty_cache()
    return out


def ssm4_rank(mesh, dev, ref: dict, err) -> dict:
    """One rank's sliced prefill of each of SSM4_ARCHS, then its sliced
    decode on from the states it computed, each against its part of one
    rank's run; the whole parameters are drawn one rank at a time, each
    rank keeping its slices.  Returns the largest differences and the
    collective bytes of the prefill and of the first decode step."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.introspect import opcount
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          cache_shardings)
    from repro_torch.parallel.sharding import local_slice
    from repro_torch.tree import leaves, tree_map

    mc = MeshConfig(data=2, model=2)
    rules = make_axis_rules(mc)
    out = {}
    for arch in SSM4_ARCHS:
        cfg, model, prompt, toks = ssm4_inputs(arch)
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "d", SERVE4_SLOTS, SERVE4_BATCH, "decode"), mesh=mc)
        db = build_decode_step(model, run, mesh, rules)
        pb = build_prefill_step(model, dataclasses.replace(
            run, shape=ShapeConfig("p", SSM4_PROMPT, SERVE4_BATCH,
                                   "prefill")), mesh, rules)
        local = None
        for turn in range(dist.get_world_size()):
            if dist.get_rank() == turn:
                full = ssm4_params(model, dev)
                local = db.init_fns[0](full)
                del full
                torch.cuda.empty_cache()
            dist.barrier()
        want = ref[arch]
        with torch.no_grad(), opcount.count() as cost:
            logits, cache = pb.step_fn(local, {"tokens": prompt.to(dev)})
        out[f"{arch} prefill collective bytes"] = cost.collective_bytes
        out[f"{arch} prefill_logits"] = err(
            logits, want["prefill_logits"][pb.rows])
        specs = cache_shardings(model.init_cache(
            SERVE4_BATCH, SSM4_PROMPT, "meta"), cfg, rules, SERVE4_BATCH)
        mine = tree_map(lambda x, sp: local_slice(x, sp, mesh),
                        want["prefill_cache"], specs)
        out[f"{arch} prefill_cache"] = max(
            err(a, b) for a, b in zip(leaves(cache), leaves(mine))
            if a.dim())
        # decode goes on from the states this rank's prefill computed
        # (keys and values, where a cut has attention, from one rank's)
        lc = tree_map(lambda x: x.to(dev), db.init_fns[1](
            want["decode_cache"]))
        for j, c in cache.items():
            if j == "index":
                lc[j].copy_(c)
                continue
            for n, x in c.items():
                if n not in ("k", "v"):
                    lc[j][n].copy_(x)
        del cache
        errs = []
        with torch.no_grad():
            for i, t in enumerate(toks):
                with opcount.count() as cost:
                    lg, lc = db.step_fn(local, lc, {"tokens": t.to(dev)})
                if i == 0:
                    out[f"{arch} collective bytes"] = cost.collective_bytes
                errs.append(err(lg, want["decode_logits"][i][db.rows]))
        after = db.init_fns[1](want["decode_cache_after"])
        out[f"{arch} decode_logits"] = max(errs)
        out[f"{arch} decode_cache"] = max(err(a, b) for a, b in
                                          zip(leaves(lc), leaves(after))
                                          if a.dim())
        del local, lc
        torch.cuda.empty_cache()
    return out


def wide4_inputs(arch: str, dev):
    """One of WIDE4_RUNS: the config, the model, the whole parameters
    (seed 0, drawn on the host), the prefill batch and the decode tokens
    (seed 7)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    cfg = dataclasses.replace(get_config(arch), n_layers=WIDE4_LAYERS,
                              dtype="float32")
    if cfg.encoder_decoder:
        cfg = dataclasses.replace(cfg, n_encoder_layers=WIDE4_LAYERS)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(7)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (SERVE4_BATCH, SERVE4_PROMPT),
                                     generator=gen, dtype=torch.int32)}
    if cfg.encoder_decoder:
        batch["frames"] = torch.randn(
            (SERVE4_BATCH, cfg.encoder_context_len, cfg.d_model),
            generator=gen)
    toks = [torch.randint(0, cfg.vocab_size, (SERVE4_BATCH, 1),
                          generator=gen, dtype=torch.int32).to(dev)
            for _ in range(WIDE4_DECODE)]
    return cfg, model, params, {k: v.to(dev) for k, v in batch.items()}, \
        toks


def wide4_reference(dev) -> dict:
    """Each of WIDE4_RUNS on one rank: the prefill's output and cache
    (whisper's: the encoder output), the decode cache it fills (the
    prompt's keys and values in its first slots, or whisper's cross cache
    of the encoder output), each decode step's logits and the cache after
    them, on the host."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    out = {}
    for arch, _ in WIDE4_RUNS:
        cfg, model, params, batch, toks = wide4_inputs(arch, dev)
        with torch.no_grad():
            first, cache = model.prefill(params, batch)
            dcache = model.init_cache(SERVE4_BATCH, SERVE4_SLOTS, dev)
            if cfg.encoder_decoder:
                dcache["cross"] = T.cross_cache(params, cfg, first)
            else:
                dcache["index"].copy_(cache["index"])
                for j, c in cache.items():
                    for n, x in (c.items() if j != "index" else ()):
                        dcache[j][n][:, :, :x.shape[2]] = x
            one = tree_map(lambda x: x.clone(), dcache)
            logits = []
            for t in toks:
                lg, one = model.decode_step(params, one, {"tokens": t})
                logits.append(lg)
        out[arch] = tree_map(lambda x: x.cpu(), {
            "prefill_out": first, "prefill_cache": cache or {},
            "decode_cache": dcache, "decode_logits": torch.stack(logits),
            "decode_cache_after": one})
        del params, cache, dcache, one
        torch.cuda.empty_cache()
    return out


def wide4_rank(dev, ref: dict, err, device_type: str) -> dict:
    """This rank's part of each of WIDE4_RUNS on its own mesh of the four
    ranks: the prefill step and WIDE4_DECODE decode steps on its rows and
    parameter and cache slices, against its part of one rank's run (the
    largest difference over the largest |value|), with the prefill's
    attention launches and the collective bytes of the prefill and of the
    first decode step."""
    import torch

    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.introspect import opcount
    from repro_torch.launch.mesh import make_axis_rules, make_mesh
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          cache_shardings)
    from repro_torch.parallel.sharding import local_slice
    from repro_torch.tree import leaves, tree_map

    out = {}
    for arch, (data, model_axis) in WIDE4_RUNS:
        mesh = make_mesh((data, model_axis), ("data", "model"), device_type)
        mc = MeshConfig(data=data, model=model_axis)
        rules = make_axis_rules(mc)
        cfg, model, params, batch, toks = wide4_inputs(arch, dev)
        want = ref[arch]
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "p", SERVE4_PROMPT, SERVE4_BATCH, "prefill"), mesh=mc)
        pb = build_prefill_step(model, run, mesh, rules)
        db = build_decode_step(model, dataclasses.replace(
            run, shape=ShapeConfig("d", SERVE4_SLOTS, SERVE4_BATCH,
                                   "decode")), mesh, rules)
        local = pb.init_fns[0](params)
        del params
        reset_counts()
        with torch.no_grad(), opcount.count() as cost:
            first, cache = pb.step_fn(local, batch)
        res = {"launches": counts(),
               "prefill collective bytes": cost.collective_bytes,
               "prefill_out": err(first, want["prefill_out"][pb.rows])}
        if cache is not None:
            specs = cache_shardings(model.init_cache(
                SERVE4_BATCH, SERVE4_PROMPT, "meta"), cfg, rules,
                SERVE4_BATCH)
            mine = tree_map(lambda x, sp: local_slice(x, sp, mesh),
                            want["prefill_cache"], specs)
            res["prefill_cache"] = max(
                err(a, b) for a, b in zip(leaves(cache), leaves(mine))
                if a.dim())
        lc = tree_map(lambda x: x.to(dev), db.init_fns[1](
            want["decode_cache"]))
        errs = []
        with torch.no_grad():
            for i, t in enumerate(toks):
                with opcount.count() as cost:
                    lg, lc = db.step_fn(local, lc, {"tokens": t})
                if i == 0:
                    res["decode collective bytes"] = cost.collective_bytes
                errs.append(err(lg, want["decode_logits"][i][db.rows]))
        after = db.init_fns[1](want["decode_cache_after"])
        res["decode_logits"] = max(errs)
        res["decode_cache"] = max(err(a, b) for a, b in
                                  zip(leaves(lc), leaves(after)) if a.dim())
        out[arch] = res
        del local, lc, cache
        torch.cuda.empty_cache()
    return out


def serve4_reference(dev, path: str) -> None:
    """Phase 24 (c) on one rank, the whole batch and cache: the prefill's
    logits and cache, the decode cache (the prompt's keys and values in
    its first slots), each decode step's logits and the cache after them,
    and :func:`ssm4_reference`'s runs, saved to ``path``."""
    import torch

    from repro_torch.tree import tree_map

    ssm = ssm4_reference(dev)
    wide = wide4_reference(dev)
    cfg, model, params, batch, toks = serve4_inputs(dev)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch)
        dcache = model.init_cache(SERVE4_BATCH, SERVE4_SLOTS, dev)
        for j, c in cache.items():
            if j == "index":
                dcache["index"].copy_(c)
                continue
            for n, x in c.items():
                dcache[j][n][:, :, :SERVE4_PROMPT] = x
        one = tree_map(lambda x: x.clone(), dcache)
        outs = []
        for t in toks:
            lg, one = model.decode_step(params, one, {"tokens": t})
            outs.append(lg)
    host = lambda tree: tree_map(lambda x: x.cpu(), tree)  # noqa: E731
    torch.save({"prefill_logits": logits.cpu(), "prefill_cache": host(cache),
                "decode_cache": host(dcache),
                "decode_logits": torch.stack(outs).cpu(),
                "decode_cache_after": host(one), "ssm": ssm,
                "wide": wide}, path)
    del params, cache, dcache, one
    torch.cuda.empty_cache()


def serve4_rank(mesh):
    """One of phase 24 (c)'s four ranks (gloo, sharing the card): the
    prefill step and SERVE4_DECODE decode steps on its rows and cache
    slices, each against its part of one rank's run (largest difference
    over the largest |value|); the attention launches of its prefill;
    then :func:`ssm4_rank`'s sliced Mamba and RWKV decodes."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import MeshConfig, RunConfig, ShapeConfig
    from repro_torch.launch.mesh import make_axis_rules
    from repro_torch.launch.steps import (build_decode_step,
                                          build_prefill_step,
                                          cache_shardings)
    from repro_torch.parallel.sharding import local_slice
    from repro_torch.tree import leaves, tree_map

    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    ref = torch.load(os.environ["CHIP_SMOKE_SERVE_REF"])
    cfg, model, params, batch, toks = serve4_inputs(dev)
    mc = MeshConfig(data=2, model=2)
    rules = make_axis_rules(mc)

    def err(got, want) -> float:
        want = want.to(got.device)
        return float((got.float() - want.float()).abs().max()) / max(
            float(want.float().abs().max()), 1e-30)

    run = RunConfig(model=cfg, shape=ShapeConfig(
        "p", SERVE4_PROMPT, SERVE4_BATCH, "prefill"), mesh=mc)
    pb = build_prefill_step(model, run, mesh, rules)
    local = pb.init_fns[0](params)
    del params
    reset_counts()
    with torch.no_grad():
        logits, cache = pb.step_fn(local, batch)
    launched = counts()
    rows = pb.rows
    out = {"rank": dist.get_rank(), "launches": launched,
           "prefill_logits": err(logits, ref["prefill_logits"][rows])}
    specs = cache_shardings(model.init_cache(SERVE4_BATCH, SERVE4_PROMPT,
                                             "meta"), cfg, rules,
                            SERVE4_BATCH)
    want = tree_map(lambda x, s: local_slice(x, s, mesh),
                    ref["prefill_cache"], specs)
    out["prefill_cache"] = max(err(a, b) for a, b in
                               zip(leaves(cache), leaves(want))
                               if a.dim())
    run = dataclasses.replace(run, shape=ShapeConfig(
        "d", SERVE4_SLOTS, SERVE4_BATCH, "decode"))
    db = build_decode_step(model, run, mesh, rules)
    lc = tree_map(lambda x: x.to(dev), db.init_fns[1](ref["decode_cache"]))
    errs = []
    with torch.no_grad():
        for i, t in enumerate(toks):
            lg, lc = db.step_fn(local, lc, {"tokens": t})
            errs.append(err(lg, ref["decode_logits"][i][rows]))
    want = db.init_fns[1](ref["decode_cache_after"])
    out["decode_logits"] = max(errs)
    out["decode_cache"] = max(err(a, b) for a, b in
                              zip(leaves(lc), leaves(want)) if a.dim())
    del local, lc
    torch.cuda.empty_cache()
    out["ssm"] = ssm4_rank(mesh, dev, ref["ssm"], err)
    out["wide"] = wide4_rank(dev, ref["wide"], err, mesh.device_type)
    return out


def dryrun_phase(dev, card: str, launches: dict) -> None:
    """Phase 24 (module docstring): (a) the production cells and the
    world-of-one trace, each in a process with no card visible, started
    first; (b) the world-of-one step for real on the card over NCCL;
    (c) four ranks serving over gloo; then (a)'s records read."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.dryrun import axis_rules, trace_step
    from repro_torch.launch.mesh import free_port, make_mesh, run_local

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    ref_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO_SRC)
    cells = DRYRUN_CELLS + ((LM_ARCH, "world1", "one"),)
    procs = []
    t0 = time.perf_counter()
    for cell in cells:
        code = (f"import time; started = time.time(); import sys; "
                f"sys.path.insert(0, {ROOT!r}); "
                f"sys.path.insert(0, {REPO_SRC!r}); import chip_smoke; "
                f"chip_smoke.dryrun_worker(*{cell!r}, {out_dir!r}, started)")
        procs.append((cell, subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    try:
        # (b) the world-of-one step for real on the card
        dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                                f"{free_port()}", rank=0, world_size=1)
        try:
            model, run, mc = world_one_run()
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            real_mem, real_cost = drive(
                "dry-run world of one, the real step", (
                    "flash_attention", "flash_attention_bwd"), launches,
                lambda: trace_step(model, run, mesh, axis_rules(mc), fake=False,
                                   device="cuda"))
            torch.cuda.synchronize()
            real_peak = torch.cuda.max_memory_allocated() - base
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        # (c) four ranks serving over gloo, against one rank
        path = os.path.join(ref_dir, "one_rank.pt")
        serve4_reference(dev, path)
        os.environ["CHIP_SMOKE_SERVE_REF"] = path
        t1 = time.perf_counter()
        ranks = run_local(serve4_rank, (2, 2), ("data", "model"),
                          backend="gloo", device="cuda", timeout=600)
        wall4 = time.perf_counter() - t1
        # (a) the records
        records, walls = {}, {}
        for cell, proc in procs:
            text, _ = proc.communicate(timeout=900)
            tail = text.strip().splitlines()[-1] if text.strip() else ""
            try:
                status = json.loads(tail)
            except ValueError:
                fail(f"dry-run {cell}: no result ({text[-2000:]})")
            walls[cell] = status["wall_s"]
            if status["launches_before"] != status["launches_after"]:
                fail(f"dry-run {cell}: the fake paths launched kernels "
                     f"({status})")
            with open(os.path.join(out_dir, "__".join(cell) + ".json")) as f:
                records[cell] = json.load(f)
            if records[cell]["status"] != "ok":
                fail(f"dry-run {cell}: {records[cell]['status']}: "
                     f"{records[cell].get('traceback', '')}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.environ.pop("CHIP_SMOKE_SERVE_REF", None)
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(ref_dir, ignore_errors=True)
    for cell in DRYRUN_CELLS:
        rec = records[cell]
        m, c = rec["memory"], rec["hlo_cost"]
        total = m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"] \
            + m["temp_bytes"]
        log(f"dry-run {' × '.join(cell)} (rank 0 of {rec['devices']}, no "
            f"card): per rank argument {m['argument_bytes'] / 1e9:.3f} GB, "
            f"output {m['output_bytes'] / 1e9:.3f} GB, temporary "
            f"{m['temp_bytes'] / 1e9:.3f} GB, aliased "
            f"{m['alias_bytes'] / 1e9:.3f} GB: total {total / 1e9:.3f} GB "
            f"of the card's {CARD_BYTES / 1e9:.0f} GB "
            f"({'fits' if total <= CARD_BYTES else 'does not fit'}); "
            f"{c['flops']:.6e} FLOPs, {c['bytes']:.6e} bytes, collective "
            f"bytes by group size {c['collectives_by_group']}; trace "
            f"{rec['trace_s']} s, process wall {walls[cell]:.2f} s")
        print(f"[chip_smoke] dryrun record {json.dumps(rec)}", flush=True)
    fake = records[(LM_ARCH, "world1", "one")]
    fm, fc = fake["memory"], fake["hlo_cost"]
    predicted = fm["argument_bytes"] + fm["output_bytes"] \
        - fm["alias_bytes"] + fm["temp_bytes"]
    for key in ("flops", "bytes"):
        rel = abs(fc[key] - real_cost[key]) / real_cost[key]
        if not rel <= DRY_COUNT_RTOL:
            fail(f"dry-run world of one: counted {key} {fc[key]:.6e} vs the "
                 f"real step's {real_cost[key]:.6e} ({rel:.3e} > "
                 f"{DRY_COUNT_RTOL})")
    measured = real_peak  # the step's arguments are allocated inside it
    if not abs(predicted - measured) <= DRY_PEAK_RTOL * measured:
        fail(f"dry-run world of one: predicted peak {predicted} B vs the "
             f"allocator's {measured} B (> {DRY_PEAK_RTOL})")
    log(f"dry-run world of one, {LM_ARCH} bf16, {MESH_BATCH} × {MESH_SEQ}, "
        f"{MESH_ACCUM} microbatches, ZeRO-1, remat full [{card}]: FLOPs "
        f"traced {fc['flops']:.6e} vs real {real_cost['flops']:.6e}, bytes "
        f"traced {fc['bytes']:.6e} vs real {real_cost['bytes']:.6e}; peak "
        f"predicted {predicted / 2 ** 30:.3f} GiB (argument "
        f"{fm['argument_bytes'] / 2 ** 30:.3f} + output "
        f"{fm['output_bytes'] / 2 ** 30:.3f} + temporary "
        f"{fm['temp_bytes'] / 2 ** 30:.3f}) vs the allocator's "
        f"{measured / 2 ** 30:.3f} GiB (max_memory_allocated after "
        f"reset_peak_memory_stats, less what was allocated before the "
        f"arguments were made); the real step's tracker {real_mem}; "
        f"trace {fake['trace_s']} s, process "
        f"wall {walls[(LM_ARCH, 'world1', 'one')]:.2f} s")
    for r in ranks:
        errs = {k: r[k] for k in ("prefill_logits", "prefill_cache",
                                  "decode_logits", "decode_cache")}
        if not max(errs.values()) <= SERVE4_RTOL:
            fail(f"serve 2x2 rank {r['rank']}: against one rank {errs} "
                 f"(> {SERVE4_RTOL})")
        if r["launches"]["flash_attention"] <= 0:
            fail(f"serve 2x2 rank {r['rank']}: the prefill launched no "
                 f"attention ({r['launches']})")
        ssm = {k: v for k, v in r["ssm"].items() if "collective" not in k}
        if not max(ssm.values()) <= SERVE4_RTOL:
            fail(f"serve 2x2 rank {r['rank']}: the sliced Mamba and RWKV "
                 f"decode against one rank {ssm} (> {SERVE4_RTOL})")
        for k, v in r["launches"].items():
            launches[k] += v
        for arch, res in r["wide"].items():
            held = {k: v for k, v in res.items() if k in WIDE4_HELD}
            if not max(held.values()) <= SERVE4_RTOL:
                fail(f"serve rank {r['rank']} {arch}: against one rank "
                     f"{held} (> {SERVE4_RTOL})")
            if res["launches"]["flash_attention"] <= 0:
                fail(f"serve rank {r['rank']} {arch}: the prefill launched "
                     f"no attention ({res['launches']})")
            for k, v in res["launches"].items():
                launches[k] += v
    log(f"serve 2x2 (data × model, 4 ranks on one card, gloo) {LM_ARCH} "
        f"full width, {SERVE4_LAYERS} layers, fp32, prefill "
        f"{SERVE4_BATCH} × {SERVE4_PROMPT}, {SERVE4_DECODE} decode steps "
        f"into {SERVE4_SLOTS} slots cut over model [{card}]: largest "
        f"difference from one rank over the ranks "
        f"{ {k: max(r[k] for r in ranks) for k in errs} }; prefill "
        f"attention launches per rank "
        f"{[r['launches']['flash_attention'] for r in ranks]}; 4 ranks in "
        f"{wall4:.2f} s; phase 24 in {time.perf_counter() - t0:.2f} s")
    log(f"serve 2x2 sliced prefill and decode, {' and '.join(SSM4_ARCHS)} "
        f"at full width cut to {SSM4_LAYERS} layers, fp32, {SERVE4_BATCH} "
        f"prompts of {SSM4_PROMPT} prefilled on the 4 ranks, then "
        f"{SSM4_DECODE} steps on from their states [{card}]: largest "
        f"difference from one rank over the ranks "
        f"{ {k: max(r['ssm'][k] for r in ranks) for k in ranks[0]['ssm']} }"
        f" (collective bytes: a rank's prefill and first decode step, every"
        f" layer: the embedding's rows summed over model, the logits' "
        f"columns gathered, and jamba's MoE experts gathered over data)")
    for arch, (data, model_axis) in WIDE4_RUNS:
        wide = [r["wide"][arch] for r in ranks]
        held = {k: max(w[k] for w in wide) for k in WIDE4_HELD
                if k in wide[0]}
        what = (f"full width, {WIDE4_LAYERS} encoder and decoder "
                f"layers, the encoder over {SERVE4_BATCH} × 1500 frames"
                if arch == AUDIO_ARCH else
                f"full width, {WIDE4_LAYERS} layers, 24/2 heads of 128 over "
                f"4 model ranks, a prefill of {SERVE4_BATCH} × "
                f"{SERVE4_PROMPT}")
        log(f"serve {data}x{model_axis} (data × model, 4 ranks on one card,"
            f" gloo) {arch}, {what}, then {WIDE4_DECODE} decode steps, fp32 "
            f"[{card}]: largest difference from one rank over the ranks "
            f"{held}; prefill attention launches per rank "
            f"{[w['launches']['flash_attention'] for w in wide]}; collective"
            f" bytes a rank: prefill {wide[0]['prefill collective bytes']:.0f}"
            f", first decode step {wide[0]['decode collective bytes']:.0f}")


def examples_phase(dev, card: str, launches: dict) -> None:
    """Phase 26 (module docstring): each of EXAMPLES through its ``main``
    on the card, its flags and a checkpoint directory in a temporary
    directory (``tempfile``'s too, where ``lm_train`` and
    ``convert_pretrained`` write), driven with the counts set to 0 (a
    ``serve_qos`` run adds its graphs' replayed launches), its own check
    passed."""
    import importlib

    import torch

    scratch = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    tmp = tempfile.tempdir
    tempfile.tempdir = scratch
    try:
        for name, flags, required in EXAMPLES:
            argv = list(flags)
            if name == "train_e2e":
                argv += ["--ckpt-dir", os.path.join(scratch, "e2e")]
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = drive(f"example {name}", required, launches,
                        lambda: mod.main(argv),
                        replayed=lambda r: r.get("graph_launches") or {})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if not out["ok"] or out["device"] == "cpu":
                fail(f"example {name} {argv}: its check failed ({out})")
            shown = {k: v for k, v in out.items()
                     if k not in ("narration", "graph_launches", "bands",
                                  "latency_ms", "tier_switches")}
            log(f"example {name} {' '.join(argv) or '(defaults)'} "
                f"[{card}]: {shown}; {wall:.2f} s, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    finally:
        tempfile.tempdir = tmp
        shutil.rmtree(scratch, ignore_errors=True)


def fig4a_blocks(n: int, seed: int):
    """The paper's §5.3 protocol (``tests/test_asm.py``): ``n`` random 4×4
    blocks box-upscaled to 8×8, as orthonormal zigzag coefficients (fp32,
    on the CPU)."""
    import numpy as np
    import torch

    from repro_torch.core import dct as dctlib

    small = np.random.default_rng(seed).uniform(-1, 1, size=(n, 4, 4))
    big = np.kron(small, np.ones((2, 2)))
    coef = dctlib.dct2(big).reshape(n, 64)[:, dctlib.zigzag_permutation()]
    return torch.as_tensor(coef, dtype=torch.float32)


def hold_asm(label: str, got, want, approx, card_mask) -> int:
    """ASM ReLU on the card against the CPU: every block within
    PAPER_ASM_RTOL but those whose mask differs, and a mask may differ only
    where the CPU's approximation lies within PAPER_TIE of 0 (two correct
    fp32 sums in another order fall on either side); returns those
    blocks' count."""
    flips = card_mask != (approx > 0)
    rows = flips.any(-1)
    if flips.any():
        worst = float(approx[flips].abs().max())
        if not worst <= PAPER_TIE * max(1.0, float(approx.abs().max())):
            fail(f"{label}: a mask differs where the approximation is "
                 f"{worst:.3e} from 0")
    compare(label, got[~rows], want[~rows], PAPER_ASM_RTOL)
    return int(rows.sum())


def paper_core_phase(dev, card: str, launches: dict) -> None:
    """Phase 25 (module docstring): the paper's formulation in ``core/`` on
    the card, each result against the same function on CPU copies (the
    plain versions) and against the paper's own identities."""
    import numpy as np
    import torch

    from repro_torch.core import asm as asmlib
    from repro_torch.core import conv as convlib
    from repro_torch.core import dct as dctlib
    from repro_torch.core import jpeg as jpeglib

    g = torch.Generator().manual_seed(25)
    grid = PAPER_IMAGE // 8
    img = torch.rand((PAPER_BATCH, PAPER_CH, PAPER_IMAGE, PAPER_IMAGE),
                     generator=g) * 2 - 1
    kern = torch.randn((PAPER_CH, PAPER_CH, 3, 3), generator=g) * 0.3
    bias = torch.randn((PAPER_CH,), generator=g)
    blocks = fig4a_blocks(PAPER_BLOCKS, 25)
    q = dctlib.quantization_table(50)
    # (e)'s lossy input: decodes of integer step-4 coefficients moved by at
    # most 0.3, so no coefficient sits within rounding of a .5 tie
    lossy_in = jpeglib.jpeg_decode(
        torch.randint(-3, 4, (PAPER_BATCH, 3, grid, grid, 64), generator=g)
        + torch.rand((PAPER_BATCH, 3, grid, grid, 64), generator=g) * 0.6
        - 0.3)
    x16 = torch.rand((16, 16), generator=g, dtype=torch.float64) * 2 - 1

    def encode(x, **kw):  # (N, C, H, W) → (N, bh, bw, C, 64)
        return jpeglib.jpeg_encode(x, **kw).movedim(1, 3)

    def decode(c, **kw):
        return jpeglib.jpeg_decode(c.movedim(3, 1), **kw)

    def card_side():
        out = {}
        coef = encode(img.to(dev), scaled=False)
        k, b = kern.to(dev), bias.to(dev)
        out["coef"] = coef
        for s in (1, 2):  # (a)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            op = convlib.explode_full(k, grid, grid, s)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out[f"full{s}"] = convlib.apply_full(coef, op)
            torch.cuda.synchronize()
            log(f"phase 25 (a) stride {s}: explode_full {t1 - t0:.3f} s "
                f"(operator {op.numel() * 4 / 1e9:.3f} GB), apply_full "
                f"{time.perf_counter() - t1:.3f} s [{card}]")
            del op
            out[f"conv{s}"] = convlib.jpeg_conv(coef, k, s)
            out[f"spatial{s}"] = encode(convlib.spatial_conv(
                decode(coef, scaled=False), k, s), scaled=False)
        out["bias"] = convlib.jpeg_conv(coef, k, 1, b)  # (b)
        out["bias_spatial"] = encode(convlib.spatial_conv(
            decode(coef, scaled=False), k, 1, b), scaled=False)
        c = blocks.to(dev)  # (c)
        oracle = asmlib.spatial_relu_oracle(c)
        out["oracle"] = oracle
        for phi in range(1, 15):
            out[f"asm{phi}"] = asmlib.asm_relu(c, phi)
            out[f"apx{phi}"] = asmlib.apx_relu(c, phi)
            out[f"mask{phi}"] = asmlib.nonnegative_mask(c, phi)
        cs = (c / torch.as_tensor(q, dtype=c.dtype, device=dev)).reshape(
            -1, 1, 1, 64)  # (d)
        out["asm_q"] = asmlib.asm_relu(cs, asmlib.EXACT_PHI, q)
        out["asm_q_pixels"] = jpeglib.jpeg_encode(torch.relu(
            jpeglib.jpeg_decode(cs, qtable=q)), qtable=q)
        c4 = c.reshape(-1, 1, 1, 64)
        out["leaky"] = asmlib.asm_piecewise(c4, asmlib.LEAKY_RELU,
                                            asmlib.EXACT_PHI)
        out["leaky_pixels"] = jpeglib.jpeg_encode(
            torch.nn.functional.leaky_relu(jpeglib.jpeg_decode(
                c4, scaled=False), 0.01), scaled=False)
        out["enc_q50"] = jpeglib.jpeg_encode(img.to(dev))  # (e)
        out["dec_q50"] = jpeglib.jpeg_decode(out["enc_q50"])
        out["enc_qt"] = jpeglib.jpeg_encode(img.to(dev), qtable=q * 0.5)
        out["lossy"] = jpeglib.jpeg_round_trip_lossy(lossy_in.to(dev))
        out["j16"] = jpeglib.jpeg_encode(x16.to(dev, torch.float32))
        torch.cuda.synchronize()
        return {k: v.cpu() for k, v in out.items()}

    with torch.no_grad():
        got = drive("paper core (phase 25)", ("jpeg_conv", "block_dct",
                                              "block_idct"),
                    launches, card_side)
        # (a) Algorithm 1 against the banded kernel and the spatial conv
        errs = {}
        for s in (1, 2):
            full = got[f"full{s}"]
            if full.shape != (PAPER_BATCH, grid // s, grid // s, PAPER_CH,
                              64):
                fail(f"phase 25 (a): apply_full shape {tuple(full.shape)}")
            errs[s] = (compare(f"(a) s{s} apply_full vs jpeg_conv", full,
                               got[f"conv{s}"], PAPER_RTOL),
                       compare(f"(a) s{s} apply_full vs spatial", full,
                               got[f"spatial{s}"], PAPER_RTOL))
        coef = got["coef"]
        compare("(a) encode vs plain", coef, encode(img, scaled=False),
                BLOCK_RTOL)
        # (b) the bias on DC
        plain_b = convlib.jpeg_conv(coef, kern, 1, bias)
        err_b = (compare("(b) jpeg_conv bias vs plain", got["bias"], plain_b,
                         PAPER_RTOL),
                 compare("(b) jpeg_conv bias vs spatial bias", got["bias"],
                         got["bias_spatial"], PAPER_RTOL))
        # (c) Fig. 4a: ASM against APX at every φ, each against the CPU
        oracle = asmlib.spatial_relu_oracle(blocks)
        compare("(c) oracle vs plain", got["oracle"], oracle, PAPER_ASM_RTOL)
        rmse_asm, rmse_apx, ties = [], [], 0
        for phi in range(1, 15):
            approx = asmlib.approx_spatial(blocks, phi)
            ties += hold_asm(f"(c) asm_relu phi={phi}", got[f"asm{phi}"],
                             asmlib.asm_relu(blocks, phi), approx,
                             got[f"mask{phi}"])
            compare(f"(c) apx_relu phi={phi}", got[f"apx{phi}"],
                    asmlib.apx_relu(blocks, phi), PAPER_ASM_RTOL)
            rmse_asm.append(float(((got[f"asm{phi}"] - got["oracle"]) ** 2)
                                  .mean().sqrt()))
            rmse_apx.append(float(((got[f"apx{phi}"] - got["oracle"]) ** 2)
                                  .mean().sqrt()))
            if not rmse_asm[-1] <= rmse_apx[-1] + 1e-9:
                fail(f"(c) phi={phi}: ASM RMSE {rmse_asm[-1]:.6e} > APX "
                     f"{rmse_apx[-1]:.6e}")
        log(f"phase 25 (c) Fig. 4a on the card [{card}], {PAPER_BLOCKS} "
            f"box-upscaled blocks, RMSE against the exact ReLU for phi = "
            f"1..14: ASM {[float(f'{e:.6e}') for e in rmse_asm]}; APX "
            f"{[float(f'{e:.6e}') for e in rmse_apx]}; blocks whose mask "
            f"sat within rounding of 0 and flipped: {ties}")
        # (d) JPEG-scaled ASM and the general case at φ = 14
        err_d = (compare("(d) asm_relu qtable vs decode-relu-encode",
                         got["asm_q"], got["asm_q_pixels"], PAPER_ASM_RTOL),
                 compare("(d) asm_piecewise leaky vs leaky pixels",
                         got["leaky"], got["leaky_pixels"], PAPER_ASM_RTOL))
        # (e) the transforms, the lossy round trip, J
        enc = jpeglib.jpeg_encode(img)
        err_e = [compare("(e) jpeg_encode q50", got["enc_q50"], enc,
                         BLOCK_RTOL),
                 compare("(e) jpeg_decode q50", got["dec_q50"],
                         jpeglib.jpeg_decode(enc), BLOCK_RTOL),
                 compare("(e) jpeg_encode qtable", got["enc_qt"],
                         jpeglib.jpeg_encode(img, qtable=q * 0.5),
                         BLOCK_RTOL)]
        want = jpeglib.jpeg_round_trip_lossy(lossy_in)
        err = float((got["lossy"] - want).abs().max())
        span = float(want.max() - want.min())
        if not err <= 1e-4 * span:
            fail(f"(e) lossy round trip: {err:.3e} > 1e-4 × {span:.3e}")
        err_e.append(err)
        j = np.einsum("hwxyk,hw->xyk", jpeglib.jpeg_tensor(16, 16),
                      x16.numpy())
        err_e.append(compare("(e) jpeg_tensor vs jpeg_encode", got["j16"],
                             torch.as_tensor(j, dtype=torch.float32),
                             BLOCK_RTOL))
    log(f"phase 25 [{card}]: (a) Algorithm 1, {PAPER_BATCH} × {PAPER_CH} × "
        f"{PAPER_IMAGE}², {PAPER_CH} → {PAPER_CH} 3×3: max abs err "
        f"(vs jpeg_conv, vs spatial) by stride {errs}; (b) bias "
        f"(vs plain, vs spatial) {err_b}; (d) {err_d}; (e) {err_e}")


def main() -> None:
    if not os.path.isdir(os.path.join(REPO_SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, REPO_SRC)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")

    from repro_torch.configs import get_config
    from repro_torch.core import dispatch as dsp
    from repro_torch.core import plan as planlib
    from repro_torch.introspect.opcount import PEAK_FP32_FLOPS, asm_work, \
        block_matmul_work, bound, conv_work, fused_work
    from repro_torch.kernels import _build
    from repro_torch.kernels import asm_relu as kasm
    from repro_torch.kernels import block_dct as kbd
    from repro_torch.kernels import fused_block as kfb
    from repro_torch.kernels import jpeg_conv as kjc
    from repro_torch.kernels import tiling
    from repro_torch.launch import serve, train

    dev = torch.device("cuda", 0)
    # --- phase 1: device and build -------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    # the synthetic client's files and the decode pool's cold start, on
    # the host beside the build
    cfg = get_config("jpeg-resnet")
    client_dir = tempfile.mkdtemp(prefix="chip_smoke_client_")
    atexit.register(shutil.rmtree, client_dir, True)
    client: dict = {}
    maker = threading.Thread(target=make_client,
                             args=(cfg, client_dir, client))
    maker.start()
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_log()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info.get('seconds', 0.0):.2f} s, cached="
        f"{info.get('cached')}) -> {_build.BUILD_DIR}")
    for line in ptxas_report(str(info.get("ptxas", ""))):
        log(f"ptxas: {line}")
    maker.join()
    if "error" in client:
        raise client["error"]
    log(f"client: {CLIENT_IMAGES} JFIF files encoded in "
        f"{client['encode_s']:.2f} s -> {client_dir}; decode pool of "
        f"{client['workers']} workers started (first batch of "
        f"{TRAIN_BATCH}) in {client['pool_start_s']:.2f} s, beside the "
        f"build")

    # --- phase 2: kernels against their plain versions ------------------
    args = serve.parse_args(["--arch", "jpeg-resnet", "--ingest", "bytes",
                             "--bands", str(BANDS), "--batch", str(BATCH),
                             "--requests", "16", "--max-new", "2",
                             "--jpeg-dir", client_dir, "--seed", "0"])
    t0 = time.perf_counter()
    plan, cp, plan_info = serve.prepare_plan(args, cfg, dev)
    torch.cuda.synchronize()
    log(f"plan built and compiled on the card in "
        f"{time.perf_counter() - t0:.2f} s: fused {cp.meta['fused']}, "
        f"per-layer {sorted(cp.meta['layers'])}, smem/CTA "
        f"{cp.meta['smem']}")
    if cp.meta["path"] != "cuda" or not cp.meta["fused"]:
        fail(f"compiled schedule does not run the kernels: {cp.meta}")
    gen = torch.Generator(device=dev).manual_seed(1)
    blocks = {b.name: b for b in cp.blocks}
    grid = cfg.image_size // 8
    rows: dict[str, dict] = {}

    def record(name, shape, err, ms, plain_ms, work, library_ms=None,
               peak=PEAK_FP32_FLOPS):
        bms, by = bound(*work, peak)
        # the kernels line carries each kernel's first (largest) shape
        r = rows.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                   "plain_ms": plain_ms, "bound_ms": bms,
                                   "bound_by": by, "library_ms": library_ms,
                                   "shape": shape})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        lib = f"{library_ms:.4f}" if library_ms is not None else "null"
        log(f"{name} @ {shape}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bms:.4f} ms ({by})  "
            f"library_ms {lib}")

    with torch.inference_mode():
        for name in ("s0b0", "s1b0"):
            blk = blocks[name]
            x = torch.randn((BATCH, grid, grid, blk.cin * blk.w_in),
                            generator=gen, device=dev)
            ops = (x, blk.conv1, blk.asm_mid, blk.conv2, blk.asm_out,
                   blk.proj)
            got = kfb.fused_block(*ops)
            want = kfb.fused_block_reference(*ops)
            err = compare(f"fused_block {name}", got, want, CONV_RTOL)
            out_rows = BATCH * (grid // blk.conv1.stride) ** 2
            convs = [pc for pc in (blk.conv1, blk.conv2, blk.proj) if pc]
            record("fused_block", f"{name} x{tuple(x.shape)}", err,
                   cuda_ms(lambda: kfb.fused_block(*ops)),
                   cuda_ms(lambda: kfb.fused_block_reference(*ops)),
                   fused_work(x.numel(), got.numel(), out_rows,
                              [pc.xi.numel() for pc in convs], blk.cout,
                              blk.asm_mid.w, blk.asm_out.w))

        # the s2b0 projection is the served path's one jpeg_conv with 64-row
        # tiles (kernels/jpeg_conv.py tile_rows)
        for label, op, shape in (
                ("s1b0.conv1", plan.operators["s1b0"]["conv1"],
                 (BATCH, grid, grid, 64, 64)),
                ("s2b0.proj", plan.operators["s2b0"]["proj"],
                 (BATCH, grid // 2, grid // 2, 128, 64)),
                ("stem", plan.operators["stem"], (BATCH, grid, grid, 3, 64))):
            coef = torch.randn(shape, generator=gen, device=dev)
            run = (coef, op.xi, op.stride)
            kw = dict(shift=op.shift, w_out=64)
            got = kjc.jpeg_conv(*run, **kw)
            want = kjc.jpeg_conv_plain(*run, **kw)
            err = compare(f"jpeg_conv {label}", got, want, CONV_RTOL)
            ndy, ndx, cin, nf_in, cout, nf_out = op.xi.shape
            s, (n, gh, gw) = op.stride, shape[:3]
            out_rows = n * (gh // s) * (gw // s)
            work = conv_work(n * gh * gw, cin, nf_in, ndy * ndx,
                             nf_in, cout, nf_out, 64, out_rows)
            cols = tiling.conv_slices(
                coef[..., :nf_in].reshape(n, gh, gw, cin * nf_in),
                s, ndy, ndx).reshape(out_rows, -1)
            xi2 = op.xi.reshape(-1, cout * nf_out)
            record("jpeg_conv", f"{label} x{tuple(shape)}", err,
                   cuda_ms(lambda: kjc.jpeg_conv(*run, **kw)),
                   cuda_ms(lambda: kjc.jpeg_conv_plain(*run, **kw)),
                   work, cuda_ms(lambda: torch.matmul(cols, xi2)))
            del cols

        # ASM at stage 0 of the per-layer walk (16 and 64 bands), then at
        # the served walk's s2 and s3 (16 bands) and a ragged row count; at
        # the served shapes also the kernel's device time from the profiler
        # and the wrapper's host time a call
        n_rows = BATCH * grid * grid * cfg.widths[0]
        s2_rows = BATCH * (grid // 4) ** 2 * cfg.widths[2]
        s3_rows = BATCH * (grid // 8) ** 2 * cfg.widths[3]
        t = torch.randn((n_rows, 64), generator=gen, device=dev)
        for label, n, w in (("s0", n_rows, BANDS), ("s0", n_rows, 64),
                            ("s2", s2_rows, BANDS), ("s3", s3_rows, BANDS),
                            ("ragged", s2_rows + 37, BANDS)):
            x = t[:n]

            def run(x=x, w=w):
                return kasm.asm_relu(x, cfg.asm_phi, bands=w)

            got = run()
            want = kasm.asm_relu_plain(x, cfg.asm_phi, bands=w)
            err = compare(f"asm_relu {label} w={w}", got, want, ASM_RTOL)
            record("asm_relu", f"{label} w={w} rows={n}", err,
                   cuda_ms(run),
                   cuda_ms(lambda: kasm.asm_relu_plain(x, cfg.asm_phi,
                                                       bands=w)),
                   asm_work(n, w))
            if label in ("s2", "s3"):
                split_cost(f"asm_relu {label} w={w} rows={n}", run,
                           "asm_kernel")
        del t, x, got, want

        # block transforms at the training path's shapes: stage 0's
        # factored encode and decode (batch 8, 64 channels of 32×32 blocks)
        # and the data encode (batch 8, 3 channels, quality 50)
        s0_rows = TRAIN_BATCH * grid * grid * cfg.widths[0]
        data_rows = TRAIN_BATCH * grid * grid * cfg.in_channels
        for name, label, n, q in (
                ("block_dct", "s0 factored encode", s0_rows, None),
                ("block_idct", "s0 factored decode", s0_rows, None),
                ("block_dct", "data encode q50", data_rows, 50)):
            fn = getattr(kbd, name)
            plain = getattr(kbd, name + "_plain")
            shape = (n, 8, 8) if name == "block_dct" else (n, 64)
            x = torch.randn(shape, generator=gen, device=dev)
            got = fn(x, q)
            err = compare(f"{name} {label}", got, plain(x, q), BLOCK_RTOL)
            x2, op = x.reshape(n, 64), kbd.operator(name, q, x)
            record(name, f"{label} rows={n}", err,
                   cuda_ms(lambda: fn(x, q)), cuda_ms(lambda: plain(x, q)),
                   block_matmul_work(n),
                   cuda_ms(lambda: torch.matmul(x2, op)))
            if q is not None:
                split_cost(f"{name} {label} rows={n}", lambda: fn(x, q),
                           "block_matmul_kernel")
            del x, x2, got

        attention_checks(dev, record)
    attention_backward_checks(dev, record)

    # --- phases 3 and 4: the server, compiled and per-layer ---------------
    launches = {k: 0 for k in KERNELS}
    ref_cfg = dsp.DispatchConfig(path="reference", bands=BANDS)
    # at 16 bands s0b0-s1b1 fuse and s2b0-s3b1 walk per layer: factored
    # convs (block transforms), the s2b0 projection (jpeg_conv), ASM
    walks = (("compiled", True, JPEG_KERNELS),
             ("per-layer", False, ("jpeg_conv", "asm_relu", "block_dct",
                                   "block_idct")))
    slot_reports = {}
    for phase, compiled, required in walks:
        seen = []
        args.compiled = compiled
        prepared = (plan, cp if compiled else None,
                    dict(plan_info, compiled=compiled))
        report = drive(
            f"serve {phase}", required, launches,
            lambda: serve.serve_jpeg_resnet(
                args, prepared=prepared,
                on_batch=lambda x, lg: seen.append((x.clone(), lg.clone()))))
        if report["completed"] != args.requests or not seen:
            fail(f"{phase}: served {report['completed']} of {args.requests}")
        errs, top1 = hold_logits(
            phase, seen, cfg.num_classes,
            lambda x: (planlib.apply_compiled_packed(cp, x, ref_cfg)
                       if compiled else planlib.apply_plan(plan, x, ref_cfg)))
        slot_reports[phase] = report
        log(f"{phase}: {report['images_per_s']:.2f} images/s (host ingest "
            f"{report['ingest_s']:.3f} s + forward {report['forward_s']:.3f} "
            f"s), latency {report['latency_ms']}, logits vs plain "
            f"path: max abs err {max(errs):.3e}, top-1 agreement {top1}")
    del plan, cp
    torch.cuda.empty_cache()

    # --- phase 5: one training step, kernel path against plain path -------
    timed("phase 5", card, lambda: train_step_check(cfg, dev))

    # --- phase 6: the trainer, then serving from its exported plan ---------
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        timed("phase 6", card, lambda: train_and_serve(
            cfg, dev, ckpt_dir, launches, client_dir))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # --- phase 7: serve --qos, CUDA graphs over the ladder -----------------
    timed("phase 7", card, lambda: qos_phase(cfg, dev, launches,
                                             slot_reports, client_dir))

    # --- phase 8: the paper's conversion at full width ----------------------
    timed("phase 8", card, lambda: conversion_phase(cfg, dev, launches,
                                                    client_dir))

    # --- phase 9: plan introspection on the h100 profile --------------------
    timed("phase 9", card, lambda: introspection_phase(cfg, dev, launches))

    # --- phases 10-12: LM serving -------------------------------------------
    timed("phases 10-12", card, lambda: lm_phases(dev, card, launches))

    # --- phase 13: LM training ----------------------------------------------
    timed("phase 13", card, lambda: lm_train_phase(dev, card, launches))

    # --- phases 14-17: the MoE and Mamba-hybrid LMs -------------------------
    timed("phase 14", card, lambda: moe_serving_phase(dev, card, launches))
    timed("phase 15", card, lambda: moe_cut_phase(
        "mixtral-8x7b", MIXTRAL_LAYERS, MIXTRAL_PROMPT, MIXTRAL_DECODE, dev,
        card, launches))
    timed("phase 16", card, lambda: moe_cut_phase(
        "jamba-v0.1-52b", JAMBA_LAYERS, JAMBA_PROMPT, JAMBA_DECODE, dev,
        card, launches))
    timed("phase 17", card, lambda: lm_grad_check(dev, card, MOE_ARCH,
                                                  launches))

    # --- phases 18-21: the RWKV, VLM and audio LMs ---------------------------
    timed("phase 18", card, lambda: rwkv_phase(dev, card, launches))
    timed("phase 19", card, lambda: vlm_phase(dev, card, launches))
    timed("phase 20", card, lambda: audio_phase(dev, card, launches))
    timed("phase 21", card, lambda: lm_family_train_phase(dev, card,
                                                          launches))

    # --- phases 22-23: training on a mesh -----------------------------------
    timed("phases 22-23", card, lambda: mesh_phases(dev, card, launches))

    # --- phase 24: the dry-run, and serving on a mesh -----------------------
    timed("phase 24", card, lambda: dryrun_phase(dev, card, launches))

    # --- phase 25: the paper's formulation in core/ -------------------------
    timed("phase 25", card, lambda: paper_core_phase(dev, card, launches))

    # --- phase 26: the examples ---------------------------------------------
    timed("phase 26", card, lambda: examples_phase(dev, card, launches))

    kernels = []
    src = {k: "src/repro_torch/csrc/jpeg_kernels.cu" for k in KERNELS}
    src["block_dct"] = src["block_idct"] = "src/repro_torch/csrc/block_dct.cu"
    src["flash_attention"] = src["flash_attention_bwd"] = \
        "src/repro_torch/csrc/flash_attention.cu"
    replaces = {"fused_block": "src/repro/kernels/fused_block.py:143",
                "jpeg_conv": "src/repro/kernels/jpeg_conv.py:112",
                "asm_relu": "src/repro/kernels/asm_relu.py:65",
                "block_dct": "src/repro/kernels/block_dct.py:37",
                "block_idct": "src/repro/kernels/block_dct.py:37",
                "flash_attention":
                    "src/repro/kernels/flash_attention.py:96",
                # the reference differentiates it by XLA's autodiff
                "flash_attention_bwd":
                    "src/repro/kernels/flash_attention.py:96 (its gradient)"}
    for name in KERNELS:
        r = rows[name]
        if launches[name] <= 0:
            fail(f"{name} was never launched on the main paths")
        kernels.append({"name": name, "route": "cuda", "source": src[name],
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"]})
    log(f"every phase passed: {time.perf_counter() - _T0:.2f} s in all")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
