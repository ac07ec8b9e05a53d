#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse # the same phases, tiny, on the CPU

Phases (any failure exits non-zero and prints no result line):

1. The card's name and power limit (nvidia-smi); build the CUDA kernels
   of src/repro_torch/kernels/csrc with nvcc, one process per source.
2. Training: ``train_filter`` on the detrac-like scene at the paper's
   g = 56, the 4-layer d_model 128 filter trunk (naive attention, as the
   JAX package trains it) with the IC head, 96 Adam steps at batch 8;
   first and last loss (both finite), ms per step, the paper's
   count accuracy on held-out frames, and the phase's peak memory.
3. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the trained weights' inputs): the two
   spatial-stats kernels bit for bit (``torch.equal``) as the planner
   calls them: ``classes=`` with the two classes it reads, on the full
   (32, 56, 56, 3) grid, the row kernel on an unsorted list of 16 int64
   row ids on the card, with duplicates; each beside two "before"
   readings, the kernel on the grid sliced beforehand and the
   composition the planner ran before (gather the planes,
   ``.contiguous()``, then the kernel); then the kernel's device time
   with the host's pick of the cluster size and at each size 1..8, at
   those calls and on (32, 56, 56, 8) grids, each bit for bit.  The CAM
   head at 1e-4, flash
   attention at max abs err 1e-4 (float32), plus a sweep of shapes,
   types, masks, GQA and ragged lengths (1e-4 float32, 2e-2 bfloat16),
   and a stress sweep of the float32 kernel's 3xTF32 split (q and k
   scaled by 3 and 8, values over four decades; 1e-4 against float64,
   and against the plain version except at x8); an in-run check that
   the plain version with one TF32 pass (``allow_tf32``) at the main
   shape, q and k scaled by 3, misses 1e-4.  Each kernel and library
   call is timed three ways: its device time per call from
   torch.profiler (25 calls after a warm-up; the ``ms`` of the kernel
   line), the median CUDA-event interval around one call ("call ms",
   the Python wrapper included), and CUDA events around 50
   back-to-back calls; the plain version by its call interval.  Beside
   them its bound and a library yardstick where one PyTorch call
   computes the same function.
4. The main path at full width: the trained filter served through the
   kernels (``attn_impl="pallas"`` trunk, CAM head kernel), 256 frames in
   batches of 32 through MultiQueryStreamExecutor -> MultiQueryExecutor
   -> MultiQueryCascade(adaptive=True), queries registered and retired
   mid-stream; then the same batches with ground-truth filter outputs,
   where the count tier decides most rows and the compacted spatial
   stage runs the row kernel.  Launch counts are reset just before and
   read just after; every kernel must have run (flash attention once
   per trunk layer and batch), the staged masks must equal the
   exhaustive plan's bit for bit, the answers must equal the exact
   oracle semantics, the kernel head must match the plain head, and the
   serving peak memory must stay under 2 GiB (no S x S scores).
5. One batch through the naive and the pallas trunk on the same trained
   weights: both timed, their outputs equal within rtol 1e-4 / atol 1e-3.
5b. The aggregate half at full width: 2048 frames of the same detrac-like
   stream (1.6 GB of float32 embeddings on the card), the learned filter
   served through the pallas trunk and the CAM head, the ground-truth
   object lists as the oracle (``make_value_fn``).  Counts are reset
   just before and read just after; flash attention, the CAM head and
   both stats kernels must have launched.  Checks: (1) a census — a
   count contract with ``max_oracle = n`` and ``eps = 1e-9`` returns the
   exact count, a zero-width interval and n oracle calls, each frame
   charged once; (2) error-bounded contracts through
   ``AggregateStreamSession`` (Thompson allocation, ±10% at 95%) on the
   learned and the ground-truth filter, for a count of car-left-of-bus
   frames and the number of cars over them: under ``cv="auto"`` the
   truth within 3 half-widths and the pooled CV variance at most the
   naive one; under ``cv="eager"`` the variance check and a second run
   with the same seed equal in every field that is not a measured
   microsecond (chunks priced by an explicit uniform vector;
   ``cv="auto"`` decides its sweeps on wall-clock prices), its coverage
   reported; beside the uniform ``cv="off"`` baseline's oracle calls;
   (3) the
   per-chunk float64 ``CVAccumulator``s on the card, merged, equal to
   ``pooled_accumulator()``, ``distributed_reduce`` and numpy
   ``mcv_estimate`` within 1e-9 relative; (4) ``calibrate`` at the
   planner's shape (batch 32, g = 56, C = 3; CUDA events), saved to
   results/calibration/torch-cuda.json, loaded back, with
   ``calibrate_oracle`` folded in; the filter stream's learned pass again
   under that model (staged == exhaustive bit for bit, answers equal to
   the static model's), and a contract priced by it reporting
   ``measured``; (5) that stream and an aggregate session on one
   ``QueryRegistry`` charging one budget ledger.
5c. Fleet serving with the temporal tier: 16 streams (cam0..cam15, each
   its own detrac-like ``VideoStream`` seeded by ``stream_seed``) x 128
   frames at g = 56, windows of 64, batch 32, through
   ``MultiStreamExecutor`` on the group engine (``evaluate_group`` over
   the flat stack, ``advance_group``): the reference fleet mix of
   temporal queries and two frame-level ones, a ground-truth pass and a
   learned pass (pallas trunk, CAM head), the learned one with a
   register and a retire inside window 2.  Counts are reset just before
   the two passes and read just after.  Checks: (1) ground-truth
   answers equal ``replay_reference`` over ``eval_objects`` per frame,
   and so do serial ``TemporalEngine`` runs with the exact oracle; (2)
   learned answers equal each stream run alone under the same churn;
   (3) ``evaluate_group`` equals ``evaluate`` per stream on every chunk
   at each spatial body; (4) the torch scan backend equals the numpy
   one; (5) frames and signal evaluations were skipped; (6) flash
   attention, the CAM head and the full-batch stats kernel launched in
   the passes, the row kernel there or in (3); (7) serving memory above
   the resident embeddings under 2 GiB.  Fleet frames/s (group vs 16
   serial loops), one chunk's plan and temporal-step ms and a profile
   of it, the temporal step's launches.
6. The RWKV-6 serving path at full width: rwkv6-3b (32 layers, d_model
   2560, vocab 65536, bf16) with random weights from a seeded CUDA
   generator, ``attn_impl="pallas"``; four requests of 1024 prompt tokens
   through ``prefill``, then 32 greedy ``decode_step``s, after one
   untimed warm-up pass.  Counts are reset just before and read just
   after: ``rwkv6_scan_bhtk`` must have launched once per layer and call
   (32 x 33); the tokens must lie in the vocabulary and every logit be
   finite.  Prefill tokens/s, ms per decode step and peak memory.
   The profile lines give the WKV scan's share of the device time.
7. The WKV-scan kernel against its plain version at that path's prefill
   and decode shapes (layer 0's inputs, kept from the warm-up with their
   strides: the time-mix's (B, T, H, K) tensors, read in place), timed;
   the strided call must equal the contiguous one bit for bit; and a
   sweep (T 1/32/50/1024, K 16/64, fp32 and bf16, non-zero u and s0, two
   halves carried through sT); 5e-3, plus one bf16 step of the output.
8. Decode attention through its entry point ``ops.decode_attention`` at
   qwen2-0.5b's decode_32k shape (B 128, S 32768, 14 heads over 2 kv
   heads, hd 64, bf16, kv_len 30000) on the model's (B, S, KV, hd) cache,
   counts reset just before and read just after; the call is timed whole,
   and its added peak memory must be no more than its output and split
   scratch (the cache is read in place, never copied); a repeated call
   and the (B, KV, S, hd) layout must give the same bits.  The kernel
   against its plain version, timed beside it and two
   ``scaled_dot_product_attention`` yardsticks (a boolean kv_len mask over
   all S rows; the kv_len slice, which reads the kernel's bytes), there
   in bf16 and in float32 (the same values); a sweep (the Pallas test's
   cases, ragged S, G 7/16, hd 128, a 20000-key cache in both types).
   Tolerances: 1e-4 in
   float32; in bf16 the Pallas test's 2e-2 or four bf16 steps of the
   largest output, whichever is smaller (a long cache's outputs are
   ~0.04, and a fixed 2e-2 would pass a kernel that ignored kv_len).
9. Float32 at full width (12.3 GB of weights, the bf16 ones freed): two
   256-token prompts and 8 decode steps through the kernel path and the
   chunked plain path (``xla_flash``) on the same weights and tokens,
   logits within 2e-2; and the kernel path's decode against a full
   forward over prompt + generated tokens, within 2e-2.
10. The zoo's attention family (``attn_impl="pallas"``, random weights
    from a seeded CUDA generator), counts reset just before each counted
    window and read just after: qwen2-0.5b at full width in bf16 (24
    layers, d_model 896, 14 heads over 2 of 64, vocab 151936), 16
    requests x 1024 prompt tokens into a 1056-row cache and 32 greedy
    decode steps after one untimed warm-up pass: prefill tokens/s, ms
    per step, peak memory (the prefill's full logits are 4.64 GiB, as in
    the JAX package), a profile of one prefill and one decode step;
    decode attention once per layer and step, tokens in the vocab,
    logits finite; layer 0's first decode call of the warm-up, on the
    bf16 cache (G 7), against the plain version (``decode_tol``, and
    1e-4 on the same values in float32).
11. The decode_32k cell on qwen2-0.5b in bf16: batch 128, a 32768-row
    cache (48.0 GiB) filled layer by layer with bf16 draws to len 30000,
    then 8 ``decode_step``s: ms per step beside the step's bytes bound
    (the valid rows and the weights at 3.35 TB/s); the cache tensors'
    pointers fixed, under 0.5 GiB added to the peak above cache and
    weights, decode attention once per layer and step.
12. whisper-base at full width in bf16: 8 requests of 1500 stub frame
    embeddings, 4 prompt tokens, 60 decode steps: encode ms (the encoder
    alone), prefill ms, ms per step, peak; flash attention once per
    encoder layer (the prefill's encoder), decode attention once per
    decoder layer and step; encoder layer 0's flash call against the
    plain version (2e-2 in bf16, 1e-4 on the same values in float32);
    the decoder's first decode call (G 1) as in phase 10.
13. qwen2-0.5b at full width in float32: 2 x 256 prompt tokens, 8 decode
    steps; each step's logits against the cache-less forward over prompt
    + generated tokens (264^2 scores: the flash kernel) within 1e-3 x
    max|logit|, greedy tokens equal; layer 0's decode call on the
    model's cache and the forward's first flash call against their plain
    versions at 1e-4.
14. The rest of the zoo at full width in bf16 (pallas, random weights
    from a seeded CUDA generator), each after one untimed warm-up pass,
    counts reset just before the timed pass: prefill tokens/s, ms per
    step (median, min, max), a profile of one decode step and one
    prefill (busy, idle share, launches), peak; tokens in the vocab,
    logits finite, the cache's pointers fixed.  granite-moe-3b-a800m
    (32 layers, d 1536, 24 heads over 8 of 64, 40 experts top-8 of d_ff
    512, capacity 1.25): 16 x 1024 prompt tokens into 1056 rows, 32
    steps, the dropped share of routed assignments per layer at
    prefill, decode attention once per layer and step and its first call
    against plain (``decode_check``).
    grok-1-314b at full width, depth cut to 2 of 64 layers (~23 GB of
    weights): 4 x 256 tokens, 8 steps; softcap, so no kernel runs (as in
    JAX).  hymba-1.5b (32 layers, d 1600, 25 heads over 5, d_inner 3200,
    N 16, window 1024): 8 x 1000 tokens (Mamba chunks of 50) into a
    1024-row ring (cap 1048), 48 steps that wrap it; no kernel (a ring);
    the pointers of k, v, pos, ssm and conv fixed.  paligemma-3b (18
    layers, d 2048, 8 heads over 1 of 256, vocab 257216): 8 x (256 stub
    patch embeddings + 64 tokens), 32 steps, decode attention at hd 256
    once per layer and step, its first call against plain.
15. Float32 at full width, depth cut to 4 layers (TF32 off): granite
    (capacity factor E/K: nothing drops), hymba (2 x 1020 tokens, 8 steps
    across the ring's wrap) and paligemma (2 x (256 + 32)); each step's
    logits against the cache-less forward within 1e-3 x max|logit|,
    greedy tokens equal; granite's and hymba's forwards reach flash
    attention (hymba's with its 1024 window), one call each against
    plain at 1e-4; granite's and paligemma's first decode call against
    plain.
16. Decode attention at hd 256 through ``ops.decode_attention`` on a
    (B, S, KV, hd) cache read in place, (B, KV, G, S, hd) = (128, 1, 8,
    32768, 256), bf16, kv_len 30000: against plain at ``decode_tol``,
    and in float32 at 1e-4 on (8, 1, 8, 4096, 256); device ms, call,
    back-to-back, plain, SDPA (masked, and on the kv_len slice) and the
    bytes bound (3.93 GB at 3.35 TB/s); the ``hd256`` entry of decode
    attention's kernel line.
17. The zoo's training: qwen2-0.5b at published widths (bf16 parameters,
    float32 AdamW moments, remat none, ``xla_flash``) through
    ``repro_torch.launch.train.main``: 16 steps of 4 x 1024 tokens with
    checkpoints every 8 (steps 0 and 8), then a resume to 24 that starts
    at step 9; each loss finite, the first within 1.0 of ln 151936; ms
    per step (median of steps 2+), tokens/s, peak; one step under
    torch.profiler; an async save's host time beside a step.  An exact
    resume (3 steps, ``save``, 2 steps from memory and 2 from
    ``restore(device="cuda")``: losses within 1e-3 relative, the largest
    parameter difference).  One 4 x 512 batch memorised in 30 AdamW
    steps at lr 1e-3 (last loss under 0.7 x the first), saved, restored
    into ``attn_impl="pallas"`` and served (4 x 256 prompt tokens into a
    512-row cache, 32 greedy steps): decode attention 24 x 32 times
    (counts reset just before, read just after), tokens in the vocab,
    logits finite, the share of greedy tokens equal to the memorised
    next tokens beside the initial weights'.  One 1 x 4096 step under
    remat none, full and selective: losses within 1e-3 relative, the
    peak under full below none's.  hymba-1.5b at published widths, 4 of
    32 layers, its selective remat: 3 steps of 2 x 512 tokens, losses and
    gradient norms finite.  ``repro_torch.launch.serve.main`` at its
    defaults: the answers on the survivors are the oracle's.
18. A ``kernels`` JSON line (all six kernels; flash and decode attention
    with their ``zoo_launches`` of phases 10-15, 17 and 19; each with its
    ``families_launches`` of phase 21 (a), its ``fleet_mesh_launches``
    of phase 22, (a) and (b)'s rank 0, and its ``flash256_phase_launches``
    of phase 23's sub-paths; flash attention with its ``hd256`` entry of
    phase 23), then the device line as the last line.
19. (Run before the lines of 18.)  The launch analyses: five steps, each
    analysed on meta by ``repro_torch.launch.dryrun.analyse`` (its own
    random-weight arguments, nothing allocated) and then run once on the
    card at published widths with the same shapes, after
    ``reset_peak_memory_stats``: (a) qwen2-0.5b decode_32k as configured
    (``xla_flash``; 1 GiB of weights and a 48 GiB cache whose ``len``
    says 32767 rows are filled), (b) the same under ``pallas`` (decode
    attention, 24 calls a step), (c) rwkv6-3b and (d) hymba-1.5b at
    long_500k (batch 1), (e) qwen2-0.5b's train step at 4 x 1024 with
    remat none (train_4k's 256 x 4096 cut to the training phase's own
    step).  Checks: the predicted peak (arguments and every live
    storage) within 10% of ``max_memory_allocated`` above what was
    allocated before the arguments (the plain versions stand in for the
    kernels on meta, so (b)'s prediction holds the plain decode
    attention's float32 copies, which the kernel never makes); the
    analysed dot FLOPs within 2% of ``torch.profiler(with_flops=True)``'s
    ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` total on the cells without
    a kernel; the plain-version calls counted on meta equal to the
    launches; the outputs finite and of their shape.  Printed: the step's
    median ms beside the H100 roofline's max(compute, memory) and their
    ratio.  Then the gradient tree of one qwen2-0.5b step at 4 x 1024
    (494 M parameters) through ``distributed.compression``: per leaf
    ``|decompress - g|`` at most ``scale / 2`` (and 127 float32 ulps of
    a step) and the new error equal to ``g - decompress`` bit for bit;
    ``allreduce_compressed`` over a one-rank NCCL group from a
    ``file://`` store (within ``scale / 2``; ``op_cost`` counting two
    all-reduces a leaf); the reference's 50-step constant-gradient case
    at 1e-3; compress and all-reduce ms beside the gradient pass.
20. (Run after 19, before the lines of 18.)  The mesh path.  (a) A
    one-rank NCCL group from a ``file://`` store under ``build/``, the
    (1, 1) host mesh: qwen2-0.5b's decode_32k in bf16 (batch 128, the
    48 GiB cache filled to 30000 rows) and in float32 (batch 8), placed
    by ``jit_step_for_cell``'s plan as DTensors in place (pointers
    unchanged), 8 steps under ``ctx.decode_shard`` (no kernel launched:
    JAX's routing), then the one-card decode from the same cache state
    (``xla_flash``): float32 logits at ``decode_tol``'s 1e-4, bf16 at
    ``mesh_tol`` (``MESH_BF16_TOL``, 0.25, set from the gaps measured
    between whole-model bf16 decodes); the train step at 4 x 1024
    through the plan against ``step_for_cell`` from the same state (AdamW
    at 1e-2: loss at 1e-4 relative, moments within 1e-4 of each leaf's
    largest, parameters within 2^-8 |p| + 1e-3 of the rate where the
    step can be read); ms per step of both, peaks.  (b) Four processes of this script
    (``--mesh-worker``) on the one card over gloo: the decode at (1, 4)
    with the cache split on sequence and the rest replicated (each rank
    builds its 8192-row slice; bf16 batch 32, float32 batch 8) against
    (a)'s logits; the pipeline, qwen2-0.5b's 24 layers as 4 stages of 6
    over 4 microbatches of 4 x 1024 bf16, against ``run_layers``; the
    collectives gloo carried.  A rank that exits non-zero, or (b) past
    120 s, fails the smoke.
21. (Run after 20, before the lines of 18.)  Every family's steps over a
    mesh.  (a) A one-rank NCCL group, the (1, 1) mesh: a prefill and 4
    decode steps through ``jit_step_for_cell`` (``pallas``) in bf16 at
    full width and depth (grok-1-314b at 2 of 64 layers) of
    granite-moe-3b-a800m, grok-1-314b, rwkv6-3b, hymba-1.5b (a 1,022-token
    prompt whose steps wrap its 1,024-row ring), whisper-base and
    paligemma-3b against the unsharded calls at ``mesh_tol``, step ms and
    peak, the WKV scan, decode attention and (whisper) flash attention
    launched through the plan; then the five families other than grok at
    full width, 2 layers, float32: two unsharded AdamW train steps (the
    (2, 2) plan's two routing groups) and a prefill + 2 decode steps,
    through the plan at world 1 within 1e-4.  (b) Four processes of this
    script (``--families-worker``) on the one card over gloo, the (2, 2)
    mesh, DTensor's functional collectives run as blocking gloo calls on
    host copies (``blocking_collectives``): each family's prefill and 2
    decode steps (``pallas``, the kernels on each rank's chunk) against
    (a)'s logits at 1e-4, its 2 train steps' losses at 1e-4 and the first
    gradient norm at 1e-4 of its size, each call's peak.  (c) Beside (b),
    one process (``--families-dryrun``) runs ``launch.dryrun.analyse`` on
    the same calls over a fake group of 4: each rank's predicted peak
    within 15% of (b)'s measured one less cuBLAS's workspace; and
    qwen2-0.5b's and qwen2-72b's decode_32k on the (16, 16) mesh of 256
    fake ranks with their per-rank argument GiB.  A process that exits
    non-zero, or (b) past 300 s, fails the smoke.
22. (Run after 21, before the lines of 18.)  Fleet serving over a
    ``("stream",)`` mesh.  (a) A one-rank NCCL group from a ``file://``
    store under ``build/`` and ``sharding.stream_mesh()``: the fleet
    phase's 16 streams x 128 frames at g = 56 (its frames kept on the
    host; the trained filter saved under ``build/`` and loaded back)
    through ``plan_group_engine_factory(fetch, mesh=...)``, the
    ground-truth pass and the learned pass with its churn: every
    stream's per-frame answers and window hits equal the one-card
    fleet's bit for bit; frames/s beside the one-card fleet's, the
    kernels' launches.  (b) Four processes of this script
    (``--fleet-worker``) on the one card over gloo, a stream mesh of 4,
    4 streams a rank: each rank loads the filter, collects its own
    streams' frames and runs its block's learned fetch (flash attention
    and the CAM head), both passes (the learned one with its compacted
    spatial tier forced onto the row kernel): every rank's answers and
    hits of all 16 streams equal (a)'s; the stats kernel on 4 x 32 =
    128 frames a call and the row kernel on local ids below 128; rank
    0's first stats call equal to its plain version bit for bit; 6
    streams over the 4 ranks take the replication fallback and agree
    with the engine without a mesh; ``distributed_reduce`` over the 4
    ranks (float64 on the card, through gloo's host copies) within
    1e-12 of the merge of the ranks' accumulators.  A rank that exits
    non-zero, or (b) past 120 s, fails the smoke.
23. (Run after 22, before the lines of 18.)  Flash attention at head dim
    256, ``ops.spatial_stats`` and the §IV-B twin.  (a) The hd 256 body
    at paligemma-3b's attention shape, (B, H, KV, S, hd) = (8, 8, 1,
    1024, 256), causal, in bf16 and float32 against the plain version
    (2e-2 / 1e-4), with a sliding window of 256 and ragged lengths (1000
    x 1000, 77 x 1000): device ms, call, back-to-back, plain, SDPA
    (causal, GQA) on the same inputs, and the bound (the causal half of
    4 B H S^2 hd FLOPs at 989 TFLOP/s in bf16, three TF32 products at
    495 in float32, against q, k, v and o once): the ``hd256`` entry of
    flash attention's kernel line; before them, bf16's wgmma body as
    built: threads, the registers setmaxnreg gives each warp role,
    registers at entry, spills and local bytes (none allowed), dynamic
    shared memory and blocks an SM, its HGMMA instructions in the SASS
    (cuobjdump), no ptxas line on wgmma serialization or setmaxnreg, and
    its two products on one tile against torch.matmul (1e-3), the
    entry's ``body``.  (b) paligemma-3b at full width in
    bf16, tokens only, ``attn_impl="pallas"``, random weights from a
    seeded CUDA generator: 8 x 1024 tokens through ``models.model.
    forward``, counts reset just before the timed pass and read just
    after: flash attention once per layer (18) and no other kernel;
    logits finite and within ``MESH_BF16_TOL`` of the same forward
    under ``xla_flash``; then 2 layers in float32 within 1e-4.  (c) Head
    dim 96, zero-padded to the 128 body, against its plain version in
    both types, timed beside the body on inputs padded beforehand.  (d)
    ``ops.spatial_stats`` on the filter stream's (32, 56, 56, 3) grid:
    one launch, bit for bit against its plain version; then
    examples/torch_monitoring_queries.py at ``--steps 40 --frames 256``
    on the card (its table; the survivors' answers equal to the exact
    semantics; the staged plan's masks equal to the cascade's; the
    spatial-stats kernels launched).
"""
import argparse
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense TF32 tensor cores
N_FRAMES, BATCH, WINDOW = 256, 32, 128
SEED = 0
TRAIN_STEPS, TRAIN_BATCH, TRAIN_FRAMES, EVAL_FRAMES = 96, 8, 256, 64
SERVING_PEAK_LIMIT = 2 * 2**30   # bytes; one S x S score tensor is 4.7 GiB
RWKV_REQUESTS, RWKV_PROMPT, RWKV_DECODE = 4, 1024, 32
RWKV_FP32_PROMPT, RWKV_FP32_DECODE = 256, 8
DECODE_KV_LEN = 30000            # valid rows of the 32768-row decode cache
ZOO_REQUESTS, ZOO_PROMPT, ZOO_DECODE = 16, 1024, 32   # qwen2-0.5b serving
DECODE32K_STEPS = 8              # decode_step calls on the 48 GiB cache
DECODE32K_ADDED_LIMIT = 2**29    # bytes a step may add above cache+weights
WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_DECODE = 8, 4, 60
ZOO_FP32_PROMPT, ZOO_FP32_DECODE = 256, 8
AGG_FRAMES, AGG_FRAMES_REHEARSE = 2048, 384  # the aggregate phase's stream
AGG_CHUNKS, AGG_EPS = 8, 0.1     # contract strata; +-10% at 95%
FLEET_STREAMS, FLEET_STREAMS_REHEARSE = 16, 4   # the fleet phase's cameras
FLEET_FRAMES, FLEET_WINDOW = 128, 64   # per stream: two hopping windows
FLEET_CHURN_AT = 64              # the chunk inside window 2 before the churn
# (B, Sq, Sk, H, KV, hd, causal, sliding_window, dtype): the Pallas kernel
# test's shapes in both types and both maskings, sliding windows with
# GQA 4/2, and ragged lengths that no 64-row tile divides
FLASH_SWEEP = (
    [(B, Sq, Sk, H, KV, hd, causal, None, dt)
     for (B, Sq, Sk, H, KV, hd) in [(1, 128, 128, 4, 4, 32),
                                    (2, 256, 256, 8, 2, 64),
                                    (1, 512, 512, 4, 1, 128)]
     for dt in ("float32", "bfloat16") for causal in (True, False)]
    + [(1, 256, 256, 4, 2, 32, True, sw, "float32") for sw in (32, 128)]
    + [(2, 300, 300, 4, 2, 32, True, None, "float32"),
       (2, 300, 300, 4, 2, 32, False, None, "bfloat16"),
       (1, 300, 300, 4, 4, 64, True, 100, "float32"),
       (1, 77, 300, 4, 4, 128, False, None, "float32")])


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def gpu_line():
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=25, warmup=3):
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, expect=None, calls=25, tries=5):
    """Device time per call of ``fn`` from torch.profiler, over ``calls``
    calls after a warm-up.  The profiler may miss launches of a window
    (a few, or on the card at times all of them), so each kernel is read
    by its mean over its recorded launches, times its launches per call:
    its count over that of the call's own kernel (``expect``, a piece of
    its name; for a library call, its least launched kernel); a window
    with no launch of ``expect`` is profiled again, up to ``tries``
    windows in all.  Where none records one, the time is read with CUDA
    events instead, over ``calls`` back-to-back calls (``b2b_ms``), and
    the window count is 0.  Returns the time and the number of windows
    it took."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    for window in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0
                and e.self_device_time_total > 0]
        n = [e.count for e in kern if expect is None or expect in e.key]
        if n:
            return sum(e.self_device_time_total / e.count
                       * round(e.count / min(n)) for e in kern) / 1e3, window
    print(f"torch.profiler recorded no device time for "
          f"{expect or 'a library call'} in {tries} windows: CUDA events "
          f"over {calls} back-to-back calls instead", file=sys.stderr)
    return b2b_ms(torch, fn, calls), 0


def b2b_ms(torch, fn, calls=50):
    """CUDA events around ``calls`` back-to-back calls, over ``calls``."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def kernel_times(torch, fn, expect=None):
    """The three readings of one kernel or library call (see phase 3),
    the profiler windows the first took, and what timed it
    (``device_timing``: ``profiler``, or ``cuda_events`` where no window
    recorded a launch)."""
    ms, windows = device_ms(torch, fn, expect)
    return {"ms": ms, "call_ms": time_ms(torch, fn),
            "b2b_ms": b2b_ms(torch, fn), "profiler_windows": windows,
            "device_timing": "profiler" if windows else "cuda_events"}


def library_entry(t):
    """``kernel_times`` of a library call, under the kernel line's keys."""
    return {"library_ms": t["ms"], "library_call_ms": t["call_ms"],
            "library_b2b_ms": t["b2b_ms"],
            "library_profiler_windows": t.get("profiler_windows"),
            "library_device_timing": t.get("device_timing")}


def ptxas_lines(libs):
    """Registers and spills of every kernel, from the ``-Xptxas -v`` report
    ``build.build_all`` keeps beside each library (``<lib>.log``)."""
    prop = re.compile(r"Function properties for (\S+)\s+\d+ bytes stack "
                      r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads\s+ptxas info\s*: Used (\d+) registers")
    lines = []
    for name, path in sorted(libs.items()):
        with open(path + ".log") as f:
            log = f.read()
        parts = []
        for mangled, st, ld, regs in prop.findall(log):
            m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
            fn, rest = mangled, ""
            if m:
                fn = mangled[m.end():m.end() + int(m.group(1))]
                rest = mangled[m.end() + int(m.group(1)):]
            args = [{"f": "float", "13__nv_bfloat16": "bf16",
                     "6__half": "half"}[a]
                    for a in re.findall(r"^I(f|13__nv_bfloat16|6__half)",
                                        rest)]
            args += re.findall(r"Li(\d+)E", rest.split("Ev")[0])
            args += [{"0": "false", "1": "true"}[b]
                     for b in re.findall(r"Lb([01])E", rest.split("Ev")[0])]
            tag = f"{fn}<{', '.join(args)}>" if args else fn
            parts.append(f"{tag} {regs} regs, spill {st}/{ld} B")
        lines.append(f"nvcc -Xptxas -v, {name}.cu: " + "; ".join(parts))
    return lines


def bound_ms(n_bytes, n_ops, flops=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(torch, dev):
    """Peak device memory since the last ``reset_peak`` (None on the CPU)."""
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def gib(n_bytes):
    return "not measured (CPU)" if n_bytes is None \
        else f"{n_bytes / 2**30:.3f} GiB"


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def configure(rehearse):
    from repro_torch.data.synthetic import DETRAC_LIKE
    from repro_torch.models.config import BranchSpec
    from repro_torch.train.filter_train import default_trunk
    g = 17 if rehearse else 56          # 289 tokens reach the flash path
    scene = dataclasses.replace(DETRAC_LIKE, grid=g)
    if rehearse:
        trunk = default_trunk(d_model=32, n_layers=2, grid=g)
        spec = BranchSpec(kind="ic", grid=g, n_classes=3, head_dim=16,
                          layer=2)
    else:
        trunk = default_trunk(d_model=128, n_layers=4, grid=g)
        spec = BranchSpec(kind="ic", grid=g, n_classes=3, head_dim=256,
                          layer=4)
    return scene, trunk, spec


def queries(g):
    """The monitor's population: busy frames, any car, a car left of a
    bus (guarded by the car count), and a rare-class region query; after
    the first window a rare-class ordering query registers and the
    car/bus one retires (at detrac density a car is in nearly every
    frame, so only rare-class guards let the count tier decide rows)."""
    from repro_torch.core import query as Q
    g2 = g // 2
    initial = {
        "busy": Q.Count(Q.Op.GE, 3),
        "car": Q.ClassCount(0, Q.Op.GE, 1),
        "car-left-of-bus": Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                                  Q.Spatial(0, Q.Rel.LEFT, 1, radius=1))),
        "truck-top-left": Q.And((Q.ClassCount(2, Q.Op.GE, 1),
                                 Q.Region(2, (0, 0, g2, g2), 1))),
    }
    late = ("truck-left-of-car",
            Q.And((Q.ClassCount(2, Q.Op.GE, 1),
                   Q.Spatial(2, Q.Rel.LEFT, 0))))
    return initial, late, "car-left-of-bus"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def training_phase(torch, dev, scene, trunk, spec, rehearse):
    """``train_filter`` on the naive trunk, then the paper's count
    accuracy on held-out frames.  Returns the trained filter and the
    report lines."""
    from repro_torch.data.synthetic import VideoStream, collect
    from repro_torch.train.filter_train import evaluate_filter, train_filter
    steps = 12 if rehearse else TRAIN_STEPS
    n_frames = 64 if rehearse else TRAIN_FRAMES
    t0 = time.perf_counter()
    collect(VideoStream(scene), n_frames)        # what train_filter collects
    collect_s = time.perf_counter() - t0
    reset_peak(torch, dev)
    t0 = time.perf_counter()
    tf = train_filter(scene, spec, trunk_cfg=trunk, steps=steps,
                      batch=TRAIN_BATCH, n_frames=n_frames, seed=SEED,
                      device=dev)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    peak = peak_bytes(torch, dev)
    losses = tf.losses
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"training losses are not {steps} finite numbers: {losses}")
    ev = evaluate_filter(tf, scene, n_frames=16 if rehearse else EVAL_FRAMES,
                         device=dev)
    check(all(math.isfinite(ev[f"cf_acc_{t}"]) for t in (0, 1)),
          "evaluate_filter gave no count accuracy")
    warm = max(steps // 6, 1)        # train_filter's count-only steps
    return tf, [
        f"training: {steps} Adam steps at batch {TRAIN_BATCH} on "
        f"{n_frames} frames (g = {scene.grid}, naive trunk), loss "
        f"{losses[0]:.6f} (first) -> {losses[warm]:.6f} (step {warm}, the "
        f"grid term joins) -> {losses[-1]:.6f} (last), "
        f"{(wall - collect_s) / steps * 1e3:.2f} ms/step (train_filter "
        f"{wall:.3f} s less {collect_s:.3f} s collecting frames), peak "
        f"device memory {gib(peak)}",
        f"held-out ({EVAL_FRAMES if not rehearse else 16} frames, dynamics "
        f"seed 99): cf_acc_0 {ev['cf_acc_0']:.4f}, cf_acc_1 "
        f"{ev['cf_acc_1']:.4f}, cf_acc_2 {ev['cf_acc_2']:.4f}"]


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def run_stream(torch, dev, data, scene, filter_fn_for, record, cost_model,
               registry=None):
    """One pass of the stream through the port's executors (the adaptive
    cascades priced by ``cost_model``; the executors charge the
    registry's budget ledger).  Returns the window results, the (name ->
    qid) map and the engines built."""
    from repro_torch.core import cascade as CS
    from repro_torch.core.streaming import (HoppingWindow,
                                            MultiQueryStreamExecutor,
                                            QueryRegistry)
    initial, late, retire = queries(scene.grid)
    registry = registry if registry is not None else QueryRegistry()
    names = {name: registry.register(q) for name, q in initial.items()}
    engines = []
    plan_s = [0.0]

    def factory(queries, slot_stats, leaf_table, step_cache, budget_ledger,
                device):
        mqc = CS.MultiQueryCascade(queries, adaptive=True,
                                   slot_stats=slot_stats,
                                   leaf_table=leaf_table,
                                   step_cache=step_cache,
                                   cost_model=cost_model)
        staged_masks = mqc.masks

        def masks(out, presumed_decided=None):
            sync(torch, dev)
            t0 = time.perf_counter()
            m = staged_masks(out, presumed_decided)
            sync(torch, dev)
            plan_s[0] += time.perf_counter() - t0
            record.append((queries, out, m))
            return m

        mqc.masks = masks
        ex = CS.MultiQueryExecutor(
            mqc, filter_fn_for, lambda idx, sel: [data["objects"][idx[j]]
                                                  for j in sel],
            scene.n_classes, scene.grid, oracle_bucket=16,
            budget_ledger=budget_ledger, device=device)
        engines.append(ex)
        return lambda idx: ex.run_batch(idx).answers

    executor = MultiQueryStreamExecutor(
        registry, factory, HoppingWindow(size=WINDOW, advance=WINDOW),
        BATCH, device=dev)

    def on_window(res):
        if res.span[0] == 0:
            names[late[0]] = registry.register(late[1])
            registry.retire(names[retire])

    t0 = time.perf_counter()
    results = executor.run(N_FRAMES, on_window)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    return results, names, engines, wall, plan_s[0], executor.rebuilds


def exact_hits(data, scene, results, names):
    """Per window and query: frames whose exact answer is True."""
    from repro_torch.core import query as Q
    initial, late, _ = queries(scene.grid)
    by_qid = {qid: (initial.get(n) or late[1]) for n, qid in names.items()}
    out = []
    for r in results:
        lo, hi = r.span
        out.append({qid: sum(Q.eval_objects(by_qid[qid], data["objects"][f],
                                            scene.n_classes, scene.grid)
                             for f in range(lo, hi))
                    for qid in r.hits})
    return out


def main_path(torch, dev, scene, serve, data):
    """Both passes of the stream, the learned one through ``serve`` (the
    trained filter on the pallas trunk, CAM head kernel); returns what
    the checks and the report need.  Launch counts and the peak memory
    cover exactly these two passes."""
    from repro_torch.core import costmodel as CM
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.kernels import ops
    embeds = torch.as_tensor(data["embeds"], device=dev)
    gt_counts = torch.as_tensor(data["counts"].astype("float32"), device=dev)
    gt_grid = torch.as_tensor(data["occupancy"], device=dev).float()

    def learned(idx):
        return serve.apply(embeds[torch.as_tensor(idx, device=dev)],
                           use_kernel=True, device=dev)

    def ground_truth(idx):
        i = torch.as_tensor(idx, device=dev)
        return FilterOutputs(counts=gt_counts[i], grid=gt_grid[i])

    record = {"learned": [], "ground_truth": []}
    runs = {}
    # priced by the static model: a calibration file that an earlier run
    # left in results/calibration/ must not change the main path's plan
    static = CM.static_cost_model()
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    for name, fn in (("learned", learned), ("ground_truth", ground_truth)):
        runs[name] = run_stream(torch, dev, data, scene, fn, record[name],
                                cost_model=static)
    launches = ops.launch_counts()
    return runs, record, launches, peak_bytes(torch, dev)


def check_main_path(torch, data, scene, runs, record):
    from repro_torch.core.plan import QueryPlan
    lines = []
    for name, (results, names, engines, wall, plan_s, rebuilds) in \
            runs.items():
        expected = exact_hits(data, scene, results, names)
        for r, want in zip(results, expected):
            for qid, n in r.hits.items():
                if name == "ground_truth":
                    check(n == want[qid], f"{name}: window {r.span} query "
                          f"{qid}: {n} hits, exact answer {want[qid]}")
                else:
                    check(n <= want[qid], f"{name}: window {r.span} query "
                          f"{qid}: {n} hits exceed the exact {want[qid]}")
        check(rebuilds == 2, f"{name}: {rebuilds} engine rebuilds, want 2")
        bodies = [b for e in engines
                  for b in (e.cascade.staging_report.bodies
                            if e.cascade.staging_report else [])]
        oracle = sum(e.stats.oracle_calls for e in engines)
        filt = sum(e.stats.filter_time_s for e in engines) - plan_s
        orac = sum(e.stats.oracle_time_s for e in engines)
        lines.append(f"{name}: {N_FRAMES / wall:.1f} frames/s, wall "
                     f"{wall * 1e3:.1f} ms = filter {filt * 1e3:.1f} ms + "
                     f"plan {plan_s * 1e3:.1f} ms + oracle {orac * 1e3:.1f}"
                     f" ms + rest, oracle calls {oracle}, hits "
                     f"{[r.hits for r in results]}, last bodies {bodies}")
    n_masks = 0
    for name, recs in record.items():
        for qs, out, staged in recs:
            want = QueryPlan(qs).evaluate(out)
            check(torch.equal(staged, want),
                  f"{name}: staged masks differ from the exhaustive plan")
            n_masks += 1
    lines.append(f"staged == exhaustive on {n_masks} batches, bit for bit")
    return lines


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(torch, dev, trunk, spec, params, data):
    """The main path's kernel inputs for the first batch: the first trunk
    layer's q, k, v (B, H, S, hd), the CAM head's features, the
    ground-truth (B, g, g, 3) grid with the two classes the first
    window's spatial stage reads (the planner passes both to the stats
    kernel), and a padded 16-row list of int64 ids on the card."""
    from repro_torch.core import cam as CAM
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    e = torch.as_tensor(data["embeds"][:BATCH], device=dev)
    x = torch.einsum("bpd,de->bpe", e, params["proj"])
    x = x + params["pos"][: x.shape[1]][None]
    layer0 = {name: {k: t[0] for k, t in sub.items()}
              for name, sub in params["trunk"]["layers"].items()}
    h = L.apply_norm(layer0["ln1"], x, trunk.norm_eps)
    qkv = [torch.einsum("bsd,dhk->bhsk", h, layer0["attn"][w]).contiguous()
           for w in ("wq", "wk", "wv")]
    tap = M.forward(params["trunk"], trunk, embeds=x, tap_layer=spec.layer,
                    stop_at_tap=True, causal=False).tap
    feat = CAM.spatialize(tap.float(), spec.grid)
    feat = torch.relu(torch.einsum("bijd,de->bije", feat,
                                   params["branch"]["proj"]))
    B, g, _, D = feat.shape
    feat = feat.reshape(B, g * g, D).contiguous()
    full = torch.as_tensor(data["occupancy"][:BATCH], device=dev).float()
    classes = torch.tensor([0, 1], device=dev)
    gen = torch.Generator().manual_seed(SEED)
    rows = torch.randint(0, BATCH, (16,), generator=gen)
    rows[-4:] = rows[-5]                         # bucket-style padding
    return qkv, feat, (full, classes), rows.to(dev)


def stats_entry(torch, SP, full, classes, rows):
    """Row 1 (``rows`` None) or 2 of the kernel line, at the planner's
    call: ``classes=`` on the full grid (and, for row 2, the plan's int64
    row ids on the card), bit for bit against its plain version, with its
    bytes bound counting every plane it reads.  Beside it, two "before"
    readings: the kernel on the grid sliced beforehand, and the
    composition the planner ran before (gather the planes,
    ``.contiguous()``, then the kernel), timed with the call in the order
    old, new, new, old and averaged."""
    sliced = full[..., classes].contiguous()
    B, g, _, C = full.shape
    Cp = classes.numel()
    if rows is None:
        def new():
            return SP.spatial_stats_bgc(full, classes=classes)

        def plain():
            return SP.spatial_stats_plain(full, classes=classes)

        def on_sliced():
            return SP.spatial_stats_bgc(sliced)

        def compose():
            return SP.spatial_stats_bgc(full[..., classes].contiguous())
        name, line, R, frames = "spatial_stats_bgc", 44, B, B
    else:
        def new():
            return SP.spatial_stats_rows_bgc(full, rows, classes=classes)

        def plain():
            return SP.spatial_stats_rows_plain(full, rows, classes=classes)

        def on_sliced():
            return SP.spatial_stats_rows_bgc(sliced, rows)

        def compose():
            return SP.spatial_stats_rows_bgc(
                full[..., classes].contiguous(), rows)
        name, line = "spatial_stats_rows_bgc", 66
        R, frames = rows.numel(), int(torch.unique(rows).numel())
    got, want = new(), plain()
    check(torch.equal(got, want), f"{name}(classes=) on the full grid "
          f"differs from plain")
    check(torch.equal(on_sliced(), want), f"{name} on the sliced grid "
          f"differs from plain")
    times = {"new": [], "compose": []}
    for which, fn in (("compose", compose), ("new", new), ("new", new),
                      ("compose", compose)):
        times[which].append(kernel_times(torch, fn, "spatial_stats_kernel"))
    before = kernel_times(torch, on_sliced, "spatial_stats_kernel")
    read = {"ms": "", "call_ms": "call_", "b2b_ms": "b2b_"}
    n_bytes = (frames * g * g * C * full.element_size() + Cp * 8
               + R * Cp * 5 * 4 + (R * 8 if rows is not None else 0))
    bnd, by = bound_ms(n_bytes, frames * g * g * Cp)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spatial_stats.cu",
        "replaces": f"src/repro/kernels/spatial_predicate.py:{line}",
        "max_abs_err": float((got - want).abs().max()),
        **{k: sum(t[k] for t in times["new"]) / 2 for k in read},
        "profiler_windows": times["new"][0]["profiler_windows"],
        "plain_ms": time_ms(torch, plain),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "shape": [B, g, g, C] + ([R] if rows is not None else []),
        "classes": classes.tolist(),
        **({"rows_dtype": str(rows.dtype)} if rows is not None else {}),
        **{f"sliced_{p}ms": before[k] for k, p in read.items()},
        **{f"compose_{p}ms": sum(t[k] for t in times["compose"]) / 2
           for k, p in read.items()}}


def cluster_sweep(torch, SP, dev, full, classes, rows):
    """Device time of the stats kernel with the host's pick of the
    cluster size ("auto") and forced to each size 1..8, each result equal
    to the plain version bit for bit: at the planner's two calls on the
    C = 3 grid, and on (32, 56, 56, 8) grids, the frames of the model
    configurations' g = 56 branches with 8 classes, where the host
    splits a frame."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wide = (torch.rand((full.shape[0], 56, 56, 8), generator=gen,
                       device=dev) < 0.05).float()
    lines = []
    for name, x, r, c in (
            ("(32, 56, 56, 3) classes=[0, 1]", full, None, classes),
            ("16 rows of (32, 56, 56, 3) classes=[0, 1]", full, rows,
             classes),
            ("(32, 56, 56, 8)", wide, None, None),
            ("(32, 56, 56, 8) classes=[0, 1]", wide, None, classes),
            ("16 rows of (32, 56, 56, 8) classes=[0, 1]", wide, rows,
             classes),
            ("(32, 56, 56, 8) bfloat16", wide.bfloat16(), None, None)):
        want = SP.spatial_stats_plain(x, classes=c) if r is None \
            else SP.spatial_stats_rows_plain(x, r, classes=c)
        parts = []
        for S in range(9):
            def fn():
                return SP._launch(x, r, c, 0.2, cluster=S)
            check(torch.equal(fn(), want), f"spatial_stats at cluster size "
                  f"{S or 'auto'} on {name} differs from plain")
            ms, _ = device_ms(torch, fn, "spatial_stats_kernel")
            parts.append(f"{S or 'auto'}: {ms:.5f}")
        lines.append(f"spatial_stats cluster sweep {name}, device ms by "
                     f"cluster size: " + ", ".join(parts))
    return lines


def kernel_phase(torch, dev, feat, params, grids, rows):
    from repro_torch.kernels import cam_head as CH
    from repro_torch.kernels import spatial_predicate as SP
    w = params["branch"]["w"].contiguous()
    b = params["branch"]["b"].contiguous()
    full, classes = grids
    entries = [stats_entry(torch, SP, full, classes, None),
               stats_entry(torch, SP, full, classes, rows)]
    sweep = cluster_sweep(torch, SP, dev, full, classes, rows)

    c_k, m_k = CH.cam_head_bgd(feat, w, b)
    c_p, m_p = CH.cam_head_plain(feat, w, b)
    err = max(float((c_k - c_p).abs().max()), float((m_k - m_p).abs().max()))
    check(torch.allclose(m_k, m_p, rtol=1e-4, atol=1e-4)
          and torch.allclose(c_k, c_p, rtol=1e-4, atol=1e-4),
          f"cam_head_bgd differs from plain (max abs err {err})")
    c_2, m_2 = CH.cam_head_bgd(feat, w, b)
    check(torch.equal(c_2, c_k) and torch.equal(m_2, m_k),
          "cam_head_bgd gave other bits on a repeated call")
    Bf, P, D = feat.shape
    Cw = w.shape[1]
    bnd, by = bound_ms(Bf * P * D * 4 + D * Cw * 4 + Cw * 4 + Bf * Cw * 4
                       + Bf * P * Cw * 4, 2 * Bf * P * D * Cw)
    entries.append({
        "name": "cam_head_bgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cam_head.cu",
        "replaces": "src/repro/kernels/cam_head.py:49",
        "max_abs_err": err, "repeat_bit_identical": True,
        **kernel_times(torch, lambda: CH.cam_head_bgd(feat, w, b),
                       "cam_tile_kernel"),
        "plain_ms": time_ms(torch, lambda: CH.cam_head_plain(feat, w, b)),
        "bound_ms": bnd, "bound_by": by,
        **library_entry(kernel_times(torch, lambda: torch.matmul(feat, w))),
        "shape": [Bf, P, D, Cw]})
    return entries, sweep


def attention64(torch, q, k, v, causal):
    """The plain version's function in float64 (no window)."""
    q, k, v = (t.double() for t in (q, k, v))
    G = q.shape[1] // k.shape[1]
    k, v = (t.repeat_interleave(G, dim=1) for t in (k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(i >= j, s, torch.full((), -0.7 * 3.4028234663852886e38,
                                              dtype=s.dtype, device=s.device))
    return torch.softmax(s, -1) @ v


def flash_phase(torch, qkv):
    """Flash attention at the main path's shape against its plain
    version, timed; the in-run TF32 check; then the sweep of
    ``FLASH_SWEEP`` and the float32 stress sweep."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = qkv
    out = FA.flash_attention_bhsd(q, k, v, causal=False)
    want = FA.flash_attention_plain(q, k, v, causal=False)
    err = float((out - want).abs().max())
    check(err <= 1e-4, f"flash_attention_bhsd differs from plain at the "
          f"main path's shape (max abs err {err}, tol 1e-4)")
    del out, want
    B, H, S, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    n_bytes = (2 * B * H * S + 2 * B * KV * Sk) * hd * 4
    flops = 4 * B * H * S * Sk * hd
    # the float32 kernel runs three TF32 tensor-core products per product
    bnd, by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    entry = {
        "name": "flash_attention_bhsd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
        "max_abs_err": err,
        **kernel_times(torch, lambda: FA.flash_attention_bhsd(
            q, k, v, causal=False), "flash_attention_kernel"),
        "plain_ms": time_ms(torch, lambda: FA.flash_attention_plain(
            q, k, v, causal=False)),
        "bound_ms": bnd, "bound_by": by,
        "bound_note": f"3 x {flops / 1e9:.1f} GFLOP of TF32 at 495 TFLOP/s "
                      f"(3xTF32); in SIMT fp32 at 67 TFLOP/s "
                      f"{bound_ms(n_bytes, flops)[0]:.4f} ms",
        **library_entry(kernel_times(torch, lambda: sdpa(q, k, v))),
        "shape": [B, S, H, hd]}
    lines = [tf32_check(torch, FA, q.shape)]

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, Sq, Sk, H, KV, hd, causal, sw, dt) in enumerate(FLASH_SWEEP):
        gen = torch.Generator(device=q.device).manual_seed(i)
        dtype = getattr(torch, dt)
        a, b, c = (torch.randn(shape, generator=gen, device=q.device
                               ).to(dtype)
                   for shape in ((B, H, Sq, hd), (B, KV, Sk, hd),
                                 (B, KV, Sk, hd)))
        o = FA.flash_attention_bhsd(a, b, c, causal=causal,
                                    sliding_window=sw)
        w = FA.flash_attention_plain(a, b, c, causal=causal,
                                     sliding_window=sw)
        e = float((o.float() - w.float()).abs().max())
        tol = 1e-4 if dt == "float32" else 2e-2
        check(o.dtype == dtype and e <= tol,
              f"flash sweep {(B, Sq, Sk, H, KV, hd, causal, sw, dt)}: max "
              f"abs err {e} (tol {tol}), dtype {o.dtype}")
        worst[dt] = max(worst[dt], e)
    lines.append(f"flash sweep: {len(FLASH_SWEEP)} cases (hd 32/64/128, "
                 f"causal and not, windows 32/128/100, GQA, ragged S 300 "
                 f"and Sq 77 x Sk 300) within tolerance: max abs err "
                 f"{worst['float32']:.3g} float32 (tol 1e-4), "
                 f"{worst['bfloat16']:.3g} bfloat16 (tol 2e-2)")
    lines.append(flash_stress(torch, FA, q.device))
    return entry, lines


def tf32_check(torch, FA, shape):
    """The 1e-4 the float32 kernel is held to must catch a kernel with one
    TF32 pass: the plain version with ``allow_tf32`` on, at the main
    shape with q and k scaled by 3 (seeded normal inputs), must miss the
    float32 plain version by more than 1e-4; the kernel must not."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    q, k = q * 3, k * 3
    want = FA.flash_attention_plain(q, k, v, causal=False)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        one = FA.flash_attention_plain(q, k, v, causal=False)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    e_one = float((one - want).abs().max())
    del one
    e_kernel = float((FA.flash_attention_bhsd(q, k, v, causal=False)
                      - want).abs().max())
    check(e_one > 1e-4, f"a one-pass TF32 plain version is within 1e-4 "
          f"({e_one}): the float32 tolerance would not catch TF32")
    check(e_kernel <= 1e-4, f"flash_attention_bhsd at the main shape with "
          f"q, k x3: max abs err {e_kernel} (tol 1e-4)")
    return (f"TF32 check at {list(shape)}, q and k x3: the plain version "
            f"with one TF32 pass misses float32 by {e_one:.3g} (> 1e-4), "
            f"the 3xTF32 kernel by {e_kernel:.3g} (tol 1e-4)")


# (hd, causal, kind) of tests/test_torch_cuda.py's FLASH_STRESS
FLASH_STRESS = [(hd, causal, kind) for hd in (32, 128)
                for causal in (False, True)
                for kind in ("qk x3", "qk x8", "v spread")]


def flash_stress(torch, FA, dev):
    """The float32 kernel on inputs that stress its 3xTF32 split, at
    (B, H, KV, S) = (1, 4, 2, 1000): max abs err 1e-4 against float64;
    against the plain version too, except at x8, where the plain
    version's own error against float64 is reported beside it."""
    worst = {"k64": 0.0, "kplain": 0.0, "plain64_x8": 0.0, "k64_x8": 0.0}
    for hd, causal, kind in FLASH_STRESS:
        rng = np.random.default_rng(hd + causal)    # the card test's inputs
        q, k, v = (torch.as_tensor(rng.normal(0, 1, (1, n, 1000, hd)).astype(
            np.float32), device=dev) for n in (4, 2, 2))
        if kind.startswith("qk"):
            f = float(kind[-1])
            q, k = q * f, k * f
        else:
            v = v * torch.as_tensor(10.0 ** np.random.default_rng(7).uniform(
                -3, 1, v.shape).astype(np.float32), device=dev)
        out = FA.flash_attention_bhsd(q, k, v, causal=causal)
        w64 = attention64(torch, q, k, v, causal)
        want = FA.flash_attention_plain(q, k, v, causal=causal)
        e64 = float((out.double() - w64).abs().max())
        ep = float((out - want).abs().max())
        check(e64 <= 1e-4 and (kind == "qk x8" or ep <= 1e-4),
              f"flash stress {(hd, causal, kind)}: max abs err {e64} "
              f"against float64, {ep} against plain (tol 1e-4)")
        if kind == "qk x8":
            worst["k64_x8"] = max(worst["k64_x8"], e64)
            worst["plain64_x8"] = max(
                worst["plain64_x8"],
                float((want.double() - w64).abs().max()))
        else:
            worst["k64"] = max(worst["k64"], e64)
            worst["kplain"] = max(worst["kplain"], ep)
    return (f"flash float32 stress: {len(FLASH_STRESS)} cases (hd 32/128, "
            f"causal and not, q and k x3 / x8, v over 1e-3..10): max abs "
            f"err {worst['k64']:.3g} against float64 and "
            f"{worst['kplain']:.3g} against plain at x3 and v spread; at "
            f"x8 {worst['k64_x8']:.3g} against float64, where the float32 "
            f"plain version itself is {worst['plain64_x8']:.3g} off "
            f"(tol 1e-4)")


def trunk_compare(torch, dev, tf, serve, data):
    """One batch through the naive trunk and the pallas trunk on the same
    trained weights: host-clock time around synchronised work (median of
    3 after a warm-up), peak memory, and agreement."""
    e = torch.as_tensor(data["embeds"][:BATCH], device=dev)
    outs, lines = {}, []
    for name, f in (("naive", tf), ("pallas", serve)):
        reset_peak(torch, dev)
        outs[name] = f.apply(e, use_kernel=True, device=dev)
        sync(torch, dev)
        peak = peak_bytes(torch, dev)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            f.apply(e, use_kernel=True, device=dev)
            sync(torch, dev)
            times.append(time.perf_counter() - t0)
        lines.append(f"filter forward of one batch ({BATCH} frames) "
                     f"through the {name} trunk: "
                     f"{sorted(times)[1] * 1e3:.3f} ms, peak device memory "
                     f"{gib(peak)}")
    a, b = outs["naive"], outs["pallas"]
    err = max(float((a.counts - b.counts).abs().max()),
              float((a.grid - b.grid).abs().max()))
    check(torch.allclose(b.counts, a.counts, rtol=1e-4, atol=1e-3)
          and torch.allclose(b.grid, a.grid, rtol=1e-4, atol=1e-3),
          f"pallas trunk differs from naive trunk (max abs err {err})")
    lines.append(f"pallas trunk vs naive trunk FilterOutputs: max abs err "
                 f"{err:.3g} (tol rtol 1e-4, atol 1e-3)")
    return lines


def plain_head_check(torch, dev, trunk, spec, params, data):
    """The kernel filter path against the plain-head filter path."""
    from repro_torch.train.filter_train import filter_forward
    e = data["embeds"][:BATCH]
    k = filter_forward(params, trunk, spec, e, use_kernel=True, device=dev)
    p = filter_forward(params, trunk, spec, e, use_kernel=False, device=dev)
    err = max(float((k.counts - p.counts).abs().max()),
              float((k.grid - p.grid).abs().max()))
    check(torch.allclose(k.counts, p.counts, rtol=1e-4, atol=1e-4)
          and torch.allclose(k.grid, p.grid, rtol=1e-4, atol=1e-4),
          f"kernel head differs from plain head (max abs err {err})")
    check(bool(torch.isfinite(k.grid).all()) and k.grid.shape ==
          (BATCH, spec.grid, spec.grid, spec.n_classes),
          "filter outputs are not finite or have the wrong shape")
    return f"kernel head vs plain head: max abs err {err:.3g} (tol 1e-4)"



# ---------------------------------------------------------------------------
# the aggregate half: contracts, the float64 accumulator, the cost model
# ---------------------------------------------------------------------------

def _contract_fields(res):
    """Every ContractResult field that is not a measured microsecond."""
    return (res.estimate, tuple(res.ci), res.mean, res.n_sampled,
            res.oracle_calls, res.satisfied, res.terminated, res.rounds,
            tuple(res.confirmations), tuple(res.allocation.tolist()),
            tuple(res.decision_calls.tolist()), res.cv_chunks,
            res.variance_reduction)


def _ledger_text(led):
    return (f"ledger: oracle {led.oracle_calls} frames "
            f"{led.oracle_us / 1e3:.3f} ms, filter {led.filter_frames} "
            f"frames {led.filter_us / 1e3:.3f} ms")


def aggregate_inputs(torch, dev, scene, serve, n_frames):
    """The detrac-like stream at the smoke's width, its embeddings on the
    card, and the three taps the aggregate half reads: the learned filter
    (the trained weights through the pallas trunk and the CAM head, in
    batches of ``BATCH`` frames), the ground-truth filter outputs, and
    the oracle (the ground-truth object lists)."""
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.data.synthetic import VideoStream, collect
    t0 = time.perf_counter()
    data = collect(VideoStream(scene, dynamics_seed=SEED), n_frames)
    collect_s = time.perf_counter() - t0
    embeds = torch.as_tensor(data["embeds"], device=dev)
    gt_counts = torch.as_tensor(data["counts"].astype("float32"), device=dev)
    gt_grid = torch.as_tensor(data["occupancy"], device=dev).float()

    def learned(idx):
        i = torch.as_tensor(np.asarray(idx), device=dev)
        parts = [serve.apply(embeds[i[k:k + BATCH]], use_kernel=True,
                             device=dev) for k in range(0, len(i), BATCH)]
        return FilterOutputs(counts=torch.cat([p.counts for p in parts]),
                             grid=torch.cat([p.grid for p in parts]))

    def ground_truth(idx):
        i = torch.as_tensor(np.asarray(idx), device=dev)
        return FilterOutputs(counts=gt_counts[i], grid=gt_grid[i])

    def oracle(idx):
        return [data["objects"][int(i)] for i in idx]

    return data, collect_s, {"learned": learned,
                             "ground_truth": ground_truth}, oracle


def aggregate_queries(scene):
    """A count with a spatial predicate (car-left-of-bus, from the
    monitor's population) and the number of cars over those frames."""
    from repro_torch.core.contracts import AggregateQuery
    initial, _, _ = queries(scene.grid)
    pred = initial["car-left-of-bus"]
    return {"count car-left-of-bus": AggregateQuery(pred=pred, agg="count",
                                                    eps=AGG_EPS),
            "sum cars | car-left-of-bus": AggregateQuery(
                pred=pred, agg="sum", cls=0, eps=AGG_EPS)}


def run_session(dev, registry, q, filter_fn, oracle, scene, n, **knobs):
    from repro_torch.core.streaming import AggregateStreamSession
    t0 = time.perf_counter()
    with AggregateStreamSession(registry, q, filter_fn=filter_fn,
                                oracle_fn=oracle, n_frames=n,
                                n_classes=scene.n_classes, grid=scene.grid,
                                n_chunks=AGG_CHUNKS, seed=SEED, device=dev,
                                **knobs) as sess:
        res = sess.run()
    return res, sess.executor, time.perf_counter() - t0


def census_check(dev, scene, oracle, n, truth, gpu):
    """Check 1: a count contract with ``max_oracle = n`` and ``eps =
    1e-9`` is a census: the exact count, a zero-width interval, every
    frame oracled and charged once.  ``cv="off"``: exact control
    variates could collapse the interval before the census ends."""
    from repro_torch.core import costmodel as CM
    from repro_torch.core.contracts import AggregateQuery
    from repro_torch.core.streaming import QueryRegistry
    initial, _, _ = queries(scene.grid)
    seen = []

    def counted(idx):
        seen.extend(int(i) for i in idx)
        return oracle(idx)

    q = AggregateQuery(pred=initial["car-left-of-bus"], agg="count",
                       eps=1e-9)
    reg = QueryRegistry()
    res, _, wall = run_session(dev, reg, q, None, counted, scene, n,
                               max_oracle=n, cv="off",
                               cost_model=CM.static_cost_model())
    check(res.terminated in ("contract", "census") and res.satisfied,
          f"census ended {res.terminated}, satisfied {res.satisfied}")
    check(abs(res.estimate - truth) <= 1e-9 * max(truth, 1.0),
          f"census estimate {res.estimate} is not the exact {truth}")
    check(res.half_width == 0.0, f"census interval {res.ci} has width")
    check(res.oracle_calls == n == reg.budget_ledger.oracle_calls
          == len(seen) == len(set(seen)),
          f"census oracle calls {res.oracle_calls}, ledger "
          f"{reg.budget_ledger.oracle_calls}, frames seen {len(seen)} "
          f"({len(set(seen))} distinct), want {n} each")
    return (f"aggregate census: count car-left-of-bus = {res.estimate:.1f} "
            f"(exact {truth}), CI {res.ci}, {res.oracle_calls} oracle "
            f"calls of {n} frames, each charged once, terminated by "
            f"{res.terminated}, wall {wall:.3f} s [{gpu}]")


def contract_checks(dev, scene, filters, oracle, n, truths, gpu,
                    cost_model):
    """Check 2: the error-bounded contracts through
    ``AggregateStreamSession`` with Thompson allocation, on the learned
    and the ground-truth filter, each with its own registry and ledger:
    the truth inside 3 half-widths and the pooled CV variance at most the
    naive one under ``cv="auto"``; under ``cv="eager"`` the variance
    check and a second run with the same seed equal in every field that
    is not a measured microsecond (chunks priced by an explicit uniform
    vector).  The repeat is held under ``cv="eager"`` because
    ``cv="auto"`` decides each chunk's sweep on the realized wall-clock
    prices of the filter and the oracle, as the JAX package does, so a
    decision near its threshold can go either way between two runs.  The
    eager runs' coverage is reported, not held: where a chunk's sampled
    residuals are all equal, the JAX package's estimator (which the port
    copies) gives that chunk zero variance, and on the ground-truth count
    the interval collapses around a biased estimate.  The uniform
    ``cv="off"`` baseline's oracle calls are reported beside them."""
    from repro_torch.core.streaming import QueryRegistry
    lines, kept = [], {}
    prices = np.ones(AGG_CHUNKS)
    for fname, ffn in filters.items():
        for qname, q in aggregate_queries(scene).items():
            truth = truths[qname]
            slack = 1e-9 * max(abs(truth), 1.0)
            runs = {}
            for cv in ("auto", "eager", "eager-repeat"):
                runs[cv] = run_session(
                    dev, QueryRegistry(), q, ffn, oracle, scene, n,
                    cv=cv.split("-")[0], cost_model=cost_model,
                    chunk_oracle_cost=prices)
            res = runs["auto"][0]
            check(abs(res.estimate - truth) <= 3 * res.half_width + slack,
                  f"{fname} {qname} cv=auto: estimate {res.estimate} is "
                  f"more than 3 half-widths ({res.half_width}) from {truth}")
            for cv in ("auto", "eager"):
                res, ex, _ = runs[cv]
                pooled = ex.pooled_accumulator().estimate()
                check(pooled.var <= pooled.naive_var * (1 + 1e-9)
                      and res.variance_reduction >= 1.0,
                      f"{fname} {qname} cv={cv}: pooled CV variance "
                      f"{pooled.var} exceeds the naive {pooled.naive_var}")
            eager, repeat = runs["eager"][0], runs["eager-repeat"][0]
            check(_contract_fields(eager) == _contract_fields(repeat),
                  f"{fname} {qname}: a second cv=eager run with seed "
                  f"{SEED} differs: {_contract_fields(eager)} vs "
                  f"{_contract_fields(repeat)}")
            base, _, base_wall = run_session(
                dev, QueryRegistry(), q, ffn, oracle, scene, n,
                allocation="uniform", cv="off", cost_model=cost_model)
            kept[(fname, qname)] = runs["eager"][:2]
            for cv in ("auto", "eager"):
                res, _, wall = runs[cv]
                covered = abs(res.estimate - truth) \
                    <= 3 * res.half_width + slack
                lines.append(
                    f"aggregate {fname} filter, {qname} (eps {AGG_EPS}, "
                    f"thompson, cv={cv}): estimate {res.estimate:.3f}, CI "
                    f"[{res.ci[0]:.3f}, {res.ci[1]:.3f}], exact "
                    f"{truth:.1f}, {res.oracle_calls} novel oracle calls "
                    f"in {res.rounds} rounds (uniform cv=off baseline "
                    f"{base.oracle_calls}, estimate {base.estimate:.3f}, "
                    f"{base_wall:.3f} s), cv chunks "
                    f"{res.cv_chunks}/{AGG_CHUNKS}, variance reduction "
                    f"{res.variance_reduction:.4g}, terminated by "
                    f"{res.terminated}, pricing {res.pricing}, wall "
                    f"{wall:.3f} s [{gpu}]; {_ledger_text(res.ledger)}"
                    + (f"; truth within 3 half-widths: {covered}"
                       f"; a repeat run identical (wall "
                       f"{runs['eager-repeat'][2]:.3f} s)"
                       if cv == "eager" else ""))
    return lines, kept


def accumulator_check(torch, dev, ex):
    """Check 3: the per-chunk float64 accumulators on the card, merged,
    equal ``pooled_accumulator()``, the stream-axis
    ``distributed_reduce`` and numpy ``mcv_estimate`` on the same
    samples, each within 1e-9 relative."""
    import functools
    from repro_torch.core import aggregates as AGG
    accs = ex.chunk_accumulators()
    check(all(a.M2.device.type == dev.type and a.M2.dtype == torch.float64
              for a in accs), "chunk accumulators are not float64 on the "
          "device")
    merged = functools.reduce(AGG.CVAccumulator.merge, accs)
    ys = np.concatenate([np.concatenate(c) for c in ex._y if c])
    zs = np.concatenate([np.concatenate(c, 0) for c in ex._z if c], 0)
    want = AGG.mcv_estimate(ys, zs)
    worst = 0.0
    for name, acc in (("merged", merged), ("pooled", ex.pooled_accumulator()),
                      ("distributed_reduce", AGG.distributed_reduce(accs))):
        got = acc.estimate()
        check(got.n == want.n, f"{name}: n {got.n}, numpy {want.n}")
        for field in ("mean", "var", "naive_var"):
            a, b = getattr(got, field), getattr(want, field)
            err = abs(a - b) / max(abs(b), 1e-300)
            worst = max(worst, err)
            check(err <= 1e-9, f"{name} {field} {a} vs numpy {b}: "
                  f"relative error {err:.3g} > 1e-9")
    return (f"aggregate accumulators: {len(accs)} per-chunk float64 "
            f"CVAccumulators on {dev.type} over {want.n} estimation "
            f"samples (d = {zs.shape[1]}); merged, pooled_accumulator(), "
            f"distributed_reduce and numpy mcv_estimate agree within "
            f"{worst:.3g} relative (tol 1e-9)")


def cost_model_checks(torch, dev, scene, data, learned_run, learned,
                      oracle, n, gpu):
    """Check 4: ``calibrate`` at the planner's shape (batch 32, g, C = 3),
    saved under results/calibration/ and loaded back, with the oracle
    folded in; the filter stream's learned pass again under that model
    (staged masks equal the exhaustive plan bit for bit, answers equal
    the static-model run's), and a contract priced by it reports
    ``measured``.  Check 5: that stream and an aggregate session on one
    registry charge one budget ledger."""
    from repro_torch.core import costmodel as CM
    from repro_torch.core.contracts import make_value_fn
    from repro_torch.core.plan import QueryPlan
    from repro_torch.core.streaming import QueryRegistry
    lines = []
    path = CM.calibration_path(device=dev)
    t0 = time.perf_counter()
    model = CM.calibrate(batch=BATCH, grid=scene.grid,
                         classes=scene.n_classes, device=dev, path=path)
    cal_s = time.perf_counter() - t0
    loaded = CM.load_calibration(path, device=dev)
    check(loaded is not None and loaded.coeffs == model.coeffs,
          f"the calibration saved to {path} does not load back")
    q = aggregate_queries(scene)["count car-left-of-bus"]
    value_fn = make_value_fn(q, oracle, scene.n_classes, scene.grid)
    measured = CM.calibrate_oracle(loaded, value_fn,
                                   lambda r: np.arange(r),
                                   rows_points=(1, 8, 32, 128), device=dev,
                                   save=True, path=path)
    check(CM.load_calibration(path, device=dev).coeffs == measured.coeffs,
          "the calibration with the oracle does not load back")
    coeffs = {k: (round(c.overhead, 3), round(c.per_row, 4))
              for k, c in measured.coeffs.items()}
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    lines.append(f"calibration ({measured.backend}, {path}, "
                 f"{cal_s:.2f} s; {clock}): "
                 f"(overhead us, per-row us) {coeffs}, step overhead "
                 f"{measured.step_overhead():.2f} us, derived min_bucket "
                 f"{measured.derived_min_bucket()}, spatial crossover rows "
                 f"{measured.spatial_crossover_rows()} [{gpu}]")

    reg = QueryRegistry()
    record = []
    run = run_stream(torch, dev, data, scene, learned, record,
                     cost_model=measured, registry=reg)
    results, names, engines, wall, plan_s, _ = run
    for qs, out, staged in record:
        check(torch.equal(staged, QueryPlan(qs).evaluate(out)),
              "measured model: staged masks differ from the exhaustive plan")
    check([r.hits for r in results] == [r.hits for r in learned_run[0]],
          f"measured model: answers {[r.hits for r in results]} differ "
          f"from the static model's {[r.hits for r in learned_run[0]]}")
    monitor = engines[-1].cascade.calibration_monitor
    modes = [(e.cascade.mode, e.cascade.restages) for e in engines]
    lines.append(f"learned pass under the measured model: "
                 f"{N_FRAMES / wall:.1f} frames/s (plan {plan_s * 1e3:.1f} "
                 f"ms; each engine's final mode and restages {modes}), "
                 f"staged == exhaustive on {len(record)} batches, answers "
                 f"equal the static model's, drift monitor "
                 f"{monitor.describe()} [{gpu}]")

    stream_oracle = sum(e.stats.oracle_calls for e in engines)
    stream_frames = sum(e.stats.frames_in for e in engines)
    led = reg.budget_ledger
    check(led.oracle_calls == stream_oracle
          and led.filter_frames == stream_frames == N_FRAMES,
          f"the stream charged {led.oracle_calls} oracle / "
          f"{led.filter_frames} filter frames, its engines counted "
          f"{stream_oracle} / {stream_frames}")
    res, _, swall = run_session(dev, reg, q, learned, oracle, scene, n,
                                cv="auto", cost_model=measured)
    check(res.pricing["oracle_price_source"] == "measured",
          f"a contract priced by the measured model reports "
          f"{res.pricing['oracle_price_source']}")
    check(res.ledger is led and led.oracle_calls == stream_oracle
          + res.oracle_calls and led.filter_frames > stream_frames,
          f"the session did not charge the stream's ledger: {led}")
    lines.append(f"one ledger: the stream ({stream_frames} filter, "
                 f"{stream_oracle} oracle frames) and a measured-priced "
                 f"session ({res.oracle_calls} oracle calls, estimate "
                 f"{res.estimate:.3f}, pricing {res.pricing}, wall "
                 f"{swall:.3f} s [{gpu}]) on one registry: "
                 f"{_ledger_text(led)}")
    return lines


def aggregate_phase(torch, dev, scene, serve, data, learned_run, gpu,
                    rehearse):
    """The aggregate half on the card, its five checks.  Launch counts are
    reset just before and read just after: the learned filter must have
    run the trunk's flash attention and the CAM head, and the verdict tap
    and the calibration the two stats kernels."""
    from repro_torch.core.contracts import make_value_fn
    from repro_torch.kernels import ops
    n = AGG_FRAMES_REHEARSE if rehearse else AGG_FRAMES
    agg_data, collect_s, filters, oracle = aggregate_inputs(
        torch, dev, scene, serve, n)
    # the stream is deterministic: its first N_FRAMES frames are the main
    # path's, so the filter stream can be served again from these
    check(all(np.array_equal(agg_data[k][:N_FRAMES], data[k])
              for k in ("embeds", "counts", "occupancy")),
          "the aggregate stream does not begin with the main path's frames")
    lines = [f"aggregate phase: {n} frames of the detrac-like stream at "
             f"g = {scene.grid} (collected in {collect_s:.2f} s; "
             f"{n * scene.grid ** 2 * scene.d_embed * 4 / 2**30:.3f} GiB "
             f"of float32 embeddings on {dev.type}), {AGG_CHUNKS} chunks"]
    truths = {name: float(make_value_fn(q, oracle, scene.n_classes,
                                        scene.grid)(np.arange(n)).sum())
              for name, q in aggregate_queries(scene).items()}
    ops.reset_launch_counts()
    lines.append(census_check(dev, scene, oracle, n,
                              truths["count car-left-of-bus"], gpu))
    from repro_torch.core import costmodel as CM
    more, kept = contract_checks(dev, scene, filters, oracle, n, truths, gpu,
                                 CM.static_cost_model())
    lines += more
    lines.append(accumulator_check(
        torch, dev, kept[("learned", "sum cars | car-left-of-bus")][1]))
    lines += cost_model_checks(torch, dev, scene, agg_data, learned_run,
                               filters["learned"], oracle, n, gpu)
    launches = ops.launch_counts()
    lines.append(f"aggregate phase launches: {launches}")
    if not rehearse:
        for name in ("flash_attention_bhsd", "cam_head_bgd",
                     "spatial_stats_bgc", "spatial_stats_rows_bgc"):
            check(launches[name] > 0,
                  f"{name} was not launched in the aggregate phase")
    return lines


# ---------------------------------------------------------------------------
# fleet serving: 16 streams through one group plan and the temporal tier
# ---------------------------------------------------------------------------

def fleet_queries(g):
    """The fleet's population: the JAX package's fleet temporal mix (two
    Durations, a SlidingCount and a Sequence: the reference fleet
    benchmark's four, benchmarks/multi_query_sharing.py) and two
    frame-level queries from the monitor's population (busy frames; a
    car left of a bus, radius 0 so that the ground-truth grid answers it
    exactly), then the churn inside window 2: a rare-class guarded
    ordering query registers (at least two trucks, one left of a car: the
    guard lets the count tier decide rows, so the spatial tier runs
    compacted) and car-left-of-bus retires.

    When each registers follows from what the short circuit can show.
    A chunk is skipped only when every query of every stream is
    window-decided before it, so never while a frame-level query is
    registered (it is never window-decided), never in a window's first
    chunk, and never in the first chunk of an engine rebuilt by churn.
    The first window therefore runs the three operators that every
    detrac-like stream decides within one batch (a car in four
    consecutive frames; a crowd of six trucks that no 28-frame run
    holds; an object within eight frames), and its second chunk is
    skipped; the Sequence (car then bus), which a stream without a bus
    in its first 32 frames leaves open, joins the frame-level pair at
    the first window boundary."""
    from repro_torch.core import query as Q
    c0 = Q.ClassCount(0, Q.Op.GE, 1)
    c1 = Q.ClassCount(1, Q.Op.GE, 1)
    early = {
        "car-run-4": Q.Duration(c0, 4),
        "truck-crowd-60": Q.Duration(Q.ClassCount(2, Q.Op.GE, 6), 60),
        "busy-8": Q.SlidingCount(Q.Count(Q.Op.GE, 1), 8, Q.Op.GE, 1),
    }
    boundary = {
        "car-then-bus-6": Q.Sequence(c0, c1, 6),
        "busy": Q.Count(Q.Op.GE, 3),
        "car-left-of-bus": Q.And((c0, Q.Spatial(0, Q.Rel.LEFT, 1))),
    }
    late = ("trucks-left-of-car",
            Q.And((Q.ClassCount(2, Q.Op.GE, 2), Q.Spatial(2, Q.Rel.LEFT, 0))))
    return early, boundary, late, "car-left-of-bus"


def fleet_final_queries(g):
    """The population after the churn, in registration order."""
    early, boundary, late, retire = fleet_queries(g)
    return tuple(list(early.values())
                 + [q for n, q in boundary.items() if n != retire]
                 + [late[1]])


class FleetSchedule:
    """One registry and its schedule: the early temporal queries from the
    start, the rest of the population at the first window boundary
    (``on_window``), and — with ``churn`` — one register and one retire
    inside window 2, after the chunk at ``FLEET_CHURN_AT``.  The fleet
    and each serial stream get a schedule of their own."""

    def __init__(self, g, churn):
        from repro_torch.core.streaming import QueryRegistry
        self.early, self.boundary, self.late, self.retire = fleet_queries(g)
        self.with_churn = churn
        self.registry = QueryRegistry()
        self.qids, self.by_qid = {}, {}
        for name, q in self.early.items():
            self._register(name, q)
        self.churned = False

    def _register(self, name, q):
        self.qids[name] = self.registry.register(q)
        self.by_qid[self.qids[name]] = q

    def on_window(self, res):
        if res.span[0] == 0:
            with self.registry.batch():
                for name, q in self.boundary.items():
                    self._register(name, q)

    def churns_after(self, lo):
        return self.with_churn and lo == FLEET_CHURN_AT

    def churn(self):
        if not self.churned:
            self.churned = True
            with self.registry.batch():
                self._register(*self.late)
                self.registry.retire(self.qids[self.retire])

    def active_qids(self):
        return tuple(qid for qid, _ in self.registry.active())


class ChunkLog:
    """Wraps an engine (a fleet group engine, or a serial per-batch
    callable): records every chunk's answers with the engine and its
    query ids, and fires the schedule's churn (a fleet engine then
    stages nothing ahead: the next chunk is served by a rebuilt
    engine)."""

    def __init__(self, engine, sched, log):
        self.engine, self.sched, self.log = engine, sched, log
        self.qids = sched.active_qids()

    def on_window_start(self, lo, hi):
        self.engine.on_window_start(lo, hi)

    def _done(self, lo, ans):
        self.log.append((self, lo, np.asarray(ans)))
        if self.sched.churns_after(lo):
            self.sched.churn()
        return ans

    def run_chunk(self, idx, nxt=None):
        lo = int(idx[0])
        return self._done(lo, self.engine.run_chunk(
            idx, None if self.sched.churns_after(lo) else nxt))

    def __call__(self, idx):
        return self._done(int(idx[0]), self.engine(idx))


class MasksAsAnswers:
    """One stream alone on the port's single-stream path, with the
    fleet's semantics: its filter, the single-stream staged plan over
    the program's deduped frame signals (window-decided signals
    presumed), and the program's scan step on the card fed the masks,
    which stay there, with suppressed columns zeroed."""

    def __init__(self, torch, queries, fetch, cost_model, dev):
        from repro_torch.core.plan import QueryPlan
        from repro_torch.core.stats import SlotStats
        from repro_torch.core.temporal import TemporalProgram
        self.torch = torch
        self.prog = TemporalProgram(queries, backend="scan", device=dev)
        self.staged = QueryPlan(self.prog.frame_queries).build_staged(
            SlotStats(), cost_model=cost_model)
        self.fetch = fetch

    def on_window_start(self, lo, hi):
        self.prog.start_window(hi - lo)

    def __call__(self, idx):
        torch, dev = self.torch, self.prog.device
        B, M = len(idx), self.prog.n_signals
        if self.prog.all_decided:
            return self.prog.advance(
                torch.zeros((B, M), dtype=torch.bool, device=dev))
        sup = self.prog.suppressed_signals()
        m = self.staged.evaluate(self.fetch(idx), presumed_decided=sup
                                 if sup.any() else None)
        return self.prog.advance(
            m & torch.as_tensor(~sup, device=dev)[None, :])


def fleet_ids(n_streams):
    return [f"cam{i}" for i in range(n_streams)]


def fleet_inputs(torch, dev, scene, serve, ids, data=None):
    """The detrac-like streams ``ids`` (cam0..), each its own
    ``VideoStream`` with a dynamics seed from ``stream_seed`` (collected
    here unless ``data`` holds them), their embeddings on the card, and
    per-stream fetches: the
    learned filter (one trunk + CAM-head call per stream and chunk; the
    outputs of the first call per chunk are kept, and a later call for
    the same chunk must give the same bits), the learned filter for the
    timed serial runs (no check inside: its outputs are kept in
    ``served`` and held against the fleet's after the timing) and the
    ground truth."""
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.core.streaming import stream_seed
    from repro_torch.data.synthetic import VideoStream, collect
    t0 = time.perf_counter()
    if data is None:
        data = {sid: collect(VideoStream(scene, dynamics_seed=stream_seed(
            SEED, sid)), FLEET_FRAMES) for sid in ids}
    collect_s = time.perf_counter() - t0
    embeds = {sid: torch.as_tensor(d["embeds"], device=dev)
              for sid, d in data.items()}
    gt = {sid: (torch.as_tensor(d["counts"].astype("float32"), device=dev),
                torch.as_tensor(d["occupancy"], device=dev).float())
          for sid, d in data.items()}
    kept, served = {}, {}

    def learned_serial(sid, idx):
        i = torch.as_tensor(np.asarray(idx), device=dev)
        out = serve.apply(embeds[sid][i], use_kernel=True, device=dev)
        served[(sid, int(idx[0]), len(idx))] = out
        return out

    def learned(sid, idx):
        i = torch.as_tensor(np.asarray(idx), device=dev)
        out = serve.apply(embeds[sid][i], use_kernel=True, device=dev)
        key = (sid, int(idx[0]), len(idx))
        if key in kept:
            check(torch.equal(out.counts, kept[key].counts)
                  and torch.equal(out.grid, kept[key].grid),
                  f"{sid}: a second filter call on frames {key[1:]} gave "
                  f"other bits")
        else:
            kept[key] = out
        return out

    def ground_truth(sid, idx):
        i = torch.as_tensor(np.asarray(idx), device=dev)
        c, g = gt[sid]
        return FilterOutputs(counts=c[i], grid=g[i])

    n_bytes = sum(e.numel() * e.element_size() for e in embeds.values())
    return ids, data, {"learned": learned, "learned_serial": learned_serial,
                       "ground_truth": ground_truth}, \
        (kept, served), collect_s, n_bytes


def fleet_run(dev, scene, ids, fetch, cost_model, churn, **engine_kw):
    """The fleet: ``MultiStreamExecutor`` over the group engine (the
    group plan and ``advance_group``; ``engine_kw`` such as ``mesh``
    forwarded to ``plan_group_engine_factory``), timed whole.  Returns
    the chunk log, the engines built, the window results and the wall
    time."""
    from repro_torch.core.streaming import HoppingWindow
    from repro_torch.distributed.multistream import (MultiStreamExecutor,
                                                     plan_group_engine_factory)
    sched = FleetSchedule(scene.grid, churn)
    log, engines = [], []
    inner = plan_group_engine_factory(lambda ctx, idx: fetch(ctx.stream_id,
                                                             idx),
                                      cost_model=cost_model, **engine_kw)

    def factory(queries, streams, slot_stats, leaf_table, step_cache,
                device):
        eng = inner(queries, streams, slot_stats=slot_stats,
                    leaf_table=leaf_table, step_cache=step_cache,
                    device=device)
        engines.append(eng)
        return ChunkLog(eng, sched, log)

    ex = MultiStreamExecutor(sched.registry, factory,
                             HoppingWindow(size=FLEET_WINDOW,
                                           advance=FLEET_WINDOW),
                             BATCH, ids, device=dev)
    t0 = time.perf_counter()
    results = ex.run(FLEET_FRAMES, sched.on_window)
    wall = time.perf_counter() - t0
    check(sched.churned == churn and ex.rebuilds == 2 + churn,
          f"fleet: churn {sched.churned}, {ex.rebuilds} engine rebuilds, "
          f"want {2 + churn}")
    return sched, log, engines, ex, results, wall


def serial_run(dev, scene, sid, make_engine, churn):
    """One stream alone through ``MultiQueryStreamExecutor`` under the
    same schedule; ``make_engine(queries)`` builds its per-batch engine."""
    from repro_torch.core.streaming import (HoppingWindow,
                                            MultiQueryStreamExecutor)
    sched = FleetSchedule(scene.grid, churn)
    log = []
    ex = MultiQueryStreamExecutor(
        sched.registry,
        lambda queries: ChunkLog(make_engine(queries), sched, log),
        HoppingWindow(size=FLEET_WINDOW, advance=FLEET_WINDOW), BATCH,
        device=dev)
    results = ex.run(FLEET_FRAMES, sched.on_window)
    return sched, log, results


def per_frame(log, pos=None):
    """{(chunk start, qid): (B,) answers} of a chunk log (a fleet log's
    stream at stack position ``pos``)."""
    out = {}
    for rec, lo, ans in log:
        a = ans if pos is None else ans[pos]
        for k, qid in enumerate(rec.qids):
            out[(lo, qid)] = a[:, k]
    return out


def fleet_answers(log, results, pos):
    """{stream id: ({"lo/qid": answers}, window hits)} of a fleet pass, in
    plain types (phase 22's ranks write them as JSON)."""
    return {sid: [{f"{lo}/{qid}": a.astype(int).tolist()
                   for (lo, qid), a in per_frame(log, p).items()},
                  [{str(q): int(n) for q, n in r.hits[sid].items()}
                   for r in results]]
            for sid, p in pos.items()}


def replay_check(log, pos, sched, objects, scene, what):
    """Every (window, engine) segment's per-frame answers against
    ``replay_reference`` over ``eval_objects`` verdicts from the
    segment's first frame (an engine rebuilt mid-window restarts its
    automata there)."""
    from repro_torch.core import query as Q
    from repro_torch.core.temporal import replay_reference
    verdicts = {}

    def fv_at(base):
        def fv(pred, t):
            v = verdicts.get(pred)
            if v is None:
                v = verdicts[pred] = np.array(
                    [Q.eval_objects(pred, o, scene.n_classes, scene.grid)
                     for o in objects])
            return bool(v[base + t])
        return fv

    segments = {}
    for rec, lo, ans in log:
        key = (lo // FLEET_WINDOW, id(rec))
        segments.setdefault(key, (rec, []))[1].append(
            (lo, ans if pos is None else ans[pos]))
    n = 0
    for rec, parts in segments.values():
        base = parts[0][0]
        check([lo for lo, _ in parts] == list(range(
            base, base + BATCH * len(parts), BATCH)),
              f"{what}: the chunks from frame {base} are not contiguous")
        got = np.concatenate([a for _, a in parts])
        for k, qid in enumerate(rec.qids):
            want = replay_reference(sched.by_qid[qid], fv_at(base),
                                    got.shape[0])
            check(np.array_equal(got[:, k], want),
                  f"{what}: query {qid} from frame {base} differs from "
                  f"replay_reference")
            n += 1
    return n


def fleet_chunk_profile(torch, dev, scene, ids, fetches, cost_model, gpu):
    """One chunk of the final population (frames 96..127 of window 2, its
    first chunk at 64 run to warm the steps) on a fresh group engine, for
    each source of filter outputs: the plan's and the temporal step's
    host-clock ms (each between two synchronisations), then
    torch.profiler over the same chunk replayed on a fresh engine
    (device busy, idle share, launches); and over one ``advance_group``
    call alone (the temporal step's launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.streaming import QueryRegistry
    from repro_torch.core.temporal import TemporalProgram, advance_group
    from repro_torch.distributed import multistream as MS
    queries = fleet_final_queries(scene.grid)
    ctxs = MS.route_streams(ids, 1)
    reg = QueryRegistry()
    lines = []

    def engine(fetch):
        eng = MS.ShardedPlanGroupEngine(
            queries, ctxs, lambda ctx, idx: fetch(ctx.stream_id, idx),
            slot_stats=reg.slot_stats, cost_model=cost_model,
            leaf_table=reg.leaf_table, step_cache=reg.step_cache, device=dev)
        eng.on_window_start(64, 128)
        eng.run_chunk(np.arange(64, 96))
        return eng

    for name, fetch in fetches.items():
        timings = {"plan": [], "temporal": []}

        def timed(what, fn, timings=timings):
            def wrapped(*a, **kw):
                sync(torch, dev)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync(torch, dev)
                timings[what].append((time.perf_counter() - t0) * 1e3)
                return out
            return wrapped

        eng = engine(fetch)
        eng.staged.evaluate_group = timed("plan", eng.staged.evaluate_group)
        inner_adv = MS.advance_group
        MS.advance_group = timed("temporal", inner_adv)
        try:
            sync(torch, dev)
            t0 = time.perf_counter()
            eng.run_chunk(np.arange(96, 128))
            sync(torch, dev)
            chunk_ms = (time.perf_counter() - t0) * 1e3
        finally:
            MS.advance_group = inner_adv
        rep = eng.staged.last_report
        lines.append(
            f"fleet chunk, {name} (frames 96..127, {len(ids)} streams x "
            f"{BATCH} frames, {len(queries)} queries, host clock): "
            f"{chunk_ms:.3f} ms = plan (evaluate_group) "
            f"{timings['plan'][0]:.3f} ms + temporal step (advance_group) "
            f"{timings['temporal'][0]:.3f} ms + filter fetch and rest; "
            f"plan bodies {rep.bodies}, rows {rep.rows_evaluated} [{gpu}]")
        if dev.type == "cuda":
            eng = engine(fetch)
            lines.append(profile_line(
                torch, f"one fleet chunk, {name} (run_chunk, frames "
                f"96..127)", lambda: eng.run_chunk(np.arange(96, 128))))
    if dev.type != "cuda":
        return lines + ["fleet chunk profile: not measured (CPU)"]
    progs = [TemporalProgram(queries, device=dev) for _ in ids]
    for p in progs:
        p.start_window(BATCH)
    sig = torch.rand((len(ids), BATCH, progs[0].n_signals), device=dev) < 0.5
    advance_group(progs, sig)                    # build the step
    for p in progs:
        p.start_window(BATCH)
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance_group(progs, sig)
        sync(torch, dev)
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    lines.append(f"temporal step alone (advance_group, S = {len(ids)}, B = "
                 f"{BATCH}, {progs[0].n_automata} automata over "
                 f"{progs[0].n_signals} signals; torch.profiler): wall "
                 f"{wall:.3f} ms, device busy {busy:.3f} ms, "
                 f"{sum(e.count for e in kern)} kernel launches [{gpu}]")
    return lines


def fleet_phase(torch, dev, scene, serve, gpu, rehearse):
    """The fleet path at full width, its seven checks.  Launch counts are
    reset just before the two fleet passes and read just after."""
    from repro_torch.core import costmodel as CM
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.core.plan import QueryPlan
    from repro_torch.core.temporal import TemporalEngine, TemporalProgram
    from repro_torch.kernels import ops
    S = FLEET_STREAMS_REHEARSE if rehearse else FLEET_STREAMS
    static = CM.static_cost_model()
    ids, data, fetches, (kept, served), collect_s, n_bytes = fleet_inputs(
        torch, dev, scene, serve, fleet_ids(S))
    lines = [f"fleet phase: {S} streams x {FLEET_FRAMES} frames of the "
             f"detrac-like scene at g = {scene.grid} (windows of "
             f"{FLEET_WINDOW}, batch {BATCH}; collected in {collect_s:.2f} "
             f"s; {n_bytes / 2**30:.3f} GiB of float32 embeddings on "
             f"{dev.type}) [{gpu}]"]
    sync(torch, dev)
    resident = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    # the churn runs on the learned pass (check 2 holds it against the
    # serial runs); the ground-truth pass keeps one engine through window
    # 2, whose second chunk shows the per-stream signal suppression
    fleet = {name: fleet_run(dev, scene, ids, fetches[name], static,
                             churn=name == "learned")
             for name in ("ground_truth", "learned")}
    sync(torch, dev)
    launches = ops.launch_counts()
    peak = peak_bytes(torch, dev)
    pos = {c.stream_id: c.position
           for c in fleet["learned"][3].streams}

    # check 1: ground truth, every stream against the replay oracle, and
    # the serial TemporalEngine (with the exact oracle) against it too
    sched, log, engines, _, _, gt_wall = fleet["ground_truth"]
    n_replay = 0
    t0 = time.perf_counter()
    for sid in ids:
        objects = data[sid]["objects"]
        n_replay += replay_check(log, pos[sid], sched, objects, scene,
                                 f"fleet ground truth {sid}")

        def make(queries, sid=sid, objects=objects):
            return TemporalEngine(
                queries, lambda idx: fetches["ground_truth"](sid, idx),
                lambda idx, sel: [objects[int(idx[j])] for j in sel],
                scene.n_classes, scene.grid, oracle_bucket=16, device=dev,
                adaptive=True, cost_model=static)
        s_sched, s_log, _ = serial_run(dev, scene, sid, make, churn=False)
        n_replay += replay_check(s_log, None, s_sched, objects, scene,
                                 f"serial TemporalEngine {sid}")
    gt_serial_wall = time.perf_counter() - t0
    lines.append(f"fleet check 1 (ground truth): every stream's per-frame "
                 f"answers equal replay_reference over eval_objects "
                 f"verdicts, and so do {S} serial MultiQueryStreamExecutor"
                 f" + TemporalEngine runs (exact oracle): {n_replay} "
                 f"(segment, query) series")

    # check 2: learned, every stream against its serial run.  The S
    # serial runs (the port's single-stream path: the staged plan and the
    # scan step on the card) are timed first with no check inside, as the
    # fleet pass was, and checked after
    sched, log, engines_l, ex_l, results, wall = fleet["learned"]
    sync(torch, dev)
    t0 = time.perf_counter()
    serial = {sid: serial_run(
        dev, scene, sid, lambda queries, sid=sid: MasksAsAnswers(
            torch, queries,
            lambda idx: fetches["learned_serial"](sid, idx), static, dev),
        churn=True) for sid in ids}
    sync(torch, dev)
    serial_wall = time.perf_counter() - t0
    # a chunk that a serial run skips may still be fetched by the fleet,
    # whose skip waits for every stream
    check(served.keys() <= kept.keys() and all(
        torch.equal(served[k].counts, kept[k].counts)
        and torch.equal(served[k].grid, kept[k].grid) for k in served),
          "fleet learned: the serial runs' filter outputs differ from the "
          "fleet's")
    serial_hits = {}
    for sid, (s_sched, s_log, s_res) in serial.items():
        want, got = per_frame(s_log), per_frame(log, pos[sid])
        check(want.keys() == got.keys() and all(
            np.array_equal(got[k], want[k]) for k in want),
              f"fleet learned {sid}: answers differ from the serial run")
        check([r.hits[sid] for r in results] == [r.hits for r in s_res],
              f"fleet learned {sid}: window hits differ from the serial "
              f"run")
        serial_hits[sid] = [r.hits for r in s_res]
    served.clear()
    n_frames = S * FLEET_FRAMES
    lines.append(f"fleet check 2 (learned filter): every stream's "
                 f"per-frame answers equal its serial run (the stream "
                 f"alone, the single-stream staged plan, the scan step on "
                 f"{dev.type}) under the same churn, and so do the filter "
                 f"outputs; hits of {ids[0]} {serial_hits[ids[0]]}")
    lines.append(f"fleet frames/s, learned filter: group + temporal "
                 f"{n_frames / wall:.1f} ({wall:.3f} s, chunk latency p50 "
                 f"{ex_l.latency_percentile(50) * 1e3:.2f} ms p95 "
                 f"{ex_l.latency_percentile(95) * 1e3:.2f} ms), serial "
                 f"({S} loops of the single-stream path, no check inside) "
                 f"{n_frames / serial_wall:.1f} "
                 f"({serial_wall:.3f} s); ground truth: group + temporal "
                 f"{n_frames / gt_wall:.1f}, serial TemporalEngine with "
                 f"the oracle + replay checks "
                 f"{n_frames / gt_serial_wall:.1f} [{gpu}]")

    # check 3: evaluate_group at each body == evaluate on each stream
    # alone, on every chunk of the final population's frame signals
    # (the chunks where no stream has more than half its rows undecided
    # after the count tier run the spatial tier compacted)
    final = fleet_final_queries(scene.grid)
    plan = QueryPlan(TemporalProgram(final, backend="numpy").frame_queries)
    ops.reset_launch_counts()
    bodies = {}
    for name in ("ground_truth", "learned"):
        for lo in range(0, FLEET_FRAMES, BATCH):
            idx = np.arange(lo, lo + BATCH)
            outs = [kept.get((sid, lo, BATCH)) if name == "learned"
                    else None for sid in ids]
            outs = [o if o is not None else fetches[name](sid, idx)
                    for sid, o in zip(ids, outs)]
            stacked = FilterOutputs(
                counts=torch.stack([o.counts for o in outs]),
                grid=torch.stack([o.grid for o in outs]))
            for body in ("auto", "rows", "full"):
                staged = plan.build_staged(None, cost_model=static,
                                           spatial_body=body)
                got = staged.evaluate_group(stacked)
                for s, o in enumerate(outs):
                    want = plan.build_staged(
                        None, cost_model=static,
                        spatial_body=body).evaluate(o)
                    check(torch.equal(got[s], want),
                          f"evaluate_group ({name}, frames {lo}.., "
                          f"{body}) stream {s} differs from evaluate "
                          f"alone")
                rep = staged.last_report
                if len(rep.bodies) > 1 and rep.bodies[1] != "batch":
                    bodies[(name, lo, body)] = (rep.bodies[1],
                                                rep.rows_evaluated[1])
    check3 = ops.launch_counts()
    lines.append(f"fleet check 3: evaluate_group over all {S} streams "
                 f"equals evaluate on each alone, on every chunk and at "
                 f"every spatial body; compacted spatial stages (source, "
                 f"chunk, body asked): (body, rows) {bodies}; launches "
                 f"{check3} [{gpu}]")

    # check 4: the scan backend against the numpy one, stream 0
    n_batches = 0
    for w0 in range(0, FLEET_FRAMES, FLEET_WINDOW):
        qs = final if w0 else tuple(fleet_queries(scene.grid)[0].values())
        progs = (TemporalProgram(qs, backend="scan", device=dev),
                 TemporalProgram(qs, backend="numpy"))
        fq = QueryPlan(progs[0].frame_queries)
        for p in progs:
            p.start_window(FLEET_WINDOW)
        for b0 in range(w0, w0 + FLEET_WINDOW, BATCH):
            m = fq.evaluate(fetches["learned"](
                ids[0], np.arange(b0, b0 + BATCH))).cpu().numpy()
            outs = [p.advance(m & ~p.suppressed_signals()[None, :])
                    for p in progs]
            check(np.array_equal(*outs) and np.array_equal(
                progs[0].query_decided, progs[1].query_decided),
                  f"scan backend differs from numpy at frame {b0}")
            n_batches += 1
    lines.append(f"fleet check 4: the torch scan backend on {dev.type} "
                 f"equals the numpy backend on stream {ids[0]}'s "
                 f"{n_batches} batches, outputs and decidedness")

    # check 5: the window-outcome short circuit fired
    stats = [e.temporal_stats for name in fleet for e in fleet[name][2]]
    skipped = sum(t.frames_skipped for t in stats)
    evals = sum(t.signal_evals_skipped for t in stats)
    check(skipped > 0 and evals > 0, f"fleet: {skipped} frames and "
          f"{evals} signal evaluations skipped, want both > 0")
    per_pass = {name: (sum(e.temporal_stats.frames_skipped
                           for e in fleet[name][2]),
                       sum(e.temporal_stats.frames_in
                           for e in fleet[name][2]),
                       sum(e.temporal_stats.signal_evals_skipped
                           for e in fleet[name][2])) for name in fleet}
    lines.append(f"fleet check 5: (frames skipped, frames in, signal evals "
                 f"skipped) per pass {per_pass} [{gpu}]")

    # checks 6 and 7: kernels launched in the passes, serving memory
    lines.append(f"fleet phase launches (both passes): {launches} [{gpu}]")
    if not rehearse:
        for name in ("flash_attention_bhsd", "cam_head_bgd",
                     "spatial_stats_bgc"):
            check(launches[name] > 0,
                  f"{name} was not launched in the fleet passes")
        check(launches["spatial_stats_rows_bgc"]
              + check3["spatial_stats_rows_bgc"] > 0,
              "spatial_stats_rows_bgc was not launched in the fleet phase")
        added = peak - resident
        check(added < SERVING_PEAK_LIMIT,
              f"fleet serving peak {gib(added)} above the resident "
              f"streams is not under {gib(SERVING_PEAK_LIMIT)}")
        lines.append(f"fleet serving peak device memory (both passes): "
                     f"{gib(peak)}, of which {gib(resident)} resident "
                     f"before the passes (the streams' embeddings and the "
                     f"filter) and {gib(added)} added by serving "
                     f"[{gpu}]")
    lines += fleet_chunk_profile(
        torch, dev, scene, ids,
        {k: fetches[k] for k in ("learned", "ground_truth")}, static, gpu)
    # what phase 22 holds the stream mesh to: the streams' frames, each
    # pass's per-frame answers and window hits, and its frames/s
    ref = {"data": data, "fps": {name: S * FLEET_FRAMES / fleet[name][5]
                                 for name in fleet}}
    for name in fleet:
        ref[name] = fleet_answers(fleet[name][1], fleet[name][4], pos)
    return lines, launches, ref


# ---------------------------------------------------------------------------
# the RWKV-6 serving path (prefill + decode) and its WKV-scan kernel
# ---------------------------------------------------------------------------

def model_config(name, rehearse, **overrides):
    """A zoo model at its published widths (rwkv6-3b: 32 layers, d_model
    2560, 40 heads of 64, d_ff 8960, vocab 65536); its smoke config on the
    CPU."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(name) if rehearse else get_config(name)
    return dataclasses.replace(cfg, **overrides)


def serve_steps(torch, dev, SV, params, cfg, prompts, cache, n_dec,
                frames=None, embeds=None):
    """``prefill`` then ``n_dec`` greedy ``decode_step``s, host clock
    around each synchronised call (a step's argmax included).  Returns
    (prefill s, step s list, the (B, n_dec + 1) tokens, whether every
    logit was finite, the cache)."""
    sync(torch, dev)
    t0 = time.perf_counter()
    logits, cache, _ = SV.prefill(params, cfg, prompts, cache=cache,
                                  frames=frames, embeds=embeds)
    sync(torch, dev)
    t_pre = time.perf_counter() - t0
    toks, finite, steps = [logits.argmax(-1)], \
        bool(torch.isfinite(logits).all()), []
    for _ in range(n_dec):
        t0 = time.perf_counter()
        logits, cache = SV.decode_step(params, cfg, toks[-1][:, None],
                                       cache=cache)
        toks.append(logits.argmax(-1))
        sync(torch, dev)
        steps.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(logits).all())
    return t_pre, steps, torch.stack(toks, 1), finite, cache


def steps_text(steps):
    ms = sorted(x * 1e3 for x in steps)
    return (f"median {ms[len(ms) // 2]:.3f} ms per step (min {ms[0]:.3f}, "
            f"max {ms[-1]:.3f})")


class CallRecorder:
    """Wraps ``ops.<name>`` to keep, on the host, the arguments of its
    first call of each key (``key(*args)``; one key, None, by default):
    ``calls[key]`` the positional ones, ``kwargs[key]`` the keywords.
    Calls go through unchanged; the copies keep their strides."""

    def __init__(self, ops, name, key=lambda *args: None):
        self.ops, self.name, self.key = ops, name, key
        self.inner, self.calls, self.kwargs = getattr(ops, name), {}, {}

    def __enter__(self):
        def rec(*args, **kw):
            k = self.key(*args)
            if k not in self.calls:
                self.calls[k] = tuple(a.cpu() if hasattr(a, "cpu") else a
                                      for a in args)
                self.kwargs[k] = dict(kw)
            return self.inner(*args, **kw)
        setattr(self.ops, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.ops, self.name, self.inner)

    def first(self, dev):
        """The first call's positional arguments on ``dev`` (one key), or
        None where the op was not reached."""
        args = self.calls.get(None)
        return None if args is None else tuple(
            a.to(dev) if hasattr(a, "to") else a for a in args)


def rwkv_serving_phase(torch, dev, rehearse):
    """Four requests through ``prefill`` and ``decode_step`` at full width
    in bf16 through the kernel path (``attn_impl="pallas"``).  Layer 0's
    scan inputs of the first prefill and decode calls are kept from the
    untimed warm-up pass (the same prompts and weights) for the kernel
    phase; counts are reset just before the timed run and read just
    after."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = model_config("rwkv6_3b", rehearse, attn_impl="pallas",
                       dtype="bfloat16")
    n_req, prompt_len, n_dec = (4, 64, 4) if rehearse else \
        (RWKV_REQUESTS, RWKV_PROMPT, RWKV_DECODE)
    gen = torch.Generator(dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, device=dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (n_req, prompt_len)), device=dev)

    def serve():
        return serve_steps(torch, dev, SV, params, cfg, prompts,
                           SV.init_cache(cfg, n_req, prompt_len + n_dec,
                                         device=dev), n_dec)

    with CallRecorder(ops, "rwkv6_scan", key=lambda *a: (
            "decode" if a[0].shape[2] == 1 else "prefill")) as rec:
        serve()                               # warm-up: cuBLAS, the kernel
    lines = []
    if dev.type == "cuda":
        cache = SV.init_cache(cfg, n_req, prompt_len + 1, device=dev)
        _, cache, _ = SV.prefill(params, cfg, prompts, cache=cache)
        lines.append(profile_line(
            torch, "one decode step", lambda: SV.decode_step(
                params, cfg, prompts[:, -1:], cache=cache),
            share_of="rwkv6_scan_kernel"))
        del cache
        lines.append(profile_line(
            torch, "one prefill", lambda: SV.prefill(
                params, cfg, prompts, cache=SV.init_cache(
                    cfg, n_req, prompt_len, device=dev)),
            share_of="rwkv6_scan_kernel"))
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    t_pre, steps, toks, finite, _ = serve()
    launches = ops.launch_counts()
    peak = peak_bytes(torch, dev)
    check(finite, "rwkv serving: a logit is not finite")
    check(toks.shape == (n_req, n_dec + 1) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          f"rwkv serving: generated tokens {toks.shape} outside the vocab")
    want = cfg.n_layers * (1 + n_dec)
    if not rehearse:
        check(launches["rwkv6_scan_bhtk"] == want,
              f"rwkv6_scan_bhtk launched {launches['rwkv6_scan_bhtk']} "
              f"times, want {want} (one per layer and call)")
    del params
    return launches, rec.calls, lines + [
        f"rwkv serving ({cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, random weights "
        f"drawn in {init_s:.3f} s): {n_req} requests x {prompt_len} "
        f"prompt tokens, prefill {t_pre * 1e3:.3f} ms = "
        f"{n_req * prompt_len / t_pre:.1f} tokens/s; {n_dec} decode steps "
        f"of {n_req} tokens, {steps_text(steps)}; peak "
        f"device memory {gib(peak)}; rwkv6_scan_bhtk launches "
        f"{launches['rwkv6_scan_bhtk']} (want {want}); tokens in the "
        f"vocab, logits finite; first request's tokens "
        f"{toks[0].tolist()}"]


def profile_line(torch, what, fn, share_of=None):
    """Device time by kernel over one call of ``fn`` (torch.profiler) and
    the host clock around it; the idle share is 1 - busy / wall (the
    profiler's own host cost counts in the wall).  ``share_of`` names a
    kernel (a piece of its name) whose share of the busy time is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy <= 0:
        return f"profile of {what}: no device time recorded (not measured)"
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    share = ""
    if share_of is not None:
        mine = [e for e in kern if share_of in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3
        share = (f"{share_of} {ms:.3f} ms over "
                 f"{sum(e.count for e in mine)} launches = "
                 f"{ms / busy:.3f} of device busy; ")
    return (f"profile of {what} (torch.profiler): wall {wall:.3f} ms, "
            f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}; "
            f"{sum(e.count for e in kern)} kernel launches; {share}top: " +
            "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} "
                      f"ms x{e.count}" for e in top))


def scan_bound(args):
    """Least time of one WKV scan: bytes (each input read once, each
    output written once) or the recurrence's fp32 operations (per token
    and head: r S and the rank-1 update with its decay, 5 K V, the bonus
    3 K + 2 V)."""
    r, k, v, lw, u, s0 = args
    B, H, T, K = r.shape
    V = v.shape[3]
    elt = r.element_size()
    n_bytes = ((2 * K + V) * elt + K * 4) * B * H * T + u.numel() * 4 \
        + 2 * B * H * K * V * 4 + B * H * T * V * elt
    return bound_ms(n_bytes, B * H * T * (5 * K * V + 3 * K + 2 * V))


def scan_inputs(torch, dev, B, H, T, K, dt, seed):
    """The JAX kernel test's distributions, with a non-zero u and s0."""
    gen = torch.Generator(dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    dtype = getattr(torch, dt)
    lw = torch.clamp(-torch.exp(n(B, H, T, K) * 0.3), -2.0, -1e-6)
    return (n(B, H, T, K).to(dtype), n(B, H, T, K).to(dtype),
            n(B, H, T, K).to(dtype), lw, n(H, K) * 0.1, n(B, H, K, K) * 0.1)


SCAN_TOL = ("out and sT atol 5e-3 (the JAX kernel test's); a bf16 out "
            "also rtol 1e-2: both sides round to bf16, one step apart at "
            "most")


def scan_err(torch, got, want):
    """Max abs error of (out, sT), and whether it is within SCAN_TOL."""
    (o, s), (wo, ws) = got, want
    err = max(float((o.float() - wo.float()).abs().max()),
              float((s - ws).abs().max()))
    rtol = 0.0 if o.dtype == torch.float32 else 1e-2
    ok = torch.allclose(o.float(), wo.float(), rtol=rtol, atol=5e-3) and \
        torch.allclose(s, ws, rtol=0, atol=5e-3)
    return err, ok


def rwkv_kernel_phase(torch, dev, calls, timer, ktimer):
    """The WKV kernel against its plain version at the serving path's
    prefill and decode shapes (layer 0's inputs), timed; then a sweep."""
    from repro_torch.kernels import rwkv6_scan as RK
    # the recorded inputs keep their strides: r, k, v, lw are the time-mix's
    # (B, T, H, K) tensors seen as (B, H, T, K), read in place
    args, dec = (tuple(t.to(dev) for t in calls[key])
                 for key in ("prefill", "decode"))
    err, ok = scan_err(torch, RK.rwkv6_scan_bhtk(*args),
                       RK.rwkv6_scan_plain(*args))
    check(ok, f"rwkv6_scan_bhtk differs from plain at the prefill shape "
          f"(max abs err {err})")
    check(not args[0].is_contiguous() or dev.type == "cpu",
          "rwkv scan: the recorded prefill inputs are not the time-mix's "
          "strided views")
    dense = tuple(t.contiguous() for t in args)
    same = all(torch.equal(x, y) for x, y in zip(RK.rwkv6_scan_bhtk(*args),
                                                  RK.rwkv6_scan_bhtk(*dense)))
    check(same, "rwkv6_scan_bhtk on the strided views differs from the "
          "same inputs made contiguous")
    del dense
    o, sT = RK.rwkv6_scan_bhtk(*args)
    wo, ws = RK.rwkv6_scan_plain(*args)
    state_err = float((sT - ws).abs().max())
    rel = float(((o.float() - wo.float()).abs()
                 / wo.float().abs().clamp_min(1.0)).max())
    del o, sT, wo, ws
    bnd, by = scan_bound(args)
    B, H, T, K = args[0].shape
    entry = {
        "name": "rwkv6_scan_bhtk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:66",
        "max_abs_err": err, "max_abs_err_state": state_err,
        "max_rel_err_out": rel, "tolerance": SCAN_TOL,
        **ktimer(lambda: RK.rwkv6_scan_bhtk(*args), "rwkv6_scan_kernel"),
        "plain_ms": timer(lambda: RK.rwkv6_scan_plain(*args)),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "library_note": "no single PyTorch call computes the recurrence",
        "shape": [B, H, T, K], "dtype": str(args[0].dtype)}
    d_err, ok = scan_err(torch, RK.rwkv6_scan_bhtk(*dec),
                         RK.rwkv6_scan_plain(*dec))
    check(ok, f"rwkv6_scan_bhtk differs from plain at the decode shape "
          f"(max abs err {d_err})")
    d_bnd, d_by = scan_bound(dec)
    d_t = ktimer(lambda: RK.rwkv6_scan_bhtk(*dec), "rwkv6_scan_kernel")
    lines = ["rwkv6_scan_bhtk on the time-mix's strided views equals the "
             "contiguous call bit for bit",
             f"rwkv6_scan_bhtk at the decode shape {list(dec[0].shape)}: "
             f"device {d_t['ms']} ms (call {d_t['call_ms']} ms, "
             f"back-to-back {d_t['b2b_ms']} ms; plain "
             f"{timer(lambda: RK.rwkv6_scan_plain(*dec))} ms, bound "
             f"{d_bnd:.6f} ms by {d_by}), max abs err {d_err:.3g}"]

    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (T, K, dt) in enumerate((T, K, dt) for T in (1, 32, 50, 1024)
                                   for K in (16, 64)
                                   for dt in ("float32", "bfloat16")):
        a = scan_inputs(torch, dev, 2, 3, T, K, dt, i)
        e, ok = scan_err(torch, RK.rwkv6_scan_bhtk(*a),
                         RK.rwkv6_scan_plain(*a))
        check(ok, f"rwkv scan sweep (T {T}, K {K}, {dt}): max abs err {e}")
        worst[dt] = max(worst[dt], e)
        if T == 50:                   # two halves carried through sT
            o1, s1 = RK.rwkv6_scan_bhtk(*(t[:, :, :21].contiguous()
                                          for t in a[:4]), a[4], a[5])
            o2, s2 = RK.rwkv6_scan_bhtk(*(t[:, :, 21:].contiguous()
                                          for t in a[:4]), a[4], s1)
            o, s = RK.rwkv6_scan_bhtk(*a)
            check(torch.equal(torch.cat([o1, o2], 2), o)
                  and torch.allclose(s2, s, rtol=0, atol=1e-5),
                  f"rwkv scan: halves carried through sT differ from the "
                  f"whole sequence (T {T}, K {K}, {dt})")
    lines.append(f"rwkv scan sweep: 16 cases (T 1/32/50/1024, K 16/64, "
                 f"float32/bfloat16, non-zero u and s0; T = 50 also as "
                 f"halves 21 + 29 carried through sT, equal to the whole) "
                 f"within tolerance: max abs err {worst['float32']:.3g} "
                 f"float32, {worst['bfloat16']:.3g} bfloat16 (tol 5e-3, "
                 f"bf16 out also rtol 1e-2)")
    return entry, lines


# ---------------------------------------------------------------------------
# decode attention, through its own entry point
# ---------------------------------------------------------------------------

def decode_phase(torch, dev, timer, ktimer, rehearse):
    """``ops.decode_attention`` (the JAX wrapper's layout) once at
    qwen2-0.5b's decode_32k shape, counts reset just before and read just
    after; then the kernel against its plain version and the library call
    at that shape, and the sweep."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops
    from repro_torch.models.config import shape_cell
    cfg = get_config("qwen2_0p5b")
    cell = shape_cell("decode_32k")
    B, S, H, KV, hd = (cell.global_batch, cell.seq_len, cfg.n_heads,
                       cfg.n_kv_heads, cfg.head_dim)
    G, kv_len = H // KV, DECODE_KV_LEN
    if rehearse:
        B, S, kv_len = 2, 640, 600
    gen = torch.Generator(dev).manual_seed(SEED)
    q = torch.randn((B, H, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    length = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, length)
    sync(torch, dev)
    launches = ops.launch_counts()
    check(rehearse or launches["decode_attention_bkgd"] == 1,
          f"ops.decode_attention launched {launches} kernels")
    qg = q.reshape(B, KV, G, hd)
    kv_, vv_ = k.transpose(1, 2), v.transpose(1, 2)   # views, as ops passes
    # the entry point reads the cache in place: the call adds only its
    # output and the split scratch to the peak, and is timed whole
    reset_peak(torch, dev)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
    again = ops.decode_attention(q, k, v, length)
    sync(torch, dev)
    call_peak = (torch.cuda.max_memory_allocated() - base
                 if dev.type == "cuda" else None)
    check(torch.equal(again, out), "ops.decode_attention is not "
          "bit-identical on a repeated call")
    del again
    plan = "split plan not measured (CPU)"
    if dev.type == "cuda":
        n_sm, per_sm = DA._slots(out.device, hd, 1, G,
                                 DA.build.library("decode_attention"))
        nsplit = DA.split_count(B, KV, S, n_sm, per_sm)
        plan = (f"{nsplit} splits per (b, kv head), {n_sm} SMs x {per_sm} "
                f"resident blocks (occupancy calculator)")
        scratch = (B * KV * G * hd * 2
                   + (B * KV * nsplit * G * (hd + 2) * 4 if nsplit > 1 else 0))
        check(call_peak <= scratch + 4096, f"ops.decode_attention added "
              f"{call_peak} bytes to the peak; its output and split scratch "
              f"are {scratch}: the cache was copied")
    entry_call = ktimer(lambda: ops.decode_attention(q, k, v, length),
                        "decode_attention_mma")
    kt, vt = (t.contiguous() for t in (kv_, vv_))
    check(torch.equal(DA.decode_attention_bkgd(qg, kt, vt, length),
                      out.reshape(B, KV, G, hd)),
          "decode_attention_bkgd on the (B, KV, S, hd) layout differs from "
          "the same cache read in place")
    want = DA.decode_attention_plain(qg, kt, vt, kv_len)
    err = float((out.reshape(B, KV, G, hd).float() - want.float()).abs()
                .max())
    tol = decode_tol(torch, want)
    check(err <= tol, f"decode_attention_bkgd differs from plain at "
          f"decode_32k (max abs err {err}, tol {tol})")
    # the checks must tell a wrong kv_len from the right one: all S rows
    # in bf16, kv_len rounded up to a 64-key tile in float32
    no_len = float((DA.decode_attention_plain(qg, kt, vt, S).float()
                    - want.float()).abs().max())
    del out, want
    q32, k32, v32 = qg.float(), kt.float(), vt.float()
    want32 = DA.decode_attention_plain(q32, k32, v32, kv_len)
    err32 = float((DA.decode_attention_bkgd(q32, k32, v32, length)
                   - want32).abs().max())
    tiled = float((DA.decode_attention_plain(q32, k32, v32,
                                             -(-kv_len // 64) * 64)
                   - want32).abs().max())
    del q32, k32, v32, want32
    check(err32 <= 1e-4, f"decode_attention_bkgd differs from plain at "
          f"decode_32k in float32 (max abs err {err32}, tol 1e-4)")
    check(no_len > tol and tiled > 1e-4,
          f"decode_32k checks too loose: ignoring kv_len moves the output "
          f"by {no_len} (bf16 tol {tol}), a tile-rounded kv_len by "
          f"{tiled} (float32 tol 1e-4)")
    mask = (torch.arange(S, device=dev) < kv_len)[None]      # (1, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 2 * B * KV * kv_len * hd * 2 + 2 * B * H * hd * 2
    bnd, by = bound_ms(n_bytes, 4 * B * H * kv_len * hd)
    sliced = ktimer(lambda: sdpa(qg, kt[:, :, :kv_len], vt[:, :, :kv_len]))
    contiguous = ktimer(lambda: DA.decode_attention_bkgd(qg, kt, vt, length),
                        "decode_attention_mma")
    entry = {
        "name": "decode_attention_bkgd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:62",
        "max_abs_err": err, "max_abs_err_float32": err32,
        "launches": launches["decode_attention_bkgd"],
        "tolerance": f"{tol:.3g} in bf16 (four bf16 steps of the largest "
                     f"output), 1e-4 in float32 on the same values",
        # the kernel on the model's cache, read in place (the path)
        **ktimer(lambda: DA.decode_attention_bkgd(qg, kv_, vv_, length),
                 "decode_attention_mma"),
        "contiguous_ms": contiguous["ms"],
        "entry_point_ms": entry_call["ms"],
        "entry_point_call_ms": entry_call["call_ms"],
        "entry_point_added_peak_bytes": call_peak,
        "plain_ms": timer(lambda: DA.decode_attention_plain(qg, kt, vt,
                                                            kv_len)),
        "bound_ms": bnd, "bound_by": by,
        **library_entry(ktimer(lambda: sdpa(qg, kt, vt, attn_mask=mask))),
        "library_note": "SDPA with a boolean kv_len mask over all S rows",
        "library_sliced_ms": sliced["ms"],
        "library_sliced_call_ms": sliced["call_ms"],
        "shape": [B, KV, G, S, hd], "kv_len": kv_len,
        "dtype": "torch.bfloat16"}
    del qg, kt, vt, kv_, vv_, k, v

    worst, worst_share = {"float32": 0.0, "bfloat16": 0.0}, 0.0
    sweep = ([(2, 2, 4, S, klen, 64, dt)
              for S, klen in [(256, 256), (256, 100), (512, 1), (300, 300),
                              (300, 77)]
              for dt in ("float32", "bfloat16")]
             + [(3, 2, 7, 1000, 999, 64, "bfloat16"),
                (1, 1, 16, 640, 333, 128, "float32")]
             + [(1, 1, 7, 20000, 12345, 64, dt)
                for dt in ("float32", "bfloat16")])
    for i, (B, KV, G, S, klen, hd, dt) in enumerate(sweep):
        g = torch.Generator(dev).manual_seed(i)
        dtype = getattr(torch, dt)
        a, b, c = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((B, KV, G, hd), (B, KV, S, hd),
                                 (B, KV, S, hd)))
        o = DA.decode_attention_bkgd(a, b, c, klen)
        w = DA.decode_attention_plain(a, b, c, klen)
        e = float((o.float() - w.float()).abs().max())
        case_tol = decode_tol(torch, w)
        check(o.dtype == dtype and e <= case_tol,
              f"decode sweep {(B, KV, G, S, klen, hd, dt)}: max abs err {e}"
              f" (tol {case_tol})")
        worst[dt] = max(worst[dt], e)
        if dt == "bfloat16":
            worst_share = max(worst_share, e / case_tol)
    return entry, [
        f"decode_attention_bkgd at decode_32k, bf16, on the model's (B, S, "
        f"KV, hd) cache read in place: device {entry['ms']} ms; on a "
        f"(B, KV, S, hd) copy {entry['contiguous_ms']} ms; "
        f"ops.decode_attention device {entry['entry_point_ms']} ms, call "
        f"{entry['entry_point_call_ms']} ms, added peak memory "
        f"{call_peak} bytes (output and split scratch only, no copy of the "
        f"cache); SDPA masked over all S device {entry['library_ms']} ms, "
        f"SDPA on the kv_len slice device {entry['library_sliced_ms']} ms "
        f"(call {entry['library_sliced_call_ms']} ms); bit-identical on a "
        f"repeated call and across the two layouts; {plan}",
        f"decode_attention_bkgd at decode_32k in float32 (the same "
        f"values): max abs err {err32:.3g} (tol 1e-4); the plain version "
        f"with kv_len ignored is {no_len:.3g} off in bf16 (tol {tol:.3g}), "
        f"with kv_len rounded up to 64 keys {tiled:.3g} in float32",
        f"decode sweep: {len(sweep)} cases ((S, kv_len) of the Pallas "
        f"test, ragged S 300, G 7/16, hd 128, a 20000-key cache in many "
        f"splits, in both types) within tolerance: max abs err "
        f"{worst['float32']:.3g} float32 (tol 1e-4), "
        f"{worst['bfloat16']:.3g} bfloat16 (tol: four "
        f"bf16 steps of the case's largest output, at most 2e-2; the worst "
        f"case used {worst_share:.3f} of its tol)"]


def decode_tol(torch, want):
    """1e-4 in float32.  In bf16 the Pallas test's 2e-2, or four bf16
    steps (2^(e - 7) for the largest |want| in [2^e, 2^(e+1))) where that
    is smaller: an output averages ~kv_len / e values of v, so a long
    cache's outputs are far below 1 and 2e-2 would pass a kernel that
    ignored kv_len (``decode_phase`` measures by how much)."""
    if want.dtype == torch.float32:
        return 1e-4
    m = float(want.float().abs().max())
    return min(2e-2, 4 * 2.0 ** (math.floor(math.log2(m)) - 7))


def kernel_line(e):
    extra = "".join(f", {k} {e[k]:.3g}" for k in ("max_abs_err_state",
                                                   "max_rel_err_out")
                    if k in e)
    return (f"kernel {e['name']} {e['shape']} {e['dtype']}: device "
            f"{e['ms']} ms (call {e['call_ms']} ms, back-to-back "
            f"{e['b2b_ms']} ms; plain {e['plain_ms']} ms, bound "
            f"{e['bound_ms']:.6f} ms by {e['bound_by']}, library device "
            f"{e['library_ms']} ms, call {e.get('library_call_ms')} ms), "
            f"max abs err "
            f"{e['max_abs_err']:.3g}{extra} (tolerance: {e['tolerance']}), "
            f"launches {e['launches']}")


# ---------------------------------------------------------------------------
# correctness of the RWKV path at full width, in float32
# ---------------------------------------------------------------------------

def rwkv_fp32_phase(torch, dev, rehearse):
    """The kernel path (pallas) against the chunked plain path (xla_flash)
    on the same float32 weights, both fed the same tokens: two prompts,
    prefill then decode steps; and the kernel path's decode against a full
    forward over prompt + generated tokens.  atol 2e-2 (the JAX model
    test's decode-vs-full tolerance)."""
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = model_config("rwkv6_3b", rehearse, attn_impl="pallas",
                       dtype="float32")
    plain = dataclasses.replace(cfg, attn_impl="xla_flash")
    n_prompt, n_dec = (32, 3) if rehearse else (RWKV_FP32_PROMPT,
                                                RWKV_FP32_DECODE)
    params = M.init_params(torch.Generator(dev).manual_seed(SEED + 1), cfg,
                           device=dev)
    prompts = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (2, n_prompt)), device=dev)
    caches = {c.attn_impl: SV.init_cache(c, 2, n_prompt + n_dec, device=dev)
              for c in (cfg, plain)}
    last = {}
    for c in (cfg, plain):
        last[c.attn_impl], caches[c.attn_impl], _ = SV.prefill(
            params, c, prompts, cache=caches[c.attn_impl])
    toks = [last["pallas"].argmax(-1)]
    worst = float((last["pallas"] - last["xla_flash"]).abs().max())
    for _ in range(n_dec):
        for c in (cfg, plain):
            last[c.attn_impl], caches[c.attn_impl] = SV.decode_step(
                params, c, toks[-1][:, None], cache=caches[c.attn_impl])
        worst = max(worst, float((last["pallas"] - last["xla_flash"]).abs()
                                 .max()))
        toks.append(last["pallas"].argmax(-1))
    check(worst <= 2e-2, f"rwkv fp32: kernel path differs from the plain "
          f"path (max abs err {worst}, tol 2e-2)")
    seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
    full = M.forward(params, cfg, seq).logits[:, -1]
    d_err = float((full - last["pallas"]).abs().max())
    check(d_err <= 2e-2, f"rwkv fp32: decode differs from the full "
          f"forward (max abs err {d_err}, tol 2e-2)")
    check(bool(torch.isfinite(full).all()), "rwkv fp32: logits not finite")
    return [f"rwkv float32 ({cfg.n_layers} layers, d_model {cfg.d_model}): "
            f"2 prompts x {n_prompt} tokens + {n_dec} decode steps, kernel "
            f"path vs chunked plain path max abs err {worst:.3g} over every "
            f"step's logits; decode vs full forward over {seq.shape[1]} "
            f"tokens max abs err {d_err:.3g} (tol 2e-2)"]


# ---------------------------------------------------------------------------
# the attention family of the model zoo, served from a KV cache
# ---------------------------------------------------------------------------

ZOO_KERNELS = ("flash_attention_bhsd", "decode_attention_bkgd")


def zoo_counts(ops):
    return {k: ops.launch_counts().get(k, 0) for k in ZOO_KERNELS}


def check_zoo_launches(rehearse, what, got, want):
    """On the card, the zoo kernels' launch counts of one counted window
    (CPU tensors run the plain versions and launch nothing)."""
    if rehearse:
        return
    for name, n in want.items():
        check(got[name] == n, f"{what}: {name} launched {got[name]} times, "
              f"want {n}")


def decode_check(torch, dev, what, rec):
    """The recorded first call of ``ops.decode_attention`` (layer 0's, on
    the model's cache), the kernel against its plain version on the
    same (B, KV, S, hd) views of the cache: in the model's dtype at
    ``decode_tol`` and on the same values in float32 at 1e-4.  Returns
    the phase's report text."""
    from repro_torch.kernels import decode_attention as DA
    args = rec.first(dev)
    check(args is not None, f"{what}: decode attention was not reached")
    q, k, v, kv_len = args
    B, H, hd = q.shape
    KV = k.shape[2]
    errs = []
    for dt in dict.fromkeys((q.dtype, torch.float32)):
        qg = q.to(dt).reshape(B, KV, H // KV, hd)
        kt, vt = k.to(dt).transpose(1, 2), v.to(dt).transpose(1, 2)
        want = DA.decode_attention_plain(qg, kt, vt, kv_len)
        err = float((DA.decode_attention_bkgd(qg, kt, vt, kv_len).float()
                     - want.float()).abs().max())
        tol = decode_tol(torch, want)
        check(err <= tol, f"{what}: decode attention on the model's cache "
              f"differs from plain in {dt} (max abs err {err}, tol {tol})")
        errs.append(f"{err:.3g} in {str(dt)[6:]} (tol {tol:.3g})")
    return (f"layer 0's decode call {[B, KV, H // KV, k.shape[1], hd]} "
            f"(kv_len {int(kv_len)}) kernel vs plain {', '.join(errs)}")


def param_bytes(params):
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def zoo_serving_phase(torch, dev, rehearse):
    """qwen2-0.5b at full width in bf16, ``attn_impl="pallas"``: 16
    requests x 1024 prompt tokens into a 1056-row cache, 32 greedy decode
    steps, after one untimed warm-up pass; a profile of one prefill and
    one decode step.  Counts are reset just before the timed pass:
    decode attention once per layer and step.  Layer 0's first decode
    call of the warm-up, on the model's bf16 cache (G = 7), against the
    plain version (``decode_check``)."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = model_config("qwen2_0p5b", rehearse, attn_impl="pallas",
                       dtype="bfloat16")
    n_req, prompt_len, n_dec = (2, 64, 4) if rehearse else \
        (ZOO_REQUESTS, ZOO_PROMPT, ZOO_DECODE)
    cap = prompt_len + n_dec
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, device=dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    prompts = torch.as_tensor(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (n_req, prompt_len)), device=dev)

    def serve():
        return serve_steps(torch, dev, SV, params, cfg, prompts,
                           SV.init_cache(cfg, n_req, cap, device=dev), n_dec)

    with CallRecorder(ops, "decode_attention") as dec:
        serve()                                # warm-up: cuBLAS, the kernels
    lines = []
    if dev.type == "cuda":
        cache = SV.init_cache(cfg, n_req, cap, device=dev)
        _, cache, _ = SV.prefill(params, cfg, prompts, cache=cache)
        lines.append(profile_line(
            torch, f"one {cfg.name} decode step", lambda: SV.decode_step(
                params, cfg, prompts[:, -1:], cache=cache),
            share_of="decode_attention"))
        del cache
        lines.append(profile_line(
            torch, f"one {cfg.name} prefill", lambda: SV.prefill(
                params, cfg, prompts, cache=SV.init_cache(
                    cfg, n_req, cap, device=dev)),
            share_of="decode_attention"))
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    t_pre, steps, toks, finite, _ = serve()
    launches = zoo_counts(ops)
    peak = peak_bytes(torch, dev)
    check(finite, f"{cfg.name} serving: a logit is not finite")
    check(toks.shape == (n_req, n_dec + 1) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          f"{cfg.name} serving: generated tokens outside the vocab")
    want = cfg.n_layers * n_dec
    check_zoo_launches(rehearse, f"{cfg.name} serving", launches,
                       {"decode_attention_bkgd": want})
    dec_text = decode_check(torch, dev, f"{cfg.name} serving", dec)
    logits_gib = n_req * prompt_len * cfg.vocab_size * 2 / 2**30
    del params
    return launches, lines + [
        f"zoo serving ({cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, hd "
        f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, random weights drawn "
        f"in {init_s:.3f} s): {n_req} requests x {prompt_len} prompt tokens "
        f"into a {cap}-row cache, prefill {t_pre * 1e3:.3f} ms = "
        f"{n_req * prompt_len / t_pre:.1f} tokens/s; {n_dec} decode steps "
        f"of {n_req} tokens, {steps_text(steps)}; peak device memory "
        f"{gib(peak)} (the prefill's full bf16 logits alone "
        f"{logits_gib:.3f} GiB); launches {launches} (decode attention "
        f"want {want}); tokens in the vocab, logits finite; first "
        f"request's tokens {toks[0].tolist()}; {dec_text}"]


def decode32k_phase(torch, dev, rehearse):
    """The zoo's decode_32k cell on qwen2-0.5b (bf16, pallas): batch 128, a
    32768-row cache (48 GiB) filled layer by layer with bf16 draws to
    ``len`` = DECODE_KV_LEN, then 8 ``decode_step``s.  Checks: the cache
    tensors never move, a step adds under 0.5 GiB to the peak above cache
    and weights, decode attention launches once per layer and step."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import shape_cell
    cfg = model_config("qwen2_0p5b", rehearse, attn_impl="pallas",
                       dtype="bfloat16")
    cell = shape_cell("decode_32k")
    B, S, kv_len = (2, 640, 600) if rehearse else \
        (cell.global_batch, cell.seq_len, DECODE_KV_LEN)
    n_dec = 3 if rehearse else DECODE32K_STEPS
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    params = M.init_params(gen, cfg, device=dev)
    cache = SV.init_cache(cfg, B, S, device=dev)
    t0 = time.perf_counter()
    for name in ("k", "v"):
        for layer in cache["layers"][name]:   # (B, S, KV, hd) views
            layer[:, :kv_len].normal_(generator=gen)
    cache["len"].fill_(kv_len)
    sync(torch, dev)
    fill_s = time.perf_counter() - t0
    ptrs = {k: a.data_ptr() for k, a in cache["layers"].items()}
    cache_bytes = sum(a.numel() * a.element_size()
                      for a in cache["layers"].values())
    w_bytes = param_bytes(params)
    tok = torch.as_tensor(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (B, 1)), device=dev)
    reset_peak(torch, dev)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    ops.reset_launch_counts()
    steps, finite = [], True
    for _ in range(n_dec):
        sync(torch, dev)
        t0 = time.perf_counter()
        logits, cache = SV.decode_step(params, cfg, tok, cache=cache)
        tok = logits.argmax(-1)[:, None]
        sync(torch, dev)
        steps.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(logits).all())
    launches = zoo_counts(ops)
    added = None if base is None else \
        torch.cuda.max_memory_allocated() - base
    check(finite and int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size,
          "decode_32k: a logit is not finite or a token is outside the vocab")
    check({k: a.data_ptr() for k, a in cache["layers"].items()} == ptrs,
          "decode_32k: a decode step moved the cache")
    check(int(cache["len"]) == kv_len + n_dec, "decode_32k: wrong len")
    if added is not None:
        check(added < DECODE32K_ADDED_LIMIT, f"decode_32k: a step added "
              f"{gib(added)} to the peak above cache and weights (one "
              f"layer's k is {gib(cache_bytes / 2 / cfg.n_layers)}): the "
              f"cache was copied")
    want = cfg.n_layers * n_dec
    check_zoo_launches(rehearse, "decode_32k", launches,
                       {"decode_attention_bkgd": want})
    # the least time of the last step: the valid cache rows it reads and
    # every weight once, at the card's memory rate
    rows = kv_len + n_dec
    row_bytes = cache_bytes // S
    bnd, by = bound_ms(rows * row_bytes + w_bytes, 0)
    lines = []
    if dev.type == "cuda":
        lines.append(profile_line(
            torch, "one decode_32k step", lambda: SV.decode_step(
                params, cfg, tok, cache=cache), share_of="decode_attention"))
    del cache, params
    return launches, lines + [
        f"decode_32k ({cfg.name}, {cfg.dtype}, pallas): batch {B}, a {S}-row "
        f"cache of {gib(cache_bytes)} filled with bf16 draws to len {kv_len} "
        f"in {fill_s:.3f} s; {n_dec} decode steps, {steps_text(steps)}; "
        f"bound of the last step {bnd:.3f} ms by {by} ({rows} valid rows x "
        f"{row_bytes} B + {w_bytes / 1e9:.3f} GB of weights at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); cache pointers unchanged; "
        f"peak added above cache and weights {gib(added)} (limit "
        f"{gib(DECODE32K_ADDED_LIMIT)}); launches {launches} (decode "
        f"attention want {want})"]


def whisper_phase(torch, dev, rehearse):
    """whisper-base at full width in bf16, pallas: 8 requests of 1500 stub
    frame embeddings, 4 prompt tokens, 60 decode steps, after one untimed
    warm-up pass; the encoder alone timed before the counted pass.
    Checks: the encoder's flash attention once per encoder layer and
    prefill, decode attention once per decoder layer and step; one
    encoder layer's flash call and the decoder's first decode call (G =
    1, on its bf16 cache) against their plain versions."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = model_config("whisper_base", rehearse, attn_impl="pallas",
                       dtype="bfloat16")
    n_req, n_prompt, n_dec = (2, 4, 4) if rehearse else \
        (WHISPER_REQUESTS, WHISPER_PROMPT, WHISPER_DECODE)
    if rehearse:                    # 300 frames reach the flash dispatch
        cfg = dataclasses.replace(cfg, enc_len=300)
    cap = n_prompt + n_dec
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    params = M.init_params(gen, cfg, device=dev)
    frames = torch.randn((n_req, cfg.enc_len, cfg.d_model), generator=gen,
                         device=dev).to(torch.bfloat16)
    prompts = torch.as_tensor(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (n_req, n_prompt)), device=dev)

    def serve():
        return serve_steps(torch, dev, SV, params, cfg, prompts,
                           SV.init_cache(cfg, n_req, cap, device=dev), n_dec,
                           frames=frames)

    with CallRecorder(ops, "flash_attention") as rec, \
            CallRecorder(ops, "decode_attention") as dec:
        serve()                                        # warm-up
    enc_ms = []
    for _ in range(3):
        sync(torch, dev)
        t0 = time.perf_counter()
        M.encode(params, cfg, frames)
        sync(torch, dev)
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    t_pre, steps, toks, finite, cache = serve()
    launches = zoo_counts(ops)
    peak = peak_bytes(torch, dev)
    check(finite and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size,
          "whisper: a logit is not finite or a token is outside the vocab")
    check(tuple(cache["enc_out"].shape) == (n_req, cfg.enc_len, cfg.d_model),
          "whisper: the encoder memory has the wrong shape")
    want = {"flash_attention_bhsd": cfg.n_enc_layers,
            "decode_attention_bkgd": cfg.n_layers * n_dec}
    check_zoo_launches(rehearse, "whisper", launches, want)
    # one encoder layer's call (layer 0 of the warm-up), kernel vs plain,
    # in bf16 and on the same values in float32
    enc = rec.first(dev)
    check(enc is not None and rec.kwargs[None].get("causal") is False,
          "whisper: the encoder did not reach ops.flash_attention "
          "bidirectionally")
    q, k, v = (t.transpose(1, 2).contiguous() for t in enc)
    errs = {}
    for dt, tol in (("bfloat16", 2e-2), ("float32", 1e-4)):
        a, b, c = (t.to(getattr(torch, dt)) for t in (q, k, v))
        got = FA.flash_attention_bhsd(a, b, c, causal=False)
        errs[dt] = float((got.float() - FA.flash_attention_plain(
            a, b, c, causal=False).float()).abs().max())
        check(errs[dt] <= tol, f"whisper encoder layer: flash attention "
              f"differs from plain in {dt} (max abs err {errs[dt]}, tol "
              f"{tol})")
    dec_text = decode_check(torch, dev, "whisper decoder", dec)
    del params, cache, frames
    return launches, [
        f"zoo enc-dec ({cfg.name}, {cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, {cfg.dtype}): {n_req} requests x {cfg.enc_len} "
        f"frames, encode alone {' / '.join(f'{x:.3f}' for x in enc_ms)} ms "
        f"(three calls); prefill (encode + {n_prompt} prompt tokens) "
        f"{t_pre * 1e3:.3f} ms; {n_dec} decode steps, {steps_text(steps)}; "
        f"peak device memory {gib(peak)}; launches {launches} (want "
        f"{want}); tokens in the vocab, logits finite",
        f"whisper encoder layer 0's flash call {list(q.shape)} (B, H, S, "
        f"hd), bidirectional: kernel vs plain max abs err "
        f"{errs['bfloat16']:.3g} in bf16 (tol 2e-2), {errs['float32']:.3g} "
        f"on the same values in float32 (tol 1e-4); decoder {dec_text}"]


def zoo_fp32_phase(torch, dev, rehearse):
    """qwen2-0.5b at full width in float32 (TF32 off), pallas: 2 x 256
    prompt tokens, 8 decode steps; each step's logits against the
    cache-less forward over prompt + generated tokens at the same
    position (its 264^2 scores reach the flash kernel), within 1e-3 x
    max|logit| and with equal greedy tokens.  Layer 0's first decode
    call on the model's cache, and the forward's first flash call,
    against their plain versions at 1e-4."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    cfg = model_config("qwen2_0p5b", rehearse, attn_impl="pallas",
                       dtype="float32")
    n_prompt, n_dec = ZOO_FP32_PROMPT, ZOO_FP32_DECODE
    params = M.init_params(torch.Generator(dev).manual_seed(SEED + 5), cfg,
                           device=dev)
    prompts = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (2, n_prompt)), device=dev)
    ops.reset_launch_counts()
    with CallRecorder(ops, "decode_attention") as dec:
        cache = SV.init_cache(cfg, 2, n_prompt + n_dec, device=dev)
        logits, cache, _ = SV.prefill(params, cfg, prompts, cache=cache)
        steps, toks = [logits], [logits.argmax(-1)]
        for _ in range(n_dec):
            logits, cache = SV.decode_step(params, cfg, toks[-1][:, None],
                                           cache=cache)
            steps.append(logits)
            toks.append(logits.argmax(-1))
    seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
    with CallRecorder(ops, "flash_attention") as fl:
        full = M.forward(params, cfg, seq).logits[:, n_prompt - 1:]
    launches = zoo_counts(ops)
    err = float((torch.stack(steps, 1) - full).abs().max())
    scale = float(full.abs().max())
    same = bool((full.argmax(-1) == torch.stack(toks, 1)).all())
    check(bool(torch.isfinite(full).all()), "zoo fp32: logits not finite")
    check(err <= 1e-3 * scale and same, f"zoo fp32: decode differs from the "
          f"full forward (max abs err {err}, tol 1e-3 x {scale}; greedy "
          f"tokens equal: {same})")
    check_zoo_launches(rehearse, "zoo fp32", launches,
                       {"decode_attention_bkgd": cfg.n_layers * n_dec,
                        "flash_attention_bhsd": cfg.n_layers})
    flash = fl.first(dev)
    check(flash is not None and fl.kwargs[None].get("causal") is True,
          "zoo fp32: flash attention was not reached causally")
    dec_text = decode_check(torch, dev, "zoo fp32", dec)
    fq, fk, fv = (t.transpose(1, 2).contiguous() for t in flash)
    f_err = float((FA.flash_attention_bhsd(fq, fk, fv, causal=True)
                   - FA.flash_attention_plain(fq, fk, fv, causal=True))
                  .abs().max())
    check(f_err <= 1e-4, f"zoo fp32: flash attention in the forward differs "
          f"from plain (max abs err {f_err}, tol 1e-4)")
    del params, cache
    return launches, [
        f"zoo float32 ({cfg.name}, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}): 2 prompts x {n_prompt} tokens + {n_dec} decode "
        f"steps against the cache-less forward over {seq.shape[1]} tokens: "
        f"max abs err {err:.3g} (tol 1e-3 x max|logit| {scale:.3g}), greedy "
        f"tokens equal; launches {launches}; {dec_text}; the forward's "
        f"flash call {list(fq.shape)} kernel vs plain {f_err:.3g} (tol "
        f"1e-4)"]


# ---------------------------------------------------------------------------
# the rest of the zoo: MoE, the Hymba hybrid, PaliGemma's prefix-LM
# ---------------------------------------------------------------------------

# per family: the config, its full-width overrides (depth cuts), the
# rehearsal's, and (requests, prompt tokens, decode steps) on the card and
# on the CPU
FAMILY_SERVING = {
    "granite": dict(name="granite_moe_3b_a800m", seed=6, full={},
                    size=(16, 1024, 32), small=(2, 64, 4)),
    "grok": dict(name="grok_1_314b", seed=7, full=dict(n_layers=2),
                 size=(4, 256, 8), small=(2, 64, 4)),
    # 1000 = 20 Mamba chunks of 50; the 1048-row cap makes a 1024-row ring
    # that the 48 steps wrap at step 25
    "hymba": dict(name="hymba_1p5b", seed=8, full={},
                  size=(8, 1000, 48), small=(2, 60, 8),
                  rehearse=dict(sliding_window=64)),
    # 256 stub patch embeddings before 64 prompt tokens
    "paligemma": dict(name="paligemma_3b", seed=9, full={},
                      size=(8, 64, 32), small=(2, 8, 4)),
}
# float32 at full width, depth cut to 4 layers: (prompt, decode steps)
FAMILY_FP32 = {
    "granite": dict(name="granite_moe_3b_a800m", seed=10, size=(256, 8),
                    small=(256, 4)),
    "hymba": dict(name="hymba_1p5b", seed=11, size=(1020, 8), small=(60, 8),
                  rehearse=dict(sliding_window=64)),
    "paligemma": dict(name="paligemma_3b", seed=12, size=(32, 8),
                      small=(8, 4)),
}
FP32_LAYERS = 4
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
DECODE256 = (128, 1, 8, 32768, 256)   # (B, KV, G, S, hd): paligemma's group


def reaches_decode(cfg):
    """Whether JAX's dispatch (``models/layers.py``) sends a single-token
    step to decode attention: no window (a ring cache) and no softcap."""
    return cfg.sliding_window is None and cfg.logits_softcap == 0.0


class MoeDrops:
    """Wraps ``layers.apply_moe`` to record, per prefill call (S > 1), the
    share of routed assignments that land past their expert's capacity,
    from the router alone (softmax, top-K with ties in index order, a
    count per expert; one routing group, as ``forward`` routes by
    default).  Calls go through unchanged."""

    def __init__(self, torch, L):
        self.torch, self.L, self.shares = torch, L, []

    def __enter__(self):
        torch, inner = self.torch, self.L.apply_moe
        self.inner = inner

        def rec(p, x, cfg, groups=1):
            if x.shape[1] > 1:
                xt = x.reshape(-1, x.shape[-1])
                probs = torch.softmax((xt @ p["router"].to(x.dtype)).float(),
                                      -1)
                K, E = cfg.experts_per_token, cfg.n_experts
                eidx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)[1][:, :K]
                count = torch.zeros(E, device=x.device).scatter_add_(
                    0, eidx.reshape(-1), torch.ones(eidx.numel(),
                                                    device=x.device))
                cap = self.L.moe_capacity(xt.shape[0], cfg)
                self.shares.append((count - cap).clamp(min=0).sum()
                                   / eidx.numel())
            return inner(p, x, cfg, groups=groups)
        self.L.apply_moe = rec
        return self

    def __exit__(self, *exc):
        self.L.apply_moe = self.inner

    def text(self):
        s = [float(x) for x in self.shares]
        return (f"dropped assignments at prefill per layer "
                f"{[round(x, 4) for x in s]} (mean {sum(s) / len(s):.4f})"
                if s else "no MoE prefill recorded")


def family_setup(torch, dev, rehearse, key):
    """The bf16 serving set-up of ``FAMILY_SERVING[key]``: (config under
    ``attn_impl="pallas"``, random weights from a CUDA generator at the
    family's seed, the VLM prefix's stub embeddings or None, the prompts,
    decode steps, cache rows, seconds to draw the weights)."""
    from repro_torch.models import model as M
    spec = FAMILY_SERVING[key]
    over = dict(attn_impl="pallas", dtype="bfloat16",
                **(spec.get("rehearse", {}) if rehearse else spec["full"]))
    cfg = model_config(spec["name"], rehearse, **over)
    n_req, prompt_len, n_dec = spec["small"] if rehearse else spec["size"]
    gen = torch.Generator(dev).manual_seed(SEED + spec["seed"])
    t0 = time.perf_counter()
    params = M.init_params(gen, cfg, device=dev)
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    embeds = None if not cfg.vlm_prefix else torch.randn(
        (n_req, cfg.vlm_prefix, cfg.d_model), generator=gen,
        device=dev).to(torch.bfloat16)
    prompts = torch.as_tensor(np.random.default_rng(SEED + spec["seed"])
                              .integers(0, cfg.vocab_size,
                                        (n_req, prompt_len)), device=dev)
    return (cfg, params, embeds, prompts, n_dec,
            cfg.vlm_prefix + prompt_len + n_dec, init_s)


def family_serving_phase(torch, dev, rehearse, key):
    """One family at full width in bf16 (``attn_impl="pallas"``, random
    weights from a seeded CUDA generator): prefill then greedy decode
    steps, after one untimed warm-up pass that records layer 0's first
    decode-attention call and (MoE) the dropped share per layer; a
    profile of one decode step and of one prefill.  Counts are reset
    just before the timed pass: decode attention once per layer and step
    where JAX's dispatch reaches it (no window, no softcap), flash
    attention never (a cached prefill runs the chunked plain path).  The
    cache's tensors keep their pointers."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import serve as SV
    cfg, params, embeds, prompts, n_dec, cap, init_s = family_setup(
        torch, dev, rehearse, key)
    n_req, prompt_len = prompts.shape
    ptrs = {}

    def serve():
        cache = SV.init_cache(cfg, n_req, cap, device=dev)
        ptrs.clear()
        ptrs.update({k: a.data_ptr() for k, a in cache["layers"].items()})
        return serve_steps(torch, dev, SV, params, cfg, prompts, cache,
                           n_dec, embeds=embeds)

    with CallRecorder(ops, "decode_attention") as dec, \
            MoeDrops(torch, L) as drops:
        serve()                                # warm-up
    lines = []
    uses_decode = reaches_decode(cfg)
    if dev.type == "cuda":
        cache = SV.init_cache(cfg, n_req, cap, device=dev)
        _, cache, _ = SV.prefill(params, cfg, prompts, cache=cache,
                                 embeds=embeds)
        lines.append(profile_line(
            torch, f"one {cfg.name} decode step", lambda: SV.decode_step(
                params, cfg, prompts[:, -1:], cache=cache),
            share_of="decode_attention" if uses_decode else None))
        del cache
        lines.append(profile_line(
            torch, f"one {cfg.name} prefill", lambda: SV.prefill(
                params, cfg, prompts, embeds=embeds, cache=SV.init_cache(
                    cfg, n_req, cap, device=dev))))
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    t_pre, steps, toks, finite, cache = serve()
    launches = zoo_counts(ops)
    peak = peak_bytes(torch, dev)
    check(finite and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
          f"{cfg.name}: a logit is not finite or a token is outside the "
          f"vocab")
    check({k: a.data_ptr() for k, a in cache["layers"].items()} == ptrs,
          f"{cfg.name}: the cache moved ({sorted(ptrs)})")
    check(int(cache["len"]) == cap, f"{cfg.name}: cache len "
          f"{int(cache['len'])}, want {cap}")
    want = {"decode_attention_bkgd": cfg.n_layers * n_dec if uses_decode
            else 0, "flash_attention_bhsd": 0}
    check_zoo_launches(rehearse, cfg.name, launches, want)
    if uses_decode:
        extra = decode_check(torch, dev, cfg.name, dec)
    else:
        check(not dec.calls, f"{cfg.name}: decode attention was reached "
              f"with a window or softcap")
        extra = ("decode attention not on this path (JAX's dispatch: "
                 + ("a ring cache" if cfg.sliding_window else "softcap") + ")")
    if cfg.block.value == "moe":
        extra += "; " + drops.text()
    shape = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
             f"heads over {cfg.n_kv_heads} of {cfg.head_dim}, vocab "
             f"{cfg.vocab_size}")
    if cfg.block.value == "moe":
        shape += (f", {cfg.n_experts} experts top-{cfg.experts_per_token} "
                  f"of d_ff {cfg.d_ff}, capacity factor "
                  f"{cfg.capacity_factor}")
    if cfg.block.value == "hybrid":
        shape += (f", d_inner {cfg.d_inner}, N {cfg.ssm_state}, window "
                  f"{cfg.sliding_window} ({cache['layers']['k'].shape[2]}"
                  f"-row ring)")
    prompt_text = (f"({cfg.vlm_prefix} patch embeddings + {prompt_len} "
                   f"tokens)" if cfg.vlm_prefix else f"{prompt_len} tokens")
    n_pre = n_req * (cfg.vlm_prefix + prompt_len)
    del params, cache, embeds
    return launches, lines + [
        f"zoo {key} ({cfg.name}, {shape}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.3f} B parameters, random weights drawn "
        f"in {init_s:.3f} s): {n_req} requests x {prompt_text} into a "
        f"{cap}-row cache, prefill {t_pre * 1e3:.3f} ms = "
        f"{n_pre / t_pre:.1f} tokens/s; {n_dec} decode steps of {n_req} "
        f"tokens, {steps_text(steps)}; peak device memory {gib(peak)}; "
        f"launches {launches} (want {want}); cache pointers of "
        f"{sorted(ptrs)} fixed; tokens in the vocab, logits finite; first "
        f"request's tokens {toks[0].tolist()}; {extra}"]


DECODE256_BODY = "decode_attention_hd256_bulk"


def decode256_body_report(torch, dev, B, KV, G, S, kv_len, rehearse):
    """bf16 hd 256's body as built and planned: its threads and warp
    roles, registers and local bytes as the runtime reads them
    (``hd256_body_info``), spills from the ``-Xptxas -v`` report, dynamic
    shared memory, blocks an SM, and the grid and splits the wrapper
    gives at (B, KV, G, S) and kv_len.  Fails on a spill or more than one
    block an SM.  None on the CPU."""
    if rehearse:
        return None, []
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    path = build.build_all(["decode_attention"])["decode_attention"]
    info = DA.hd256_body_info()
    with open(path + ".log") as f:
        log = f.read()
    prop = re.search(r"Function properties for \S*" + DECODE256_BODY
                     + r"\S*\s+\d+ bytes stack frame, (\d+) bytes spill "
                     r"stores, (\d+) bytes spill loads", log)
    check(prop is not None, f"no ptxas report of {DECODE256_BODY}")
    st, ld = int(prop.group(1)), int(prop.group(2))
    n_sm, per_sm = DA._slots(dev, 256, 1, G, build.library(
        "decode_attention"))
    nsplit = DA.split_count(B, KV, S, n_sm, per_sm)
    spans = [DA.split_span(kv_len, nsplit, i) for i in range(nsplit)]
    live = sum(hi > lo for lo, hi in spans)
    floats = DA.scratch_floats(B, KV, G, 256, nsplit)
    rep = {"kernel": DECODE256_BODY, **info, "spill_stores": st,
           "spill_loads": ld, "sms": n_sm, "splits": nsplit,
           "grid_blocks": B * KV * nsplit, "live_splits": live,
           "tiles_a_split": -(-(spans[0][1] - spans[0][0]) // DA.TILE),
           "scratch_bytes": 4 * floats}
    check(st == 0 and ld == 0 and info["local_bytes"] == 0,
          f"{DECODE256_BODY} spills: {st}/{ld} B, local "
          f"{info['local_bytes']} B")
    check(info["blocks_per_sm"] == 1 and per_sm == 1, f"{DECODE256_BODY}: "
          f"{info['blocks_per_sm']} blocks an SM, want 1")
    line = (f"{DECODE256_BODY} (bf16 hd 256): {info['threads']} threads (one "
            f"producer warp moving bytes by TMA, "
            f"{info['consumer_warps']} consumer warps of mma.sync), "
            f"{info['regs']} registers a thread, spill {st}/{ld} B, local "
            f"{info['local_bytes']} B; {info['smem_bytes']} B of dynamic "
            f"shared memory ({info['stages']} ring stages of 64 K and 64 V "
            f"rows), {info['blocks_per_sm']} block an SM; grid ({nsplit}, "
            f"{KV}, {B}) = {B * KV * nsplit} blocks on {n_sm} SMs, {live} "
            f"live splits of up to {rep['tiles_a_split']} tiles of 64 keys "
            f"a (b, kv head), {4 * floats} B of scratch"
            + ("" if nsplit == 1 else ", then the merge"))
    return rep, [line]


def decode256_entry(torch, dev, timer, ktimer, rehearse):
    """Decode attention at head dim 256 through ``ops.decode_attention`` on
    a (B, S, KV, hd) cache read in place, paligemma's group (G 8 over one
    kv head) at the decode_32k batch and length (kv_len 30000): the bf16
    body's report (``decode256_body_report``), the kernel against its
    plain version (``decode_tol``), timed three ways beside the plain
    version, SDPA (masked over all S, and on the kv_len slice) and its
    bytes bound, then again with NaN in every cache row past kv_len
    (bit-identical); then float32 on a shorter cache at 1e-4."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ops
    B, KV, G, S, hd = DECODE256
    kv_len = DECODE_KV_LEN
    if rehearse:
        B, S, kv_len = 2, 640, 600
    body, lines = decode256_body_report(torch, dev, B, KV, G, S, kv_len,
                                        rehearse)
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    q = torch.randn((B, KV * G, hd), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).bfloat16()
    length = torch.tensor([kv_len], dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    out = ops.decode_attention(q, k, v, length)
    sync(torch, dev)
    n_launch = ops.launch_counts()["decode_attention_bkgd"]
    check(rehearse or n_launch == 1, f"hd 256: ops.decode_attention "
          f"launched {n_launch} kernels")
    qg = q.reshape(B, KV, G, hd)
    kv_, vv_ = k.transpose(1, 2), v.transpose(1, 2)
    want = DA.decode_attention_plain(qg, kv_, vv_, kv_len)
    err = float((out.reshape(qg.shape).float() - want.float()).abs().max())
    tol = decode_tol(torch, want)
    check(err <= tol, f"decode attention at hd 256 differs from plain "
          f"(max abs err {err}, tol {tol})")
    del want
    g32 = torch.Generator(dev).manual_seed(SEED + 14)
    a, b, c = (torch.randn(shape, generator=g32, device=dev) for shape in
               ((8, KV, G, hd), (8, KV, 4096, hd), (8, KV, 4096, hd)))
    err32 = float((DA.decode_attention_bkgd(a, b, c, 3001)
                   - DA.decode_attention_plain(a, b, c, 3001)).abs().max())
    check(err32 <= 1e-4, f"decode attention at hd 256 in float32 differs "
          f"from plain (max abs err {err32}, tol 1e-4)")
    del a, b, c
    kt, vt = kv_.contiguous(), vv_.contiguous()
    mask = (torch.arange(S, device=dev) < kv_len)[None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_bytes = 2 * B * KV * kv_len * hd * 2 + 2 * B * KV * G * hd * 2
    bnd, by = bound_ms(n_bytes, 4 * B * KV * G * kv_len * hd, BF16_FLOPS)
    sliced = ktimer(lambda: sdpa(qg, kt[:, :, :kv_len], vt[:, :, :kv_len]))
    entry = {
        "shape": [B, KV, G, S, hd], "kv_len": kv_len,
        "dtype": "torch.bfloat16", "max_abs_err": err,
        "max_abs_err_float32": err32,
        "tolerance": f"{tol:.3g} in bf16 (four bf16 steps of the largest "
                     f"output), 1e-4 in float32 on (8, 1, 8, 4096, 256)",
        **ktimer(lambda: DA.decode_attention_bkgd(qg, kv_, vv_, length),
                 DECODE256_BODY),
        "plain_ms": timer(lambda: DA.decode_attention_plain(qg, kt, vt,
                                                            kv_len)),
        "bound_ms": bnd, "bound_by": by, "bound_bytes": n_bytes,
        **library_entry(ktimer(lambda: sdpa(qg, kt, vt, attn_mask=mask))),
        "library_note": "SDPA with a boolean kv_len mask over all S rows",
        "library_sliced_ms": sliced["ms"],
        "library_sliced_call_ms": sliced["call_ms"], "body": body}
    del kt, vt
    if not rehearse:             # the plain version weighs every row
        k[:, kv_len:] = float("nan")
        v[:, kv_len:] = float("nan")
        nan_same = torch.equal(ops.decode_attention(q, k, v, length), out)
        check(nan_same, "decode attention at hd 256 changes with NaN in "
              "the cache rows past kv_len")
        entry["nan_past_kv_len_bit_identical"] = nan_same
    del q, k, v, qg, kv_, vv_, out
    return entry, lines + [
        f"decode_attention_bkgd at hd 256 {entry['shape']} bf16, kv_len "
        f"{kv_len}, the (B, S, KV, hd) cache read in place: device "
        f"{entry['ms']} ms (call {entry['call_ms']} ms, back-to-back "
        f"{entry['b2b_ms']} ms; plain {entry['plain_ms']} ms; SDPA masked "
        f"device {entry['library_ms']} ms, on the kv_len slice "
        f"{entry['library_sliced_ms']} ms; bound {bnd:.4f} ms by {by}: "
        f"{n_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
        f"max abs err {err:.3g} (tol {tol:.3g}), float32 {err32:.3g} (tol "
        f"1e-4); NaN in every cache row past kv_len: "
        f"{'bit-identical' if not rehearse else 'not run (CPU)'}"]


def family_fp32_phase(torch, dev, rehearse, key):
    """One family at full width in float32 (TF32 off), depth cut to 4
    layers, pallas: 2 prompts, prefill then 8 greedy decode steps; each
    step's logits against the cache-less forward over prompt + generated
    tokens at the same position within 1e-3 x max|logit|, greedy tokens
    equal.  Granite routes with capacity factor E/K (nothing drops, so
    decode and the forward route alike).  Where the forward reaches flash
    attention (no prefix, more than 256^2 scores) its first call, and
    where decode reaches decode attention layer 0's first call, against
    their plain versions at 1e-4."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    spec = FAMILY_FP32[key]
    over = dict(attn_impl="pallas", dtype="float32",
                **(spec.get("rehearse", {}) if rehearse
                   else dict(n_layers=FP32_LAYERS)))
    cfg = model_config(spec["name"], rehearse, **over)
    if cfg.block.value == "moe":
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)
    n_prompt, n_dec = spec["small"] if rehearse else spec["size"]
    gen = torch.Generator(dev).manual_seed(SEED + spec["seed"])
    params = M.init_params(gen, cfg, device=dev)
    embeds = None if not cfg.vlm_prefix else torch.randn(
        (2, cfg.vlm_prefix, cfg.d_model), generator=gen, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(SEED + spec["seed"])
                              .integers(0, cfg.vocab_size, (2, n_prompt)),
                              device=dev)
    n_pre = cfg.vlm_prefix + n_prompt
    ops.reset_launch_counts()
    with CallRecorder(ops, "decode_attention") as dec:
        cache = SV.init_cache(cfg, 2, n_pre + n_dec, device=dev)
        logits, cache, _ = SV.prefill(params, cfg, prompts, cache=cache,
                                      embeds=embeds)
        steps, toks = [logits], [logits.argmax(-1)]
        for _ in range(n_dec):
            logits, cache = SV.decode_step(params, cfg, toks[-1][:, None],
                                           cache=cache)
            steps.append(logits)
            toks.append(logits.argmax(-1))
    seq = torch.cat([prompts, torch.stack(toks[:-1], 1)], 1)
    with CallRecorder(ops, "flash_attention") as fl:
        full = M.forward(params, cfg, seq, embeds=embeds).logits[
            :, n_pre - 1:]
    launches = zoo_counts(ops)
    err = float((torch.stack(steps, 1) - full).abs().max())
    scale = float(full.abs().max())
    same = bool((full.argmax(-1) == torch.stack(toks, 1)).all())
    check(bool(torch.isfinite(full).all()), f"{cfg.name} fp32: logits not "
          f"finite")
    check(err <= 1e-3 * scale and same, f"{cfg.name} fp32: decode differs "
          f"from the full forward (max abs err {err}, tol 1e-3 x {scale}; "
          f"greedy tokens equal: {same})")
    uses_decode = reaches_decode(cfg)
    n_all = n_pre + n_dec
    uses_flash = not cfg.vlm_prefix and cfg.logits_softcap == 0.0 \
        and n_all * n_all > 256 * 256
    check_zoo_launches(rehearse, f"{cfg.name} fp32", launches, {
        "decode_attention_bkgd": cfg.n_layers * n_dec if uses_decode else 0,
        "flash_attention_bhsd": cfg.n_layers if uses_flash else 0})
    texts = []
    if uses_decode:
        texts.append(decode_check(torch, dev, f"{cfg.name} fp32", dec))
    if uses_flash:
        flash = fl.first(dev)
        kw = fl.kwargs[None]
        check(flash is not None and kw.get("causal") is True,
              f"{cfg.name} fp32: flash attention was not reached causally")
        fq, fk, fv = (t.transpose(1, 2).contiguous() for t in flash)
        sw = kw.get("sliding_window")
        f_err = float((FA.flash_attention_bhsd(fq, fk, fv, causal=True,
                                               sliding_window=sw)
                       - FA.flash_attention_plain(fq, fk, fv, causal=True,
                                                  sliding_window=sw))
                      .abs().max())
        check(f_err <= 1e-4, f"{cfg.name} fp32: flash attention in the "
              f"forward differs from plain (max abs err {f_err}, tol 1e-4)")
        texts.append(f"the forward's flash call {list(fq.shape)} (window "
                     f"{sw}) kernel vs plain {f_err:.3g} (tol 1e-4)")
    del params, cache, full
    return launches, [
        f"zoo float32 {key} ({cfg.name}, {cfg.n_layers} of "
        f"{model_config(spec['name'], rehearse).n_layers} layers at full "
        f"width, d_model {cfg.d_model}): 2 prompts x "
        + (f"({cfg.vlm_prefix} + {n_prompt})" if cfg.vlm_prefix
           else f"{n_prompt}")
        + f" tokens + {n_dec} decode steps against the cache-less forward "
        f"over {n_all} positions: max abs err {err:.3g} (tol 1e-3 x "
        f"max|logit| {scale:.3g}), greedy tokens equal; launches "
        f"{launches}" + "".join(f"; {t}" for t in texts)]


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the zoo's training (phase 17)
# ---------------------------------------------------------------------------

# qwen2-0.5b through the launcher: --batch, --seq, --steps, the resumed
# run's --steps, --ckpt-every
ZOO_TRAIN = dict(batch=4, seq=1024, steps=16, resume_to=24, every=8)
ZOO_TRAIN_SMALL = dict(batch=2, seq=64, steps=16, resume_to=24, every=8)
# memorise one batch, then serve it: prompt rows into a 2 x prompt cache
MEMO = dict(batch=4, seq=512, steps=30, lr=1e-3, prompt=256, decode=32)
MEMO_SMALL = dict(batch=4, seq=32, steps=30, lr=3e-3, prompt=16, decode=8)
REMAT_SEQ, REMAT_SEQ_SMALL = 4096, 256    # train_4k's sequence length
HYMBA_TRAIN = dict(layers=4, batch=2, seq=512, steps=3)
HYMBA_TRAIN_SMALL = dict(layers=2, batch=2, seq=64, steps=3)


def token_batch(torch, dev, cfg, B, S, seed):
    """One batch of ``TokenStream`` (tokens and labels) on ``dev``."""
    from repro_torch.data.pipeline import TokenStream
    b = next(iter(TokenStream(cfg.vocab_size, B, S, seed=seed)))
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in b.items()}


def median_ms(seconds):
    ms = sorted(x * 1e3 for x in seconds)
    return ms[len(ms) // 2]


def rel_diff(a, b):
    return abs(a - b) / max(abs(a), 1e-30)


def launcher_runs(torch, dev, cfg, z, root, rehearse):
    """``repro_torch.launch.train.main`` twice: ``z["steps"]`` steps with
    checkpoints every ``z["every"]``, then a resume to ``z["resume_to"]``.
    The launcher installs a SIGTERM handler (preemption); the process's
    own is put back.  Returns (first run, resumed run, peak bytes of the
    first, checkpoint steps after each)."""
    import signal
    from repro_torch.checkpoint import manager as CKPT
    from repro_torch.launch import train as LT
    ck = os.path.join(root, "launcher")
    argv = ["--arch", "qwen2_0p5b", "--batch", str(z["batch"]),
            "--seq", str(z["seq"]), "--ckpt-dir", ck,
            "--ckpt-every", str(z["every"]), "--log-every", "4",
            "--device", dev.type] + (["--smoke"] if rehearse else [])
    old = signal.getsignal(signal.SIGTERM)
    try:
        reset_peak(torch, dev)
        run = LT.main(argv + ["--steps", str(z["steps"])])
        peak = peak_bytes(torch, dev)
        saved = CKPT.all_steps(ck)
        resumed = LT.main(argv + ["--steps", str(z["resume_to"])])
        saved2 = CKPT.all_steps(ck)
    finally:
        signal.signal(signal.SIGTERM, old)
    losses = run.losses + resumed.losses
    check(all(math.isfinite(x) for x in losses + run.grad_norms
              + resumed.grad_norms), f"{cfg.name} launcher: a loss or "
          f"gradient norm is not finite ({losses})")
    check(abs(run.losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"{cfg.name} launcher: first loss {run.losses[0]} is not within "
          f"1.0 of ln {cfg.vocab_size}")
    every = z["every"]
    want = list(range(0, z["steps"], every))
    check(saved == want, f"{cfg.name} launcher: checkpoints {saved}, "
          f"want {want}")
    check(resumed.start == want[-1] + 1 and len(resumed.losses)
          == z["resume_to"] - resumed.start, f"{cfg.name} launcher: the "
          f"resume started at {resumed.start} and ran "
          f"{len(resumed.losses)} steps")
    want2 = list(range(0, z["resume_to"], every))[-3:]
    check(saved2 == want2, f"{cfg.name} launcher: checkpoints after the "
          f"resume {saved2}, want {want2} (keep 3)")
    return run, resumed, peak, (saved, saved2)


def exact_resume(torch, dev, cfg, step_fn, opt, batch, root):
    """3 steps, ``save``, then 2 steps from memory and 2 from ``restore``
    on the same batch.  Returns (losses a, losses b, the largest
    parameter difference, whether the parameters are equal bit for
    bit)."""
    from repro_torch.checkpoint import manager as CKPT
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import step as TS
    gen = torch.Generator(dev).manual_seed(SEED + 21)
    state = TS.init_state(gen, cfg, opt, device=dev)
    for _ in range(3):
        state, _ = step_fn(state, batch)
    ckd = os.path.join(root, "resume")
    CKPT.save(ckd, state, 3)
    runs = []
    b, step = CKPT.restore(ckd, TS.init_state(gen, cfg, opt, device="meta"),
                           device=dev)
    check(step == 3 and int(b["step"]) == 3, f"restored step {step}, "
          f"state step {int(b['step'])}")
    for st in (state, b):
        losses = []
        for _ in range(2):
            st, m = step_fn(st, batch)
            losses.append(float(m["loss"]))
        runs.append((st, losses))
    del state, b
    (a, la), (b, lb) = runs
    pa, pb = tree_leaves(a["params"]), tree_leaves(b["params"])
    dmax = max(float((x.float() - y.float()).abs().max())
               for x, y in zip(pa, pb))
    equal = all(torch.equal(x, y) for x, y in zip(pa, pb))
    worst = max(rel_diff(x, y) for x, y in zip(la, lb))
    check(worst < 1e-3, f"{cfg.name} resume: losses from memory {la} and "
          f"from the checkpoint {lb} differ by {worst:.3g} relative")
    return la, lb, dmax, equal


def memorise_and_serve(torch, dev, cfg, m, root, rehearse):
    """``m["steps"]`` AdamW steps on one batch; ``save``, ``restore`` the
    params into ``attn_impl="pallas"``; prefill each row's first
    ``m["prompt"]`` tokens into a 2 x prompt cache and take
    ``m["decode"]`` greedy steps, counts reset just before and read just
    after.  The share of greedy tokens equal to the memorised next tokens
    beside the same under the initial weights.  Returns (launches,
    text)."""
    from repro_torch.checkpoint import manager as CKPT
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    opt = adamw(m["lr"])
    step_fn = TS.build_train_step(cfg, opt)
    seed = SEED + 22
    state = TS.init_state(torch.Generator(dev).manual_seed(seed), cfg, opt,
                          device=dev)
    batch = token_batch(torch, dev, cfg, m["batch"], m["seq"], seed)
    losses, t0 = [], time.perf_counter()
    for _ in range(m["steps"]):
        state, mt = step_fn(state, batch)
        losses.append(float(mt["loss"]))
    train_s = time.perf_counter() - t0
    check(all(math.isfinite(x) for x in losses) and losses[-1]
          < 0.7 * losses[0], f"{cfg.name} memorise: losses {losses[0]:.4f}"
          f" -> {losses[-1]:.4f}, want under 0.7 x the first")
    ckm = os.path.join(root, "memorised")
    CKPT.save(ckm, state, m["steps"])
    del state
    scfg = dataclasses.replace(cfg, attn_impl="pallas")
    params = CKPT.restore(ckm, TS.init_state(
        torch.Generator(dev).manual_seed(seed), cfg, opt, device="meta"),
        device=dev)[0]["params"]
    B, P, n_dec = m["batch"], m["prompt"], m["decode"]
    prompts = batch["tokens"][:, :P]
    want = batch["tokens"][:, P:P + n_dec + 1]

    def serve(p):
        return serve_steps(torch, dev, SV, p, scfg, prompts,
                           SV.init_cache(scfg, B, 2 * P, device=dev), n_dec)

    serve(params)                                # warm-up
    ops.reset_launch_counts()
    _, steps, toks, finite, _ = serve(params)
    launches = zoo_counts(ops)
    check(finite and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab_size, f"{cfg.name} trained "
          f"serving: a logit is not finite or a token is outside the vocab")
    check_zoo_launches(rehearse, f"{cfg.name} trained serving", launches,
                       {"decode_attention_bkgd": cfg.n_layers * n_dec,
                        "flash_attention_bhsd": 0})
    hit = float((toks == want).float().mean())
    init = M.init_params(torch.Generator(dev).manual_seed(seed), scfg,
                         device=dev)
    hit0 = float((serve(init)[2] == want).float().mean())
    del params, init
    return launches, (
        f"memorised one {B} x {m['seq']} batch: {m['steps']} AdamW steps "
        f"at lr {m['lr']} (constant, clip 1.0) in {train_s:.3f} s, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({losses[-1] / losses[0]:.3f}"
        f" of the first; every 10th: "
        f"{[round(x, 4) for x in losses[::10]]}); saved, restored into "
        f"attn_impl=pallas and served: {B} x {P} prompt tokens into a "
        f"{2 * P}-row cache, {n_dec} greedy steps, {steps_text(steps)}; "
        f"launches {launches} (decode attention want "
        f"{cfg.n_layers * n_dec}); greedy tokens equal to the memorised "
        f"next tokens: {hit:.4f} (initial weights {hit0:.4f})")


def remat_check(torch, dev, cfg, S, opt):
    """One 1 x S step under ``remat`` none, full and selective on the same
    state and batch: losses within 1e-3 relative, and on the card the
    peak under full below the peak under none.  Returns the text."""
    from repro_torch.train import step as TS
    state = TS.init_state(torch.Generator(dev).manual_seed(SEED + 23), cfg,
                          opt, device=dev)
    batch = token_batch(torch, dev, cfg, 1, S, SEED + 23)
    res = {}
    for remat in ("none", "full", "selective"):
        fn = TS.build_train_step(dataclasses.replace(cfg, remat=remat), opt)
        reset_peak(torch, dev)
        t0 = time.perf_counter()
        new, mt = fn(state, batch)
        loss = float(mt["loss"])
        res[remat] = (loss, peak_bytes(torch, dev),
                      time.perf_counter() - t0)
        del new
    for remat in ("full", "selective"):
        check(rel_diff(res["none"][0], res[remat][0]) < 1e-3,
              f"{cfg.name} remat {remat}: loss {res[remat][0]} against "
              f"{res['none'][0]} without remat")
    if dev.type == "cuda":
        check(res["full"][1] < res["none"][1], f"{cfg.name}: the peak under "
              f"remat full {gib(res['full'][1])} is not below none's "
              f"{gib(res['none'][1])}")
    del state
    return (f"remat at 1 x {S} tokens, one step each on the same state: " +
            "; ".join(f"{k}: loss {v[0]:.6f}, peak {gib(v[1])}, "
                      f"{v[2] * 1e3:.1f} ms (host, first call)"
                      for k, v in res.items()))


def hymba_training(torch, dev, rehearse):
    """hymba-1.5b at published widths, depth cut, its published
    ``remat="selective"``: a few AdamW steps on one batch; losses and
    gradient norms finite.  Returns the text."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    h = HYMBA_TRAIN_SMALL if rehearse else HYMBA_TRAIN
    cfg = model_config("hymba_1p5b", rehearse, n_layers=h["layers"])
    check(cfg.remat == "selective", f"{cfg.name}: remat {cfg.remat}")
    opt = adamw(3e-4, weight_decay=0.01)
    state = TS.init_state(torch.Generator(dev).manual_seed(SEED + 24), cfg,
                          opt, device=dev)
    batch = token_batch(torch, dev, cfg, h["batch"], h["seq"], SEED + 24)
    step_fn = TS.build_train_step(cfg, opt)
    reset_peak(torch, dev)
    losses, norms, secs = [], [], []
    for _ in range(h["steps"]):
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    peak = peak_bytes(torch, dev)
    check(all(math.isfinite(x) for x in losses + norms), f"{cfg.name} "
          f"training: losses {losses}, gradient norms {norms}")
    del state
    return (f"hymba training ({cfg.name}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, d_inner {cfg.d_inner}, N {cfg.ssm_state}, "
            f"remat {cfg.remat}, {cfg.dtype}): {h['steps']} steps of "
            f"{h['batch']} x {h['seq']} tokens, losses "
            f"{[round(x, 4) for x in losses]}, gradient norms "
            f"{[round(x, 4) for x in norms]}, ms per step "
            f"{[round(x * 1e3, 1) for x in secs]} (the first includes "
            f"warm-up), peak {gib(peak)}")


def serve_cli(rehearse):
    """``repro_torch.launch.serve.main`` at its defaults (the card); the
    answers must be the oracle's on the survivors and false elsewhere."""
    from repro_torch.launch import serve as LS
    res = LS.main(["--device", "cpu", "--frames", "256", "--train-steps",
                   "20"] if rehearse else [])
    check(np.array_equal(res["answers"], res["truth"] & res["survived"]),
          "launch.serve: answers differ from the oracle's on survivors")
    return (f"launch.serve at its defaults: {res['frames_processed']} "
            f"frames at {res['fps']:.1f} frames/s, dropped {res['dropped']}"
            f", selectivity {res['selectivity']:.4f}, oracle calls "
            f"{res['oracle_calls']}, recall {res['recall']:.4f}, filter "
            f"{res['filter_ms']:.4f} ms/frame, speedup {res['speedup']:.2f}x"
            f"; answers equal the oracle's on the survivors")


def zoo_training_phase(torch, dev, rehearse):
    """qwen2-0.5b trained at published widths (bf16 parameters, float32
    AdamW moments, ``remat="none"``, ``attn_impl="xla_flash"``) through
    ``repro_torch.launch.train``, checkpointed and resumed; an exact
    resume; a memorised batch served through decode attention from the
    restored checkpoint; remat at 1 x 4096; hymba-1.5b trained at 4
    layers; the paper's CLI.  Returns (decode-attention launches of the
    trained serving, lines)."""
    import shutil
    from repro_torch.checkpoint import manager as CKPT
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    t_phase = time.perf_counter()
    cfg = model_config("qwen2_0p5b", rehearse)
    check(rehearse or (cfg.remat, cfg.attn_impl, cfg.dtype)
          == ("none", "xla_flash", "bfloat16"), f"{cfg.name}: published "
          f"remat / attn_impl / dtype are {cfg.remat} / {cfg.attn_impl} / "
          f"{cfg.dtype}")
    z = ZOO_TRAIN_SMALL if rehearse else ZOO_TRAIN
    root = os.path.join(HERE, "build", "train_phase")
    shutil.rmtree(root, ignore_errors=True)
    lines = []
    try:
        run, resumed, peak, saved = launcher_runs(torch, dev, cfg, z, root,
                                                  rehearse)
        shutil.rmtree(os.path.join(root, "launcher"))
        med = median_ms(run.step_s[2:])
        n_tok = z["batch"] * z["seq"]
        lines.append(
            f"zoo training ({cfg.name}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, "
            f"vocab {cfg.vocab_size}, {cfg.dtype} parameters, float32 AdamW "
            f"moments, remat {cfg.remat}, {cfg.attn_impl}) through "
            f"repro_torch.launch.train: {z['steps']} steps of {z['batch']} x "
            f"{z['seq']} tokens, losses {run.losses[0]:.4f} -> "
            f"{run.losses[-1]:.4f} (ln V = {math.log(cfg.vocab_size):.4f}), "
            f"median {med:.3f} ms per step over steps 2+ (min "
            f"{min(run.step_s[2:]) * 1e3:.3f}, max "
            f"{max(run.step_s[2:]) * 1e3:.3f}) = {n_tok / med * 1e3:.1f} "
            f"tokens/s; peak {gib(peak)}; checkpoints {saved[0]}, resumed "
            f"at step {resumed.start} to {z['resume_to']} (losses "
            f"{resumed.losses[0]:.4f} -> {resumed.losses[-1]:.4f}, median "
            f"{median_ms(resumed.step_s[1:]):.3f} ms), checkpoints "
            f"{saved[1]}")

        opt = adamw(3e-4, weight_decay=0.01)
        step_fn = TS.build_train_step(cfg, opt)
        batch = token_batch(torch, dev, cfg, z["batch"], z["seq"], SEED + 20)
        state = TS.init_state(torch.Generator(dev).manual_seed(SEED + 20),
                              cfg, opt, device=dev)
        state, _ = step_fn(state, batch)             # warm-up
        if dev.type == "cuda":
            lines.append(profile_line(
                torch, f"one {cfg.name} train step ({z['batch']} x "
                f"{z['seq']})", lambda: step_fn(state, batch)))
        saves = []
        for i in range(2):            # the second reuses pinned host memory
            sync(torch, dev)
            t0 = time.perf_counter()
            th = CKPT.save_async(os.path.join(root, "async"), state, i)
            snap_s = time.perf_counter() - t0
            th.join()
            saves.append((snap_s, time.perf_counter() - t0))
        nbytes = param_bytes(state)
        del state
        shutil.rmtree(os.path.join(root, "async"))
        lines.append(
            f"async save of the {nbytes / 2**30:.3f} GiB train state, "
            f"twice: " + ", ".join(
                f"{a * 1e3:.1f} ms on the training thread (the snapshot's "
                f"copies enqueued) and {b:.3f} s until written"
                for a, b in saves) + f"; a step takes {med:.3f} ms")

        la, lb, dmax, equal = exact_resume(torch, dev, cfg, step_fn, opt,
                                           batch, root)
        shutil.rmtree(os.path.join(root, "resume"))
        lines.append(
            f"exact resume ({z['batch']} x {z['seq']}): 3 steps, save, then "
            f"2 steps from memory {[round(x, 6) for x in la]} and 2 from "
            f"restore(device={dev.type}) {[round(x, 6) for x in lb]}; "
            f"largest parameter difference {dmax:.3g} ("
            + ("equal bit for bit" if equal else
               "not bit for bit: the embedding gradient sums with atomics")
            + ")")

        m = MEMO_SMALL if rehearse else MEMO
        launches, text = memorise_and_serve(torch, dev, cfg, m, root,
                                            rehearse)
        lines.append(text)
        lines.append(remat_check(torch, dev, cfg, REMAT_SEQ_SMALL if rehearse
                                 else REMAT_SEQ, opt))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lines.append(hymba_training(torch, dev, rehearse))
    lines.append(serve_cli(rehearse))
    lines.append(f"training phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, lines


# ---------------------------------------------------------------------------
# the launch analyses against steps on the card (phase 19)
# ---------------------------------------------------------------------------

LAUNCH_PEAK_RTOL = 0.10        # predicted peak against the measured one
LAUNCH_DOT_RTOL = 0.02         # analysed dot FLOPs against the profiler's
LAUNCH_STEPS = 5               # timed steps of a serving cell (median)
LAUNCH_TRAIN_STEPS = 3         # timed steps of the train cell
# train_4k (256 x 4096) cut to the training phase's own step
LAUNCH_TRAIN = dict(batch=4, seq=1024)
LAUNCH_TRAIN_SMALL = dict(batch=2, seq=64)
PROFILED_DOTS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
COMPRESS_STEPS = 50            # the reference's constant-gradient case


def launch_cells(rehearse):
    """(label, arch, cell, config overrides, what the cell runs); on the
    CPU the smoke configs, decode_32k cut to 4 x 512 rows."""
    from repro_torch.models.config import ShapeCell, shape_cell
    d32 = (ShapeCell("decode_32k", 512, 4, "decode") if rehearse
           else shape_cell("decode_32k"))
    t = LAUNCH_TRAIN_SMALL if rehearse else LAUNCH_TRAIN
    train = ShapeCell("train_4k", t["seq"], t["batch"], "train")
    return [("a", "qwen2_0p5b", d32, {}, "as configured (xla_flash)"),
            ("b", "qwen2_0p5b", d32, {"attn_impl": "pallas"},
             "decode attention"),
            ("c", "rwkv6_3b", shape_cell("long_500k"), {}, "RWKV-6 decode"),
            ("d", "hymba_1p5b", shape_cell("long_500k"), {},
             "hybrid decode"),
            ("e", "qwen2_0p5b", train, {"remat": "none"},
             f"train_4k cut from 256 x 4096 to {t['batch']} x {t['seq']}")]


def card_args(torch, dev, cfg, cell, opt, seed):
    """The step's arguments on ``dev`` at the cell's shapes: random
    weights (or a train state), tokens in the vocabulary, stub
    embeddings in the model's dtype, and for a decode cell an empty cache
    whose ``len`` says seq_len - 1 rows are filled (the last row is
    written)."""
    from repro_torch.launch import specs as SPECS
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.train import step as TS
    gen = torch.Generator(dev).manual_seed(seed)
    first = (TS.init_state(gen, cfg, opt, device=dev) if cell.kind == "train"
             else M.init_params(gen, cfg, device=dev))
    inputs = {}
    for k, spec in SPECS.input_specs(cfg, cell).items():
        if k == "cache":
            inputs[k] = SV.init_cache(cfg, cell.global_batch, cell.seq_len,
                                      device=dev)
            if cell.kind == "decode":
                inputs[k]["len"].fill_(cell.seq_len - 1)
        elif spec.dtype == torch.int32:
            inputs[k] = torch.randint(0, cfg.vocab_size, spec.shape,
                                      generator=gen, device=dev,
                                      dtype=torch.int32)
        else:
            inputs[k] = torch.randn(spec.shape, generator=gen, device=dev,
                                    dtype=spec.dtype)
    return first, inputs


def profiled_dot_flops(torch, fn):
    """FLOPs of the matrix products of one call of ``fn``, as
    torch.profiler(with_flops=True) counts them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_flops=True) as prof:
        fn()
        torch.cuda.synchronize()
    return float(sum(e.flops for e in prof.key_averages()
                     if e.key in PROFILED_DOTS))


def launch_cell(torch, dev, label, arch, cell, overrides, what, rehearse,
                gpu):
    """One cell: ``dryrun.analyse`` on meta, then the same step on the
    card: predicted against measured peak, the step's ms beside the
    roofline, dot FLOPs against the profiler's (xla_flash cells), the
    plain-version calls against the launches.  Returns (launches, text)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun as D
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    cfg = model_config(arch, rehearse, **overrides)
    t0 = time.perf_counter()
    pred = D.analyse(cfg, cell)
    analyse_s = time.perf_counter() - t0
    roof = D.roofline(pred, cfg, cell)
    bound_ms = max(roof["compute_s"], roof["memory_s"]) * 1e3

    base = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    opt = adamw(1e-4, weight_decay=0.1) if cell.kind == "train" else None
    first, inputs = card_args(torch, dev, cfg, cell, opt, SEED + 30)
    step = TS.step_for_cell(cfg, cell, opt)
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    out = step(first, inputs)
    sync(torch, dev)
    launches = {k: n for k, n in ops.launch_counts().items() if n}
    measured = peak_bytes(torch, dev)
    if measured is not None:
        measured -= base
    head = out[1]["loss"] if cell.kind == "train" else out[0]
    want = (() if cell.kind == "train"
            else (cell.global_batch, cfg.vocab_size))
    check(tuple(head.shape) == want and bool(torch.isfinite(head).all()),
          f"({label}) {arch} {cell.name}: output {tuple(head.shape)} is not "
          f"finite of shape {want}")
    del out, head
    times = []
    for _ in range(LAUNCH_TRAIN_STEPS if cell.kind == "train"
                   else LAUNCH_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = step(first, inputs)
        sync(torch, dev)
        times.append(time.perf_counter() - t0)
        del out
    ms = median_ms(times)
    text = (f"launch analysis ({label}) {arch} {cell.name} ({what}; "
            f"{cell.global_batch} x {cell.seq_len}, {cfg.dtype}, "
            f"{cfg.attn_impl}, remat {cfg.remat}): analysed on meta in "
            f"{analyse_s:.1f} s; peak predicted "
            f"{pred['peak_bytes'] / 2**30:.3f} GiB (arguments "
            f"{pred['argument_bytes'] / 2**30:.3f})")
    if measured is not None:
        gap = pred["peak_bytes"] / measured - 1
        text += f", measured {gib(measured)} ({gap:+.4f})"
        check(abs(gap) <= LAUNCH_PEAK_RTOL,
              f"({label}) {arch}: predicted peak {pred['peak_bytes']} B is "
              f"not within {LAUNCH_PEAK_RTOL} of the measured {measured} B")
    text += (f"; step median {ms:.3f} ms (min {min(times) * 1e3:.3f}, max "
             f"{max(times) * 1e3:.3f}) beside the roofline's "
             f"{bound_ms:.3f} ms ({roof['bottleneck']}; compute "
             f"{roof['compute_s'] * 1e3:.3f}, memory "
             f"{roof['memory_s'] * 1e3:.3f}, unfused ceiling "
             f"{roof['memory_s_unfused_ceiling'] * 1e3:.3f}): ratio "
             f"{ms / bound_ms:.2f}")
    dots = sum(pred["dot_flops"].values())
    if dev.type == "cuda" and not pred["kernel_calls"]:
        prof = profiled_dot_flops(torch, lambda: step(first, inputs))
        gap = dots / max(prof, 1.0) - 1
        by_dtype = ", ".join(f"{k} {v:.6g}"
                             for k, v in pred["dot_flops"].items())
        text += (f"; dot FLOPs analysed {dots:.6g} ({by_dtype}), profiler "
                 f"{prof:.6g} ({gap:+.5f})")
        check(abs(gap) <= LAUNCH_DOT_RTOL,
              f"({label}) {arch}: analysed dot FLOPs {dots} not within "
              f"{LAUNCH_DOT_RTOL} of the profiler's {prof}")
    else:
        text += f"; dot FLOPs analysed {dots:.6g}"
    text += (f"; plain-version calls {pred['kernel_calls']}, launches "
             f"{launches} [{gpu}]")
    if dev.type == "cuda":
        check(pred["kernel_calls"] == launches,
              f"({label}) {arch}: the analysis counted "
              f"{pred['kernel_calls']} kernel calls, the card launched "
              f"{launches}")
    del first, inputs
    return launches, text


def loss_and_grads(torch, cfg, params, batch):
    """The train step's loss (its aux included) and its gradients."""
    from repro_torch.models import model as M
    from repro_torch.train import losses as LS
    from repro_torch.train import step as TS

    def loss_fn(p, b):
        out = M.forward(p, cfg, b["tokens"])
        loss, _ = LS.softmax_cross_entropy(out.logits, b["labels"])
        return loss + 0.01 * out.aux, (loss, out.aux)
    (total, _), grads = TS.value_and_grad(loss_fn, params, batch)
    return total, grads


def compression_check(torch, dev, rehearse, gpu):
    """Error-feedback int8 compression of one training step's gradient
    tree on the card, the all-reduce over a one-rank NCCL group (gloo on
    the CPU) and the reference's constant-gradient case.  Returns the
    report lines."""
    import torch.distributed as dist
    from repro_torch.distributed import compression as C
    from repro_torch.launch import op_cost as OC
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import tree_leaves
    cfg = model_config("qwen2_0p5b", rehearse)
    t = LAUNCH_TRAIN_SMALL if rehearse else LAUNCH_TRAIN
    params = M.init_params(torch.Generator(dev).manual_seed(SEED + 31), cfg,
                           device=dev)
    batch = token_batch(torch, dev, cfg, t["batch"], t["seq"], SEED + 31)
    loss_and_grads(torch, cfg, params, batch)            # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    total, grads = loss_and_grads(torch, cfg, params, batch)
    sync(torch, dev)
    grad_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(total)), "compression: the loss is not finite")
    del params
    leaves = tree_leaves(grads)
    n = sum(g.numel() for g in leaves)
    err = C.init_error_state(grads)
    C.compress(grads, err)                                # warm-up
    sync(torch, dev)
    t0 = time.perf_counter()
    q, scales, new_err = C.compress(grads, err)
    sync(torch, dev)
    compress_ms = (time.perf_counter() - t0) * 1e3
    deq = C.decompress(q, scales)
    worst, exact = 0.0, True
    for g, d, s, e in zip(leaves, tree_leaves(deq), tree_leaves(scales),
                          tree_leaves(new_err)):
        worst = max(worst, float((d - g.float()).abs().max() / s))
        exact &= torch.equal(e, g.float() - d)
    # round((g + e) / scale) is within half a step; float32 products and
    # quotients add at most 127 ulps of a step
    check(worst <= 0.5 + 127 * 2.0 ** -23,
          f"compression: |decompress - g| reaches {worst} x scale")
    check(exact, "compression: the new error is not g - decompress exactly")
    q_bytes = sum(x.numel() for x in tree_leaves(q))
    lines = [f"compression of one qwen2-0.5b gradient tree ({t['batch']} x "
             f"{t['seq']} tokens, {len(leaves)} leaves, {n} parameters): "
             f"{q_bytes / 2**30:.3f} GiB of int8 against {4 * n / 2**30:.3f} "
             f"GiB of float32; max |decompress - g| = {worst:.6f} x scale; "
             f"new error == g - decompress bit for bit; compress "
             f"{compress_ms:.3f} ms beside the step's gradient pass "
             f"{grad_ms:.3f} ms [{gpu}]"]
    del q, deq, new_err

    backend = "nccl" if dev.type == "cuda" else "gloo"
    check(backend != "nccl" or dist.is_nccl_available(),
          "torch.distributed has no NCCL")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = os.path.join(HERE, "build", "launch_phase_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        with OC.OpCost() as cost:
            mean, _ = C.allreduce_compressed(grads, err)
        sync(torch, dev)
        summary = OC.summarize(cost.collectives)
        check(summary["total"]["count"] == 2 * len(leaves),
              f"compression: op_cost counted {summary['total']['count']} "
              f"all-reduces for {len(leaves)} leaves, want two per leaf")
        worst_ar = max(float((m - g.float()).abs().max() / s) for m, g, s in
                       zip(tree_leaves(mean), leaves, tree_leaves(scales)))
        check(worst_ar <= 0.5 + 127 * 2.0 ** -23,
              f"compression: the all-reduced mean is {worst_ar} x scale off")
        del mean
        t0 = time.perf_counter()
        mean, _ = C.allreduce_compressed(grads, err)
        sync(torch, dev)
        ar_ms = (time.perf_counter() - t0) * 1e3
        del mean
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):       # a FileStore removes it itself
            os.remove(store)
    lines.append(
        f"allreduce_compressed over a one-rank {backend} group: "
        f"{summary['total']['count']:.0f} all-reduces counted by op_cost "
        f"(2 per leaf, {summary['total']['operand_bytes'] / 2**30:.3f} GiB "
        f"of operands), the mean within {worst_ar:.6f} x scale of g; "
        f"{ar_ms:.3f} ms (compress included) beside a gradient pass of "
        f"{grad_ms:.3f} ms")
    del grads, err

    g = {"w": torch.tensor([0.301, -0.7003, 0.11], device=dev)}
    e = C.init_error_state(g)
    acc = torch.zeros(3, device=dev)
    for _ in range(COMPRESS_STEPS):
        q, s, e = C.compress(g, e)
        acc += C.decompress(q, s)["w"]
    off = float((acc / COMPRESS_STEPS - g["w"]).abs().max())
    check(off <= 1e-3, f"compression: {COMPRESS_STEPS} constant-gradient "
          f"steps are {off} off the gradient")
    lines.append(f"error feedback, {COMPRESS_STEPS} steps of a constant "
                 f"gradient: mean {off:.3g} off (at most 1e-3)")
    return lines


def launch_phase(torch, dev, rehearse, gpu):
    """Phase 19: each cell of ``launch_cells`` analysed on meta and run on
    the card, then gradient compression.  Returns (decode attention's
    launches at (b), lines)."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    lines, zoo_b = [], None
    for label, arch, cell, overrides, what in launch_cells(rehearse):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        launches, text = launch_cell(torch, dev, label, arch, cell,
                                     overrides, what, rehearse, gpu)
        lines.append(text)
        if label == "b":
            zoo_b = {k: launches.get(k, 0) for k in ZOO_KERNELS}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lines += compression_check(torch, dev, rehearse, gpu)
    ops.reset_launch_counts()
    lines.append(f"launch phase: {time.perf_counter() - t_phase:.1f} s")
    return zoo_b, lines


# ---------------------------------------------------------------------------
# the mesh path: the sharding plan, the decode shard, the pipeline (phase 20)
# ---------------------------------------------------------------------------

MESH_STEPS = 8                 # decode steps of (a) and (b)
MESH_WORLD = 4                 # (b): ranks sharing the one card over gloo
MESH_F32_BATCH = 8             # the float32 decode's batch (6 GiB cache)
MESH_DTYPES = ("bfloat16", "float32")
MESH_B_LIMIT_S = 120           # (b)'s ranks, from start to exit
MESH_PIPE = dict(micro=4, batch=4, seq=1024)
MESH_PIPE_SMALL = dict(micro=4, batch=2, seq=16)
MESH_TRAIN_STEPS = 3           # timed steps of each train step
MESH_TRAIN_LR = 1e-2           # AdamW's rate there: a step moves bf16 weights
# whole-model bf16 decode logits, sharded vs unsharded: 1.6 x the largest
# gap measured at decode_32k between the port's own one-card decodes
# (``xla_flash`` vs the decode kernel, 0.1323-0.1494) and between the
# sharded and the unsharded decode (0.1348-0.1592), NVIDIA H100 80GB
# HBM3 at 700 W (phase 20); float32 holds the precision, 1e-4
MESH_BF16_TOL = 0.25
# (b)'s layout: the cache split on sequence, everything else replicated;
# gloo carries only broadcast and all_reduce on CUDA tensors, and this is
# the layout whose only collectives are the decode shard's all_reduces
SEQ_ONLY = {"cache_seq": "model"}


def mesh_store(name):
    d = os.path.join(HERE, "build", "mesh_phase")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, name)
    if os.path.exists(path):
        os.remove(path)
    return path


def mesh_decode_cfg(rehearse, dtype):
    """(config, batch, cache rows, valid rows) of (a)'s decode in ``dtype``:
    qwen2-0.5b's decode_32k as configured (``xla_flash``), batch 128 in
    bf16 (the 48 GiB cache), ``MESH_F32_BATCH`` in float32; its smoke
    config on the CPU."""
    from repro_torch.models.config import shape_cell
    cfg = model_config("qwen2_0p5b", rehearse, dtype=dtype)
    if rehearse:
        return cfg, (8 if dtype == "bfloat16" else 4), 64, 50
    c = shape_cell("decode_32k")
    B = c.global_batch if dtype == "bfloat16" else MESH_F32_BATCH
    return cfg, B, c.seq_len, DECODE_KV_LEN


def mesh_batch_b(B, dtype):
    """(b)'s batch: bf16 cut by the ranks (128 -> 32), float32 whole."""
    return B // MESH_WORLD if dtype == "bfloat16" else B


def fill_rows(torch, dev, bufs, kv_len, block, b0, r0, seed):
    """Fill the valid rows (< ``kv_len``) of local cache chunks ``bufs``
    ({name: (L, b, s, KV, hd)} holding global batch rows b0.. and
    sequence rows r0..) with bf16 normal draws made ``block`` batch rows
    at a time from seeded generators, so that any chunk of the same cache
    holds the same values."""
    for n, name in enumerate(sorted(bufs)):
        buf = bufs[name]
        L, b, s = buf.shape[:3]
        hi = min(r0 + s, kv_len)
        if hi <= r0:
            continue
        tmp = torch.empty((block, kv_len) + tuple(buf.shape[3:]),
                          dtype=buf.dtype, device=dev)
        for layer in range(L):
            for j in range(b0 // block, (b0 + b - 1) // block + 1):
                g = torch.Generator(dev).manual_seed(
                    SEED + 7919 * (n * L + layer) + j)
                tmp.normal_(generator=g)
                lo_b, hi_b = max(b0, j * block), min(b0 + b, (j + 1) * block)
                buf[layer, lo_b - b0:hi_b - b0, :hi - r0] = \
                    tmp[lo_b - j * block:hi_b - j * block, r0:hi]
        del tmp


def mesh_tokens(cfg, B):
    return np.random.default_rng(SEED + 20).integers(
        0, cfg.vocab_size, (B, MESH_STEPS))


def mesh_tol(torch, want):
    """A step's tolerance: ``decode_tol`` in float32; in bf16 at least
    ``MESH_BF16_TOL``: a whole bf16 model's logits move by bf16
    roundings layer after layer, beyond the one-call ``decode_tol``."""
    tol = decode_tol(torch, want)
    return max(tol, MESH_BF16_TOL) if want.dtype == torch.bfloat16 else tol


def plain_decodes(torch, dev, SV, params, cfg, cache, toks):
    """``MESH_STEPS`` unsharded decode steps from ``cache``'s state (its
    ``len`` is never advanced in place); returns (logits, step seconds)."""
    out, times = [], []
    for i in range(MESH_STEPS):
        sync(torch, dev)
        t0 = time.perf_counter()
        lg, cache = SV.decode_step(params, cfg, toks[:, i:i + 1],
                                   cache=cache)
        sync(torch, dev)
        times.append(time.perf_counter() - t0)
        out.append(lg)
    return out, times


def mesh_decode_a(torch, dev, rehearse, mesh, gpu, dtype):
    """(a) decode in ``dtype``: ``MESH_STEPS`` steps under
    ``ctx.decode_shard`` on the plan's DTensors at world 1, then the
    unsharded decode from the same cache state as configured
    (``xla_flash``), held at ``mesh_tol``.  Returns (the sharded logits
    of (b)'s rows per step on the host, lines)."""
    from repro_torch.distributed import ctx
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import step as TS
    cfg, B, S, kv_len = mesh_decode_cfg(rehearse, dtype)
    bb = mesh_batch_b(B, dtype)
    params = M.init_params(torch.Generator(dev).manual_seed(SEED + 20), cfg,
                           device=dev)
    cache = SV.init_cache(cfg, B, S, device=dev)
    t0 = time.perf_counter()
    fill_rows(torch, dev, cache["layers"], kv_len, bb, 0, 0, SEED + 21)
    cache["len"].fill_(kv_len)
    sync(torch, dev)
    fill_s = time.perf_counter() - t0
    toks = torch.as_tensor(mesh_tokens(cfg, B), device=dev)
    cell = ShapeCell("decode_32k", S, B, "decode")
    _, plan = TS.jit_step_for_cell(cfg, cell, mesh)
    dp = plan.place(params, plan.param_shardings)
    dcache = plan.place_inputs({"cache": cache})["cache"]
    check(all(dcache["layers"][k].to_local().data_ptr() ==
              cache["layers"][k].data_ptr() for k in ("k", "v")),
          "mesh (a): placing the cache on the (1, 1) mesh copied it")
    cache_bytes = sum(a.numel() * a.element_size()
                      for a in cache["layers"].values())
    reset_peak(torch, dev)
    base = torch.cuda.memory_allocated() if dev.type == "cuda" else None
    ops.reset_launch_counts()
    got, sharded = [], []
    with plan.sharder(), ctx.decode_shard(mesh):
        for i in range(MESH_STEPS):
            sync(torch, dev)
            t0 = time.perf_counter()
            lg, dcache = SV.decode_step(dp, cfg, plan.place_inputs(
                {"tokens": toks[:, i:i + 1]})["tokens"], cache=dcache)
            lg = lg.full_tensor()
            sync(torch, dev)
            sharded.append(time.perf_counter() - t0)
            got.append(lg)
    peak = None if base is None else torch.cuda.max_memory_allocated() - base
    launched = zoo_counts(ops)
    check(sum(launched.values()) == 0, f"mesh (a): the sharded decode "
          f"launched {launched} (JAX's routing: the shard path, no kernel)")
    check(int(dcache["len"].full_tensor()) == kv_len + MESH_STEPS,
          "mesh (a): the sharded decode's len")
    del dcache
    want, plain = plain_decodes(torch, dev, SV, params, cfg, cache, toks)
    check(int(cache["len"]) == kv_len, "mesh (a): the plain len moved")
    errs, tols = [], []
    for i in range(MESH_STEPS):
        errs.append(float((got[i].float() - want[i].float()).abs().max()))
        tols.append(mesh_tol(torch, want[i]))
        check(bool(torch.isfinite(got[i]).all()) and errs[-1] <= tols[-1],
              f"mesh (a) {dtype}: decode step {i} sharded vs unsharded: "
              f"max abs err {errs[-1]} (tol {tols[-1]})")
    first = [g[:bb].float().cpu() for g in got]
    del params, got, want, cache
    text = (f"mesh (a) decode, {dtype}: {cfg.name} decode_32k "
            f"({cfg.attn_impl}) over a one-rank "
            f"{'NCCL' if dev.type == 'cuda' else 'gloo'} group, mesh (1, 1): "
            f"batch {B}, a {S}-row cache of {gib(cache_bytes)} filled to "
            f"{kv_len} rows in {fill_s:.3f} s, placed as DTensors in place "
            f"(pointers unchanged); {MESH_STEPS} steps under "
            f"ctx.decode_shard {steps_text(sharded)} (first "
            f"{sharded[0] * 1e3:.3f}), peak added above cache and weights "
            f"{gib(peak)}, decode attention launched {launched}; the "
            f"unsharded decode ({cfg.attn_impl}) from the same cache state "
            f"{steps_text(plain)}")
    text += (f"; sharded vs unsharded max abs err {min(errs):.4g}-"
             f"{max(errs):.4g} against tol {min(tols):.4g}-{max(tols):.4g} "
             f"(``mesh_tol``) [{gpu}]")
    return first, [text]


def mesh_train_a(torch, dev, rehearse, mesh, gpu):
    """(a) train: qwen2-0.5b's AdamW step at 4 x 1024 through the plan at
    world 1 against ``step_for_cell`` from the same state: the loss at
    1e-4 relative, both moments (float32) within 1e-4 of each leaf's
    largest, and the new parameters within one bf16 rounding (2^-8 |p|)
    plus 1e-3 of the rate where the step can be read: the gradient at
    least 1e-2 of its leaf's largest (else a gradient near AdamW's eps
    makes the step's size a rounding) and |p| at most 64 x the rate (one
    rounding then under a quarter of the rate), where the plain step
    must have moved each weight by a quarter of the rate; ms per step of
    both."""
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import step as TS
    t = LAUNCH_TRAIN_SMALL if rehearse else LAUNCH_TRAIN
    cfg = model_config("qwen2_0p5b", rehearse, remat="none")
    cell = ShapeCell("train_4k", t["seq"], t["batch"], "train")
    lr = MESH_TRAIN_LR
    opt = adamw(lr, weight_decay=0.1)
    state = TS.init_state(torch.Generator(dev).manual_seed(SEED + 22), cfg,
                          opt, device=dev)
    batch = token_batch(torch, dev, cfg, t["batch"], t["seq"], SEED + 22)
    plain_fn = TS.step_for_cell(cfg, cell, opt)
    step, plan = TS.jit_step_for_cell(cfg, cell, mesh, opt)

    def timed(fn):
        out, times = None, []
        for _ in range(1 + MESH_TRAIN_STEPS):
            del out
            sync(torch, dev)
            t0 = time.perf_counter()
            out = fn(state, batch)
            float(out[1]["loss"])
            sync(torch, dev)
            times.append(time.perf_counter() - t0)
        return out, times

    (want, wm), plain_s = timed(plain_fn)
    reset_peak(torch, dev)
    (got, gm), plan_s = timed(step)
    peak = peak_bytes(torch, dev)
    lw, lg = float(wm["loss"]), float(gm["loss"])
    check(math.isfinite(lg) and abs(lg - lw) <= 1e-4 * abs(lw),
          f"mesh (a) train: loss {lg} through the plan, {lw} plain")
    worst_m, where = 0.0, None
    for k in ("m", "v"):
        for i, (a, b) in enumerate(zip(tree_leaves(got["opt"][k]),
                                       tree_leaves(want["opt"][k]))):
            d = float((a.full_tensor() - b).abs().max())
            d /= max(float(b.abs().max()), 1e-30)
            if d > worst_m:
                worst_m, where = d, f"{k} of leaf {i} {tuple(b.shape)}"
    check(worst_m <= 1e-4, f"mesh (a) train: the moment {where} is "
          f"{worst_m} of its largest off the plain step's (limit 1e-4)")
    worst, worst_over, held, total, moved = 0.0, -1.0, 0, 0, math.inf
    for a, b, p0, m in zip(tree_leaves(got["params"]),
                           tree_leaves(want["params"]),
                           tree_leaves(state["params"]),
                           tree_leaves(want["opt"]["m"])):
        g = m.abs()
        keep = (g >= 1e-2 * g.max()) & (p0.float().abs() <= 64 * lr)
        d = (a.full_tensor().float() - b.float()).abs()
        worst = max(worst, float(d.max()))
        held, total = held + int(keep.sum()), total + keep.numel()
        if keep.any():
            moved = min(moved, float((b.float() - p0.float()).abs()[keep]
                                     .min()))
            worst_over = max(worst_over, float(
                (d - 2.0 ** -8 * b.float().abs() - 1e-3 * lr)[keep].max()))
    check(held >= total // 10 and moved >= 0.25 * lr,
          f"mesh (a) train: the step read on {held} of {total} weights, "
          f"the plain step moving them at least {moved} (rate {lr})")
    check(worst_over <= 0, f"mesh (a) train: a parameter is off the plain "
          f"step's by 2^-8 x |p| + 1e-3 x the rate + {worst_over}")
    n_leaves = len(tree_leaves(got["params"]))
    placements = sorted({str(p.placements) for p in
                         tree_leaves(got["params"])})
    del got, want, state
    ms = median_ms(plan_s[1:])
    ms_plain = median_ms(plain_s[1:])
    return [f"mesh (a) train: {cfg.name} {t['batch']} x {t['seq']} "
            f"({cfg.dtype}, {cfg.attn_impl}, remat none) through "
            f"jit_step_for_cell on the (1, 1) mesh, AdamW at {lr}: loss "
            f"{lg:.6f} against {lw:.6f} plain, moments within {worst_m:.3g} "
            f"of their leaves' largest, largest parameter difference "
            f"{worst:.3g} over {n_leaves} leaves, the step read on {held} of "
            f"{total} weights (each moved at least {moved:.3g} by the plain "
            f"step) (placed {placements}); step median "
            f"{ms:.3f} ms (first {plan_s[0] * 1e3:.3f}, min "
            f"{min(plan_s[1:]) * 1e3:.3f}, max {max(plan_s[1:]) * 1e3:.3f}) "
            f"against step_for_cell's {ms_plain:.3f} ms (first "
            f"{plain_s[0] * 1e3:.3f}): DTensor adds {ms - ms_plain:.3f} ms a "
            f"step; peak {gib(peak)} [{gpu}]"]


def mesh_worker(rank, store, rehearse):
    """One of (b)'s ranks: a gloo group of ``MESH_WORLD`` processes on the
    one card (the CPU in rehearsal).  The sequence-sharded decode at (1, 4)
    against (a)'s logits, then the pipeline against ``run_layers``.
    Writes its numbers as JSON beside the store; returns 0."""
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import ctx
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.pipeline import make_pipelined_forward
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import ShapeCell
    from repro_torch.train import step as TS
    t_start = time.perf_counter()
    if rehearse:
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=MESH_WORLD)
    carried = {}
    inner = dist.all_reduce

    def counted(t, *a, **kw):           # which collectives gloo carries
        op = str(kw.get("op", "SUM")).split(".")[-1]
        key = f"all_reduce {op} {t.device.type} {str(t.dtype)[6:]}"
        carried[key] = carried.get(key, 0) + 1
        return inner(t, *a, **kw)
    dist.all_reduce = counted
    out = {"rank": rank}
    try:
        want_all = torch.load(os.path.join(os.path.dirname(store), "a.pt"))
        mesh = make_mesh((1, MESH_WORLD), ("data", "model"), device=dev)
        rules = {k: SEQ_ONLY.get(k) for k in SH.DEFAULT_RULES}
        for dtype in MESH_DTYPES:
            cfg, B, S, kv_len = mesh_decode_cfg(rehearse, dtype)
            bb = mesh_batch_b(B, dtype)
            _, plan = TS.jit_step_for_cell(
                cfg, ShapeCell("decode_32k_b", S, bb, "decode"), mesh,
                rules=rules)
            params = M.init_params(
                torch.Generator(dev).manual_seed(SEED + 20), cfg, device=dev)
            dp = plan.place(params, plan.param_shardings)
            s_local = S // MESH_WORLD
            local = SV.init_cache(cfg, bb, s_local, device=dev)
            fill_rows(torch, dev, local["layers"], kv_len, bb, 0,
                      rank * s_local, SEED + 21)
            local["len"].fill_(kv_len)
            dcache = SH.map_axes(
                lambda spec, t: SH.from_local(t, mesh, spec),
                plan.input_shardings["cache"], local)
            want = want_all[dtype]
            toks = torch.as_tensor(mesh_tokens(cfg, B)[:bb], device=dev)
            errs, tols, steps = [], [], []
            carried.clear()
            with plan.sharder(), ctx.decode_shard(mesh):
                for i in range(MESH_STEPS):
                    sync(torch, dev)
                    t0 = time.perf_counter()
                    lg, dcache = SV.decode_step(dp, cfg, plan.place_inputs(
                        {"tokens": toks[:, i:i + 1]})["tokens"],
                        cache=dcache)
                    lg = lg.to_local()
                    sync(torch, dev)
                    steps.append(time.perf_counter() - t0)
                    w = want[i].to(dev)
                    errs.append(float((lg.float() - w).abs().max()))
                    tols.append(mesh_tol(torch, w.to(lg.dtype)))
                    check(bool(torch.isfinite(lg).all())
                          and errs[-1] <= tols[-1],
                          f"mesh (b) rank {rank} {dtype}: decode step {i} "
                          f"logits {errs[-1]} off (a)'s (tol {tols[-1]})")
            out[dtype] = dict(errs=errs, tols=tols, steps=steps,
                              carried=dict(carried), rows=s_local, batch=bb,
                              cache_gib=sum(
                                  t.numel() * t.element_size()
                                  for t in local["layers"].values()) / 2**30)
            del dp, dcache, local, params

        p = MESH_PIPE_SMALL if rehearse else MESH_PIPE
        pcfg = model_config("qwen2_0p5b", rehearse, dtype="bfloat16")
        if rehearse:                  # 4 stages of one layer
            pcfg = dataclasses.replace(pcfg, n_layers=MESH_WORLD)
        pmesh = make_mesh((MESH_WORLD,), ("pod",), device=dev)
        pp = M.init_params(torch.Generator(dev).manual_seed(SEED + 23), pcfg,
                           device=dev)
        x = torch.randn((p["micro"], p["batch"], p["seq"], pcfg.d_model),
                        generator=torch.Generator(dev).manual_seed(SEED + 24),
                        device=dev, dtype=torch.bfloat16)
        fn = make_pipelined_forward(pcfg, pmesh, pipe_axis="pod",
                                    n_micro=p["micro"])
        carried.clear()
        sync(torch, dev)
        t0 = time.perf_counter()
        outs = fn(pp["layers"], x)
        sync(torch, dev)
        pipe_s = time.perf_counter() - t0
        pipe_carried = dict(carried)
        with torch.no_grad():
            ref = torch.stack([M.run_layers(pp["layers"], x[m], pcfg)[0]
                               for m in range(p["micro"])])
        err = float((outs.float() - ref.float()).abs().max())
        tol = decode_tol(torch, ref)
        check(err <= tol, f"mesh (b) rank {rank}: the pipeline is {err} off "
              f"run_layers (tol {tol})")
        host = x.is_cuda and dist.get_backend(pmesh.get_group("pod")) == "gloo"
        out["pipe"] = dict(err=err, tol=tol, s=pipe_s, carried=pipe_carried,
                           layers=pcfg.n_layers, host=host, **p)
        out["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(os.path.dirname(store), f"rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_ranks(torch, rehearse, gpu):
    """(b): ``MESH_WORLD`` processes of this script on the one card over
    gloo (``mesh_worker``).  Any rank that exits non-zero, or a phase
    over ``MESH_B_LIMIT_S``, fails the smoke; every process is stopped."""
    store = mesh_store("store_b")
    d = os.path.dirname(store)
    for r in range(MESH_WORLD):
        if os.path.exists(os.path.join(d, f"rank{r}.json")):
            os.remove(os.path.join(d, f"rank{r}.json"))
    cmd = [sys.executable, os.path.abspath(__file__), "--mesh-worker"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + [str(r), store] +
                              (["--rehearse"] if rehearse else []),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(MESH_WORLD)]
    outs = []
    try:
        for p in procs:
            left = MESH_B_LIMIT_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1))[0])
    except subprocess.TimeoutExpired:
        raise SmokeError(f"mesh (b): the ranks did not finish within "
                         f"{MESH_B_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, o) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"mesh (b): rank {r} exited "
              f"{p.returncode}:\n{o[-3000:]}")
    res = []
    for r in range(MESH_WORLD):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    lines = []
    for dtype in MESH_DTYPES:
        dec = [x[dtype] for x in res]
        errs = [e for x in dec for e in x["errs"]]
        tols = [t for x in dec for t in x["tols"]]
        steps = [s for x in dec for s in x["steps"][1:]]
        lines.append(
            f"mesh (b) decode, {dtype}: {MESH_WORLD} processes on the one "
            f"card over gloo, mesh (1, {MESH_WORLD}) (cache split on "
            f"sequence, the rest replicated): batch {dec[0]['batch']}, "
            f"{dec[0]['rows']} cache rows and {dec[0]['cache_gib']:.3f} GiB "
            f"a rank; {MESH_STEPS} steps, every rank's logits against (a)'s "
            f"world-1 logits: max abs err {min(errs):.4g}-{max(errs):.4g}, "
            f"tol {min(tols):.4g}-{max(tols):.4g}; steps 2+ "
            f"{steps_text(steps)} over the ranks; gloo carried "
            f"{dec[0]['carried']} (rank 0) [{gpu}]")
    pipe = [x["pipe"] for x in res]
    pl = pipe[0]
    return lines + [
        f"mesh (b) pipeline: {pl['layers']} layers as {MESH_WORLD} stages of "
        f"{pl['layers'] // MESH_WORLD}, {pl['micro']} microbatches of "
        f"{pl['batch']} x {pl['seq']} bf16: within {max(x['err'] for x in pipe):.3g} "
        f"of run_layers (tol {pl['tol']:.3g}) on every rank; "
        f"{max(x['s'] for x in pipe):.3f} s; gloo carried {pl['carried']}, "
        f"the activations {'through pinned host buffers' if pl['host'] else 'as they are'}"
        f" (batch_isend_irecv of CPU tensors); the ranks {wall:.1f} s from "
        f"start to exit (limit {MESH_B_LIMIT_S})"]


def mesh_phase(torch, dev, rehearse, gpu):
    """Phase 20: (a) the mesh path at world 1 (NCCL on the card, gloo on
    the CPU), mesh (1, 1): qwen2-0.5b's decode_32k under ``decode_shard``
    and its train step through the plan, each against the one-card path;
    (b) four ranks on the one card over gloo.  Returns its lines."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed(dev, init_file=mesh_store("store_a"), rank=0,
                     world_size=1)
    try:
        check(dist.get_backend() == ("nccl" if dev.type == "cuda"
                                     else "gloo"),
              f"mesh (a): backend {dist.get_backend()}")
        mesh = make_host_mesh(dev)
        first, lines = {}, []
        for dtype in MESH_DTYPES:
            first[dtype], more = mesh_decode_a(torch, dev, rehearse, mesh,
                                               gpu, dtype)
            lines += more
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        torch.save(first, mesh_store("a.pt"))
        lines += mesh_train_a(torch, dev, rehearse, mesh, gpu)
    finally:
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lines += mesh_ranks(torch, rehearse, gpu)
    lines.append(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return lines


# ---------------------------------------------------------------------------
# every family's steps over a mesh, and the dry-run's per-rank peaks
# (phase 21)
# ---------------------------------------------------------------------------

FAM_WORLD = 4                  # (b): ranks sharing the one card over gloo
FAM_B_LIMIT_S = 300            # (b)'s ranks, from start to exit
FAM_STEPS = 4                  # (a)'s decode steps
FAM_B_STEPS = 2                # (b)'s decode steps and train steps
FAM_LR = 1e-3                  # AdamW's rate in (b)'s train steps
FAM_PEAK_TOL = 0.15            # (c): predicted against measured peaks
# (a): serving at full width and depth in bf16 (grok-1-314b at 2 of 64
# layers, as phase 14 serves it) through the plan at world 1: (batch,
# prompt tokens, cache rows); hymba's prompt and four steps pass its
# 1,024-row window (the 1,048-row cell makes a ring of 1,024 rows, which
# step 3 wraps); paligemma's rows hold its 256 patch embeddings too
FAM_A = {
    "granite": dict(name="granite_moe_3b_a800m", over={}, size=(4, 256, 264),
                    small=(2, 24, 32)),
    "grok": dict(name="grok_1_314b", over=dict(n_layers=2),
                 size=(4, 128, 136), small=(2, 24, 32)),
    "rwkv": dict(name="rwkv6_3b", over={}, size=(4, 256, 264),
                 small=(2, 24, 32)),
    "hymba": dict(name="hymba_1p5b", over={}, size=(4, 1022, 1048),
                  small=(2, 15, 32), rehearse=dict(sliding_window=16)),
    "whisper": dict(name="whisper_base", over={}, size=(4, 64, 72),
                    small=(2, 24, 32)),
    "paligemma": dict(name="paligemma_3b", over={}, size=(4, 64, 328),
                      small=(2, 8, 32)),
}
# the kernels each family's serving must launch on the card
FAM_KERNELS = {"rwkv": ("rwkv6_scan_bhtk",),
               "granite": ("decode_attention_bkgd",),
               "paligemma": ("decode_attention_bkgd",),
               "whisper": ("flash_attention_bhsd", "decode_attention_bkgd")}
# (b): five families at full width, 2 layers, float32, on the (2, 2)
# mesh: the train steps' batch x sequence, and each serving cell's
# prompt and cache rows (hymba's cache a ring at its window; paligemma's
# rows hold 256 patch embeddings and the prompt)
FAM_B = ("granite", "rwkv", "hymba", "whisper", "paligemma")
FAM_B_TRAIN = (4, 64)
FAM_B_SERVE = {"hymba": (1023, 1048), "paligemma": (30, 288)}
FAM_B_SERVE_SMALL = {"hymba": (1023, 1048), "paligemma": (14, 32)}
FAM_B_DEFAULT = (30, 32)
FAM_MOE_GROUPS = 2             # the (2, 2) plan's routing groups (data)


def fam_cfg(key, rehearse, **over):
    """(a)'s config of ``key``: full width and depth (its depth cut),
    smoke on the CPU."""
    spec = FAM_A[key]
    o = dict(spec["over"])
    if rehearse:
        o = dict(spec.get("rehearse", {}))
    o.update(over)
    return model_config(spec["name"], rehearse, **o)


def fam_b_cfgs(key, rehearse):
    """(b)'s configs of ``key``: full width, 2 layers, float32; the train
    steps under ``xla_flash`` (no kernel has a backward), serving under
    ``pallas``."""
    o = dict(dtype="float32", n_layers=2)
    name = FAM_A[key]["name"]
    return (model_config(name, rehearse, attn_impl="xla_flash", **o),
            model_config(name, rehearse, attn_impl="pallas", **o))


def fam_b_serve(key, rehearse):
    return (FAM_B_SERVE_SMALL if rehearse else FAM_B_SERVE).get(
        key, FAM_B_DEFAULT)


def fam_inputs(torch, dev, cfg, B, P, seed, labels=False):
    """A step's inputs from ``seed``: int32 tokens (B, P) (and labels),
    the VLM's stub patch embeddings (``specs.batch_inputs``: S // 2 of a
    train cell, all ``vlm_prefix`` before a prompt), an encoder-decoder's
    frames (B, enc_len, d)."""
    import torch as _t
    g = _t.Generator(dev).manual_seed(seed)
    dt = getattr(_t, cfg.dtype)
    out = {}
    if cfg.vlm_prefix:
        p = min(cfg.vlm_prefix, P // 2) if labels else cfg.vlm_prefix
        P = P - p if labels else P
        out["embeds"] = _t.randn((B, p, cfg.d_model), generator=g,
                                 device=dev).to(dt)
    if cfg.enc_dec:
        out["frames"] = _t.randn((B, cfg.enc_len, cfg.d_model), generator=g,
                                 device=dev).to(dt)
    out["tokens"] = _t.randint(0, cfg.vocab_size, (B, P), generator=g,
                               device=dev, dtype=_t.int32)
    if labels:
        out["labels"] = _t.randint(0, cfg.vocab_size, (B, P), generator=g,
                                   device=dev, dtype=_t.int32)
    return out


def fam_tokens(torch, dev, cfg, B, n, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, n), generator=g, device=dev,
                         dtype=torch.int32)


def whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def fam_serve(torch, dev, cfg, params, inputs, rows, toks, steps=None):
    """A prefill and one decode step per column of ``toks``, through the
    plan's ``steps`` (prefill, decode) or the unsharded serving calls.
    Returns (the logits of each call, whole, float32, its seconds)."""
    from repro_torch.models import serve as SV
    B = inputs["tokens"].shape[0]
    cache = SV.init_cache(cfg, B, rows, device=dev)
    out, secs = [], []
    for i in range(1 + toks.shape[1]):
        sync(torch, dev)
        t0 = time.perf_counter()
        if i == 0 and steps is None:
            lg, cache, _ = SV.prefill(params, cfg, inputs["tokens"],
                                      cache=cache,
                                      embeds=inputs.get("embeds"),
                                      frames=inputs.get("frames"))
        elif i == 0:
            lg, cache = steps[0](params, dict(inputs, cache=cache))
        elif steps is None:
            lg, cache = SV.decode_step(params, cfg, toks[:, i - 1:i],
                                       cache=cache)
        else:
            lg, cache = steps[1](params, {"tokens": toks[:, i - 1:i],
                                         "cache": cache})
        lg = whole(lg).float()
        sync(torch, dev)
        secs.append(time.perf_counter() - t0)
        out.append(lg)
    return out, secs


def fam_serving_a(torch, dev, rehearse, mesh, key, gpu):
    """(a) serving: a prefill and ``FAM_STEPS`` decode steps of ``key``
    in bf16 through ``jit_step_for_cell`` on the (1, 1) mesh, against the
    unsharded calls on the same weights and inputs (``mesh_tol``); step
    ms, peak, launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import step as TS
    cfg = fam_cfg(key, rehearse, attn_impl="pallas")
    B, P, R = FAM_A[key]["small" if rehearse else "size"]
    seed = SEED + 40 + list(FAM_A).index(key)
    params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                           device=dev)
    inputs = fam_inputs(torch, dev, cfg, B, P, seed)
    toks = fam_tokens(torch, dev, cfg, B, FAM_STEPS, seed)
    steps = tuple(TS.jit_step_for_cell(cfg, ShapeCell(k, R, B, k), mesh)[0]
                  for k in ("prefill", "decode"))
    reset_peak(torch, dev)
    ops.reset_launch_counts()
    got, secs = fam_serve(torch, dev, cfg, params, inputs, R, toks, steps)
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    peak = peak_bytes(torch, dev)
    want, plain = fam_serve(torch, dev, cfg, params, inputs, R, toks)
    errs, tols = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        errs.append(float((g - w).abs().max()))
        tols.append(mesh_tol(torch, w.to(getattr(torch, cfg.dtype))))
        check(bool(torch.isfinite(g).all()) and errs[-1] <= tols[-1],
              f"families (a) {key}: call {i} through the plan is "
              f"{errs[-1]} off the unsharded one (tol {tols[-1]})")
    if not rehearse:
        for name in FAM_KERNELS.get(key, ()):
            check(launched.get(name, 0) > 0, f"families (a) {key}: {name} "
                  f"was not launched through the plan ({launched})")
    n_par = sum(t.numel() for t in tree_leaves(params))
    del params, got, want, steps
    return launched, (
        f"families (a) {key}: {cfg.name} ({cfg.n_layers} layers, "
        f"{n_par / 1e9:.3f} B parameters, {cfg.dtype}, {cfg.attn_impl}) "
        f"through jit_step_for_cell on the (1, 1) mesh: batch {B}, prompt "
        f"{P} into a {R}-row cache; prefill {secs[0] * 1e3:.3f} ms, "
        f"{FAM_STEPS} decode steps {steps_text(secs[1:])}; unsharded "
        f"prefill {plain[0] * 1e3:.3f} ms, decode {steps_text(plain[1:])}; "
        f"logits max abs err {min(errs):.4g}-{max(errs):.4g} (tol "
        f"{min(tols):.4g}); peak {gib(peak)}; launches {launched} [{gpu}]")


def fam_train_batches(torch, dev, cfg, seed):
    B, S = FAM_B_TRAIN
    return [fam_inputs(torch, dev, cfg, B, S, seed + i, labels=True)
            for i in range(FAM_B_STEPS)]


def fam_reference_a(torch, dev, rehearse, mesh, key, gpu):
    """(a) float32, 2 layers: ``key``'s unsharded train steps (with the
    (2, 2) plan's routing groups) and serving calls, (b)'s references;
    and its serving through the plan at world 1 against them at 1e-4.
    Returns ((b)'s references on the host, lines)."""
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    tcfg, scfg = fam_b_cfgs(key, rehearse)
    seed = SEED + 50 + FAM_B.index(key)
    params = M.init_params(torch.Generator(dev).manual_seed(seed), tcfg,
                           device=dev)
    opt = adamw(FAM_LR, weight_decay=0.1)
    step = TS.build_train_step(tcfg, opt, moe_groups=FAM_MOE_GROUPS)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    ref = {"loss": [], "aux": [], "grad_norm": []}
    for batch in fam_train_batches(torch, dev, tcfg, seed):
        state, met = step(state, batch)
        for k in ref:
            ref[k].append(float(met[k]))
    del state
    P, R = fam_b_serve(key, rehearse)
    B = FAM_B_TRAIN[0]
    inputs = fam_inputs(torch, dev, scfg, B, P, seed)
    toks = fam_tokens(torch, dev, scfg, B, FAM_B_STEPS, seed)
    want, _ = fam_serve(torch, dev, scfg, params, inputs, R, toks)
    steps = tuple(TS.jit_step_for_cell(scfg, ShapeCell(k, R, B, k), mesh)[0]
                  for k in ("prefill", "decode"))
    got, _ = fam_serve(torch, dev, scfg, params, inputs, R, toks, steps)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= 1e-4, f"families (a) {key} float32: the plan's logits at "
          f"world 1 are {err} off the unsharded ones (tol 1e-4)")
    ref["logits"] = [w.cpu() for w in want]
    del params, got, want, steps
    return ref, [f"families (a) {key} float32 ({scfg.n_layers} layers, full "
                 f"width): prefill + {FAM_B_STEPS} decode steps through the "
                 f"plan at world 1 within {err:.3g} of the unsharded calls "
                 f"(tol 1e-4); unsharded train losses "
                 f"{[round(x, 6) for x in ref['loss']]}, gradient norms "
                 f"{[round(x, 5) for x in ref['grad_norm']]} (routing groups "
                 f"{FAM_MOE_GROUPS}) [{gpu}]"]


def blocking_collectives():
    """A dispatch mode that runs DTensor's functional collectives
    (``_c10d_functional.*``) as the blocking ``torch.distributed`` calls,
    with ``wait_tensor`` the identity.  torch 2.11's functional
    collectives over gloo crash on CUDA tensors in ``wait_tensor``
    (a segmentation fault on the H100), while gloo's blocking
    all_gather / reduce_scatter / all_to_all / all_reduce carry them; so
    (b)'s ranks, which share one card over gloo, run DTensor under it.
    DTensor ops are declined (they come back as local ops)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}

    # each collective on host copies (gloo's own CUDA forms stage through
    # the host too)
    def gather(x, n, name):
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype)
        dist.all_gather_into_tensor(out, x.cpu().contiguous(),
                                    group=_resolve_process_group(name))
        return out.to(x.device)

    def scatter(x, op, n, name):
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype)
        dist.reduce_scatter_tensor(out, x.cpu().contiguous(), op=ops[op],
                                   group=_resolve_process_group(name))
        out = out.to(x.device)
        return out / n if op == "avg" else out

    def reduce(x, op, name):
        out = x.cpu().clone()
        g = _resolve_process_group(name)
        dist.all_reduce(out, op=ops[op], group=g)
        out = out.to(x.device)
        return out / g.size() if op == "avg" else out

    def to_all(x, out_sizes, in_sizes, name):
        g = _resolve_process_group(name)
        shape = (sum(out_sizes),) if out_sizes else (x.shape[0],)
        out = torch.empty(shape + tuple(x.shape[1:]), dtype=x.dtype)
        dist.all_to_all_single(out, x.cpu().contiguous(), out_sizes or None,
                               in_sizes or None, group=g)
        return out.to(x.device)

    impls = {"all_gather_into_tensor": gather,
             "reduce_scatter_tensor": scatter, "all_reduce": reduce,
             "all_to_all_single": to_all,
             "wait_tensor": lambda x: x}

    class Blocking(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = func._schema.name.split("::")[-1]
            if func.namespace == "_c10d_functional" and name in impls:
                out = impls[name](*args, **(kwargs or {}))
            else:
                check(func.namespace != "_c10d_functional" or "wrap" in name,
                      f"families (b): no blocking form of {name}")
                out = func(*args, **(kwargs or {}))
            return out
    return Blocking()


def fam_worker(rank, store, rehearse):
    """One of (b)'s ranks: a gloo group of ``FAM_WORLD`` processes on the
    one card (the CPU in rehearsal), the (2, 2) mesh.  Per family of
    ``FAM_B``: a prefill and ``FAM_B_STEPS`` decode steps (``pallas``)
    and ``FAM_B_STEPS`` AdamW train steps (``xla_flash``) through
    ``jit_step_for_cell``, logits and metrics against (a)'s unsharded
    ones, each call's peak device memory (all the rank holds: the
    arguments and what the step makes).  Writes its numbers as JSON
    beside the store; returns 0."""
    sys.path.insert(0, SRC)
    import logging
    import torch
    import torch.distributed as dist
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    t_start = time.perf_counter()
    if rehearse:
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=FAM_WORLD)
    d = os.path.dirname(store)
    out = {"rank": rank}

    def note(what):                 # shown only where a rank fails
        if dev.type == "cuda":
            print(f"rank {rank} {what}: allocated "
                  f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
                  flush=True)
    try:
        want_all = torch.load(os.path.join(d, "fam_a.pt"))
        mesh = make_mesh((2, 2), ("data", "model"), device=dev)
        mode = blocking_collectives()
        # cuBLAS takes its workspaces from the caching allocator at its
        # first products and holds them: no tensor a step makes, so the
        # dry-run does not count them; measured once, left out of (c)
        base = torch.cuda.memory_allocated() if dev.type == "cuda" else 0
        x = torch.ones((64, 64), device=dev)
        y = torch.addmm(x, x, x) + torch.bmm(x[None], x[None])[0] + x @ x
        del x, y
        sync(torch, dev)
        out["blas_workspace"] = (torch.cuda.memory_allocated() - base
                                 if dev.type == "cuda" else 0)
        for key in FAM_B:
            tcfg, scfg = fam_b_cfgs(key, rehearse)
            want = want_all[key]
            seed = SEED + 50 + FAM_B.index(key)
            rec, P, R = {}, *fam_b_serve(key, rehearse)
            B, S = FAM_B_TRAIN
            params = M.init_params(torch.Generator(dev).manual_seed(seed),
                                   tcfg, device=dev)
            opt = adamw(FAM_LR, weight_decay=0.1)
            step, plan = TS.jit_step_for_cell(
                tcfg, ShapeCell("train", S, B, "train"), mesh, opt)
            note(f"{key} drawn")
            placed = plan.place(params, plan.param_shardings)
            del params
            note(f"{key} placed")
            inputs = fam_inputs(torch, dev, scfg, B, P, seed)
            toks = fam_tokens(torch, dev, scfg, B, FAM_B_STEPS, seed)
            steps = tuple(TS.jit_step_for_cell(
                scfg, ShapeCell(k, R, B, k), mesh)[0]
                for k in ("prefill", "decode"))
            from repro_torch.models import serve as SV
            cache = SV.init_cache(scfg, B, R, device=dev)
            ops.reset_launch_counts()
            errs, secs, peaks = [], [], []
            with mode:
                for i in range(1 + FAM_B_STEPS):
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                    reset_peak(torch, dev)
                    t0 = time.perf_counter()
                    if i == 0:
                        lg, cache = steps[0](placed, dict(inputs, cache=cache))
                    else:
                        lg, cache = steps[1](placed, {
                            "tokens": toks[:, i - 1:i], "cache": cache})
                    sync(torch, dev)
                    secs.append(time.perf_counter() - t0)
                    peaks.append(peak_bytes(torch, dev))
                    note(f"{key} serving call {i}")
                    lg = whole(lg).float()
                    errs.append(float((lg.cpu() - want["logits"][i])
                                      .abs().max()))
                    check(bool(torch.isfinite(lg).all()) and errs[-1] <= 1e-4,
                          f"families (b) rank {rank} {key}: call {i}'s "
                          f"logits are {errs[-1]} off (a)'s (tol 1e-4)")
                    del lg
            rec["launched"] = {k: n for k, n in ops.launch_counts().items()
                               if n}
            rec.update(serve_err=max(errs), serve_s=secs, serve_peaks=peaks,
                       cache_rows=R, prompt=P)
            del cache, steps
            state = {"params": placed, "opt": opt.init(placed),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)}
            del placed
            tsecs, tpeaks, metrics = [], [], []
            with mode:
                for batch in fam_train_batches(torch, dev, tcfg, seed):
                    if dev.type == "cuda":
                        torch.cuda.empty_cache()
                    reset_peak(torch, dev)
                    t0 = time.perf_counter()
                    state, met = step(state, batch)
                    loss = float(met["loss"])
                    tsecs.append(time.perf_counter() - t0)
                    tpeaks.append(peak_bytes(torch, dev))
                    note(f"{key} train step")
                    metrics.append({k: float(v) for k, v in met.items()})
                    del batch
            # the losses (and MoE aux losses) of both steps at 1e-4; the
            # first step's gradient norm, from the same parameters, at
            # 1e-4 of its size (the second's starts from parameters that
            # AdamW's eps moved by a rounding wherever a gradient is tiny)
            for i, m in enumerate(metrics):
                for k in ("loss", "aux", "grad_norm")[:3 - i]:
                    w = want[k][i]
                    tol = 1e-4 * max(1.0, abs(w)) if k == "grad_norm" \
                        else 1e-4
                    check(math.isfinite(m[k]) and abs(m[k] - w) <= tol,
                          f"families (b) rank {rank} {key}: train step {i}'s "
                          f"{k} {m[k]} against (a)'s {w} (tol {tol})")
            rec.update(train=metrics, train_s=tsecs, train_peaks=tpeaks)
            out[key] = rec
            del state
            if dev.type == "cuda":
                rec["left_allocated"] = torch.cuda.memory_allocated()
        out["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(d, f"fam{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def fam_dryrun(path, rehearse):
    """(c), in a process of its own (the fake process group): the mesh
    dry-run of (b)'s calls at (2, 2), each rank 0's predicted peak; then
    qwen2-0.5b's and qwen2-72b's decode_32k on the (16, 16) mesh of 256
    ranks (``launch.dryrun.run_cell``).  Writes JSON to ``path``."""
    sys.path.insert(0, SRC)
    import logging
    import torch
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import specs as SPECS
    from repro_torch.models.config import ShapeCell
    meta = torch.device("meta")
    MESH.init_fake(FAM_WORLD)
    mesh = MESH.make_mesh((2, 2), ("data", "model"))
    out = {"torch": torch.__version__}
    for key in FAM_B:
        tcfg, scfg = fam_b_cfgs(key, rehearse)
        B, S = FAM_B_TRAIN
        P, R = fam_b_serve(key, rehearse)
        t0 = time.perf_counter()
        train = D.analyse(tcfg, ShapeCell("train", S, B, "train"), mesh)
        cache = SPECS.input_specs(scfg, ShapeCell("d", R, B, "decode"))
        pre = {k: v.to(meta) for k, v in fam_inputs(
            torch, torch.device("cpu"), scfg, B, P, 0).items()}
        prefill = D.analyse(scfg, ShapeCell("prefill", R, B, "prefill"),
                            mesh, inputs=dict(pre, cache=cache["cache"]))
        decode = D.analyse(scfg, ShapeCell("decode", R, B, "decode"), mesh)
        out[key] = {"train": train["peak_bytes"],
                    "prefill": prefill["peak_bytes"],
                    "decode": decode["peak_bytes"],
                    "kernel_calls": prefill["kernel_calls"],
                    "s": time.perf_counter() - t0}
    for arch in ("qwen2_0p5b", "qwen2_72b"):
        t0 = time.perf_counter()
        rec = D.run_cell(arch, "decode_32k", mesh="single")
        out[arch] = {"status": rec["status"],
                     "argument_gib": rec["memory"]["argument_bytes"] / 2**30,
                     "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
                     "fits_hbm": rec["memory"]["fits_hbm"],
                     "collectives": rec["collectives"]["total"]["count"],
                     "s": time.perf_counter() - t0}
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def dev_cuda(res):
    return res[0].get("blas_workspace", 0) > 0


def fam_ranks(torch, rehearse, gpu, refs):
    """(b) and (c) side by side: ``FAM_WORLD`` processes of this script
    on the one card over gloo (``fam_worker``) and one dry-run process
    (``fam_dryrun``).  Any that exits non-zero, or (b) past
    ``FAM_B_LIMIT_S``, fails the smoke; every process is stopped."""
    store = mesh_store("store_fam")
    d = os.path.dirname(store)
    for r in range(FAM_WORLD):
        if os.path.exists(os.path.join(d, f"fam{r}.json")):
            os.remove(os.path.join(d, f"fam{r}.json"))
    dry = os.path.join(d, "fam_dryrun.json")
    extra = ["--rehearse"] if rehearse else []
    me = [sys.executable, os.path.abspath(__file__)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(me + ["--families-worker", str(r), store] +
                              extra, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(FAM_WORLD)]
    procs.append(subprocess.Popen(me + ["--families-dryrun", dry] + extra,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            left = FAM_B_LIMIT_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1))[0])
    except subprocess.TimeoutExpired:
        raise SmokeError(f"families (b): the ranks did not finish within "
                         f"{FAM_B_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    bad = [f"{f'rank {r}' if r < FAM_WORLD else 'the dry-run'} exited "
           f"{p.returncode}:\n" + "\n".join(
               [x for x in o.splitlines() if x.startswith(f"rank {r} ")][-8:])
           + f"\n{o[-1500:]}"
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    check(not bad, "families (b)/(c): " + "\n".join(bad))
    res = []
    for r in range(FAM_WORLD):
        with open(os.path.join(d, f"fam{r}.json")) as f:
            res.append(json.load(f))
    with open(dry) as f:
        pred = json.load(f)
    lines, worst = [], 0.0
    for key in FAM_B:
        recs = [x[key] for x in res]
        r0 = recs[0]
        launched = r0["launched"]
        if not rehearse:
            for name in FAM_KERNELS.get(key, ()):
                check(all(x["launched"].get(name, 0) > 0 for x in recs),
                      f"families (b) {key}: {name} was not launched on "
                      f"every rank's chunk ({[x['launched'] for x in recs]})")
        cmp = []
        for what, got in (("prefill", [x["serve_peaks"][0] for x in recs]),
                          ("decode", [x["serve_peaks"][1] for x in recs]),
                          ("train", [x["train_peaks"][0] for x in recs])):
            want = pred[key][what]
            if got[0] is None:
                cmp.append(f"{what} predicted {gib(want)}")
                continue
            got = [g - x["blas_workspace"] for g, x in zip(got, res)]
            off = max(abs(g - want) / g for g in got)
            worst = max(worst, off)
            cmp.append(f"{what} predicted {gib(want)} measured "
                       f"{gib(min(got))}-{gib(max(got))} less the workspace "
                       f"({off:.1%} off)")
            check(off <= FAM_PEAK_TOL, f"families (c) {key}: the dry-run's "
                  f"{what} peak {want} is {off:.1%} off the ranks' "
                  f"{got} (limit {FAM_PEAK_TOL:.0%})")
        tr = r0["train"]
        lines.append(
            f"families (b) {key}: {FAM_WORLD} processes on the one card over "
            f"gloo, mesh (2, 2), 2 layers at full width in float32: "
            f"prefill of {r0['prompt']} into {r0['cache_rows']} rows + "
            f"{FAM_B_STEPS} decode steps (pallas) within "
            f"{max(x['serve_err'] for x in recs):.3g} of (a)'s unsharded "
            f"logits (tol 1e-4), {FAM_B_STEPS} train steps {FAM_B_TRAIN} "
            f"(xla_flash, AdamW {FAM_LR}) losses "
            f"{[round(m['loss'], 6) for m in tr]} (a)'s "
            f"{[round(x, 6) for x in refs[key]['loss']]}, grad norms "
            f"{[round(m['grad_norm'], 5) for m in tr]} (a)'s "
            f"{[round(x, 5) for x in refs[key]['grad_norm']]}; rank 0 prefill {r0['serve_s'][0] * 1e3:.1f} ms, decode "
            f"{[round(x * 1e3, 1) for x in r0['serve_s'][1:]]} ms, train "
            f"{[round(x * 1e3, 1) for x in r0['train_s']]} ms; launches on "
            f"rank 0's chunk {launched}; (c) per-rank peaks: "
            f"{'; '.join(cmp)} [{gpu}]")
    for arch in ("qwen2_0p5b", "qwen2_72b"):
        q = pred[arch]
        check(q["status"] == "ok", f"families (c): {arch} decode_32k on "
              f"(16, 16): {q['status']}")
        lines.append(
            f"families (c) {arch} decode_32k on the (16, 16) mesh of 256 "
            f"fake ranks (torch {pred['torch']}): {q['argument_gib']:.4f} "
            f"GiB of arguments a rank, peak {q['peak_gib']:.4f} GiB (fits "
            f"80 GiB: {q['fits_hbm']}), {q['collectives']} collectives, "
            f"analysed in {q['s']:.1f} s")
    lines.append(f"families (b)/(c): the ranks and the dry-run {wall:.1f} s "
                 f"from start to exit (limit {FAM_B_LIMIT_S}); worst peak "
                 f"gap {worst:.1%} (measured peaks less cuBLAS's workspace, "
                 f"{gib(res[0]['blas_workspace'] if dev_cuda(res) else None)}"
                 f" a rank); rank 0 {res[0]['seconds']:.1f} s")
    return lines


def families_phase(torch, dev, rehearse, gpu):
    """Phase 21: (a) each family's serving through the plan at world 1
    (NCCL on the card, gloo on the CPU), mesh (1, 1), in bf16 at full
    depth and in float32 at 2 layers, against the unsharded calls; (b)
    four ranks on the one card over gloo at (2, 2); (c) the mesh dry-run
    beside (b).  Prints (a)'s lines as they come; returns (the launches
    of (a)'s bf16 serving, the lines of (b) and (c))."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed(dev, init_file=mesh_store("store_fam_a"), rank=0,
                     world_size=1)
    lines, launches, refs = [], {}, {}
    try:
        mesh = make_host_mesh(dev)
        for key in FAM_A:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            got, line = fam_serving_a(torch, dev, rehearse, mesh, key, gpu)
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
            print(line, flush=True)
        for key in FAM_B:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            refs[key], more = fam_reference_a(torch, dev, rehearse, mesh, key,
                                              gpu)
            print(*more, sep="\n", flush=True)
        torch.save(refs, mesh_store("fam_a.pt"))
    finally:
        dist.destroy_process_group()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lines += fam_ranks(torch, rehearse, gpu, refs)
    lines.append(f"families phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, lines


# ---------------------------------------------------------------------------
# fleet serving over a ("stream",) mesh (phase 22)
# ---------------------------------------------------------------------------

FLEET_WORLD = 4                  # (b)'s ranks on the one card
FLEET_B_LIMIT_S = 120            # (b) from start to exit
FLEET_FALLBACK_STREAMS = 6       # does not divide over FLEET_WORLD ranks
FLEET_REDUCE_TOL = 1e-12         # distributed_reduce vs the merge, float64
FLEET_KERNELS = ("spatial_stats_bgc", "spatial_stats_rows_bgc",
                 "cam_head_bgd", "flash_attention_bhsd")


def fleet_filter_path():
    d = os.path.join(HERE, "build", "fleet_mesh")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "filter.pt")


def save_filter(torch, tf, path):
    """The trained filter (pallas trunk) for phase 22's processes."""
    from repro_torch.optim.optimizers import tree_map
    torch.save({"params": tree_map(lambda t: t.detach().cpu(), tf.params),
                "trunk_cfg": tf.trunk_cfg, "spec": tf.spec,
                "count_scale": tf.count_scale}, path)


def load_filter(torch, path, dev):
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.train.filter_train import TrainedFilter
    d = torch.load(path, weights_only=False)
    return TrainedFilter(params=tree_map(lambda t: t.to(dev), d["params"]),
                         trunk_cfg=d["trunk_cfg"], spec=d["spec"],
                         losses=[], count_scale=d["count_scale"])


def answers_differ(got, want):
    """The streams whose per-frame answers or window hits differ."""
    return sorted(sid for sid in want if got.get(sid) != want[sid])


def stats_spy(torch, SP, ops, keep_first):
    """Wraps the plan's two stats entry points: records each full-batch
    call's frames and each compacted call's frames and largest row id;
    with ``keep_first``, the first full call's inputs and output."""
    seen = {"full": [], "rows": [], "first": None}
    full, rows_fn = ops.spatial_stats_inline, ops.spatial_stats_rows_inline

    def full_spy(grid, tau=0.2, *, classes=None):
        out = full(grid, tau, classes=classes)
        seen["full"].append(int(grid.shape[0]))
        if keep_first and seen["first"] is None:
            seen["first"] = (grid.clone(), tau, None if classes is None
                             else classes.clone(), out.clone())
        return out

    def rows_spy(grid, rows, tau=0.2, *, classes=None):
        seen["rows"].append((int(grid.shape[0]), int(rows.max())))
        return rows_fn(grid, rows, tau, classes=classes)

    ops.spatial_stats_inline = full_spy
    ops.spatial_stats_rows_inline = rows_spy

    def first_vs_plain():
        if seen["first"] is None:
            return None
        grid, tau, classes, out = seen["first"]
        want = SP.spatial_stats_plain(grid.contiguous(), tau, classes=classes)
        return bool(torch.equal(out, want)), tuple(grid.shape)

    def restore():
        ops.spatial_stats_inline, ops.spatial_stats_rows_inline = \
            full, rows_fn
    return seen, first_vs_plain, restore


def fleet_mesh_a(torch, dev, scene, ref, gpu, rehearse):
    """(a) The fleet phase's streams through the group engine over a
    ``("stream",)`` mesh of one rank (NCCL on the card, a gloo control
    group beside it), both passes, against the one-card fleet's
    answers bit for bit.  Returns (launches, answers, lines)."""
    import torch.distributed as dist
    from repro_torch.core import costmodel as CM
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import init_distributed
    S = FLEET_STREAMS_REHEARSE if rehearse else FLEET_STREAMS
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    init_distributed(dev, init_file=mesh_store("store_fleet_a"), rank=0,
                     world_size=1)
    try:
        mesh = SH.stream_mesh(device=dev)
        serve = load_filter(torch, fleet_filter_path(), dev)
        ids, _, fetches, _, _, _ = fleet_inputs(
            torch, dev, scene, serve, fleet_ids(S), data=ref["data"])
        static = CM.static_cost_model()
        sync(torch, dev)
        ops.reset_launch_counts()
        runs = {name: fleet_run(dev, scene, ids, fetches[name], static,
                                churn=name == "learned", mesh=mesh)
                for name in ("ground_truth", "learned")}
        sync(torch, dev)
        launches = ops.launch_counts()
        wrapped = [e.shard_wrap is not None for name in runs
                   for e in runs[name][2]]
        check(all(wrapped), "fleet mesh (a): an engine took the "
              "replication fallback at world 1")
        lines, got = [], {}
        for name, (_, log, engines, ex, results, wall) in runs.items():
            pos = {c.stream_id: c.position for c in ex.streams}
            got[name] = fleet_answers(log, results, pos)
            bad = answers_differ(got[name], ref[name])
            check(not bad, f"fleet mesh (a) {name}: streams {bad} differ "
                  f"from the one-card fleet")
            lines.append(
                f"fleet mesh (a) {name}: {S} streams x {FLEET_FRAMES} "
                f"frames through plan_group_engine_factory(mesh=) on a "
                f"('stream',) mesh of 1 rank (NCCL, gloo control group): "
                f"every stream's per-frame answers and window hits equal "
                f"the one-card fleet's bit for bit; {S * FLEET_FRAMES / wall:.1f}"
                f" frames/s ({wall:.3f} s, chunk p50 "
                f"{ex.latency_percentile(50) * 1e3:.2f} ms) beside the "
                f"one-card fleet's {ref['fps'][name]:.1f} [{gpu}]")
        if not rehearse:
            for name in ("spatial_stats_bgc", "cam_head_bgd",
                         "flash_attention_bhsd"):
                check(launches[name] > 0, f"fleet mesh (a): {name} was "
                      f"not launched")
        lines.append(f"fleet mesh (a) launches (both passes): "
                     f"{ {k: launches[k] for k in FLEET_KERNELS} } [{gpu}]")
    finally:
        dist.destroy_process_group()
    return launches, got, lines


def fleet_worker(rank, store, rehearse):
    """One of (b)'s ranks: a gloo group of ``FLEET_WORLD`` processes on
    the one card (the CPU in rehearsal), a ``("stream",)`` mesh of
    ``FLEET_WORLD``.  Serves its block of the fleet's streams (their
    frames collected here, the filter saved by the parent): the
    ground-truth pass and the learned pass, with the stats calls recorded;
    then each chunk of its block through the final population's group
    plan under the wrap with the compacted spatial tier on the row kernel
    (fleet check 3 on the mesh: each stream equal to ``evaluate`` alone),
    the replication fallback at ``FLEET_FALLBACK_STREAMS`` streams and
    ``distributed_reduce`` over the ranks.  Writes JSON beside the store;
    returns 0."""
    sys.path.insert(0, SRC)
    import functools
    import torch
    import torch.distributed as dist
    from repro_torch.core import costmodel as CM
    from repro_torch.core import query as Q
    from repro_torch.core.aggregates import CVAccumulator, distributed_reduce
    from repro_torch.core.filters import FilterOutputs
    from repro_torch.distributed import multistream as MS
    from repro_torch.distributed import sharding as SH
    from repro_torch.kernels import ops
    from repro_torch.kernels import spatial_predicate as SP
    t_start = time.perf_counter()
    if rehearse:
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=FLEET_WORLD)
    d = os.path.dirname(store)
    out = {"rank": rank}
    try:
        mesh = SH.stream_mesh(device=dev)
        scene, _, _ = configure(rehearse)
        S = FLEET_STREAMS_REHEARSE if rehearse else FLEET_STREAMS
        ids = fleet_ids(S)
        mine = [c.stream_id for c in MS.route_streams(ids, FLEET_WORLD)
                if c.slot == rank]
        serve = load_filter(torch, fleet_filter_path(), dev)
        t0 = time.perf_counter()
        _, _, fetches, (kept, _), collect_s, _ = fleet_inputs(
            torch, dev, scene, serve, mine)
        out["collect_s"] = collect_s
        static = CM.static_cost_model()
        seen, first_vs_plain, restore = stats_spy(torch, SP, ops,
                                                  keep_first=rank == 0)
        sync(torch, dev)
        ops.reset_launch_counts()
        runs = {}
        t0 = time.perf_counter()
        for name in ("ground_truth", "learned"):
            runs[name] = fleet_run(dev, scene, ids, fetches[name], static,
                                   churn=name == "learned", mesh=mesh)
        sync(torch, dev)
        out["passes_s"] = time.perf_counter() - t0
        out["launches"] = ops.launch_counts()
        out["stats_frames"] = list(seen["full"])
        out["first_vs_plain"] = first_vs_plain()

        # fleet check 3 on the mesh: this rank's block of every chunk
        # through the final population's plan under the wrap, compacted
        # spatial tiers on the row kernel, against evaluate alone
        from repro_torch.core.plan import QueryPlan
        from repro_torch.core.temporal import TemporalProgram
        plan = QueryPlan(TemporalProgram(fleet_final_queries(scene.grid),
                                         backend="numpy").frame_queries)
        wrap = runs["learned"][2][-1].shard_wrap
        n_eq, rows_wrap = 0, []
        for name in ("ground_truth", "learned"):
            for lo in range(0, FLEET_FRAMES, BATCH):
                idx = np.arange(lo, lo + BATCH)
                outs = [kept.get((sid, lo, BATCH)) if name == "learned"
                        else None for sid in mine]
                outs = [o if o is not None else fetches[name](sid, idx)
                        for sid, o in zip(mine, outs)]
                n0 = len(seen["rows"])
                got = plan.build_staged(
                    None, cost_model=static, spatial_body="rows"
                ).evaluate_group(FilterOutputs(
                    counts=torch.stack([o.counts for o in outs]),
                    grid=torch.stack([o.grid for o in outs])),
                    shard_wrap=wrap)
                rows_wrap += seen["rows"][n0:]     # not evaluate's below
                for s, o in enumerate(outs):
                    want = plan.build_staged(
                        None, cost_model=static,
                        spatial_body="rows").evaluate(o)
                    check(torch.equal(got[s], want), f"fleet mesh (b) "
                          f"rank {rank}: evaluate_group under the wrap "
                          f"({name}, frames {lo}..) differs from evaluate "
                          f"on {mine[s]} alone")
                    n_eq += 1
        sync(torch, dev)
        restore()
        out["check3"] = n_eq
        out["check3_launches"] = {
            k: n - out["launches"][k] for k, n in ops.launch_counts().items()}
        out["rows_calls"] = rows_wrap
        out["local"] = [[c.stream_id for c in e.local_streams]
                        for name in runs for e in runs[name][2]]
        out["wrapped"] = [e.shard_wrap is not None
                          for name in runs for e in runs[name][2]]
        out["answers"], out["fps"] = {}, {}
        for name, (_, log, _, ex, results, wall) in runs.items():
            pos = {c.stream_id: c.position for c in ex.streams}
            out["answers"][name] = fleet_answers(log, results, pos)
            out["fps"][name] = S * FLEET_FRAMES / wall

        # the replication fallback: 6 streams over 4 ranks, every rank
        # serving all six, against the same engine without a mesh
        ctxs = MS.route_streams(fleet_ids(FLEET_FALLBACK_STREAMS), 1)
        rng = np.random.default_rng(SEED + 7)
        g, C = scene.grid, scene.n_classes
        fb = {c.stream_id: (
            torch.as_tensor(rng.poisson(1.5, (2 * BATCH, C)).astype(
                np.float32), device=dev),
            torch.as_tensor((rng.random((2 * BATCH, g, g, C)) < 0.02)
                            .astype(np.float32), device=dev))
            for c in ctxs}

        def fb_fetch(ctx, idx):
            c, gr = fb[ctx.stream_id]
            i = torch.as_tensor(idx, device=dev)
            return FilterOutputs(counts=c[i], grid=gr[i])

        fq = (Q.Count(Q.Op.GE, 3),
              Q.And((Q.ClassCount(0, Q.Op.GE, 1),
                     Q.Spatial(0, Q.Rel.LEFT, 1))))
        engs = [MS.ShardedPlanGroupEngine(fq, ctxs, fb_fetch, mesh=m,
                                          cost_model=static, device=dev)
                for m in (mesh, None)]
        out["fallback_wrap"] = engs[0].shard_wrap is not None
        out["fallback_local"] = len(engs[0].local_streams)
        out["fallback_equal"] = all(
            np.array_equal(*(e.run_chunk(np.arange(b0, b0 + BATCH))
                             for e in engs)) for b0 in (0, BATCH))

        # distributed_reduce over the ranks against the merge
        accs = []
        for r in range(FLEET_WORLD):
            rr = np.random.default_rng(700 + r)
            z = rr.normal(40.0 + r, 3.0, (1000 + 100 * r, 2))
            y = 2.0 * z[:, 0] - z[:, 1] + rr.normal(0.0, 1.0, z.shape[0])
            accs.append(CVAccumulator.init(2, device=dev).update(y, z))
        red = distributed_reduce(accs[rank], mesh=mesh)
        merged = functools.reduce(CVAccumulator.merge, accs)
        out["reduce_rel"] = max(
            float(((getattr(red, f) - getattr(merged, f)).abs().max()
                   / getattr(merged, f).abs().max()).cpu())
            for f in ("n", "mean", "M2"))
        out["reduce_device"] = red.M2.device.type
        out["seconds"] = time.perf_counter() - t_start
        with open(os.path.join(d, f"fleet{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def fleet_ranks(torch, rehearse, gpu, want):
    """(b): ``FLEET_WORLD`` processes of this script on the one card over
    gloo (``fleet_worker``).  Any that exits non-zero, or (b) past
    ``FLEET_B_LIMIT_S``, fails the smoke; every process is stopped.
    Returns (rank 0's launches, lines)."""
    store = mesh_store("store_fleet_b")
    d = os.path.dirname(store)
    for r in range(FLEET_WORLD):
        if os.path.exists(os.path.join(d, f"fleet{r}.json")):
            os.remove(os.path.join(d, f"fleet{r}.json"))
    extra = ["--rehearse"] if rehearse else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--fleet-worker", str(r), store] + extra,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(FLEET_WORLD)]
    outs = []
    try:
        for p in procs:
            left = FLEET_B_LIMIT_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(left, 1))[0])
    except subprocess.TimeoutExpired:
        raise SmokeError(f"fleet mesh (b): the ranks did not finish within "
                         f"{FLEET_B_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    bad = [f"rank {r} exited {p.returncode}:\n{o[-2500:]}"
           for r, (p, o) in enumerate(zip(procs, outs)) if p.returncode]
    check(not bad, "fleet mesh (b): " + "\n".join(bad))
    res = []
    for r in range(FLEET_WORLD):
        with open(os.path.join(d, f"fleet{r}.json")) as f:
            res.append(json.load(f))
    S = FLEET_STREAMS_REHEARSE if rehearse else FLEET_STREAMS
    n_local = S // FLEET_WORLD
    frames = n_local * BATCH
    for r, x in enumerate(res):
        check(all(x["wrapped"]) and all(len(b) == n_local
                                        for b in x["local"]),
              f"fleet mesh (b) rank {r}: engines {x['wrapped']} blocks "
              f"{x['local']}, want {n_local} streams each under the wrap")
        for name in ("ground_truth", "learned"):
            diff = answers_differ(x["answers"][name], want[name])
            check(not diff, f"fleet mesh (b) rank {r} {name}: streams "
                  f"{diff} differ from (a)'s")
        # full-batch calls see the block's 128 frames (a compacted step
        # with the gathered-grid body sees the block's bucket rows)
        check(x["stats_frames"] and max(x["stats_frames"]) == frames and
              all(n % n_local == 0 for n in x["stats_frames"]),
              f"fleet mesh (b) rank {r}: the stats kernel ran on "
              f"{sorted(set(x['stats_frames']))} frames, want {frames}")
        check(x["rows_calls"] and all(n == frames and top < frames
                                      for n, top in x["rows_calls"]),
              f"fleet mesh (b) rank {r}: row kernel calls (frames, largest "
              f"id) {x['rows_calls'][:8]}, want local ids below {frames}")
        if not rehearse:
            for name in ("spatial_stats_bgc", "cam_head_bgd",
                         "flash_attention_bhsd"):
                check(x["launches"][name] > 0, f"fleet mesh (b) rank {r}: "
                      f"{name} was not launched on its block")
            check(x["check3_launches"]["spatial_stats_rows_bgc"] > 0,
                  f"fleet mesh (b) rank {r}: the row kernel was not "
                  f"launched under the wrap")
        check(not x["fallback_wrap"] and x["fallback_local"]
              == FLEET_FALLBACK_STREAMS and x["fallback_equal"],
              f"fleet mesh (b) rank {r}: {FLEET_FALLBACK_STREAMS} streams "
              f"over {FLEET_WORLD} ranks did not replicate and agree")
        check(x["reduce_rel"] <= FLEET_REDUCE_TOL,
              f"fleet mesh (b) rank {r}: distributed_reduce is "
              f"{x['reduce_rel']:.3g} off the merge (tol "
              f"{FLEET_REDUCE_TOL})")
    first = res[0]["first_vs_plain"]
    check(first is not None and first[0], f"fleet mesh (b) rank 0: the "
          f"first stats call against its plain version: {first}")
    r0 = res[0]
    lines = [
        f"fleet mesh (b): {FLEET_WORLD} processes on the one card over "
        f"gloo, a ('stream',) mesh of {FLEET_WORLD}, {n_local} streams a "
        f"rank (frames collected on each rank in "
        f"{max(x['collect_s'] for x in res):.2f} s at most); every rank's "
        f"per-frame answers and window hits of all {S} streams equal (a)'s "
        f"in both passes (learned: register + retire in window 2); the "
        f"stats kernel on {frames} frames a full-batch call "
        f"({len(r0['stats_frames'])} calls on rank 0); evaluate_group under "
        f"the wrap at the final population, the compacted spatial tier on "
        f"the row kernel, equal to evaluate alone on each rank's "
        f"{r0['check3']} (stream, chunk) pairs, the row kernel on local ids "
        f"below {frames} ({len(r0['rows_calls'])} calls on rank 0; "
        f"{r0['check3_launches']['spatial_stats_rows_bgc']} row-kernel "
        f"launches in the check, its evaluate-alone calls included); "
        f"rank 0's first stats "
        f"call on {first[1]} equal to the plain version bit for bit; "
        f"{FLEET_FALLBACK_STREAMS} streams over {FLEET_WORLD} ranks "
        f"replicated and equal to the engine without a mesh; "
        f"distributed_reduce over the ranks ({r0['reduce_device']} float64, "
        f"gloo) within {max(x['reduce_rel'] for x in res):.3g} of the "
        f"merge (tol {FLEET_REDUCE_TOL}) [{gpu}]",
        f"fleet mesh (b) rank 0: passes {r0['passes_s']:.2f} s, frames/s "
        f"ground truth {r0['fps']['ground_truth']:.1f}, learned "
        f"{r0['fps']['learned']:.1f}; launches on its block "
        f"{ {k: r0['launches'][k] for k in FLEET_KERNELS} }; ranks "
        f"{[round(x['seconds'], 1) for x in res]} s from start, {wall:.1f} "
        f"s in all (limit {FLEET_B_LIMIT_S}) [{gpu}]"]
    return r0["launches"], lines


def fleet_mesh_phase(torch, dev, scene, ref, gpu, rehearse):
    """Phase 22: (a) the fleet over a one-rank stream mesh against the
    one-card fleet; (b) four ranks on the one card over gloo against
    (a).  Returns ({kernel: {"world1": n, "rank0_of_4": n}}, lines)."""
    t_phase = time.perf_counter()
    launches_a, want, lines = fleet_mesh_a(torch, dev, scene, ref, gpu,
                                           rehearse)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches_b, lines = fleet_ranks(torch, rehearse, gpu, want)
    lines.append(f"fleet mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return {k: {"world1": launches_a[k], "rank0_of_4": launches_b[k]}
            for k in launches_a}, lines


# ---------------------------------------------------------------------------
# flash attention at head dim 256, ops.spatial_stats and the §IV-B
# monitoring-queries twin (phase 23)
# ---------------------------------------------------------------------------

# (B, H, KV, S, hd): paligemma-3b's attention at 8 sequences of 1024 tokens
# (8 heads over one kv head of 256); the rehearsal's on the CPU
FLASH256, FLASH256_REHEARSE = (8, 8, 1, 1024, 256), (2, 2, 1, 320, 256)
FLASH_PAD_HD = 96                # a head dim between bodies: padded to 128
PALIGEMMA_SEQS, PALIGEMMA_TOKENS = 8, 1024
PALIGEMMA_SEQS_REHEARSE, PALIGEMMA_TOKENS_REHEARSE = 2, 320
PALIGEMMA_FP32_LAYERS = 2
TWIN_ARGS = ["--steps", "40", "--frames", "256"]
TWIN_ARGS_REHEARSE = ["--steps", "3", "--frames", "32"]
STATS_KERNELS = ("spatial_stats_bgc", "spatial_stats_rows_bgc")


def timers(torch, rehearse):
    """``timer(fn)`` (CUDA events, median ms) and ``ktimer(fn, expect)``
    (``kernel_times``); on the CPU each runs ``fn`` once, untimed."""
    if rehearse:
        def timer(fn):
            fn()

        def ktimer(fn, expect=None):
            fn()
            return {"ms": None, "call_ms": None, "b2b_ms": None}
    else:
        def timer(fn):
            return time_ms(torch, fn)

        def ktimer(fn, expect=None):
            return kernel_times(torch, fn, expect)
    return timer, ktimer


def max_gap(torch, a, b):
    """max |a - b| in float32, one leading row at a time (a whole bf16
    model's logits are 4.2 GB)."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def flash_case(torch, FA, dev, shape, dtype, seed, Sk=None, **kw):
    """q, k, v drawn on ``dev`` (seeded CUDA or CPU generator) at (B, H,
    KV, S, hd) (``Sk`` keys, S by default), and the kernel's max abs err
    against the plain version (1e-4 in float32, the bf16 flash cases'
    2e-2 in bfloat16)."""
    B, H, KV, S, hd = shape
    Sk = S if Sk is None else Sk
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((B, H, S, hd), (B, KV, Sk, hd), (B, KV, Sk, hd)))
    out = FA.flash_attention_bhsd(q, k, v, **kw)
    want = FA.flash_attention_plain(q, k, v, **kw)
    err = float((out.float() - want.float()).abs().max())
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    check(out.dtype == dtype and out.shape == q.shape and err <= tol,
          f"flash attention at hd {hd} {tuple(q.shape)} x {tuple(k.shape)} "
          f"{dtype} {kw}: max abs err {err} (tol {tol})")
    return (q, k, v), err


HD256_BODY = "flash_attention_kernel_hd256_wgmma"


def hd256_body_report(torch, dev, rehearse):
    """bf16 hd 256's wgmma body as built: its launch shape and
    resources from ``flash_attention_hd256_info`` (dynamic shared memory,
    threads, the registers ``setmaxnreg`` gives a consumer and a producer
    thread, the registers at entry and local bytes the runtime reads
    from the binary, blocks an SM), its spills from the ``-Xptxas -v``
    report, its HGMMA (wgmma) instructions counted in the library's SASS
    (``cuobjdump -sass``), and any ptxas line that says wgmma was
    serialized or ``setmaxnreg`` ignored; then its two products on one
    tile (``wgmma_probe``) against ``torch.matmul``.  Fails on a spill,
    a serialization or setmaxnreg line, no HGMMA, more than one block an
    SM, or a probe error above 1e-3.  None on the CPU."""
    if rehearse:
        return None, []
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    path = build.build_all(["flash_attention"])["flash_attention"]
    info = (ctypes.c_int * 7)()
    build.check(build.library("flash_attention").flash_attention_hd256_info(
        info), "flash_attention_hd256_info")
    smem, threads, regs_c, regs_p, regs_entry, local, per_sm = list(info)
    with open(path + ".log") as f:
        log = f.read()
    prop = re.search(r"Function properties for \S*" + HD256_BODY
                     + r"\S*\s+\d+ bytes stack frame, (\d+) bytes spill "
                     r"stores, (\d+) bytes spill loads", log)
    check(prop is not None, f"no ptxas report of {HD256_BODY}")
    st, ld = int(prop.group(1)), int(prop.group(2))
    warned = [ln.strip() for ln in log.splitlines()
              if re.search(r"serializ|setmaxnreg", ln, re.I)]
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-500:]}")
    funcs = sass.stdout.split("Function : ")
    body = [f for f in funcs if f.split("\n", 1)[0].find(HD256_BODY) >= 0]
    check(len(body) == 1, f"{HD256_BODY} not found in the SASS")
    hgmma = len(re.findall(r"\bHGMMA\.", body[0]))
    gen = torch.Generator(dev).manual_seed(SEED + 36)
    a, b, c = (torch.randn(64, 256, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    d, e = FA.wgmma_probe(a, b, c)
    probe = {"d": float((d - a.float() @ b.float().T).abs().max()),
             "e": float((e - d.bfloat16().float() @ c.float()).abs().max())}
    rep = {"kernel": HD256_BODY, "threads": threads,
           "smem_bytes": smem, "blocks_per_sm": per_sm,
           "regs_consumer": regs_c, "regs_producer": regs_p,
           "regs_entry": regs_entry, "local_bytes": local,
           "spill_stores": st, "spill_loads": ld, "hgmma_sass": hgmma,
           "ptxas_warnings": warned, "probe_max_abs_err": probe}
    check(st == 0 and ld == 0 and local == 0, f"{HD256_BODY} spills: "
          f"{st}/{ld} B, local {local} B")
    check(not warned, f"ptxas on {HD256_BODY}: {warned}")
    check(hgmma > 0, f"{HD256_BODY} has no HGMMA in its SASS")
    check(per_sm == 1, f"{HD256_BODY}: {per_sm} blocks an SM, want 1")
    check(max(probe.values()) <= 1e-3, f"wgmma probe against torch.matmul: "
          f"{probe} (tol 1e-3)")
    line = (f"{HD256_BODY} (bf16 hd 256): {threads} threads (a producer "
            f"warpgroup at {regs_p} registers a thread, two consumer "
            f"warpgroups at {regs_c}, by setmaxnreg; {regs_entry} at entry), "
            f"spill {st}/{ld} B, local {local} B; {smem} B of dynamic shared "
            f"memory, {per_sm} block an SM; {hgmma} HGMMA (wgmma) "
            f"instructions in its SASS; no ptxas line on wgmma "
            f"serialization or setmaxnreg; wgmma probe (one tile's q k^T "
            f"and p v) against torch.matmul: max abs err {probe['d']:.3g} / "
            f"{probe['e']:.3g} (tol 1e-3)")
    return rep, [line]


def flash256_entry(torch, dev, rehearse, timer, ktimer):
    """(a) bf16's wgmma body as built (``hd256_body_report``), then the
    hd 256 body at paligemma's shape, causal, in bf16 and
    float32 against the plain version, each timed three ways beside the
    plain version and SDPA (causal, GQA) on the same inputs, with its
    bound: the causal half of 4 B H S^2 hd FLOPs at the type's
    tensor-core peak (3xTF32 in float32) against q, k, v and o once; a
    sliding window (256) and ragged lengths (1000 x 1000, 77 x 1000)
    in both types.  (c) hd 96 zero-padded to the 128 body against its
    plain version in both types, timed beside the 128 body on inputs
    padded beforehand (the difference is the pad's cost), SDPA and the
    bound of the hd 96 work."""
    from repro_torch.kernels import flash_attention as FA
    shape = FLASH256_REHEARSE if rehearse else FLASH256
    B, H, KV, S, hd = shape
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 4 * B * H * S * S * hd // 2          # the causal half
    entry = {"shape": [B, H, KV, S, hd], "causal": True, "launches": None}
    entry["body"], lines = hd256_body_report(torch, dev, rehearse)
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32,
                                                    "float32")):
        (q, k, v), err = flash_case(torch, FA, dev, shape, dt, SEED + 30,
                                    causal=True)
        n_bytes = (2 * B * H * S + 2 * B * KV * S) * hd * q.element_size()
        bnd, by = (bound_ms(n_bytes, flops, BF16_FLOPS) if dt == torch.bfloat16
                   else bound_ms(n_bytes, 3 * flops, TF32_FLOPS))
        t = ktimer(lambda: FA.flash_attention_bhsd(q, k, v, causal=True),
                   "flash_attention_kernel")
        lib = ktimer(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        e = {"dtype": name, "max_abs_err": err, **t,
             "plain_ms": timer(lambda: FA.flash_attention_plain(
                 q, k, v, causal=True)),
             "bound_ms": bnd, "bound_by": by, "bound_bytes": n_bytes,
             "bound_flops": flops * (1 if dt == torch.bfloat16 else 3),
             **library_entry(lib)}
        del q, k, v
        n = 300 if rehearse else 1000                # no 64-row tile divides
        errs = [flash_case(torch, FA, dev, shape, dt, SEED + 31, causal=True,
                           sliding_window=256)[1],
                flash_case(torch, FA, dev, (B, H, KV, n, hd), dt, SEED + 32,
                           causal=True)[1],
                flash_case(torch, FA, dev, (B, H, KV, 77, hd), dt, SEED + 33,
                           Sk=n, causal=False)[1]]
        e["max_abs_err_window_ragged"] = max(errs)
        entry[name] = e
        lines.append(
            f"flash_attention_bhsd at hd 256 {shape} (B, H, KV, S, hd) "
            f"{name}, causal: device {e['ms']} ms (call {e['call_ms']} ms, "
            f"back-to-back {e['b2b_ms']} ms; plain {e['plain_ms']} ms; SDPA "
            f"causal GQA device {e['library_ms']} ms, call "
            f"{e.get('library_call_ms')} ms; bound {bnd:.4f} ms by {by}: "
            f"{e['bound_flops'] / 1e9:.1f} GFLOP (the causal half"
            + (", 3xTF32" if dt == torch.float32 else "")
            + f") at {(BF16_FLOPS if dt == torch.bfloat16 else TF32_FLOPS) / 1e12:.0f}"
            f" TFLOP/s, {n_bytes / 1e6:.1f} MB at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); max abs err {err:.3g}, "
            f"window 256 / ragged 1000 / 77 x 1000 {max(errs):.3g} (tol "
            + ("1e-4)" if dt == torch.float32 else "2e-2)"))
    # (c) a head dim between bodies, padded
    pad_shape = (B, H, KV, S, FLASH_PAD_HD)
    pad = {}
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32,
                                                    "float32")):
        (q, k, v), err = flash_case(torch, FA, dev, pad_shape, dt,
                                    SEED + 34, causal=True)
        pad[f"max_abs_err_{name}"] = err
        if dt == torch.bfloat16:
            body = FA.body_head_dim(FLASH_PAD_HD)
            qp, kp, vp = (torch.nn.functional.pad(t, (0, body - FLASH_PAD_HD))
                          for t in (q, k, v))
            t96 = ktimer(lambda: FA.flash_attention_bhsd(q, k, v,
                                                          causal=True),
                         "flash_attention_kernel")
            t128 = ktimer(lambda: FA.flash_attention_bhsd(qp, kp, vp,
                                                           causal=True),
                          "flash_attention_kernel")
            lib = ktimer(lambda: sdpa(q, k, v, is_causal=True,
                                      enable_gqa=True))
            bnd, by = bound_ms((2 * B * H * S + 2 * B * KV * S)
                               * FLASH_PAD_HD * q.element_size(),
                               4 * B * H * S * S * FLASH_PAD_HD // 2,
                               BF16_FLOPS)
            pad.update({"hd": FLASH_PAD_HD, "body": body, "dtype": name,
                        "shape": list(pad_shape), **t96,
                        "body_ms": t128["ms"], "body_call_ms": t128["call_ms"],
                        "plain_ms": timer(lambda: FA.flash_attention_plain(
                            q, k, v, causal=True)),
                        "bound_ms": bnd, "bound_by": by,
                        **library_entry(lib)})
            if not rehearse:
                pad["pad_ms"] = t96["ms"] - t128["ms"]
            del qp, kp, vp
        del q, k, v
    entry["padded"] = pad
    entry.update(entry.pop("bfloat16"))     # bf16 at the top, as decode's
    lines.append(
        f"flash_attention_bhsd at hd {FLASH_PAD_HD} (zero-padded to the "
        f"{pad['body']} body) {list(pad_shape)} bfloat16, causal: device "
        f"{pad['ms']} ms with the pad and slice (call {pad['call_ms']} ms), "
        f"the {pad['body']} body alone on inputs padded beforehand "
        f"{pad['body_ms']} ms: pad cost {pad.get('pad_ms')} ms; plain "
        f"{pad['plain_ms']} ms; SDPA causal GQA device {pad['library_ms']} "
        f"ms; bound {pad['bound_ms']:.4f} ms by {pad['bound_by']} (the "
        f"causal half at hd {FLASH_PAD_HD}); max abs err "
        f"{pad['max_abs_err_bfloat16']:.3g}"
        f" (tol 2e-2), float32 {pad['max_abs_err_float32']:.3g} (tol 1e-4)")
    return entry, lines


def paligemma_forward(torch, dev, rehearse, ops):
    """(b) paligemma-3b at full width (18 layers, d 2048, 8 heads over
    one kv head of 256), bf16, tokens only, ``attn_impl="pallas"``,
    random weights from a seeded CUDA generator: 8 x 1024 tokens through
    ``models.model.forward`` after one untimed pass under each
    ``attn_impl``; counts reset just before the timed pass and read just
    after (flash attention once per layer, nothing else); its logits
    against the same forward under ``xla_flash`` within
    ``MESH_BF16_TOL``; then float32 at 2 layers (TF32 off), the same
    tokens, within 1e-4."""
    from repro_torch.models import model as M
    over = dict(attn_impl="pallas")
    if rehearse:
        over.update(n_heads=2, head_dim=256)
    n_seq, n_tok = ((PALIGEMMA_SEQS_REHEARSE, PALIGEMMA_TOKENS_REHEARSE)
                    if rehearse else (PALIGEMMA_SEQS, PALIGEMMA_TOKENS))
    lines, res = [], {}
    for dt in ("bfloat16", "float32"):
        o = dict(over, dtype=dt)
        if dt == "float32":
            o["n_layers"] = PALIGEMMA_FP32_LAYERS
        cfg = model_config("paligemma_3b", rehearse, **o)
        gen = torch.Generator(dev).manual_seed(SEED + 35)
        params = M.init_params(gen, cfg, device=dev)
        toks = torch.as_tensor(np.random.default_rng(SEED + 35).integers(
            0, cfg.vocab_size, (n_seq, n_tok)), device=dev)
        flat = dataclasses.replace(cfg, attn_impl="xla_flash")
        for c in (cfg, flat):                            # warm-up
            M.forward(params, c, toks)
        sync(torch, dev)
        ops.reset_launch_counts()
        ops.reset_plain_counts()
        t0 = time.perf_counter()
        got = M.forward(params, cfg, toks).logits
        sync(torch, dev)
        t_k = time.perf_counter() - t0
        launches = ops.launch_counts()
        plain = ops.plain_counts()["flash_attention_bhsd"]
        want_l = dict.fromkeys(launches, 0)
        want_l["flash_attention_bhsd"] = cfg.n_layers
        if rehearse:
            check(plain == cfg.n_layers, f"paligemma {dt}: the forward "
                  f"reached flash attention {plain} times, want "
                  f"{cfg.n_layers}")
        else:
            check(launches == want_l, f"paligemma {dt}: launches "
                  f"{launches}, want {cfg.n_layers} flash attention and "
                  f"nothing else")
        t0 = time.perf_counter()
        want = M.forward(params, flat, toks).logits
        sync(torch, dev)
        t_x = time.perf_counter() - t0
        check(bool(torch.isfinite(got).all()), f"paligemma {dt}: logits "
              f"not finite")
        gap = max_gap(torch, got, want)
        tol = MESH_BF16_TOL if dt == "bfloat16" else 1e-4
        check(gap <= tol, f"paligemma {dt} pallas vs xla_flash logits: max "
              f"abs gap {gap} (tol {tol})")
        res[dt] = {"launches": launches, "gap": gap}
        lines.append(
            f"paligemma-3b forward, tokens only ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.n_heads} heads over "
            f"{cfg.n_kv_heads} of {cfg.head_dim}, vocab {cfg.vocab_size}, "
            f"{dt}, random weights): {n_seq} x {n_tok} tokens under pallas "
            f"{t_k * 1e3:.3f} ms ({n_seq * n_tok / t_k:.1f} tokens/s), "
            f"under xla_flash {t_x * 1e3:.3f} ms; flash attention launches "
            f"{launches['flash_attention_bhsd']} (want {cfg.n_layers}, no "
            f"other kernel; plain calls {plain}); logits max abs gap "
            f"{gap:.4g} (tol {tol}), max |logit| "
            f"{max(float(x.float().abs().max()) for x in want):.4g}")
        del params, got, want
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res, lines


def twin_phase(torch, dev, scene, rehearse, ops):
    """(d) ``ops.spatial_stats`` on the filter stream's ground-truth grid
    (the first 32 frames at g = 56, as phase 3 takes it): one launch,
    equal to the plain version bit for bit; then
    examples/torch_monitoring_queries.py's ``main`` at reduced steps on
    the device, counts reset just before and read just after: its table,
    the survivors' answers equal to the exact semantics, the staged
    plan's masks equal to the cascade's (checked in the twin), the stats
    kernels launched by the staged plan's spatial tier."""
    import importlib.util

    from repro_torch.data.synthetic import VideoStream, collect
    from repro_torch.kernels import spatial_predicate as SP
    from repro_torch.core import query as Q
    data = collect(VideoStream(scene, dynamics_seed=SEED), BATCH)
    grid = torch.as_tensor(data["occupancy"], device=dev).float()
    ops.reset_launch_counts()
    stats = ops.spatial_stats(grid)
    sync(torch, dev)
    n_stats = ops.launch_counts()
    check(rehearse or (n_stats["spatial_stats_bgc"] == 1
                       and sum(n_stats.values()) == 1),
          f"ops.spatial_stats launched {n_stats}, want one stats kernel")
    check(torch.equal(stats, SP.spatial_stats_plain(grid)),
          "ops.spatial_stats differs from its plain version")
    lines = [f"ops.spatial_stats on the filter stream's grid "
             f"{list(grid.shape)}: {dict((k, v) for k, v in n_stats.items() if v)}"
             f" launch(es), bit for bit against its plain version"]
    path = os.path.join(HERE, "examples", "torch_monitoring_queries.py")
    spec = importlib.util.spec_from_file_location("torch_monitoring_queries",
                                                  path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    argv = (TWIN_ARGS_REHEARSE if rehearse else TWIN_ARGS) + \
        ["--device", dev.type]
    ops.reset_launch_counts()
    ops.reset_plain_counts()
    t0 = time.perf_counter()
    results = twin.main(argv)
    sync(torch, dev)
    t_twin = time.perf_counter() - t0
    launches = ops.launch_counts()
    reached = (ops.plain_counts() if rehearse else launches)
    n_reached = sum(reached[k] for k in STATS_KERNELS)
    check(n_reached > 0, f"the twin's staged plans never reached the "
          f"spatial stats (calls {reached})")
    from repro_torch.data.synthetic import PRESETS
    for r, (_, scene_name, strict, _) in zip(results, twin.QUERIES):
        sc = PRESETS[scene_name]
        exact = np.array([Q.eval_objects(strict(), o, sc.n_classes, sc.grid)
                          for o in r["objects"]])
        check(np.array_equal(r["truth"], exact)
              and np.array_equal(r["answers"], exact & r["mask"]),
              f"twin {r['name']}: answers on the survivors are not the "
              f"exact semantics")
    lines.append(
        f"examples/torch_monitoring_queries.py {' '.join(argv)}: "
        f"{len(results)} queries in {t_twin:.1f} s (training included), "
        f"survivors' answers equal to eval_objects, staged masks equal to "
        f"the cascade's; launches {dict((k, v) for k, v in launches.items() if v)}"
        f" (stats calls {n_reached}); " + "; ".join(
            f"{r['name']} recall {r['recall']:.3f} selectivity "
            f"{r['selectivity']:.3f} speedup {r['speedup']:.1f}x filter "
            f"{r['filter_ms']:.3f} ms/frame" for r in results))
    return ({"ops_spatial_stats": n_stats, "monitoring_twin": launches},
            lines)


def flash256_phase(torch, dev, scene, rehearse, gpu):
    """Phase 23: (a) and (c) ``flash256_entry``, (b) the paligemma-3b
    forward, (d) ``twin_phase``.  Returns (the flash kernel line's
    ``hd256`` entry, {sub-path: launches}, lines)."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    timer, ktimer = timers(torch, rehearse)
    entry, lines = flash256_entry(torch, dev, rehearse, timer, ktimer)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fwd, lines = paligemma_forward(torch, dev, rehearse, ops)
    for line in lines:
        print(line, flush=True)
    entry["launches"] = fwd["bfloat16"]["launches"]["flash_attention_bhsd"]
    entry["logits_gap"] = {k: v["gap"] for k, v in fwd.items()}
    twin, lines = twin_phase(torch, dev, scene, rehearse, ops)
    lines.append(f"flash256 phase: {time.perf_counter() - t_phase:.1f} s "
                 f"[{gpu}]")
    launches = {"paligemma_forward": fwd["bfloat16"]["launches"],
                "paligemma_forward_float32": fwd["float32"]["launches"],
                **twin}
    return entry, launches, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU at a tiny size (plain "
                         "versions instead of kernels, no result line)")
    ap.add_argument("--mesh-worker", nargs=2, metavar=("RANK", "STORE"),
                    help="run one rank of phase 20 (b) (started by the "
                         "smoke itself)")
    ap.add_argument("--families-worker", nargs=2, metavar=("RANK", "STORE"),
                    help="run one rank of phase 21 (b) (started by the "
                         "smoke itself)")
    ap.add_argument("--fleet-worker", nargs=2, metavar=("RANK", "STORE"),
                    help="run one rank of phase 22 (b) (started by the "
                         "smoke itself)")
    ap.add_argument("--families-dryrun", metavar="OUT",
                    help="run phase 21 (c)'s mesh dry-run (started by the "
                         "smoke itself)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        raise SmokeError(f"no src/repro_torch beside {__file__}: run from "
                         f"a checkout of the repository")
    if args.mesh_worker:
        return mesh_worker(int(args.mesh_worker[0]), args.mesh_worker[1],
                           args.rehearse)
    if args.families_worker:
        return fam_worker(int(args.families_worker[0]),
                          args.families_worker[1], args.rehearse)
    if args.families_dryrun:
        return fam_dryrun(args.families_dryrun, args.rehearse)
    if args.fleet_worker:
        return fleet_worker(int(args.fleet_worker[0]), args.fleet_worker[1],
                            args.rehearse)
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.data.synthetic import VideoStream, collect
    from repro_torch.kernels import build

    if args.rehearse:
        dev = torch.device("cpu")
        gpu = "CPU rehearsal"
    else:
        check(torch.cuda.is_available(), "torch finds no CUDA device")
        dev = torch.device("cuda")
        gpu = gpu_line()
        print(gpu, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        libs = build.build_all()
        print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in ptxas_lines(libs):
            print(line, flush=True)

    scene, trunk, spec = configure(args.rehearse)
    tf, lines = training_phase(torch, dev, scene, trunk, spec,
                               args.rehearse)
    for line in lines:
        print(line, flush=True)
    params = tf.params
    serve = dataclasses.replace(
        tf, trunk_cfg=dataclasses.replace(trunk, attn_impl="pallas"))
    save_filter(torch, serve, fleet_filter_path())
    data = collect(VideoStream(scene, dynamics_seed=SEED), N_FRAMES)

    qkv, feat, grids, rows = kernel_inputs(torch, dev, trunk, spec, params,
                                           data)
    if args.rehearse:
        entries = []
    else:
        entries, sweep = kernel_phase(torch, dev, feat, params, grids, rows)
        flash, flash_lines = flash_phase(torch, qkv)
        entries.append(flash)
        for e in entries:
            print(f"kernel {e['name']} {e['shape']}: device {e['ms']:.4f} "
                  f"ms (call {e['call_ms']:.4f} ms, back-to-back "
                  f"{e['b2b_ms']:.4f} ms; plain {e['plain_ms']:.4f} ms, "
                  f"bound {e['bound_ms']:.4f} ms by {e['bound_by']}, "
                  f"library device {e['library_ms']} ms, call "
                  f"{e.get('library_call_ms')} ms), max abs err "
                  f"{e['max_abs_err']:.3g}", flush=True)
        for e in entries[:2]:
            print(f"kernel {e['name']} before, on the grid sliced to "
                  f"classes {e['classes']}: device {e['sliced_ms']:.5f} ms, "
                  f"call {e['sliced_call_ms']:.5f} ms, back-to-back "
                  f"{e['sliced_b2b_ms']:.5f} ms; gather + .contiguous() + "
                  f"kernel: device {e['compose_ms']:.5f} ms, call "
                  f"{e['compose_call_ms']:.5f} ms, back-to-back "
                  f"{e['compose_b2b_ms']:.5f} ms", flush=True)
        for line in sweep:
            print(line, flush=True)
        for line in flash_lines:
            print(line, flush=True)
    del qkv, feat, grids, rows
    print(plain_head_check(torch, dev, trunk, spec, params, data),
          flush=True)

    runs, record, launches, peak = main_path(torch, dev, scene, serve, data)
    print(f"main path launches: {launches}", flush=True)
    print(f"serving peak device memory (both passes, pallas trunk): "
          f"{gib(peak)}", flush=True)
    for line in check_main_path(torch, data, scene, runs, record):
        print(line, flush=True)
    for line in trunk_compare(torch, dev, tf, serve, data):
        print(line, flush=True)
    for line in aggregate_phase(torch, dev, scene, serve, data,
                                runs["learned"], gpu, args.rehearse):
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lines, fleet_launches, fleet_ref = fleet_phase(torch, dev, scene, serve,
                                                   gpu, args.rehearse)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not args.rehearse:
        check(peak < SERVING_PEAK_LIMIT, f"serving peak {gib(peak)} is not "
              f"under {gib(SERVING_PEAK_LIMIT)}")
        want = spec.layer * (N_FRAMES // BATCH)
        check(launches["flash_attention_bhsd"] == want,
              f"flash_attention_bhsd launched "
              f"{launches['flash_attention_bhsd']} times on the main path, "
              f"want {want} (one per trunk layer and batch)")
        for e in entries:
            check(launches[e["name"]] > 0,
                  f"{e['name']} was not launched on the main path")
            e["launches"] = launches[e["name"]]
    del tf, serve, params, data

    timer, ktimer = timers(torch, args.rehearse)
    rwkv_launches, calls, lines = rwkv_serving_phase(torch, dev,
                                                     args.rehearse)
    for line in lines:
        print(line, flush=True)
    scan, lines = rwkv_kernel_phase(torch, dev, calls, timer, ktimer)
    scan["launches"] = rwkv_launches["rwkv6_scan_bhtk"]
    del calls
    print(kernel_line(scan), flush=True)
    for line in lines:
        print(line, flush=True)
    decode, lines = decode_phase(torch, dev, timer, ktimer, args.rehearse)
    print(kernel_line(decode), flush=True)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for line in rwkv_fp32_phase(torch, dev, args.rehearse):
        print(line, flush=True)
    zoo = {}
    phases = [("qwen2_serving", zoo_serving_phase),
              ("decode_32k", decode32k_phase),
              ("whisper", whisper_phase),
              ("qwen2_fp32", zoo_fp32_phase)]
    phases += [(f"{k}_serving", functools.partial(family_serving_phase,
                                                  key=k))
               for k in FAMILY_SERVING]
    phases += [(f"{k}_fp32", functools.partial(family_fp32_phase, key=k))
               for k in FAMILY_FP32]
    for name, phase in phases:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        zoo[name], lines = phase(torch, dev, args.rehearse)
        for line in lines:
            print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    decode["hd256"], lines = decode256_entry(torch, dev, timer, ktimer,
                                             args.rehearse)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    zoo["qwen2_train_serve"], lines = zoo_training_phase(torch, dev,
                                                         args.rehearse)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    zoo["launch_b"], lines = launch_phase(torch, dev, args.rehearse, gpu)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for line in mesh_phase(torch, dev, args.rehearse, gpu):
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fam_launches, lines = families_phase(torch, dev, args.rehearse, gpu)
    for line in lines:
        print(line, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fleet_mesh, lines = fleet_mesh_phase(torch, dev, scene, fleet_ref, gpu,
                                         args.rehearse)
    for line in lines:
        print(line, flush=True)
    del fleet_ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    hd256, p23, lines = flash256_phase(torch, dev, scene, args.rehearse, gpu)
    for line in lines:
        print(line, flush=True)
    if args.rehearse:
        print("rehearsal done (CPU: plain versions, no kernels)")
        return 0
    flash["hd256"] = hd256
    entries += [scan, decode]
    for e in entries:
        e["kernel_ms"] = e["ms"]
        e["fleet_launches"] = fleet_launches[e["name"]]
        e["families_launches"] = fam_launches.get(e["name"], 0)
        e["fleet_mesh_launches"] = fleet_mesh[e["name"]]
        e["flash256_phase_launches"] = {k: n[e["name"]]
                                        for k, n in p23.items()}
        if e["name"] in ZOO_KERNELS:
            e["zoo_launches"] = {k: n[e["name"]] for k, n in zoo.items()}
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
