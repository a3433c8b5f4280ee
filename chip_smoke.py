#!/usr/bin/env python3
"""Start the PyTorch/CUDA port on one NVIDIA H100 and hold it to account.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --only flash_attention`` builds only
``flash_attention.cu`` and runs only phase 1's flash-attention checks and
timings, then exits 0 without the result line: a quick check of that
kernel, never to be taken for a full run.  ``--only matmul`` does the same
for ``matmul.cu``, and also times the tensor-core route at forced split
counts.  ``--only decode_attention`` does
the same for ``paged_attention.cu`` and ``flash_decode.cu`` (the four entry
points of the decode template).  ``--only conv2d`` does the same for
``conv2d.cu``, with the conv shapes taken from shape-only batch-1 CPU
forwards of the three CNNs (``profiling/conv2d_ab.conv_shapes``), and also
times the tensor-core route at forced column tiles and split counts.
``--only serving_graph`` builds the four sources of the serving path
(``matmul.cu``, ``flash_attention.cu``, ``paged_attention.cu``,
``flash_decode.cu``), runs phase 2's CUDA-graph checks and then
``profiling/decode_profile``'s A/B of eager decode steps against graph
replays and ``profiling/prefill_profile``'s of eager refills and waves
against theirs, and exits 0 without the result line.  ``--only cluster``
builds the same four sources and runs phase 4 alone, without the result
line.  ``--only families`` builds the same four sources and runs the
eleventh slice's checks of phases 1-3 (the MoE and VLM families and the
dense family's other configs) alone, without the result line.  ``--only
ssm`` builds the same four sources and runs the twelfth slice's checks of
phases 1-3 (the SSM and hybrid families: mamba2-130m, hymba-1.5b) alone,
without the result line.  ``--only encdec`` builds the same four sources and
runs the thirteenth slice's checks of phases 1-3 (the enc-dec family:
whisper-base, and flash attention's bidirectional mode) alone, without the
result line.  ``--only train`` builds the training path's three sources
(the matmul, flash attention and its backward) and runs the fourteenth
slice's checks of phases 1-3 (training qwen2-7b at full width) alone,
without the result line.  ``--only train_families`` builds the same three
and runs the sixteenth slice's checks of phases 1-3 (training the MoE,
VLM, SSM, hybrid and enc-dec families) alone, without the result line.
``--only spmd`` builds the same three and runs the eighteenth slice's
phase 3 [spmd] (the partitioned step, a one-rank device mesh, the dry
run) alone, without the result line.

Phases (each raises on failure; nothing is caught):

0. Build every CUDA kernel of the port from ``src/repro_torch/kernels/
   csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (one process per source, in
   parallel) into ``build/kernels/``.
1. Kernels against their plain PyTorch versions, on the card, at the
   serving path's qwen2-7b shapes in bf16 (tolerance 3e-2, the reference's
   bf16 tolerance) and fp32 (tolerance 2e-4, the reference's fp32
   tolerance: both sides accumulate in f32, only in another order, with
   TF32 switched off explicitly), plus one ragged shape per kernel; packed
   int8/fp8 pages at 5e-2, the reference's quantization budget (QTOL).
   The matmul is also held over its tensor-core tiles' edges (MM_EDGE_MS x
   MM_EDGE_KN), at forced split counts on each route, with bf16 operands
   whose rows are not 16-byte aligned (which must take the tensor cores,
   staged: the MM_STAGED_* grid) and by two launches of
   each route on the same inputs (bf16 on the tensor cores, f32 on the
   CUDA cores: bit for bit); it is
   timed over a decode step's 197 calls and a prefill wave's 196, each
   shape on its own weight buffers past the L2 (``prefill_ms`` and its
   peers in the JSON), and at the CNNs' fp32 fc.
   flash attention is also held in bf16 over its tensor-core tiles' edges
   (every mix of G in FA_GROUPS, Sq = Skv in FA_LENGTHS, window in
   FA_WINDOWS, D in FA_DIMS) and at a 2048-token prompt, and timed there
   too (``long_ms``, ``long_library_ms``, ``long_bound_ms`` in the JSON).
   The four decode-template kernels (paged float, packed, sparse, dense
   slab) are held through the model path's wrapper (the split plan) and at
   forced splits (1, the plan's, more than the walk's tiles), at the
   serving shapes, a ragged window with an inactive slot, D = 16 and 20,
   contexts 1 / 31 / 32 / 33 and about 4,096, and timed at the main shape
   and at 4,096 (``splits`` and ``long_splits`` give the plan's counts).
   Then each kernel's time beside its plain version's, one PyTorch library
   call's (a yardstick the port never calls) and its roofline bound.
   conv2d is held to its plain version at every distinct conv shape of
   ResNet-50 at 224 (20), GoogLeNet's 5x5 branch shapes and VGG-16's
   first conv, bf16 (3e-2) and fp32 (2e-4), plus a ragged shape; over the
   tensor-core tiles' edges (CONV_EDGE_*); at forced splits and column
   tiles on each route; with operands that must take the CUDA cores; and
   by two launches of each tensor-core plan (bit for bit).  It is timed
   at ResNet-50's shapes at batch 64 on the plan's route and on the CUDA
   cores beside the plain version and ``F.conv2d`` (channels_last, TF32
   off; TF32 on logged for information), cycling over input sets that
   overflow the L2.  These checks take their shapes from what phase 2's
   CPU forwards passed to the conv2d wrapper, so they run after it.
   The matmul and flash attention are also held at the shapes of the
   eleventh slice's configs (FAMILY_RUNS), bf16 and fp32: every
   projection at M = SLOTS and at a prefill wave's rows, each LM head at
   M = SLOTS (internvl2's 92,553 columns staged), and each
   config's prefill wave (G = 1 with 20 heads; internvl2's 288 rows, 256
   of them the image prefix).  And at the twelfth slice's shapes
   (``phase_ssm_kernels``), bf16 and fp32, each timed in bf16 beside its
   plain version and bound: the matmul at every (M, K, N) of mamba2-130m
   and hymba-1.5b at M = SLOTS and at a wave's rows (hymba's 128 meta rows
   included) and each LM head, with its route (hymba's in_proj, N = 3257,
   and head, 32,001 columns, are not 16-byte rows: staged); flash
   attention at hymba's (Hq 25, Hkv 5, D 64), 4 x 160 rows and a 1,280-row
   prompt, windows 0 and 1024 (which bites there); ``paged_decode`` and
   ``flash_decode`` at (25, 5, 64), contexts 163-174 and ~1,290, windows 0
   and 1024, at the plan's split count and at forced ones.  And at the
   thirteenth slice's (``phase_encdec_kernels``): flash attention's
   bidirectional mode (``causal=False``) at whisper's encoder (4 x 1500
   rows, 8 heads of 64, G = 1), the cross shapes (32 and 1 rows over 1500
   frames) and 240 tile-edge shapes (G 1 / 4, Sq and Skv apart and equal
   on both sides of the 64-row and 64-key tiles, windows 0 / 16, D 64 /
   80), bf16 and fp32, timed at the encoder beside SDPA; flash decode at G
   = 1 over the 1500-row cross K/V at a device scalar position and over the
   self slab, at forced splits, timed beside SDPA; the matmul at an encoder
   wave's M = 6000 and a decode step's M = 4 (the 51,865-column head
   staged), with routes and times beside ``torch.matmul``.  And at
   the fourteenth slice's (``phase_train_kernels``): flash attention's
   forward with its log-sum-exp and the three backward kernels (Delta, dK
   / dV, dQ) at qwen2-7b's training shape (q (1, 4096, 28, 128), bf16,
   causal), over the backward's tile edges (BWD_*: G 1 / 7 / 16, ragged
   and unequal Sq / Skv, windows 0 / 16, D 16 / 64 / 128, causal in both
   dtypes, bidirectional in bf16 and with one query row in both) and at
   whisper's encoder and cross shapes in both dtypes: the forward's
   output by the rule above, its LSE and dQ, dK, dV within 3e-2 / 2e-4 x
   (rms + |plain|) of the plain version run in f32 on the same inputs,
   each backward bit for bit on a second launch (bf16 on the tensor
   cores, f32 on the CUDA cores); timed, the three kernels together and
   each alone, at the training shape and at whisper's encoder and cross
   shapes beside the plain version, SDPA's forward + backward and the
   operations bound (2.5x the forward's FLOPs).  Then the matmul's
   training products (each projection's forward and two backward products
   at M = 4096, the loss chunk's head product and its two), each against
   ``ref.matmul`` and timed beside ``torch.matmul`` and its bound, summed
   over a step.  And at the sixteenth slice's
   (``phase_train_family_kernels``): the same attention checks and
   timings at each family's training shapes (qwen3-moe's and internvl2's
   GQA, hymba's G = 5 at D = 64 with and without its 1024-key window,
   whisper's decoder self attention and its cross attention of 4096
   queries over 1500 frames), and every training product whose rows are
   not 16 bytes (hymba's in_proj, the heads of 32,001, 92,553 and 51,865
   columns): forward, dA and dB on the tensor cores, staged, bit for bit
   on a second launch, timed beside ``torch.matmul``.
2. Card against CPU: a 2-layer qwen2-7b at full width in fp32, the same
   weights on both; ragged prefill and 4 decode steps on a float pool
   (logits within 1e-3: f32 on both sides, summed in different orders
   through two layers with contractions up to 18,944 long; identical
   argmax), an int8 and an fp8 pool (5e-2), a sparse float pool and a
   sparse int8 pool (the keep masks first compared equal, any flip
   reported by slot, head, block and estimated mass; then 1e-3 and 5e-2)
   and the dense slab (1e-3).  A prefix-cache hit on the card gives
   logits bit-identical to a cold engine.  The decode step as a CUDA graph
   (``serving/step_graph.py``): one bf16 ``mm_mma`` and one ``pa_launch``
   captured through ctypes replay bit for bit like their eager launches;
   a graph engine and a ``cuda_graph=False`` engine in lockstep (the
   2-layer fp32 model in the same six layouts, then full-width bf16
   qwen2-7b on the float pool, four refills included, three of one
   shape) give the same tokens, live slots' logits and KV state bit for
   bit and the same dropped-block counts every step, with 1 eager step
   and the rest replays; the graph engine's prefills
   (``serving/prefill_graph.py``) share a cache with two engines that
   seat a wave of its wave's shape first, so its wave is a replay, and
   the cache runs each shape as an LRU does: eagerly at its first use,
   captured at its second, replayed after that.  One more 2-layer run
   refills more prompt lengths than the cache holds, so shapes are
   evicted, run eagerly again and captured again.  The graph engine's
   wrappers count its eager and captured prefills and steps as the eager
   engine's count theirs and nothing on a replay, and profiler traces of
   one replayed step and one replayed refill show the same kernels by
   name as the eager engine's, each trace holding one kernel per launch
   the eager engine's wrappers counted (an eager trace short of that
   beside a complete replay's, or both short by the same kernels, has
   lost profiler records: the lockstep then runs again, TRACE_ATTEMPTS
   runs at most, each rerun logged and counted at the end; a complete
   eager trace beside a replay's that differs fails).  A
   prefix-cache hit seated by a replayed
   refill gives logits bit-identical to a cold eager engine's.
   ResNet-50, GoogLeNet and VGG-16
   at 224, fp32, batch 2, built from one seed on both devices: logits
   within 1e-3 * max|cpu| (f32 on both sides, summed in other orders
   through up to 53 convs and 16 unnormalised residual adds), identical
   argmax per image.  The eleventh slice's six configs at full width in
   fp32 (2 layers; dbrx-132b 1: 12.7 GB of f32 experts a layer), the same
   weights on both: a ragged wave (internvl2's with seeded patch
   embeddings before the text; slot 0's prompt one token repeated, whose
   rows route alike, so experts overflow) on a float pool, then 4 decode
   steps: every MoE call's expert ids equal the CPU's but for flips where
   the CPU's top-k gap is below 1e-6 (printed, counted, their slots left
   out), the same overflowing experts on both (at least one), logits
   within 1e-3 and the same argmax; then the graph lockstep above at 2
   layers for qwen3-moe-30b-a3b and internvl2-26b.  The SSM and hybrid
   families (``phase_ssm_card_vs_cpu``): mamba2-130m at 2 layers and
   hymba-1.5b at 3 (its layer 2 windowed), full width, fp32, 2 prompts
   of 1,152 tokens (hymba's 1,280 positions with its meta rows) and 8
   decode steps on a pool: logits within 1e-3, the same argmax, the SSM
   state and conv window within 1e-3 after the prefill and the last
   step; the graph lockstep for both (a wave of two prompt lengths, so
   the SSM's one prefill per length runs as two groups, then four
   refills; the live slots' SSM state and conv compared bit for bit with
   their KV state); and the PD oracle of phase 4a on hymba's 3 layers: a
   wave handed over the wire, KV pages and SSM state, decodes bit for
   bit as the never-migrated engine.  whisper-base
   (``phase_encdec_card_vs_cpu``) at full width, 2 + 2 layers, fp32, 4 x
   1500 seeded frames: the teacher-forced forward (causal self attention,
   bidirectional cross attention at Sq != Skv), the cross K/V and 8 greedy
   decode steps within 1e-3, the same argmax every step; then a graph
   engine and a ``cuda_graph=False`` engine over three waves (each of
   another prompt width: one prefill key, eager, captured, replayed) equal
   bit for bit in tokens, logits, self and cross K/V.  Training
   (``phase_train_card_vs_cpu``): qwen2-7b at full width, 2 layers, fp32,
   the same weights on both, two ``make_train_step`` steps (warmup 1) on
   2 x 128-token ``synth_lm_batch`` batches: the loss and every gradient
   before each step, then the metrics, m, v and the update within 1e-3 x
   (rms + |cpu|) (the update where the CPU's m is above UPDATE_MASK of
   the RMS of its nonzero entries).  The same for each other family
   (``phase_train_family_card_vs_cpu``) at full width: qwen3-moe-30b-a3b
   (its expert ids equal on both devices in every routed call) and
   internvl2-26b at 1 layer, mamba2-130m and whisper-base at 2,
   hymba-1.5b at 3 (a windowed layer), on batches of 2 x (the prefix + 128
   text rows; hymba's 1152, so that its window masks keys), a vocabulary
   table's rms over the rows and columns the batch touches
   (``token_rms``).
3. The slice: ``repro_torch.launch.serve.main`` serves qwen2-7b at full
   width (28 layers, bf16, random weights from seed 0) with 2 partitions,
   then at a smaller load (1 partition, 4 requests, prompt 64) on the
   float pool, with ``--kv-dtype int8 --sparse-threshold T``, with
   ``--kv-dtype fp8``, with ``--sparse-threshold T --prefix-cache`` and
   with ``--dense``; then the refill-heavy load (32 requests through 2 x
   4 slots, 24 refills) and the five lever runs again at a longer load
   (16 requests x 16 tokens through 4 slots, 12 refills).  Every request
   must complete, every bf16 prefill matmul must take the tensor-core
   route, every kernel's launch count must rise on the run that carries
   it (the counts are set to 0 just before each run and read just after;
   they count the launches issued eagerly and those recorded into a
   graph, not its replays), every engine must run one eager decode step,
   one capture and replays, the fleet's one prefill cache must run each
   shape eagerly once, capture it at its second use and replay it after
   that, with nothing evicted (each run logs its graph counts and capture
   seconds), the loads that repeat a prefill shape must replay it, and
   the sparse runs must drop blocks.  Then each of the eleventh slice's
   configs through the same CLI at full width, bf16, at phase 3's load
   (qwen3-moe-30b-a3b, internvl2-26b, mistral-nemo-12b and qwen1.5-4b at
   every layer; qwen1.5-110b at 8 of 80 and dbrx-132b at 4 of 40, the
   depth one 80 GB card holds), and qwen3-moe with int8 pages and sparse
   decode at the lever load, each model freed before the next: the same
   gates, and each logs the replayed decode step's device ms (CUDA events
   over bare replays of the first engine's graph), the wall of the
   engine's own step after the load and the idle share, beside the bytes
   bound of its weights; for MoE the expert products' ms a step, timed
   layer after layer at the step's buffer on the engine's weights, beside
   their bytes bound.  Then mamba2-130m (24 layers) and hymba-1.5b (32)
   at full width and depth, bf16, phase 3's load, and hymba again on the
   dense slab, the same gates (``phase_ssm_serve``); every matmul must
   take the tensor cores, hymba's in_proj and head staged;
   each logs its replayed step beside a bound of its weights (mamba2's
   tied embedding included) and its slots' SSM state read and written,
   and its SSM path's device ms alone (every layer's ``ssm_decode``
   captured as one graph).  Then whisper-base at full width and depth
   (6 + 6 layers), bf16, phase 3's load (``phase_encdec_serve``): the same
   gates, flash decode and no paged kernel, every matmul on the tensor
   cores but the 4 issued LM heads; it logs the replayed step beside its
   bytes bound (the decoder's weights, the tied head, the cross K/V), the
   encoder wave (a replay of the fleet's one captured prefill) beside its
   operations bound, the idle share and the peak memory; then the graph
   lockstep at that size.  Then training (``phase_train_run``):
   ``repro_torch.launch.train.main`` trains qwen2-7b at full width in bf16
   at 8 of 28 layers (the weights, grads, f32 moments and f32 accumulator
   of all 28 exceed one card), seq 4096, batch 2 in 2 microbatches, 4
   steps to a checkpoint, then ``--resume`` for 2; a straight run of 6
   from the same seed must give the same losses bit for bit, and every
   run's launches must equal what the code issues (remat runs each
   forward kernel twice); one step is measured (wall, device ms and idle
   share under the profiler, the forward / backward / optimizer split by
   CUDA events, tokens per second, peak memory, beside its 6 N D bound).
   Then ``--partitions 2 --sync-every 2 --fail-at 3:1 --ckpt-every 2`` at
   2 layers, 4 steps: the live replicas equal bit for bit after each
   sync, partition 1 gone from step 3, one checkpoint at the second
   sync.  Then the other families (``phase_train_family_run``) in bf16 at
   full width through ``make_train_step``, qwen3-moe at 4 of 48 layers,
   internvl2 at 6 of 48, mamba2, hymba and whisper whole: 4 steps, one
   measured as above (its bound from ``profiling/train_counts``), and two
   runs of 2 steps from one seed equal bit for bit; whisper's and
   mamba2's CLI for 2 steps and ``--resume`` for 1 against a straight run
   of 3.  Then the SPMD tooling (``phase_spmd``): qwen2-7b at full width,
   SPMD_LAYERS layer, SPMD_PARTS partitions of 1 x TRAIN_SEQ tokens
   through ``make_partitioned_train_step`` for SPMD_STEPS steps (each
   step's device ms by CUDA events, wall ms, peak memory), its launches
   what the code issues, bit for bit against each partition alone through
   ``make_train_step`` and ``sync_params`` the f32 mean; a one-rank NCCL
   process group's (1, 1) ``DeviceMesh``, the params placed on it by
   ``param_shardings`` whole and bit for bit, a SPMD_CKPT_ARCH checkpoint
   restored onto it by ``restore(shardings=)``; and ``python -m
   repro_torch.launch.dryrun --all --mesh both`` on the host, every cell
   OK.  The CNN slice: ``repro_torch.models.cnn
   .apply_cnn`` runs each of ResNet-50, GoogLeNet and VGG-16 at 224, batch
   64, fp32 on the card: one forward holds every conv2d and matmul call
   against its plain version on the call's own inputs (2e-4 of the
   output's scale), one times the kernels inside the forward with CUDA
   events, then the timed forwards (device ms per forward, images/s, peak
   memory, the conv2d and matmul launches per forward, which must equal
   the op tables' 53+1, 57+1, 13+3, with every conv but the C = 3 stem,
   52 / 56 / 12, on the tensor cores), and ``repro_torch.core.shaping_sim
   .partition_sweep`` reproduces the paper's Fig. 5 sweep for each net on
   the host, held to the reference's own reproduction gates.
4. The cluster on the card, at full-width bf16 qwen2-7b (seed 0), after
   the earlier phases' models are freed.  4a, the migrated-decode oracle
   on graph engines in paged float, int8 and the dense slab: a wave of
   SLOTS prompts prefilled on engine A is exported (``export_handoff``),
   encoded and decoded by the cluster codec and imported into engine B
   (``apply_handoff``); B then decodes it and refills SLOTS more beside an
   engine C that prefilled the same wave and never migrated it.  B's
   tokens, live slots' logits and KV state must equal C's bit for bit
   after the import and every step, and B's own steps (counted apart
   from C's) must launch the layout's decode kernel and the matmul.  4b, ``launch.cluster.run_cluster`` with two
   real worker processes on the card (``--transport mp``, round_robin,
   phase 3's load: 8 requests, prompt 32, 16 tokens, 4 slots each) must
   give the request stamps, tokens and summary (wall time aside) of the
   in-process ``EventScheduler`` fleet (policy none) of the same engines
   and weights; each worker must launch the matmul, flash attention and
   paged decode.  4c, the same load with ``--router pd --pd-split 1:1
   --trace``: every request completes, the prefill worker never decodes
   and the decode worker never prefills (their launch counts say so too),
   and the trace passes ``validate_chrome``, carries one ``kv_handoff``
   flow per migrated request, and its bw counter track integrates to
   ``bw_stats`` within 1e-9.  Each run logs its wall seconds, generated
   tokens per wall second, each worker's boot seconds, peak memory and
   launch counts (read back from its status snapshots; boot by part:
   process start to ``worker_main``, the CUDA context, the engine build)
   and the handoff's bytes per request.

The second-to-last line is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.  Without a card, or without the port's
sources beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BW = 3.35e12            # HBM3 bytes/s, data sheet
H100_BF16 = 989e12           # dense bf16 tensor-core FLOP/s, data sheet
TOL = {"bfloat16": 3e-2, "float32": 2e-4}
QTOL = 5e-2                  # packed KV pages (tests/test_kv_quant.py)
MODEL_TOL = 1e-3
H100_FP32 = 67e12            # float32 FLOP/s outside the tensor cores

# flash attention's tile edges (64 flattened rows q_pos * G + g and 64 keys
# a tile): G = 7 puts Sq * G = 63, 70 on both sides of 64 at Sq = 9, 10;
# Sq = 65, 100 cross a key tile; D = 16, 80 are zero-padded to 32, 96
FA_GROUPS = (1, 7, 8, 16)
FA_LENGTHS = (1, 9, 10, 63, 65, 100)
FA_WINDOWS = (0, 16, 100)
FA_DIMS = (16, 64, 80, 128)
FA_LONG = 2048               # a long prompt: operations-bound

# the matmul's tensor-core tiles (16 / 64 / 128 rows, 128 columns, K steps
# of 32 or 64 in a ring of 4): M on both sides of each row tile; K = 1000
# ends inside a K step, K = 72 is shorter than the ring; N = 520 and 8 end
# inside a column tile
MM_EDGE_MS = (1, 4, 15, 16, 17, 63, 64, 65, 127, 128, 129, 200)
MM_EDGE_KN = ((1000, 520), (72, 8))
MM_SWEEP = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 20, 28)
# the staged grid: operands whose rows are not 16-byte aligned on the
# tensor cores; (K, N) cover every K mod 8 and N mod 8, the K step's and
# the 128-column tile's edges; (A, B) bytes off a 16-byte boundary
MM_STAGED_MS = (1, 4, 16, 17, 64, 65, 128, 129, 300)
MM_STAGED_KN = ((7, 1), (63, 7), (65, 9), (1000, 127), (3583, 129),
                (1000, 521), (3583, 3257), (130, 130), (1003, 515), (68, 4),
                (125, 517), (1006, 262), (1000, 520))
MM_STAGED_OFFS = ((0, 0), (2, 6), (6, 14), (14, 2))
MM_STAGED_SPLITS = (1, 2, 3, 7, 10_000)

# the decode template's split walk: contexts 1, 31, 32, 33 around the first
# 32-row tile edge, and contexts of about DECODE_LONG (bytes-bound), each
# timed launch on its own operands, LONG_SETS of them together past the L2
EDGE_CURS = [0, 30, 31, 32]
DECODE_LONG = 4096
LONG_OFFSETS = (0, 5, 3, 14)
LONG_SETS = 4

# the CNN slice: the paper's total batch, fp32 (the paper's dtype)
CNN_NETS = ("resnet50", "googlenet", "vgg16")
CNN_BATCH = 64
CNN_CHECK_BATCH = 2          # card vs CPU, and the conv2d checks
CNN_REPS = 3                 # timed forwards per net
CNN_TOL = 1e-3               # relative to max|cpu logits|
CNN_LAUNCHES = {"resnet50": (53, 1), "googlenet": (57, 1),
                "vgg16": (13, 3)}     # (conv2d, matmul) per forward
CNN_SWEEP = (2, 4, 8, 16)    # partitions of the Fig. 5 sweep
# the conv2d tensor-core tiles (128 rows, 64 / 128 columns, depth steps of
# 64 bf16 / 32 f32): 1-2 images of 9 / 12 / 13 rows put M = 81 to 338 on
# both sides of a row tile; Cout 8, 72, 200 end inside a column tile; C = 8,
# 16, 24 with 3x3 / 5x5 / 7x7 taps give R that are not whole steps
CONV_EDGE_TAPS = (1, 3, 5, 7)
CONV_EDGE_CS = (8, 16, 24, 64)
CONV_EDGE_HS = (9, 12, 13)
CONV_EDGE_KOUT = (8, 72, 200)
CONV_SWEEP = (1, 2, 3, 4, 6, 8)
# conv2d launches per forward on the tensor cores: all but the C = 3 stem
CNN_CONV_MMA = {"resnet50": 52, "googlenet": 56, "vgg16": 12}
SWEEP_BATCH = 64             # its total batch (benchmarks/common.py SIM_KW)

SERVE_ARGS = ["--arch", "qwen2-7b", "--partitions", "2", "--stagger",
              "demand", "--requests", "8", "--batch", "4", "--prompt-len",
              "32", "--gen", "16", "--device", "cuda"]
SLOTS, PROMPT, GEN = 4, 32, 16
# the graph lockstep's step traced under the profiler: its third decode
# step, the graph engine's first replay after the one that follows capture
TRACED_STEP = 2
# the graph lockstep's refill traced under the profiler: its third, the
# third use of one refill shape, a replay
TRACED_REFILL = 2
# the lever runs: prompts of 64 tokens span 5 blocks of 16 once decode
# starts, so a threshold of 0.25 > 1/5 leaves at least two blocks of every
# (slot, kv head) below it, one of which is not the current block: blocks
# are dropped whatever the weights
LEVER_PROMPT, LEVER_GEN, THRESHOLD = 64, 8, 0.25
# the eleventh slice's configs, served at full width in bf16 at the depth
# one 80 GB card holds (None: every layer; qwen1.5-110b is ~220 GB and
# dbrx-132b ~264 GB whole)
FAMILY_RUNS = {"qwen3-moe-30b-a3b": None, "internvl2-26b": None,
               "mistral-nemo-12b": None, "qwen1.5-4b": None,
               "qwen1.5-110b": 8, "dbrx-132b": 4}
# phase 2 holds each at 2 layers in fp32 on the card and the CPU; dbrx at
# 1 (12.7 GB of f32 experts a layer)
FAMILY_CHECK_LAYERS = {"dbrx-132b": 1}
FAMILY_LOCKSTEP = ("qwen3-moe-30b-a3b", "internvl2-26b")
FAMILY_LEVER = "qwen3-moe-30b-a3b"     # int8 pages + sparse decode
STEP_CALLS = 9          # engine steps timed after a family's serve run
# phase 4: the serving load of phase 3 through two worker processes
CLUSTER_REQUESTS = 8
HEARTBEAT_S = 600.0     # full-width workers boot for tens of seconds
LEVER_ARGS = ["--arch", "qwen2-7b", "--partitions", "1", "--requests", "4",
              "--batch", "4", "--prompt-len", str(LEVER_PROMPT), "--gen",
              str(LEVER_GEN), "--device", "cuda", "--no-sim"]


def flag(argv, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def with_flag(argv, name: str, value: int) -> list:
    out = list(argv)
    out[out.index(name) + 1] = str(value)
    return out


# the refill-heavy run: the calibration's load (32 requests through 2 x 4
# slots: 8 in the waves, 24 by refills)
REFILL_ARGS = with_flag(SERVE_ARGS, "--requests", 32)
# the lever runs again at a load whose replayed steps and refills dominate
# (16 requests x 16 tokens through 4 slots: one wave, 12 refills)
LONG_LEVER_ARGS = with_flag(with_flag(LEVER_ARGS, "--requests", 16),
                            "--gen", 16)
LEVER_RUNS = {    # "paged": the float pool at the same load, for comparison
    "paged": [],
    "int8+sparse": ["--kv-dtype", "int8", "--sparse-threshold",
                    str(THRESHOLD)],
    "fp8": ["--kv-dtype", "fp8"],
    "sparse+prefix": ["--sparse-threshold", str(THRESHOLD),
                      "--prefix-cache"],
    "dense": ["--dense"],
}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(torch, fn, n_args: int, iters: int = 20) -> float:
    """Mean device ms of ``fn(i)`` over ``iters`` launches cycling over
    ``n_args`` input sets (distinct buffers keep the L2 cold, as on the
    serving path where each layer's weights are read once per step).
    The card first spins for ~10 ms so that the host has queued every
    launch before the start event fires: the events then bracket device
    work only, not the wrappers' host cost (tens of microseconds a call,
    more than some of these kernels take)."""
    fn(0)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for i in range(iters):
        fn(i % n_args)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(byts: float, flops: float, peak: float):
    tb, tf = byts / H100_BW, flops / peak
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def check_close(torch, name, got, want, tol):
    err = (got.float() - want.float()).abs()
    lim = tol + tol * want.float().abs()
    worst = float(err.max())
    if not torch.isfinite(got.float()).all() or bool((err > lim).any()):
        fail(f"{name}: kernel disagrees with its plain version (max abs err "
             f"{worst:.3g}, tolerance {tol} abs + {tol} rel)")
    return worst


def paged_tables(torch, curs, bs, dev, inactive=True):
    """Shuffled block chains covering positions [0, cur] of each slot plus
    a null-padded tail; with ``inactive`` a slot with cur 0 stays on null
    block 0 (an inactive slot).  Returns (tables (B, T) int32, pool
    blocks N)."""
    B = len(curs)
    T = max(-(-(c + 1) // bs) for c in curs) + 1
    N = 1 + B * T
    free = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        B)).add(1).tolist()
    tables = torch.zeros((B, T), dtype=torch.int32)
    for b, c in enumerate(curs):
        if c > 0 or not inactive:
            for t in range(-(-(c + 1) // bs)):
                tables[b, t] = free.pop()
    return tables.to(dev), N


def rows_read(torch, cur, bs, T, Hkv, keep=None):
    """(slot, kv head, position) rows a decode kernel must read: positions
    [0, cur[b]] of every kv head, only in kept blocks when ``keep`` (B,
    Hkv, T) is given."""
    pos = torch.arange(T * bs, device=cur.device)
    live = (pos[None, :] <= cur[:, None].long())            # (B, S)
    live = live[:, None, :].expand(-1, Hkv, -1)
    if keep is not None:
        live = live & keep.bool().repeat_interleave(bs, dim=-1)
    return float(live.sum())


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def staged_view(torch, rnd, shape, off):
    """A contiguous bf16 matrix ``off`` bytes past a 16-byte boundary."""
    n = shape[0] * shape[1]
    flat = rnd((n + 8,), torch.bfloat16)
    return flat[off // 2:off // 2 + n].view(shape)


def staged_grid(torch, rnd) -> int:
    """The tensor-core route on operands whose rows are not 16-byte
    aligned, against ``ref.matmul`` at 3e-2: every M of MM_STAGED_MS at
    every (K, N) of MM_STAGED_KN with A and B off by MM_STAGED_OFFS; the
    forced splits of MM_STAGED_SPLITS at M = 65; each staged combination
    (A only, B only, both) launched twice on the same inputs bit for bit,
    and a staged launch on views off 16 bytes bit for bit against an
    aligned launch on copies of them (one tile layout, one product loop).
    Returns the launches held to the plain version."""
    from repro_torch.kernels.matmul import matmul as mm_k
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref

    t0 = time.perf_counter()
    tol, n = TOL["bfloat16"], 0
    before = (mm_ops.matmul.staged, dict(mm_ops.matmul.routes))
    for K, N in MM_STAGED_KN:
        for a_off, b_off in MM_STAGED_OFFS:
            b = staged_view(torch, rnd, (K, N), b_off).mul_(1 / math.sqrt(K))
            for M in MM_STAGED_MS:
                a = staged_view(torch, rnd, (M, K), a_off)
                want = mm_ref.matmul(a, b)
                got = mm_ops.matmul(a, b)
                staged = (K % 8 != 0 or a_off != 0, N % 8 != 0 or b_off != 0)
                p = mm_k.plan_for(a, b)
                if p.route != "mma" or p.staged != staged:
                    fail(f"matmul staged {M}x{K}x{N} (A +{a_off} B +{b_off} "
                         f"bytes): plan {p}, want mma with staged {staged}")
                check_close(torch, f"matmul staged {M}x{K}x{N} A +{a_off} "
                            f"B +{b_off} ({p})", got, want, tol)
                n += 1
                if any(staged) and not torch.equal(got, mm_k.launch(a, b, p)):
                    fail(f"matmul staged {M}x{K}x{N} A +{a_off} B +{b_off} "
                         f"({p}): two launches on the same inputs differ")
                if any(staged) and K % 8 == 0 and N % 8 == 0 and M in (
                        4, 65, 300) and not torch.equal(
                            got, mm_k.matmul_cuda(a.clone(), b.clone())):
                    fail(f"matmul staged {M}x{K}x{N} A +{a_off} B +{b_off}: "
                         "differs from the aligned launch on copies")
            # forced splits, more than the K steps last
            M = 65
            a = staged_view(torch, rnd, (M, K), a_off)
            want = mm_ref.matmul(a, b)
            for splits in MM_STAGED_SPLITS:
                q = mm_k.plan_for(a, b, splits=splits)
                check_close(torch, f"matmul staged {M}x{K}x{N} A +{a_off} "
                            f"B +{b_off} ({q})", mm_k.launch(a, b, q), want,
                            tol)
                n += 1
    launched = mm_ops.matmul.staged - before[0]
    want_staged = sum(
        len(MM_STAGED_MS) for K, N in MM_STAGED_KN
        for a_off, b_off in MM_STAGED_OFFS
        if K % 8 or a_off or N % 8 or b_off)
    if launched != want_staged or any(
            mm_ops.matmul.routes[r] != before[1][r]
            for r in ("skinny", "tiled")):
        fail(f"matmul staged grid: the wrapper counted {launched} staged "
             f"launches (want {want_staged}) and routes {mm_ops.matmul.routes}"
             f" (from {before[1]})")
    log(f"phase 1: matmul staged grid: {n} launches on the tensor cores "
        f"within {tol} of ref.matmul (M {MM_STAGED_MS}, (K, N) "
        f"{MM_STAGED_KN}, A / B off {MM_STAGED_OFFS} bytes, splits "
        f"{MM_STAGED_SPLITS} at M = 65), each staged combination bit for "
        f"bit twice, aligned copies bit for bit; {launched} staged launches "
        "counted "
        f"({time.perf_counter() - t0:.1f} s)")
    return n


def staged_products():
    """(tag, M, K, N) of the products whose operands are not 16-byte rows:
    hymba's in_proj and the heads of 32,001 / 92,553 / 51,865 columns, at a
    decode step's M = SLOTS, hymba's in_proj at a wave's 4 x 160 rows, the
    training forward's M (``train_family_products``) and M = 64 (the
    64-row tile; "train" and "64" are timed with their backward
    products)."""
    out = []
    for tag, M, K, N, _, _ in train_family_products():
        out.append((f"{tag} decode", SLOTS, K, N))
        if "hymba-1.5b block" in tag:
            out.append((f"{tag} wave", SLOTS * 160, K, N))
        out += [(f"{tag} train", M, K, N), (f"{tag} 64", 64, K, N)]
    return out


def staged_ab(torch) -> dict:
    """The staged route's A/B (``--only matmul``): each product of
    ``staged_products`` (training ones as forward, dA = dC B^T and dB =
    A^T dC), timed in turns on the plan's staged launch and
    ``torch.matmul``, the weight buffers past the L2; and the plan's
    launch at the shape cut to whole 16-byte rows (K and N rounded down to
    multiples of 8: no operand staged), for what the staging costs.  The
    parent's route is timed against another checkout by
    ``profiling/matmul_ab``, not here."""
    from repro_torch.kernels.matmul import matmul as mm_k

    g = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(bf)

    out = {}
    for tag, M, K, N in staged_products():
        calls = {"forward": (M, K, N)}
        if tag.endswith(("train", "64")):
            calls.update({"dA": (M, N, K), "dB": (K, M, N)})
        for kind, (Mx, Kx, Nx) in calls.items():
            n_buf = max(1, min(16, int(256e6 // (Kx * Nx * 2)) + 1))
            a = rnd((Mx, Kx))
            bs = [rnd((Kx, Nx), 1 / math.sqrt(Kx)) for _ in range(n_buf)]
            fns = {"staged": lambda i: mm_k.matmul_cuda(a, bs[i])}
            fns["torch"] = lambda i: torch.matmul(a, bs[i])
            ka, na = Kx - Kx % 8, Nx - Nx % 8
            a8 = rnd((Mx, ka))
            b8 = [rnd((ka, na), 1 / math.sqrt(ka)) for _ in range(n_buf)]
            fns["aligned"] = lambda i: mm_k.matmul_cuda(a8, b8[i])
            order = list(fns) + list(fns)[::-1]
            iters = 3 if Mx * Kx * Nx > 2e10 else 10
            times = {k: [] for k in fns}
            for k in order:
                times[k].append(time_ms(torch, fns[k], n_buf, iters))
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            b_ms, by = bound(2 * (Mx * Kx + Kx * Nx + Mx * Nx),
                             2 * Mx * Kx * Nx, H100_BF16)
            p = mm_k.plan_for(a, bs[0])
            name = f"{tag} {kind} ({Mx},{Kx},{Nx})"
            out[name] = dict(ms, bound_ms=b_ms, bound_by=by, plan=str(p))
            log(f"  matmul staged A/B {name} [{p.route} bm {p.bm} splits "
                f"{p.splits} staged {p.staged}]: "
                + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
                + f" ms; bound {b_ms:.4f} ({by})")
            del a, bs, a8, b8
        torch.cuda.empty_cache()
    return out


def phase_matmul(torch, cfg, sweep=False):
    """The matmul kernels against ``ref.matmul`` on the card: the main
    path's shapes (M = slots at decode, slots x prompt in a prefill wave) in
    bf16 and fp32; the edges of the tensor-core tiles (every M of MM_EDGE_MS
    at K and N that are not whole K steps or column tiles, and K shorter
    than the ring); forced split counts on every route; bf16 operands whose
    rows are not 16-byte aligned, which must take the tensor cores, staged
    (``staged_grid``); every route twice on the same inputs (bf16 on the
    tensor cores, f32 on the CUDA cores), bit for bit.  Then the decode
    step's 197 calls and the prefill wave's 196, each shape timed on its
    own weight buffers past the L2, beside
    ``torch.matmul`` and the bytes bound; the CNNs' fp32 fc at M = 64.
    ``sweep`` also times the tensor-core route at forced split counts and
    the staged route's A/B (``staged_ab``)."""
    from repro_torch.kernels.matmul import matmul as mm_k
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def operands(M, K, N, dt):
        return rnd((M, K), dt), rnd((K, N), dt, 1 / math.sqrt(K))

    def tol(dt):
        return TOL[str(dt).split(".")[1]]

    d, hd, Hq, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    # (K, N, calls per decode step) of every projection and the LM head
    proj = [(d, Hq * hd, 2 * cfg.n_layers),          # wq, wo (square)
            (d, Hkv * hd, 2 * cfg.n_layers),         # wk, wv
            (d, cfg.d_ff, 2 * cfg.n_layers),         # w1, w3
            (cfg.d_ff, d, cfg.n_layers),             # w2
            (d, cfg.vocab, 1)]                       # LM head
    bf = torch.bfloat16
    out = {}

    # -- correctness at the main path's widths, bf16 and fp32, plus ragged
    # shapes that no 16-byte route can take
    worst = 0.0
    for M in (SLOTS, SLOTS * PROMPT):
        for K, N, _ in proj:
            for dt in (bf, torch.float32):
                a, b = operands(M, K, N, dt)
                e = check_close(torch, f"matmul {M}x{K}x{N} {dt}",
                                mm_ops.matmul(a, b), mm_ref.matmul(a, b),
                                tol(dt))
                if dt == bf:
                    worst = max(worst, e)
                del a, b
    for M, K, N in ((37, 1000, 517), (5, 3583, 130), (129, 100, 70)):
        for dt in (bf, torch.float32):
            a, b = operands(M, K, N, dt)
            check_close(torch, f"matmul ragged {M}x{K}x{N} {dt}",
                        mm_ops.matmul(a, b), mm_ref.matmul(a, b), tol(dt))
    # the tensor-core tiles' edges: M around 16 / 64 / 128 rows, K past a
    # whole K step and shorter than the ring, N past a 128-column tile
    edge_worst = 0.0
    for M in MM_EDGE_MS:
        for K, N in MM_EDGE_KN:
            for dt in (bf, torch.float32):
                a, b = operands(M, K, N, dt)
                e = check_close(torch, f"matmul edge {M}x{K}x{N} {dt}",
                                mm_ops.matmul(a, b), mm_ref.matmul(a, b),
                                tol(dt))
                if dt == bf:
                    edge_worst = max(edge_worst, e)
    # forced splits on every route (the last one more than the K steps)
    n_forced = 0
    for route, M, K, N in (("mma", 4, d, Hkv * hd), ("mma", 64, 1000, 520),
                           ("mma", 128, d, d), ("mma", 200, 1000, 520),
                           ("mma", 200, 1003, 517), ("mma", 4, 1000, 521),
                           ("skinny", 4, 1000, 520),
                           ("tiled", 128, 1000, 520)):
        for dt in ((bf,) if route == "mma" else (torch.float32,)):
            a, b = operands(M, K, N, dt)
            want = mm_ref.matmul(a, b)
            for splits in (1, 2, 3, 7, 10_000):
                p = mm_k.plan_for(a, b, route=route, splits=splits)
                check_close(torch, f"matmul {route} {M}x{K}x{N} {dt} splits "
                            f"{p.splits}", mm_k.launch(a, b, p), want,
                            tol(dt))
                n_forced += 1
    # every bf16 operand takes the tensor cores: the staged grid
    n_staged = staged_grid(torch, rnd)
    # every route twice on the same inputs (bf16 on the tensor cores, f32
    # on the CUDA cores): bit for bit
    for route, M, K, N, dt in (("mma", SLOTS, d, d, bf), ("mma", 64, d, d, bf),
                               ("mma", SLOTS * PROMPT, d, d, bf),
                               ("mma", SLOTS * PROMPT, d, Hkv * hd, bf),
                               ("mma", 200, 1003, 517, bf),
                               ("mma", 4, 1000, 521, bf),
                               ("skinny", SLOTS, d, d, torch.float32),
                               ("tiled", SLOTS * PROMPT, d, d,
                                torch.float32)):
        a, b = operands(M, K, N, dt)
        p = mm_k.plan_for(a, b, route=route)
        if not torch.equal(mm_k.launch(a, b, p), mm_k.launch(a, b, p)):
            fail(f"matmul {route} {M}x{K}x{N} {dt} ({p}): two launches on "
                 "the same inputs differ")
    log(f"phase 1: matmul matches its plain version at {2 * len(proj)} "
        f"main-path shapes x 2 dtypes (bf16 max abs err {worst:.3g}), 3 "
        f"ragged ones, {len(MM_EDGE_MS) * len(MM_EDGE_KN)} tile-edge shapes "
        f"x 2 dtypes (bf16 {edge_worst:.3g}), {n_forced} forced splits, "
        f"{n_staged} staged launches on the tensor cores; each route "
        "is bitwise repeatable")

    def b_buffers(K, N, dt):
        """Distinct weight buffers, together past the 50 MB L2."""
        n_buf = max(1, min(16, int(256e6 // (K * N * 2)) + 1))
        return [rnd((K, N), dt, 1 / math.sqrt(K)) for _ in range(n_buf)]

    def timed(M, K, N, dt=bf):
        a, bs = rnd((M, K), dt), b_buffers(K, N, dt)
        n = len(bs)
        t_k = time_ms(torch, lambda i: mm_ops.matmul(a, bs[i]), n)
        t_p = time_ms(torch, lambda i: mm_ref.matmul(a, bs[i]), n, 5)
        t_l = time_ms(torch, lambda i: torch.matmul(a, bs[i]), n)
        peak = H100_BF16 if dt == bf else H100_FP32
        b_ms, by = bound(a.element_size() * (M * K + K * N + M * N),
                         2 * M * K * N, peak)
        p = mm_k.plan_for(a, bs[0])
        del a, bs
        return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                    bound_by=by, plan=p)

    def add(total, r, calls):
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[k] = total.get(k, 0.0) + calls * r[k]

    # -- one decode step: 197 calls at M = slots
    step = {}
    for K, N, calls in proj:
        r = timed(SLOTS, K, N)
        add(step, r, calls)
        log(f"  matmul bf16 {SLOTS}x{K}x{N} (x{calls}/step, {r['plan']}): "
            f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f}"
            f" ({r['bound_by']})")
    # -- one prefill wave: 196 calls at M = slots x prompt
    wave = {}
    for K, N, calls in proj[:-1]:
        r = timed(SLOTS * PROMPT, K, N)
        add(wave, r, calls)
        log(f"  matmul bf16 {SLOTS * PROMPT}x{K}x{N} (x{calls}/wave, "
            f"{r['plan']}): kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']})")
    n_step = sum(c for _, _, c in proj)
    n_wave = sum(c for _, _, c in proj[:-1])
    log(f"  matmul decode step ({n_step} calls at M={SLOTS}): kernel_ms "
        f"{step['ms']:.3f} plain_ms {step['plain_ms']:.3f} library_ms "
        f"{step['library_ms']:.3f} bound_ms {step['bound_ms']:.3f}")
    log(f"  matmul prefill wave ({n_wave} calls at M={SLOTS * PROMPT}): "
        f"kernel_ms {wave['ms']:.3f} plain_ms {wave['plain_ms']:.3f} "
        f"library_ms {wave['library_ms']:.3f} bound_ms "
        f"{wave['bound_ms']:.3f}")
    # -- the CNNs' fc at the paper's batch, fp32 (ResNet-50's)
    r = timed(CNN_BATCH, 2048, 1000, torch.float32)
    log(f"  matmul fp32 {CNN_BATCH}x2048x1000 (ResNet-50 fc, {r['plan']}): "
        f"kernel_ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
        f"{r['library_ms']:.4f} (TF32 off) bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']})")
    if sweep:
        for M in (SLOTS, SLOTS * PROMPT):
            for K, N, _ in proj[:4] + ([proj[4]] if M == SLOTS else []):
                a, bs = rnd((M, K), bf), b_buffers(K, N, bf)
                plan = mm_k.plan_for(a, bs[0])
                row = []
                for splits in MM_SWEEP:
                    p = mm_k.plan_for(a, bs[0], route="mma", splits=splits)
                    if p.splits != splits:
                        continue
                    t = time_ms(torch, lambda i: mm_k.launch(a, bs[i], p),
                                len(bs))
                    row.append(f"{splits}: {t:.4f}")
                log(f"  matmul sweep mma {M}x{K}x{N} (plan splits "
                    f"{plan.splits}): ms by splits " + ", ".join(row))
                del a, bs
        out["matmul_staged_ab"] = staged_ab(torch)
    out["matmul"] = dict(
        shape=f"one decode step: {n_step} calls at M={SLOTS} (28 x q,k,v,o,"
              f"w1,w3,w2 + LM head), bf16; prefill: one wave's {n_wave} "
              f"calls at M={SLOTS * PROMPT}",
        max_abs_err=worst, ms=step["ms"], plain_ms=step["plain_ms"],
        library_ms=step["library_ms"], bound_ms=step["bound_ms"],
        bound_by="bytes", prefill_ms=wave["ms"],
        prefill_plain_ms=wave["plain_ms"],
        prefill_library_ms=wave["library_ms"],
        prefill_bound_ms=wave["bound_ms"])
    return out


def phase_flash_attention(torch, cfg):
    """The prefill flash-attention kernel against ``ref.attention`` on the
    card: the prefill wave, a ragged windowed shape and D = 16 in bf16 and
    fp32, then bf16 over the tensor-core kernel's tile edges (every mix of
    FA_GROUPS, FA_LENGTHS, FA_WINDOWS and FA_DIMS) and a FA_LONG-token
    prompt.  Timed at the main path's prefill wave and at the long prompt
    beside SDPA (K/V expanded to the query heads) and the roofline bound."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def check(tag, dt, B, Sq, hq, hkv, D, w):
        q, k, v = (rnd((B, Sq, hq, D), dt), rnd((B, Sq, hkv, D), dt),
                   rnd((B, Sq, hkv, D), dt))
        return check_close(torch, f"flash_attention {tag} {dt}",
                           fa_ops.flash_attention(q, k, v, window=w),
                           fa_ref.attention(q, k, v, window=w),
                           TOL[str(dt).split(".")[1]])

    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    worst = 0.0
    cases = [(SLOTS, PROMPT, Hq, Hkv, hd, 0, "main"),
             (2, 45, Hq, Hkv, hd, 16, "ragged+window"),
             (3, 29, 4, 2, 16, 0, "D=16")]
    for B, Sq, hq, hkv, D, w, tag in cases:
        for dt in (torch.bfloat16, torch.float32):
            e = check(tag, dt, B, Sq, hq, hkv, D, w)
            if tag == "main" and dt == torch.bfloat16:
                worst = e
    edges = [(G, Sq, w, D) for G in FA_GROUPS for Sq in FA_LENGTHS
             for w in FA_WINDOWS for D in FA_DIMS]
    edge_worst = max(check(f"G={G} S={Sq} window={w} D={D}", torch.bfloat16,
                           2, Sq, 2 * G, 2, D, w) for G, Sq, w, D in edges)
    long_err = check(f"long S={FA_LONG}", torch.bfloat16, 1, FA_LONG, Hq,
                     Hkv, hd, 0)
    log(f"phase 1: flash_attention matches at {len(cases)} shapes x 2 dtypes"
        f" (bf16 main max abs err {worst:.3g}), {len(edges)} bf16 tile-edge "
        f"shapes (max abs err {edge_worst:.3g}) and the {FA_LONG}-token prompt"
        f" ({long_err:.3g})")

    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = Hq // Hkv

    def timings(B, S, iters):
        q = rnd((B, S, Hq, hd), torch.bfloat16)
        k = rnd((B, S, Hkv, hd), torch.bfloat16)
        v = rnd((B, S, Hkv, hd), torch.bfloat16)
        qt = q.transpose(1, 2).contiguous()                 # SDPA layout
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        t_k = time_ms(torch, lambda i: fa_ops.flash_attention(q, k, v), 1,
                      iters)
        t_p = time_ms(torch, lambda i: fa_ref.attention(q, k, v), 1, 5)
        t_l = time_ms(torch, lambda i: sdpa(qt, kt, vt, is_causal=True), 1,
                      iters)
        pairs = S * (S + 1) / 2
        flops = 4 * B * Hq * hd * pairs
        b_ms, by = bound(2 * (2 * q.numel() + 2 * k.numel()), flops,
                         H100_BF16)
        return t_k, t_p, t_l, b_ms, by, flops

    t_k, t_p, t_l, b_ms, by, _ = timings(SLOTS, PROMPT, 20)
    log(f"  flash_attention bf16 ({SLOTS},{PROMPT},{Hq},{hd}): kernel_ms "
        f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (SDPA on K/V "
        f"expanded to {Hq} heads) bound_ms {b_ms:.5f} ({by})")
    lt_k, lt_p, lt_l, lb_ms, lby, lflops = timings(1, FA_LONG, 10)
    log(f"  flash_attention bf16 long (1,{FA_LONG},{Hq},{hd}) causal: "
        f"kernel_ms {lt_k:.4f} ({lflops / lt_k / 1e9:.1f} TFLOP/s) plain_ms "
        f"{lt_p:.4f} library_ms {lt_l:.4f} ({lflops / lt_l / 1e9:.1f} "
        f"TFLOP/s) bound_ms {lb_ms:.5f} ({lby})")
    return {"flash_attention": dict(
        shape=f"one layer of a prefill wave: q ({SLOTS},{PROMPT},{Hq},{hd}), "
              f"k/v ({SLOTS},{PROMPT},{Hkv},{hd}), causal, bf16; long: "
              f"q (1,{FA_LONG},{Hq},{hd})",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=b_ms, bound_by=by, long_ms=lt_k, long_library_ms=lt_l,
        long_bound_ms=lb_ms)}


def phase_decode_kernels(torch, cfg, prefix=0, label=""):
    """Phase 1 for the four entry points of the decode-attention template
    (paged_decode, paged_decode_quant, paged_decode_sparse, flash_decode).
    Each is held against its plain version through the model path's
    wrapper (the split plan) and through its kernel at forced splits (1,
    the plan's, more than the walk's tiles), at the serving path's shapes
    (its contexts ``prefix`` rows later: an image prefix), a ragged window
    with an inactive slot, D = 16 and D = 20, contexts 1, 31, 32 and 33
    around the first tile edge, and contexts of about DECODE_LONG; then
    each kernel is timed alone (its ``*_cuda`` launch with the plan's
    splits: no wrapper's counting ops) at the main shape and at
    DECODE_LONG.  Each log line starts with ``label`` and gives the worst
    error over all of the kernel's cases."""
    from repro_torch.kernels import decode_split
    from repro_torch.kernels.flash_decode import flash_decode as fd_k
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as pa_k
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.serving.kv_pool import quantize_kv

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(4)
    sms = decode_split.sm_count(torch.device(dev))

    def rnd(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def keys(shape, dtype):
        # each (block, kv head) tile of K carries its own offset, so the
        # blocks' estimated masses differ as a real model's do
        base = torch.randn(shape, generator=g, device=dev)
        off = torch.randn((shape[0], 1, *shape[2:]), generator=g, device=dev)
        return (base + 2 * off).to(dtype)

    def counts(walk, B, hkv):
        """Forced splits: 1, the plan's, more than the walk's tiles."""
        tiles = -(-walk // decode_split.KT)
        return sorted({1, decode_split.plan(B, hkv, walk, sms), tiles + 3})

    worst_all = {}

    def held(name, wrapped, kernel, want, tol, walk, B, hkv):
        """The model path's wrapper, then the kernel at each forced split
        count, against one plain output."""
        name = f"{label}{name}"
        worst = check_close(torch, name, wrapped(), want, tol)
        for n in counts(walk, B, hkv):
            worst = max(worst, check_close(torch, f"{name} splits={n}",
                                           kernel(n), want, tol))
        k = name[len(label):].split()[0]
        worst_all[k] = max(worst_all.get(k, 0.0), worst)
        return worst

    hd, Hq, Hkv, bs = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, 16
    G = Hq // Hkv
    out = {}
    bf, f32 = torch.bfloat16, torch.float32
    lever_curs = [prefix + LEVER_PROMPT + o for o in (1, 7, 3, 5)]
    long_curs = [DECODE_LONG + o for o in LONG_OFFSETS]

    def cases(main):
        # (curs, window, Hq, Hkv, D, tag, cur 0 = inactive slot)
        return [(main, 0, Hq, Hkv, hd, "main", True),
                ([0, 5, 37, 63], 20, Hq, Hkv, hd, "ragged+window+inactive",
                 True),
                ([3, 17, 40], 0, 4, 2, 16, "D=16", True),
                ([3, 17, 40], 0, 4, 2, 20, "D=20", True),
                (EDGE_CURS, 0, Hq, Hkv, hd, "contexts 1/31/32/33", False),
                (long_curs, 0, Hq, Hkv, hd, f"contexts ~{DECODE_LONG}",
                 False)]

    def plan_of(tables):
        return decode_split.plan(tables.shape[0], Hkv, tables.shape[1] * bs,
                                 sms)

    # -- paged_decode (float pages): the serving path's contexts
    worst = 0.0
    pcases = cases([prefix + PROMPT + o for o in (3, 9, 1, 14)])
    for curs, w, hq, hkv, D, tag, inactive in pcases:
        B = len(curs)
        tables, N = paged_tables(torch, curs, bs, dev, inactive)
        cur = torch.tensor(curs, dtype=torch.int32, device=dev)
        for dt in (bf, f32):
            qd = rnd((B, hq, D), dt)
            kp, vp = rnd((N, bs, hkv, D), dt), rnd((N, bs, hkv, D), dt)
            e = held(f"paged_decode {tag} {dt}",
                     lambda: pa_ops.paged_decode(qd, kp, vp, tables, cur,
                                                 window=w),
                     lambda n: pa_k.paged_decode_cuda(
                         qd, kp, vp, tables, cur, window=w, splits=n),
                     pa_ref.paged_decode_attention(qd, kp, vp, tables, cur,
                                                   window=w),
                     TOL[str(dt).split(".")[1]], tables.shape[1] * bs, B, hkv)
            if tag == "main" and dt == bf:
                worst = e
                main = (qd, kp, vp, tables, cur)
    qd, kp, vp, tables, cur = main
    t_k = time_ms(torch, lambda i: pa_k.paged_decode_cuda(qd, kp, vp, tables,
                                                          cur), 1)
    t_p = time_ms(torch, lambda i: pa_ref.paged_decode_attention(
        qd, kp, vp, tables, cur), 1)

    def float_bound(q, cur, n_rows, extra):
        return bound(2 * (2 * q.numel() + 2 * n_rows * hd) + 4 * extra,
                     4 * G * hd * n_rows, H100_BF16)

    b_ms, by = float_bound(qd, cur, float((cur + 1).sum()) * Hkv,
                           tables.numel() + cur.numel())
    # contexts of about DECODE_LONG, each launch on its own pool (together
    # past the 50 MB L2, as a decode step finds each layer's pages cold)
    ltables, lN = paged_tables(torch, long_curs, bs, dev)
    lcur = torch.tensor(long_curs, dtype=torch.int32, device=dev)
    sets = [(rnd((SLOTS, Hq, hd), bf), rnd((lN, bs, Hkv, hd), bf),
             rnd((lN, bs, Hkv, hd), bf)) for _ in range(LONG_SETS)]
    lt_k = time_ms(torch, lambda i: pa_k.paged_decode_cuda(
        *sets[i], ltables, lcur), LONG_SETS)
    lb_ms, _ = float_bound(sets[0][0], lcur, float((lcur + 1).sum()) * Hkv,
                           ltables.numel() + lcur.numel())
    del sets
    out["paged_decode"] = dict(
        shape=f"one layer of a decode step: q ({SLOTS},{Hq},{hd}), pool of "
              f"{kp.shape[0]} blocks x {bs}, contexts {cur.tolist()}, bf16; "
              f"long: contexts {lcur.tolist()}",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=None,
        bound_ms=b_ms, bound_by=by, long_ms=lt_k, long_bound_ms=lb_ms,
        splits=plan_of(tables), long_splits=plan_of(ltables))
    log(f"phase 1: {label}paged_decode matches at {len(pcases)} shapes x 2 "
        f"dtypes x (the wrapper + forced splits), max abs err "
        f"{worst_all['paged_decode']:.3g}; kernel_ms {t_k:.4f} plain_ms "
        f"{t_p:.4f} library_ms null bound_ms {b_ms:.5f} ({by}), splits "
        f"{plan_of(tables)}; long kernel_ms {lt_k:.4f} bound_ms "
        f"{lb_ms:.5f} splits {plan_of(ltables)}")

    # -- paged_decode_quant: the int8+sparse and fp8 runs' shapes, int8 and
    # fp8 pages, q bf16 and f32, with and without a keep mask and the
    # current rows
    worst = 0.0
    qcases = cases(lever_curs)
    for curs, w, hq, hkv, D, tag, inactive in qcases:
        B = len(curs)
        tables, N = paged_tables(torch, curs, bs, dev, inactive)
        cur = torch.tensor(curs, dtype=torch.int32, device=dev)
        for kind in ("int8", "fp8"):
            kq, ks = quantize_kv(keys((N, bs, hkv, D), f32), kind)
            vq, vs = quantize_kv(rnd((N, bs, hkv, D), f32), kind)
            for dt in (bf, f32):
                q = rnd((B, hq, D), dt)
                rows = dict(k_row=rnd((B, hkv, D), dt),
                            v_row=rnd((B, hkv, D), dt))
                keep = pa_ref.block_keep_mask(q, kq, tables, cur,
                                              threshold=THRESHOLD, window=w,
                                              k_scales=ks)
                args = (q, kq, vq, ks, vs, tables, cur)
                for kk, rr in ((None, {}), (None, rows), (keep, rows)):
                    e = held(
                        f"paged_decode_quant {tag} {kind} {dt} keep="
                        f"{kk is not None} rows={bool(rr)}",
                        lambda: pa_ops.paged_decode_quant(
                            *args, window=w, keep=kk, **rr),
                        lambda n: pa_k.paged_decode_quant_cuda(
                            *args, window=w, splits=n,
                            keep=None if kk is None else kk.to(torch.int32),
                            **rr),
                        pa_ref.paged_decode_attention_quant(
                            *args, window=w, keep=kk, **rr), QTOL,
                        tables.shape[1] * bs, B, hkv)
                    if tag == "main" and dt == bf:
                        worst = max(worst, e)
                if tag == "main" and kind == "int8" and dt == bf:
                    main = (args, rows, keep, N)
    args, rows, keep, N = main
    q, kq, _, _, _, tables, cur = args
    T = tables.shape[1]
    ikeep = keep.to(torch.int32)
    t_k = time_ms(torch, lambda i: pa_k.paged_decode_quant_cuda(
        *args, keep=ikeep, **rows), 1)
    t_p = time_ms(torch, lambda i: pa_ref.paged_decode_attention_quant(
        *args, keep=keep, **rows), 1)

    def quant_bound(q, cur, T, keep, rows):
        n_rows = rows_read(torch, cur, bs, T, Hkv, keep)
        blocks = float(keep.sum()) if keep is not None else \
            float(pa_ref.valid_blocks(cur, T, bs).sum()) * Hkv
        extra = T * cur.numel() + cur.numel() \
            + (keep.numel() if keep is not None else 0)
        return bound(1 * 2 * n_rows * hd + 4 * 2 * blocks
                     + 2 * (2 * q.numel() + 2 * rows["k_row"].numel())
                     + 4 * extra, 4 * G * hd * n_rows, H100_BF16), blocks

    (b_ms, by), blocks = quant_bound(q, cur, T, keep, rows)
    valid = float(pa_ref.valid_blocks(cur, T, bs).sum()) * Hkv
    # long: an int8 pool read whole (no keep mask), with current rows
    lsets = []
    for _ in range(LONG_SETS):
        lkq, lks = quantize_kv(keys((lN, bs, Hkv, hd), f32), "int8")
        lvq, lvs = quantize_kv(rnd((lN, bs, Hkv, hd), f32), "int8")
        lsets.append(((rnd((SLOTS, Hq, hd), bf), lkq, lvq, lks, lvs, ltables,
                       lcur), dict(k_row=rnd((SLOTS, Hkv, hd), bf),
                                   v_row=rnd((SLOTS, Hkv, hd), bf))))
    lt_k = time_ms(torch, lambda i: pa_k.paged_decode_quant_cuda(
        *lsets[i][0], **lsets[i][1]), LONG_SETS)
    (lb_ms, _), _ = quant_bound(lsets[0][0][0], lcur, ltables.shape[1], None,
                                lsets[0][1])
    del lsets
    out["paged_decode_quant"] = dict(
        shape=f"one layer of an int8+sparse decode step: q ({SLOTS},{Hq},"
              f"{hd}) bf16, int8 pool of {N} blocks x {bs}, contexts "
              f"{cur.tolist()}, keep mask at {THRESHOLD} ({int(blocks)} of "
              f"{int(valid)} (slot, head, block) kept), current rows; long: "
              f"int8, no keep mask, current rows, contexts {lcur.tolist()}",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=None,
        bound_ms=b_ms, bound_by=by, long_ms=lt_k, long_bound_ms=lb_ms,
        splits=plan_of(tables), long_splits=plan_of(ltables))
    log(f"phase 1: {label}paged_decode_quant matches at {len(qcases)} "
        f"shapes x int8/fp8 x 2 dtypes x 3 operand sets x (the wrapper + "
        f"forced splits), max abs err "
        f"{worst_all['paged_decode_quant']:.3g}; "
        f"kernel_ms {t_k:.4f} plain_ms {t_p:.4f} library_ms null "
        f"bound_ms {b_ms:.5f} ({by}), splits {plan_of(tables)}; long "
        f"kernel_ms {lt_k:.4f} bound_ms {lb_ms:.5f}")

    # -- paged_decode_sparse: the model path's mask, a mask that drops
    # about half the blocks, and one where only the current block survives
    # in one slot
    worst = 0.0

    def masks(cur, T, B, hkv, w):
        valid = pa_ref.valid_blocks(cur, T, bs, w)[:, None, :].expand(
            -1, hkv, -1)
        current = (torch.arange(T, device=dev)[None, None, :]
                   == (cur[:, None, None] // bs)) & valid
        half = (torch.rand((B, hkv, T), generator=g, device=dev) < 0.5)
        half = (half & valid) | current
        only_cur = half.clone()
        only_cur[B - 1] = current[B - 1]
        return half, only_cur

    for curs, w, hq, hkv, D, tag, inactive in qcases:
        B = len(curs)
        tables, N = paged_tables(torch, curs, bs, dev, inactive)
        T = tables.shape[1]
        cur = torch.tensor(curs, dtype=torch.int32, device=dev)
        half, only_cur = masks(cur, T, B, hkv, w)
        for dt in (bf, f32):
            q = rnd((B, hq, D), dt)
            kp, vp = keys((N, bs, hkv, D), dt), rnd((N, bs, hkv, D), dt)
            model = pa_ref.block_keep_mask(q, kp, tables, cur,
                                           threshold=THRESHOLD, window=w)
            for mname, keep in (("model", model), ("half", half),
                                ("only-current", only_cur)):
                e = held(f"paged_decode_sparse {tag} {mname} {dt}",
                         lambda: pa_ops.paged_decode_sparse(
                             q, kp, vp, tables, cur, window=w, keep=keep),
                         lambda n: pa_k.paged_decode_sparse_cuda(
                             q, kp, vp, tables, cur, keep.to(torch.int32),
                             window=w, splits=n),
                         pa_ref.paged_decode_attention_sparse(
                             q, kp, vp, tables, cur, window=w, keep=keep),
                         TOL[str(dt).split(".")[1]], T * bs, B, hkv)
                if tag == "main" and dt == bf:
                    worst = max(worst, e)
            if tag == "main" and dt == bf:
                main = (q, kp, vp, tables, cur, model, N)
    q, kp, vp, tables, cur, keep, N = main
    T = tables.shape[1]
    ikeep = keep.to(torch.int32)
    t_k = time_ms(torch, lambda i: pa_k.paged_decode_sparse_cuda(
        q, kp, vp, tables, cur, ikeep), 1)
    t_p = time_ms(torch, lambda i: pa_ref.paged_decode_attention_sparse(
        q, kp, vp, tables, cur, keep=keep), 1)
    n_rows = rows_read(torch, cur, bs, T, Hkv, keep)
    b_ms, by = float_bound(q, cur, n_rows, tables.numel() + cur.numel()
                           + keep.numel())
    dropped = rows_read(torch, cur, bs, T, Hkv) - n_rows
    # long: about half the blocks kept
    lhalf, _ = masks(lcur, ltables.shape[1], SLOTS, Hkv, 0)
    sets = [(rnd((SLOTS, Hq, hd), bf), keys((lN, bs, Hkv, hd), bf),
             rnd((lN, bs, Hkv, hd), bf)) for _ in range(LONG_SETS)]
    ihalf = lhalf.to(torch.int32)
    lt_k = time_ms(torch, lambda i: pa_k.paged_decode_sparse_cuda(
        *sets[i], ltables, lcur, ihalf), LONG_SETS)
    l_rows = rows_read(torch, lcur, bs, ltables.shape[1], Hkv, lhalf)
    lb_ms, _ = float_bound(sets[0][0], lcur, l_rows, ltables.numel()
                           + lcur.numel() + lhalf.numel())
    del sets
    out["paged_decode_sparse"] = dict(
        shape=f"one layer of a sparse decode step: q ({SLOTS},{Hq},{hd}), "
              f"bf16 pool of {N} blocks x {bs}, contexts {cur.tolist()}, "
              f"keep mask at {THRESHOLD} ({int(n_rows)} rows read, "
              f"{int(dropped)} dropped); long: about half the blocks kept "
              f"({int(l_rows)} rows read), contexts {lcur.tolist()}",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=None,
        bound_ms=b_ms, bound_by=by, long_ms=lt_k, long_bound_ms=lb_ms,
        splits=plan_of(tables), long_splits=plan_of(ltables))
    log(f"phase 1: {label}paged_decode_sparse matches at {len(qcases)} "
        f"shapes x 3 masks x 2 dtypes x (the wrapper + forced splits), max "
        f"abs err {worst_all['paged_decode_sparse']:.3g}; kernel_ms "
        f"{t_k:.4f} plain_ms {t_p:.4f} library_ms null bound_ms {b_ms:.5f} "
        f"({by}), splits {plan_of(tables)}; long kernel_ms {lt_k:.4f} "
        f"bound_ms {lb_ms:.5f}")

    # -- flash_decode: the dense run's slab (S = max_len), scalar and
    # vector cur, a window, a ragged S, the tile edge, a long slab
    S_main = prefix + LEVER_PROMPT + 4 * LEVER_GEN
    S_long = DECODE_LONG + 64
    worst = 0.0
    fcases = [(SLOTS, S_main, Hq, Hkv, hd, 0, "main", lever_curs),
              (3, 77, Hq, Hkv, hd, 16, "ragged S+window", None),
              (2, 30, 4, 2, 16, 0, "D=16", None),
              (2, 30, 4, 2, 20, 0, "D=20", None),
              (SLOTS, 40, Hq, Hkv, hd, 0, "contexts 1/31/32/33", EDGE_CURS),
              (SLOTS, S_long, Hq, Hkv, hd, 0, f"contexts ~{DECODE_LONG}",
               long_curs)]
    for B, S, hq, hkv, D, w, tag, curs in fcases:
        for dt in (bf, f32):
            q = rnd((B, hq, D), dt)
            k, v = rnd((B, S, hkv, D), dt), rnd((B, S, hkv, D), dt)
            vec = torch.randint(0, S, (B,), generator=g, device=dev,
                                dtype=torch.int32) if curs is None else \
                torch.tensor(curs, dtype=torch.int32, device=dev)
            for cur in (torch.tensor(S // 2, dtype=torch.int32, device=dev),
                        vec):
                e = held(f"flash_decode {tag} cur{tuple(cur.shape)} {dt}",
                         lambda: fd_ops.flash_decode(q, k, v, cur, window=w),
                         lambda n: fd_k.flash_decode_cuda(
                             q, k, v, cur, window=w, splits=n),
                         fd_ref.decode_attention(q, k, v, cur, window=w),
                         TOL[str(dt).split(".")[1]], S, B, hkv)
                if tag == "main" and dt == bf:
                    worst = max(worst, e)
            if tag == "main" and dt == bf:
                main = (q, k, v, vec)
    q, k, v, cur = main
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_operands(q, k, v, cur, S):
        """SDPA's layout: K/V expanded to the query heads, a boolean mask
        of the valid positions."""
        return (q[:, :, None, :],
                k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous(),
                v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous(),
                (torch.arange(S, device=dev)[None, :]
                 <= cur[:, None])[:, None, None, :])

    qt, kt, vt, mask = sdpa_operands(q, k, v, cur, S_main)
    t_k = time_ms(torch, lambda i: fd_k.flash_decode_cuda(q, k, v, cur), 1)
    t_p = time_ms(torch, lambda i: fd_ref.decode_attention(q, k, v, cur), 1)
    t_l = time_ms(torch, lambda i: sdpa(qt, kt, vt, attn_mask=mask), 1)
    del qt, kt, vt

    def fd_bound(q, cur):
        return float_bound(q, cur, float((cur + 1).sum()) * Hkv, cur.numel())

    b_ms, by = fd_bound(q, cur)
    lcur = torch.tensor(long_curs, dtype=torch.int32, device=dev)
    sets = [(rnd((SLOTS, Hq, hd), bf), rnd((SLOTS, S_long, Hkv, hd), bf),
             rnd((SLOTS, S_long, Hkv, hd), bf)) for _ in range(LONG_SETS)]
    lt_k = time_ms(torch, lambda i: fd_k.flash_decode_cuda(*sets[i], lcur),
                   LONG_SETS)
    lb_ms, _ = fd_bound(sets[0][0], lcur)
    lsets = [sdpa_operands(*st, lcur, S_long) for st in sets]
    del sets
    lt_l = time_ms(torch, lambda i: sdpa(lsets[i][0], lsets[i][1],
                                         lsets[i][2], attn_mask=lsets[i][3]),
                   LONG_SETS)
    del lsets

    def fd_plan(S):
        return decode_split.plan(SLOTS, Hkv, S, sms)

    out["flash_decode"] = dict(
        shape=f"one layer of a dense-slab decode step: q ({SLOTS},{Hq},{hd})"
              f", k/v ({SLOTS},{S_main},{Hkv},{hd}) bf16, cur "
              f"{cur.tolist()}; long: k/v ({SLOTS},{S_long},{Hkv},{hd}), cur "
              f"{long_curs}",
        max_abs_err=worst, ms=t_k, plain_ms=t_p, library_ms=t_l,
        bound_ms=b_ms, bound_by=by, long_ms=lt_k, long_bound_ms=lb_ms,
        long_library_ms=lt_l, splits=fd_plan(S_main),
        long_splits=fd_plan(S_long))
    log(f"phase 1: {label}flash_decode matches at {len(fcases)} shapes x "
        f"scalar/vector cur x 2 dtypes x (the wrapper + forced splits), max "
        f"abs err {worst_all['flash_decode']:.3g}; kernel_ms "
        f"{t_k:.4f} plain_ms {t_p:.4f} library_ms {t_l:.4f} (SDPA with a "
        f"boolean mask on K/V expanded to {Hq} heads) bound_ms {b_ms:.5f} "
        f"({by}), splits {fd_plan(S_main)}; long kernel_ms {lt_k:.4f} "
        f"library_ms {lt_l:.4f} bound_ms {lb_ms:.5f} splits "
        f"{fd_plan(S_long)}")
    return out


def phase_conv_kernel(torch, shapes, sweep=False):
    """Phase 1 for conv2d, at the conv shapes the CNNs' CPU forwards passed
    to the wrapper (``shapes``: {net: {(H, Cin, Cout, k, stride): calls per
    forward}}): every distinct shape of ResNet-50 at 224, GoogLeNet's 5x5
    branch shapes and VGG-16's first conv, bf16 and fp32 at batch
    ``CNN_CHECK_BATCH``, plus a ragged shape; the tensor-core tiles' edges
    (CONV_EDGE_*: ragged M, Cout and R; C 8 / 16 / 24 / 64; strides 1 and
    2; 1x1 to 7x7); forced splits and column tiles on each route; operands
    that must take the CUDA cores (C = 3, bf16 C = 12, Cout = 70, x or w
    off a 16-byte boundary); each tensor-core plan twice on the same
    inputs, bit for bit.  Then ResNet-50's shapes timed at batch 64 on each
    route beside the plain version and ``F.conv2d`` (TF32 off; TF32 on
    logged for information only: another function), each cycling over
    input sets that together overflow the L2, as the forward reads each
    layer's weights once.  ``sweep`` also times the tensor-core route at
    forced column tiles and split counts on the 28x28 to 7x7 stages."""
    import itertools

    import torch.nn.functional as F

    from repro_torch.kernels.conv2d import conv2d as cv_k
    from repro_torch.kernels.conv2d import ops as cv_ops
    from repro_torch.kernels.conv2d import plan as cv_plan
    from repro_torch.kernels.conv2d import ref as cv_ref

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    name_of = {bf: "bfloat16", f32: "float32"}

    def operands(N, H, C, K, k, dt):
        x = torch.randn((N, H, H, C), generator=g, device=dev).to(dt)
        w = (torch.randn((k, k, C, K), generator=g, device=dev)
             * math.sqrt(2.0 / (k * k * C))).to(dt)
        return x, w

    def want_of(x, w, st):
        return cv_ref.conv2d(cv_ops.pad_same(x, w.shape[0], w.shape[1], st),
                             w, stride=st)

    def routed(tag, x, w, st, route, padding="SAME"):
        """The wrapper's output; fails unless it took ``route``."""
        before = dict(cv_ops.conv2d.routes)
        got = cv_ops.conv2d(x, w, stride=st, padding=padding)
        took = [r for r in cv_plan.ROUTES
                if cv_ops.conv2d.routes[r] != before[r]]
        if took != [route]:
            fail(f"conv2d {tag}: took route {took}, expected {route}")
        return got

    resnet = shapes["resnet50"]
    if len(resnet) != 20 or sum(resnet.values()) != 53:
        fail(f"conv2d: ResNet-50 passed {len(resnet)} distinct conv shapes and "
             f"{sum(resnet.values())} convs to the wrapper, expected 20 and 53")
    extra = sorted({sh for sh in shapes["googlenet"] if sh[3] == 5}
                   | {sh for sh in shapes["vgg16"] if sh[1] == 3})
    worst = {bf: 0.0, f32: 0.0}
    cases = [(CNN_CHECK_BATCH, *sh) for sh in sorted(resnet)] + \
        [(CNN_CHECK_BATCH, *sh) for sh in extra] + \
        [(3, 13, 5, 70, 3, 2)]                      # ragged M, R and K
    for N, H, C, K, k, st in cases:
        for dt in (bf, f32):
            x, w = operands(N, H, C, K, k, dt)
            route = "mma" if cv_plan.aligned(C, K, bf16=dt == bf) \
                else "cuda_core"
            e = check_close(torch, f"conv2d {(N, H, C, K, k, st)} {dt}",
                            routed((N, H, C, K, k, st), x, w, st, route),
                            want_of(x, w, st), TOL[name_of[dt]])
            if (H, C, K, k, st) in resnet:
                worst[dt] = max(worst[dt], e)
            del x, w
    log(f"phase 1: conv2d matches its plain version at {len(cases)} shapes "
        f"(ResNet-50's {len(resnet)}, GoogLeNet's 5x5 and VGG-16's first "
        f"{extra}, one ragged) x 2 dtypes, batch {CNN_CHECK_BATCH} (max abs "
        f"err at ResNet-50's shapes: fp32 {worst[f32]:.3g}, bf16 "
        f"{worst[bf]:.3g})")

    # the tensor-core tiles' edges: M around a 128-row tile, Cout around
    # the 64 / 128 column tiles, R not whole 64 (bf16) / 32 (f32) steps
    edges = [(1 + i % 2, CONV_EDGE_HS[i % 3], C, CONV_EDGE_KOUT[i // 2 % 3],
              k, st) for i, (k, C, st) in enumerate(itertools.product(
                  CONV_EDGE_TAPS, CONV_EDGE_CS, (1, 2)))]
    edge_worst = {bf: 0.0, f32: 0.0}
    for N, H, C, K, k, st in edges:
        for dt in (bf, f32):
            x, w = operands(N, H, C, K, k, dt)
            e = check_close(torch, f"conv2d edge {(N, H, C, K, k, st)} {dt}",
                            routed((N, H, C, K, k, st), x, w, st, "mma"),
                            want_of(x, w, st), TOL[name_of[dt]])
            edge_worst[dt] = max(edge_worst[dt], e)
    # forced splits and column tiles on each route (the last split count
    # more than the depth steps; the CUDA cores hold any count to 1)
    n_forced = 0
    for route, (N, H, C, K, k, st) in (
            ("mma", (CNN_CHECK_BATCH, 7, 512, 512, 3, 1)),
            ("mma", (3, 13, 24, 72, 5, 2)),
            ("mma", (CNN_BATCH, 7, 512, 512, 3, 1)),
            ("cuda_core", (CNN_CHECK_BATCH, 14, 256, 256, 3, 1))):
        for dt in (bf, f32):
            x, w = operands(N, H, C, K, k, dt)
            xp = cv_ops.pad_same(x, k, k, st)
            want = cv_ref.conv2d(xp, w, stride=st)
            for splits, bn in itertools.product(
                    (1, 2, 3, 7, 10_000),
                    cv_plan.MMA_BNS if route == "mma" else (None,)):
                p = cv_k.plan_for(xp, w, stride=st, route=route,
                                  splits=splits, bn=bn)
                if route == "cuda_core" and p.splits != 1:
                    fail(f"conv2d cuda_core plan {p}: splits past 1")
                check_close(torch, f"conv2d {route} {(N, H, C, K, k, st)} "
                            f"{dt} {p}", cv_k.launch(xp, w, p, stride=st),
                            want, TOL[name_of[dt]])
                n_forced += 1
            del x, w, xp, want
    # operands the tensor cores cannot stage: the plan sends them to the
    # CUDA cores (x or w off a 16-byte boundary: VALID, so no pad copy)
    n_cc = 0
    for N, H, C, K, k, st, dts in (
            (CNN_CHECK_BATCH, 32, 3, 64, 7, 2, (bf, f32)),   # a stem
            (CNN_CHECK_BATCH, 9, 12, 64, 3, 1, (bf,)),       # 12 % 8
            (CNN_CHECK_BATCH, 9, 6, 64, 3, 1, (f32,)),       # 6 % 4
            (CNN_CHECK_BATCH, 9, 64, 70, 3, 1, (bf, f32))):  # Cout % 8
        for dt in dts:
            x, w = operands(N, H, C, K, k, dt)
            check_close(torch, f"conv2d misfit {(N, H, C, K, k, st)} {dt}",
                        routed((N, H, C, K, k, st), x, w, st, "cuda_core"),
                        want_of(x, w, st), TOL[name_of[dt]])
            n_cc += 1
    for dt in (bf, f32):
        for off_x in (True, False):
            x, w = operands(CNN_CHECK_BATCH, 9, 64, 64, 3, dt)
            flat = torch.empty(x.numel() + 1 if off_x else w.numel() + 1,
                               dtype=dt, device=dev)
            if off_x:
                x = flat[1:].view(x.shape).copy_(x)
            else:
                w = flat[1:].view(w.shape).copy_(w)
            check_close(torch, f"conv2d misaligned {'x' if off_x else 'w'} "
                        f"{dt}", routed("misaligned", x, w, 1, "cuda_core",
                                        padding="VALID"),
                        cv_ref.conv2d(x, w, stride=1), TOL[name_of[dt]])
            n_cc += 1
    # each tensor-core plan twice on the same inputs: bit for bit
    n_bits = 0
    for (N, H, C, K, k, st), splits, bn in (
            ((CNN_BATCH, 7, 512, 512, 3, 1), None, None),   # split 2
            ((CNN_CHECK_BATCH, 28, 128, 128, 3, 1), 1, 128),
            ((CNN_CHECK_BATCH, 28, 128, 64, 3, 1), None, 64),
            ((CNN_CHECK_BATCH, 28, 128, 64, 3, 1), 2, 128),
            ((CNN_CHECK_BATCH, 14, 256, 256, 3, 1), 3, None),
            ((3, 13, 24, 72, 5, 2), None, None)):
        for dt in (bf, f32):
            x, w = operands(N, H, C, K, k, dt)
            xp = cv_ops.pad_same(x, k, k, st)
            p = cv_k.plan_for(xp, w, stride=st, splits=splits, bn=bn)
            if p.route != "mma" or not torch.equal(
                    cv_k.launch(xp, w, p, stride=st),
                    cv_k.launch(xp, w, p, stride=st)):
                fail(f"conv2d {(N, H, C, K, k, st)} {dt} ({p}): two launches "
                     "on the same inputs differ")
            n_bits += 1
            del x, w, xp
    log(f"phase 1: conv2d matches its plain version at {len(edges)} tile-edge "
        f"shapes x 2 dtypes on the tensor cores (max abs err fp32 "
        f"{edge_worst[f32]:.3g}, bf16 {edge_worst[bf]:.3g}), {n_forced} "
        f"forced plans, {n_cc} operands the plan sends to the CUDA cores; "
        f"{n_bits} tensor-core plans are bitwise repeatable")

    # one ResNet-50 forward's convs at batch 64, each shape timed on the
    # input the wrapper would pad: kernel on the plan's route (through the
    # wrapper, VALID on the padded input) and on the CUDA cores, plain
    # version, F.conv2d on channels_last tensors
    keys = ("ms", "cuda_core", "plain", "lib", "lib_tf32", "bound",
            "bound_cuda_core", "bound_bytes", "bound_operations")
    tot = {dt: dict.fromkeys(keys, 0.0) for dt in (f32, bf)}
    for (H, C, K, k, st), calls in sorted(resnet.items()):
        line = []
        for dt in (f32, bf):
            sets = []
            while len(sets) < 2 or (len(sets) < 4 and len(sets) * sum(
                    t.numel() * t.element_size() for t in sets[0][:2])
                    < 128e6):
                x, w = operands(CNN_BATCH, H, C, K, k, dt)
                xp = cv_ops.pad_same(x, k, k, st)
                sets.append((xp, w, xp.permute(0, 3, 1, 2),  # channels_last
                             w.permute(3, 2, 0, 1).contiguous(
                                 memory_format=torch.channels_last)))
                del x, w
            n = len(sets)
            p = cv_k.plan_for(sets[0][0], sets[0][1], stride=st)
            t = dict(ms=time_ms(torch, lambda i: cv_ops.conv2d(
                sets[i][0], sets[i][1], stride=st, padding="VALID"), n, 2 * n))
            pc = cv_k.plan_for(sets[0][0], sets[0][1], stride=st,
                               route="cuda_core")
            t["cuda_core"] = time_ms(torch, lambda i: cv_k.launch(
                sets[i][0], sets[i][1], pc, stride=st), n, 2 * n)
            t["plain"] = time_ms(torch, lambda i: cv_ref.conv2d(
                sets[i][0], sets[i][1], stride=st), n, n)
            t["lib"] = time_ms(torch, lambda i: F.conv2d(
                sets[i][2], sets[i][3], stride=st), n, 2 * n)
            if dt == f32:   # cuDNN's default for f32: not the same function
                torch.backends.cudnn.allow_tf32 = True
                t["lib_tf32"] = time_ms(torch, lambda i: F.conv2d(
                    sets[i][2], sets[i][3], stride=st), n, 2 * n)
                torch.backends.cudnn.allow_tf32 = False
            xp, w = sets[0][:2]
            M, _, R, _, _ = cv_plan.gemm_dims(xp.shape, w.shape, st)
            byts = xp.element_size() * (xp.numel() + w.numel() + M * K)
            flops = 2.0 * M * K * R
            # the bound is the dtype's, whatever the route: bf16 at the
            # tensor cores' rate, f32 as their three bf16 passes; each
            # route's own bound is kept for information
            passes = 3 if dt == f32 else 1
            t["bound"], by = bound(byts, passes * flops, H100_BF16)
            t["bound_cuda_core"], _ = bound(byts, flops, H100_FP32)
            t[f"bound_{by}"] = t["bound"]
            for key, v in t.items():
                tot[dt][key] += calls * v
            line.append(f"{name_of[dt]} ({p.route}, bn {p.bn}, splits "
                        f"{p.splits}) kernel_ms {t['ms']:.4f} cuda_core_ms "
                        f"{t['cuda_core']:.4f} plain_ms {t['plain']:.4f} "
                        f"library_ms {t['lib']:.4f}" + (
                            f" (TF32 on {t['lib_tf32']:.4f})" if dt == f32
                            else "") + f" bound_ms {t['bound']:.4f} ({by}) "
                        f"({n} input sets)")
            del sets, xp, w
        log(f"  conv2d {CNN_BATCH}x{H}x{H}x{C} -> {K} k{k} s{st} (x{calls}"
            f"/forward): " + "; ".join(line))
    for dt in (f32, bf):
        t = tot[dt]
        log(f"  conv2d one ResNet-50 forward's 53 convs, batch {CNN_BATCH}, "
            f"{name_of[dt]}: kernel_ms {t['ms']:.3f} (plan's routes) "
            f"cuda_core_ms {t['cuda_core']:.3f} plain_ms {t['plain']:.3f} "
            f"library_ms {t['lib']:.3f}" + (
                f" (TF32 on, for information: {t['lib_tf32']:.3f})"
                if dt == f32 else "") + f" bound_ms {t['bound']:.3f} (the "
            f"dtype's on the tensor cores, {t['bound_operations']:.3f} of it "
            f"operations-bound; cuda_core route {t['bound_cuda_core']:.3f})")
    if sweep:
        for (H, C, K, k, st), _ in sorted(resnet.items()):
            if H > 28 or st != 1:
                continue
            for dt in (f32, bf):
                x, w = operands(CNN_BATCH, H, C, K, k, dt)
                xp = cv_ops.pad_same(x, k, k, st)
                plan = cv_k.plan_for(xp, w, stride=st)
                row = []
                for bn, splits in itertools.product(cv_plan.MMA_BNS,
                                                    CONV_SWEEP):
                    p = cv_k.plan_for(xp, w, stride=st, bn=bn, splits=splits)
                    if p.splits != splits:
                        continue
                    ms = time_ms(torch, lambda i: cv_k.launch(
                        xp, w, p, stride=st), 1)
                    row.append(f"{p.bm}x{bn} x{splits}: {ms:.4f}")
                log(f"  conv2d sweep {CNN_BATCH}x{H}x{H}x{C} -> {K} k{k} "
                    f"{name_of[dt]} (plan {plan.bm}x{plan.bn} splits "
                    f"{plan.splits}): ms " + ", ".join(row))
                del x, w, xp
    t, tb = tot[f32], tot[bf]
    return {"conv2d": dict(
        shape=f"one ResNet-50 forward at 224, batch {CNN_BATCH}, fp32: 53 "
              f"calls at 20 distinct shapes, each timed alone on the plan's "
              f"route (library: F.conv2d, channels_last, TF32 off)",
        max_abs_err=worst[f32], ms=t["ms"], plain_ms=t["plain"],
        library_ms=t["lib"], bound_ms=t["bound"],
        bound_by=max(("bytes", "operations"), key=lambda b: t[f"bound_{b}"]),
        route_ms={"cuda_core": t["cuda_core"]},
        route_bound_ms={"mma": t["bound"],
                        "cuda_core": t["bound_cuda_core"]},
        library_tf32_ms=t["lib_tf32"], bf16_ms=tb["ms"],
        bf16_plain_ms=tb["plain"], bf16_library_ms=tb["lib"],
        bf16_bound_ms=tb["bound"],
        bf16_bound_by=max(("bytes", "operations"),
                          key=lambda b: tb[f"bound_{b}"]),
        bf16_route_ms={"cuda_core": tb["cuda_core"]},
        bf16_route_bound_ms={"mma": tb["bound"],
                             "cuda_core": tb["bound_cuda_core"]})}


# ---------------------------------------------------------------------------
# phase 2: the card against the CPU on the same full-width weights
# ---------------------------------------------------------------------------


def phase_card_vs_cpu(torch, cfg):
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TF
    from repro_torch.serving import kv_pool as KV

    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(2)
    params = {"cuda": TF.init_lm(cfg2, g, "cuda")}
    params["cpu"] = tree_to(params["cuda"], "cpu")
    lens = [PROMPT, 20, 27, 9]
    max_len = PROMPT + 16
    tokens = torch.randint(1, cfg2.vocab, (len(lens), PROMPT),
                           generator=torch.Generator().manual_seed(3))

    def run(dev, kind, threshold, bs, masks):
        """Prefill + 4 decode steps on ``dev``; returns per-step logits.
        ``masks`` collects every keep mask (and its block masses)."""
        p = params[dev]
        T = -(-max_len // bs)
        pool = KV.BlockPool(1 + len(lens) * T, bs)
        tables = torch.tensor([pool.alloc(T) for _ in lens],
                              dtype=torch.int32)
        lg, cache = TF.prefill(p, cfg2, {"tokens": tokens.to(dev)},
                               max_len=max_len, lens=torch.tensor(lens))
        steps = [lg.cpu()]
        tok = lg.argmax(-1)
        if kind == "dense":
            pc = dict(cache, len=torch.tensor(lens, dtype=torch.int32,
                                              device=dev))
        else:
            pages = KV.init_pages(cfg2, pool.n_blocks, bs, device=dev,
                                  kv_dtype=kind)
            KV.write_prefix_pages(pages, cache["k"], cache["v"],
                                  tables.to(dev))
            pc = dict(pages, tables=tables.to(dev),
                      lens=torch.tensor(lens, dtype=torch.int32, device=dev))
        for _ in range(4):
            if kind == "dense":
                lg, pc = TF.decode_step(p, cfg2, tok[:, None], pc)
            else:
                lg, pc = TF.decode_step_paged(p, cfg2, tok[:, None], pc,
                                              sparse_threshold=threshold)
            lg = lg[:, 0]
            steps.append(lg.cpu())
            tok = lg.argmax(-1)
        return steps

    keep_mask = L.block_keep_mask

    def recording(masks):
        def record(q, k_pages, tables, cur_pos, **kw):
            keep = keep_mask(q, k_pages, tables, cur_pos, **kw)
            kw.pop("threshold")
            mass = pa_ref.block_mass(q, k_pages, tables, cur_pos, **kw)
            valid = pa_ref.valid_blocks(cur_pos, tables.shape[1],
                                        k_pages.shape[1], kw["window"])
            masks.append((keep.cpu(), mass.cpu(),
                          int(valid.sum()) * keep.shape[1]))
            return keep
        return record

    layouts = [("fp32", 0.0, 16, MODEL_TOL), ("int8", 0.0, 16, QTOL),
               ("fp8", 0.0, 16, QTOL), ("fp32", THRESHOLD, 8, MODEL_TOL),
               ("int8", THRESHOLD, 8, QTOL), ("dense", 0.0, 16, MODEL_TOL)]
    for kind, threshold, bs, tol in layouts:
        name = f"{kind}" + (f"+sparse {threshold}" if threshold else "")
        logits, masks = {}, {}
        for dev in ("cuda", "cpu"):
            masks[dev] = []
            L.block_keep_mask = recording(masks[dev])
            try:
                logits[dev] = run(dev, kind, threshold, bs, masks[dev])
            finally:
                L.block_keep_mask = keep_mask
        if threshold:
            flips = []
            for call, ((kc, mc, _), (kp, mp, _)) in enumerate(
                    zip(masks["cuda"], masks["cpu"])):
                for b, h, t in (kc != kp).nonzero().tolist():
                    flips.append(f"call {call} slot {b} head {h} block {t}: "
                                 f"card {bool(kc[b, h, t])} mass "
                                 f"{float(mc[b, h, t]):.6g}, CPU "
                                 f"{bool(kp[b, h, t])} mass "
                                 f"{float(mp[b, h, t]):.6g}")
            if flips or len(masks["cuda"]) != len(masks["cpu"]):
                fail(f"card vs CPU {name}: keep masks differ:\n  "
                     + "\n  ".join(flips))
            kept = sum(int(k.sum()) for k, _, _ in masks["cpu"])
            valid = sum(n for _, _, n in masks["cpu"])
            if kept >= valid:
                fail(f"card vs CPU {name}: the keep masks dropped no block")
            log(f"  {name}: {len(masks['cpu'])} keep masks equal on card and "
                f"CPU ({valid - kept} of {valid} valid blocks dropped)")
        worst = 0.0
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            if not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"card vs CPU {name}: argmax differs at step {i}")
            worst = max(worst, check_close(
                torch, f"card vs CPU {name} step {i}", a, b, tol))
        log(f"phase 2: 2-layer full-width fp32 model, {name} layout, card "
            f"(kernels) vs CPU (plain): prefill + 4 decode steps agree (max "
            f"abs logit err {worst:.3g}, tolerance {tol}), identical argmax")
    phase_prefix_bitwise(torch, cfg2, params["cuda"])


def phase_prefix_bitwise(torch, cfg2, params):
    """A prefix-cache hit on the card: the hit request's logits bit for
    bit those of a cold engine that wrote every block itself, and serving
    the donor's prompt again bit for bit its own cold run."""
    import numpy as np

    from repro_torch.models import api as mapi
    from repro_torch.serving import PartitionEngine, RequestQueue

    api = mapi.build(cfg2, "cuda")
    bs, head = 16, 2 * 16
    rng = np.random.default_rng(9)
    first = rng.integers(1, cfg2.vocab, size=(head,)).astype(np.int32)
    prompts = [np.concatenate([first, rng.integers(1, cfg2.vocab, size=(5,))
                               .astype(np.int32)]) for _ in range(2)]

    def engine(cache):
        return PartitionEngine(cfg2, api, params, slots=2, max_len=64,
                               block_size=bs, prefix_cache=cache)

    def drive(eng, prompt):
        q = RequestQueue()
        q.submit(prompt, 4)
        eng.assign(q.pop(1))
        eng.prefill_wave(0.0)
        i = next(j for j, r in enumerate(eng.active) if r is not None)
        out = []
        while eng.busy:
            eng.decode_step(0.0)
            out.append(eng.last_logits[i].copy())
        return out

    warm = engine(True)
    drive(warm, prompts[0])
    for prompt in (prompts[1], prompts[0]):
        hit = drive(warm, prompt)
        cold = drive(engine(False), prompt)
        if warm.n_cached_tokens < head:
            fail("prefix cache: the second request did not hit the cached "
                 "head")
        for i, (h, c) in enumerate(zip(hit, cold)):
            if not np.array_equal(h, c):
                fail(f"prefix cache: hit logits differ from a cold engine's "
                     f"at decode step {i} (max abs diff "
                     f"{float(np.abs(h - c).max()):.3g}); bitwise expected")
    log(f"phase 2: prefix-cache hits on the card ({warm.n_prefix_hits} hits, "
        f"{warm.n_cached_tokens} cached tokens): logits bit-identical to "
        f"cold engines")

    # hits seated by slot refills: one slot, four requests, the refills'
    # one shape eager, captured, then replayed; against a cold engine
    # that prefills eagerly
    order = [prompts[0], prompts[1], prompts[0], prompts[1]]

    def refilled(cache, graph):
        eng = PartitionEngine(cfg2, api, params, slots=1, max_len=64,
                              block_size=bs, prefix_cache=cache,
                              cuda_graph=graph)
        q = RequestQueue()
        for prompt in order:
            q.submit(prompt, 4)
        eng.assign(q.pop(len(order)))
        eng.prefill_wave(0.0)
        out = []
        while eng.busy:
            eng.decode_step(0.0)
            out.append(eng.last_logits[0].copy())
        return eng, out

    (hit_eng, hit), (_, cold) = refilled(True, True), refilled(False, False)
    pg = hit_eng.prefill_graphs
    if hit_eng.n_refills != 3 or pg.n_replays - pg.n_captures < 1 or \
            hit_eng.n_prefix_hits < 3:
        fail(f"prefix cache: {hit_eng.n_refills} refills, "
             f"{hit_eng.n_prefix_hits} hits, prefill graphs {pg.n_eager} "
             f"eager / {pg.n_captures} captured / {pg.n_replays} replays "
             "(want 3 refills, all hits, one replayed after its capture)")
    for i, (h, c) in enumerate(zip(hit, cold, strict=True)):
        if not np.array_equal(h, c):
            fail(f"prefix cache: refilled hit logits differ from a cold "
                 f"eager engine's at decode step {i} (max abs diff "
                 f"{float(np.abs(h - c).max()):.3g}); bitwise expected")
    log(f"phase 2: prefix-cache hits seated by refills ({hit_eng.n_prefix_hits}"
        f" hits; prefills {pg.n_eager} eager, {pg.n_captures} captured, "
        f"{pg.n_replays} replays): logits over {len(hit)} decode steps "
        f"bit-identical to a cold eager engine")


# ---------------------------------------------------------------------------
# phase 2 (continued): the decode step captured as a CUDA graph
# ---------------------------------------------------------------------------


def phase_graph_probe(torch):
    """One bf16 ``mm_mma`` launch and one ``pa_launch`` through ctypes,
    captured in a CUDA graph: each replay equals the eager launch on the
    same inputs bit for bit, also after the inputs change in place (so the
    replay really runs and reads them)."""
    from repro_torch.kernels.matmul import matmul as mm_k
    from repro_torch.kernels.paged_attention import paged_attention as pa_k

    g = torch.Generator(device="cuda").manual_seed(30)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).to(torch.bfloat16)

    a, b = rnd((SLOTS, 3584)), rnd((3584, 4608), 0.02)
    plan = mm_k.plan_for(a, b)
    if plan.route != "mma":
        fail(f"graph probe: the bf16 decode matmul plans {plan}, not mm_mma")
    tables, N = paged_tables(torch, [40, 35, 47, 33], 16, "cuda",
                             inactive=False)
    q, kp, vp = rnd((SLOTS, 28, 128)), rnd((N, 16, 4, 128)), \
        rnd((N, 16, 4, 128))
    cur = torch.tensor([40, 35, 47, 33], dtype=torch.int32, device="cuda")
    launches = {"mm_mma": (lambda: mm_k.launch(a, b, plan), a),
                "pa_launch": (lambda: pa_k.paged_decode_cuda(
                    q, kp, vp, tables, cur), q)}
    for name, (fn, x) in launches.items():
        eager = fn()                       # loads the library, warms up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(out, eager):
            fail(f"graph probe: a replayed {name} differs from its eager "
                 f"launch (max abs diff "
                 f"{float((out.float() - eager.float()).abs().max()):.3g})")
        x.copy_(rnd(tuple(x.shape)))
        graph.replay()
        if not torch.equal(out, fn()):
            fail(f"graph probe: a replayed {name} on new inputs differs "
                 "from its eager launch")
        del graph
    log("phase 2: graph probe: one bf16 mm_mma and one pa_launch, captured "
        "through ctypes and replayed, equal their eager launches bit for "
        "bit (and again on new inputs)")


def lru_kinds(keys, bound: int) -> list:
    """What a ``PrefillGraphs`` of ``bound`` entries does at each use of
    ``keys``, in order: "eager" at a shape's first use since it was last
    admitted (the least recently used entry out first when full),
    "capture" at its second, "replay" after that."""
    from collections import OrderedDict

    held, out = OrderedDict(), []
    for k in keys:
        if k not in held:
            if len(held) >= bound:
                held.popitem(last=False)
            held[k] = False
            out.append("eager")
        else:
            held.move_to_end(k)
            out.append("replay" if held[k] else "capture")
            held[k] = True
    return out


SSM_STATE = ("ssm_state", "ssm_conv")


def live_state(torch, eng) -> dict:
    """The state an engine's live slots read, as raw bytes: the pool
    blocks in their tables but the null block (every inactive slot's rows
    land there by one scatter, in an order the card does not fix), or
    their rows of the dense slab; and their rows of the SSM state and conv
    window (SSM and hybrid families)."""
    from repro_torch.serving.kv_pool import NULL_BLOCK

    live = [i for i, r in enumerate(eng.active) if r is not None]
    src = eng.pages if eng.paged else eng.cache
    if eng.paged:
        rows = sorted({b for i in live for b in eng.slot_tables[i]}
                      - {NULL_BLOCK})
        state = {k: t for k, t in src.items() if k not in SSM_STATE}
    else:
        rows = live
        state = {k: src[k] for k in ("k", "v") if k in src}
    idx = torch.tensor(rows, dtype=torch.long, device=eng.device)
    out = {k: t.index_select(1, idx).contiguous().view(torch.uint8)
           for k, t in state.items()}
    slots = torch.tensor(live, dtype=torch.long, device=eng.device)
    out.update({k: src[k].index_select(1, slots).contiguous().view(
        torch.uint8) for k in SSM_STATE if k in src})
    return out


class TraceIncomplete(Exception):
    """The eager engine's profiler trace shows fewer of the port's kernels
    than its wrappers counted, while the replay's trace shows no kernel
    more than they counted: the profiler lost records (it has, PERF.md §5
    and §6: once 4 of 15 matmuls of an eager step and every kernel of its
    replay, whose outputs had matched bit for bit), so the traces cannot
    be compared."""


def trace_check(name, what, traced: dict, issued) -> None:
    """Hold the profiler traces of ``what`` (``traced``: the port's
    kernels by name in the eager and the graph engine's trace) to the
    eager engine's wrapper counts for it (``issued``, ``counts.diff`` over
    ``step_graph.WRAPPERS``): one matmul, flash-attention or decode kernel
    per counted launch.  Both complete passes.  The eager trace short
    while the replay's holds no kernel more than was counted, or a
    complete eager trace beside a replay's that holds none of the port's
    kernels at all (the profiler lost the replay's records: its outputs
    were already held bit for bit to the eager engine's), raises
    ``TraceIncomplete`` (the lockstep runs again and must end with both
    complete); anything else (a complete eager trace beside a replay's
    that holds some kernels but not the counted ones, above all) fails at
    once."""
    launches = [n for n, _ in issued]
    want = {"matmul": launches[0], "flash attention": launches[1],
            "decode attention": sum(launches[2:])}
    got = {mode: {
        "matmul": sum(k.get(n, 0) for n in ("mm_mma", "mm_skinny",
                                            "mm_tiled")),
        "flash attention": sum(k.get(n, 0) for n in ("fa_kernel",
                                                     "fa_mma_kernel")),
        "decode attention": k.get("decode::kernel", 0)}
        for mode, k in ((m, traced[m]) for m in ("eager", "graph"))}
    eager, graph = got["eager"], got["graph"]
    if eager == want and graph == want:
        return
    msg = (f"graph lockstep {name}: profiler traces of {what} show the "
           f"port's kernels eager {eager}, replayed {graph}; the eager "
           f"engine's wrappers issued {want}")
    short = eager != want and all(eager[k] <= want[k] for k in want)
    lost = eager == want and not any(graph.values())
    if lost or short and all(graph[k] <= want[k] for k in want):
        raise TraceIncomplete(msg)
    fail(msg)


TRACE_ATTEMPTS = 3
TRACE_RERUNS = []       # (lockstep, what the profiler lost), every rerun


def graph_lockstep_traced(*args, **kw):
    """``graph_lockstep``, run again (up to TRACE_ATTEMPTS times in all)
    when ``trace_check`` finds that the profiler lost records of the eager
    engine's trace; every check is made again on the new run, and each
    rerun is logged and kept in ``TRACE_RERUNS``."""
    for attempt in range(TRACE_ATTEMPTS):
        try:
            return graph_lockstep(*args, **kw)
        except TraceIncomplete as e:
            TRACE_RERUNS.append((args[3], str(e)))
            log(f"phase 2: {e}: the profiler lost records; the lockstep runs "
                f"again (attempt {attempt + 2} of {TRACE_ATTEMPTS})")
            gc.collect()
            torch = args[0]
            torch.cuda.empty_cache()
    fail(f"graph lockstep {args[3]}: every one of {TRACE_ATTEMPTS} runs lost "
         "profiler records")


def graph_lockstep(torch, cfg2, params, name, lens, gens, min_steps,
                   evicting=False, **kw):
    """A graph engine and a ``cuda_graph=False`` engine on one stream in
    lockstep: after the wave and every decode step the same occupancy and
    tokens, and bit for bit the same KV state of the live slots (pool
    blocks or slab rows); after every step the same live slots' logits
    and dropped blocks.  The graph engine decodes through its
    ``DecodeGraph`` and prefills through a ``PrefillGraphs`` it shares
    with two engines that seat a wave of its wave's shape before it (other
    tokens, the lengths in another order; eager, then captured), so its
    own wave is a replay, whose logits equal the eager engine's bit for
    bit.  ``lens`` after the first SLOTS are the refills' prompt lengths
    in order; each prefill of the cache does what ``lru_kinds`` says for
    its bound, ``MAX_GRAPHS`` (with ``evicting``, shapes must be evicted
    and captured again).  The wrappers' counts (by wrapper and matmul
    route) of each eager or captured prefill and of the graph
    engine's eager and captured decode steps equal the eager engine's,
    and a replay adds none; the port's kernels in a profiler trace of
    decode step ``TRACED_STEP`` and of refill ``TRACED_REFILL`` (both
    replays) are the same, by name, as the eager engine's.  Inactive
    slots are left out of the logits: their rows all go to null block 0 by
    one scatter, whose order among duplicate indices the card does not
    fix.  Returns the number of steps."""
    import numpy as np

    from repro_torch.kernels import counts
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import api as mapi
    from repro_torch.profiling.decode_profile import port_kernels
    from repro_torch.serving import PartitionEngine, PrefillGraphs, \
        RequestQueue
    from repro_torch.serving.step_graph import WRAPPERS

    api = mapi.build(cfg2, "cuda")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def traced(fn):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            out = fn()
            torch.cuda.synchronize()
        return out, port_kernels(prof.key_averages())

    def zero(issued):
        return tuple((0, dict.fromkeys(r, 0)) for _, r in issued)

    class Logged(PrefillGraphs):
        """The cache, logging (key, what it did) at each use in order: an
        SSM family's wave uses it once a prompt length."""

        def __init__(self, api):
            super().__init__(api)
            self.log = []

        def __call__(self, *args, **kw):
            out = super().__call__(*args, **kw)
            key = next(reversed(self._entries))     # the entry just used
            self.log.append((key, self._entries[key].last))
            return out

    pg = Logged(api)
    hist = {"primer": [], "graph": [], "eager": []}   # every prefill, in order
    traced_refill = {}

    def recorded(mode, eng, what, inner):
        """``inner`` (the engine's wave or refill hook), recording its
        counts, the cache keys it used and what the cache did (one kind
        for all of a wave's groups, else "mixed"), and a wave's logits;
        tracing refill ``TRACED_REFILL``."""
        def run(*args):
            n = sum(r["what"] == what for r in hist[mode])
            used = len(pg.log)
            before = counts.snapshot(WRAPPERS)
            if what == "refill" and n == TRACED_REFILL:
                out, traced_refill[mode] = traced(lambda: inner(*args))
            else:
                out = inner(*args)
            rec = dict(what=what,
                       counts=counts.diff(counts.snapshot(WRAPPERS), before))
            if eng.prefill_graphs is not None:
                kinds = {kind for _, kind in pg.log[used:]}
                rec.update(kind=kinds.pop() if len(kinds) == 1
                           else f"mixed {sorted(kinds)}")
            if what == "wave":
                rec["logits"] = out[0][:len(args[0])].float().cpu().numpy()
            hist[mode].append(rec)
            return out
        return run

    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg2.vocab, size=(n,)).astype(np.int32)
               for n in lens]
    # the primers' wave: the same shape with other tokens and the lengths
    # in another order, so a replay that kept a stale input shows
    primed = [rng.integers(1, cfg2.vocab, size=(n,)).astype(np.int32)
              for n in lens[1:SLOTS] + lens[:1]]

    def engine(mode, prompts, gens):
        eng = PartitionEngine(
            cfg2, api, params, slots=SLOTS,
            max_len=(cfg2.n_img_tokens or 0) + (cfg2.n_meta_tokens or 0)
            + max(lens) + max(gens),
            cuda_graph=mode != "eager",
            prefill_graphs=pg if mode != "eager" else None, **kw)
        eng._wave_prefill_cache = recorded(mode, eng, "wave",
                                           eng._wave_prefill_cache)
        eng._refill_slot = recorded(mode, eng, "refill", eng._refill_slot)
        q = RequestQueue()
        for prompt, gen in zip(prompts, gens):
            q.submit(prompt, gen)
        eng.assign(q.pop(len(prompts)))
        eng.prefill_wave(0.0)
        return eng

    for _ in range(2):      # the wave's shape: eager, then captured
        engine("primer", primed, gens)
    engines = {mode: engine(mode, prompts, gens) for mode in ("graph",
                                                              "eager")}
    ge, ee = engines["graph"], engines["eager"]
    wave, got = hist["eager"][0], hist["graph"][0]
    for rec in hist["primer"] + [got]:
        want = zero(wave["counts"]) if rec["kind"] == "replay" \
            else wave["counts"]
        if rec["counts"] != want:
            fail(f"graph lockstep {name}: a {rec['kind']} wave's counts "
                 f"{rec['counts']}, want {want}")
    if [r["kind"] for r in hist["primer"]] != ["eager", "capture"] or \
            got["kind"] != "replay" or \
            not np.array_equal(got["logits"], wave["logits"]):
        fail(f"graph lockstep {name}: the graph engine's wave "
             f"({got['kind']}) after the primers' "
             f"{[r['kind'] for r in hist['primer']]}: logits bit for bit the "
             f"eager wave's: {np.array_equal(got['logits'], wave['logits'])}")

    def same_state(where):
        if ge.slot_tokens != ee.slot_tokens:
            fail(f"graph lockstep {name}: tokens differ {where}")
        a, b = live_state(torch, ge), live_state(torch, ee)
        bad = [k for k in b if not torch.equal(a[k], b[k])]
        if a.keys() != b.keys() or bad:
            fail(f"graph lockstep {name}: the live slots' KV state differs "
                 f"{where} in {bad or sorted(a)}")

    same_state("after the wave")
    dropped = (pa_ops.paged_decode_sparse, pa_ops.paged_decode_quant)
    traced_step = {}
    steps = 0
    while ee.busy:
        live = [i for i, r in enumerate(ee.active) if r is not None]
        if [r and r.rid for r in ge.active] != \
                [r and r.rid for r in ee.active]:
            fail(f"graph lockstep {name}: occupancy differs at step {steps}")
        seen = {}
        for mode, eng in engines.items():
            for w in dropped:
                w.dropped_blocks.reset()
            before = counts.snapshot(WRAPPERS)
            if steps == TRACED_STEP:
                pend, traced_step[mode] = traced(eng.issue_decode)
            else:
                pend = eng.issue_decode()
            seen[mode] = (counts.diff(counts.snapshot(WRAPPERS), before),
                          [w.dropped_blocks.value for w in dropped])
            if steps == TRACED_STEP and mode == "eager":
                traced_step["issued"] = seen[mode][0]
            eng.commit_op(pend, pend.cost.duration)      # retire, refill
        # the graph engine's wrappers issue its eager step and, into the
        # graph, its captured one; a replay issues nothing from Python
        issued, eager_dropped = seen["eager"]
        want = (issued if steps < 2 else zero(issued), eager_dropped)
        if seen["graph"] != want:
            fail(f"graph lockstep {name}: step {steps} counts differ: graph "
                 f"{seen['graph']}, want {want}")
        a, b = ge.last_logits[live], ee.last_logits[live]
        if not np.array_equal(a, b):
            fail(f"graph lockstep {name}: live slots' logits differ at step "
                 f"{steps} (max abs diff {float(np.abs(a - b).max()):.3g})")
        same_state(f"after step {steps}")
        steps += 1
    if ge.busy:
        fail(f"graph lockstep {name}: the graph engine is still busy")
    gr = ge.graph
    if steps < min_steps or gr.n_eager != 1 or gr.n_replays != steps - 1:
        fail(f"graph lockstep {name}: {steps} steps, {gr.n_eager} eager, "
             f"{gr.n_replays} replays (want >= {min_steps} steps, 1 eager, "
             "the rest replays)")
    eager_refill = [r for r in hist["eager"] if r["what"] == "refill"]
    for what, traced_op, issued in (
            (f"step {TRACED_STEP}", traced_step, traced_step["issued"]),
            (f"refill {TRACED_REFILL}", traced_refill,
             eager_refill[TRACED_REFILL]["counts"]
             if len(eager_refill) > TRACED_REFILL else None)):
        if issued is not None and {"eager", "graph"} <= traced_op.keys():
            trace_check(name, what, traced_op, issued)
    if not traced_step["eager"] or traced_step["graph"] != \
            traced_step["eager"]:
        fail(f"graph lockstep {name}: the port's kernels in a profiler trace "
             f"of step {TRACED_STEP}: replay {traced_step['graph']}, eager "
             f"step {traced_step['eager']}")
    # each use of the cache as an LRU of MAX_GRAPHS does it; a prefill's
    # counts the eager engine's for an eager run or a capture, none for a
    # replay
    kinds = [kind for _, kind in pg.log]
    if kinds != lru_kinds([key for key, _ in pg.log], pg.max_graphs):
        fail(f"graph lockstep {name}: the prefill cache did {kinds}, not "
             f"what an LRU of {pg.max_graphs} does")
    if [r["what"] for r in hist["graph"]] != \
            [r["what"] for r in hist["eager"]]:
        fail(f"graph lockstep {name}: prefills {len(hist['graph'])} and "
             f"{len(hist['eager'])} (want the same waves and refills)")
    for k, (got, ref) in enumerate(zip(hist["graph"], hist["eager"])):
        want = zero(ref["counts"]) if got["kind"] == "replay" \
            else ref["counts"]
        if got["counts"] != want:
            fail(f"graph lockstep {name}: prefill {k} ({got['what']}, "
                 f"{got['kind']}) counts differ: graph {got['counts']}, "
                 f"want {want}")
    refills = [r for r in hist["graph"] if r["what"] == "refill"]
    n_kinds = {k: kinds.count(k) for k in ("eager", "capture", "replay")}
    recaptured = n_kinds["capture"] > len({key for key, kind in pg.log
                                           if kind == "capture"})
    if len(refills) <= TRACED_REFILL or \
            refills[TRACED_REFILL]["kind"] != "replay" or \
            (pg.n_eager, pg.n_captures, pg.n_replays) != (
                n_kinds["eager"], n_kinds["capture"],
                n_kinds["capture"] + n_kinds["replay"]) or \
            len(pg) > pg.max_graphs or \
            pg.n_evictions != pg.n_eager - len(pg) or \
            (evicting and not (pg.n_evictions and recaptured)) or \
            (not evicting and pg.n_evictions):
        fail(f"graph lockstep {name}: prefill graphs {pg.n_eager} eager, "
             f"{pg.n_captures} captures, {pg.n_replays} replays, "
             f"{pg.n_evictions} evictions, {len(pg)} held over uses "
             f"{n_kinds}; refill {TRACED_REFILL} a replay (want it; "
             f"evictions and shapes captured again: {evicting})")
    if not traced_refill["eager"] or traced_refill["graph"] != \
            traced_refill["eager"]:
        fail(f"graph lockstep {name}: the port's kernels in a profiler trace "
             f"of refill {TRACED_REFILL}: replay {traced_refill['graph']}, "
             f"eager {traced_refill['eager']}")
    log(
        f"phase 2: graph lockstep {name}: {steps} decode steps "
        f"({ge.n_refills} refills), 1 eager + {gr.n_replays} replays (capture "
        f"{gr.capture_s:.3f} s) equal the eager engine bit for bit in tokens, "
        f"live logits, dropped blocks and the live slots' KV state every "
        f"step; its wave a replay (after two other waves of its shape, "
        f"eager and captured), logits bit for bit the eager wave's; prefills "
        f"{pg.n_eager} eager, {pg.n_captures} captured, {pg.n_replays} "
        f"replays, {pg.n_evictions} evictions (capture {pg.capture_s:.3f} s) "
        f"over {len(pg.uses)} shapes, as an LRU of {pg.max_graphs} does; the "
        f"wrappers issued the eager and captured prefills and steps as the "
        f"eager engine did and nothing on a replay; profiler traces of step "
        f"{TRACED_STEP} and refill {TRACED_REFILL} show the same port "
        f"kernels replayed as eager: {traced_step['graph']}, "
        f"{traced_refill['graph']}")
    return steps


def phase_graph(torch, cfg, profile=False):
    """The decode step as a CUDA graph: the ctypes probe; replay against
    eager at the 2-layer full-width fp32 model in the six layouts of the
    card-vs-CPU phase; and at full-width bf16 qwen2-7b on the float pool.
    With ``profile`` (``--only serving_graph``) also
    ``profiling/decode_profile``'s A/B of eager steps against replays.
    Returns no kernel stats (the kernels are phase 1's)."""
    from repro_torch.models import transformer as TF
    from repro_torch.serving.prefill_graph import MAX_GRAPHS

    phase_graph_probe(torch)
    cfg2 = cfg.replace(n_layers=2, dtype="float32")
    params = TF.init_lm(cfg2, torch.Generator(device="cuda").manual_seed(2),
                        "cuda")
    # the wave, then four refills, three of one shape (eager, capture,
    # replay)
    lens, gens = [PROMPT, 20, 27, 9, 14, 14, 14, 25], [8, 3, 7, 6, 5, 4, 3, 4]
    layouts = {"fp32": {}, "int8": dict(kv_dtype="int8"),
               "fp8": dict(kv_dtype="fp8"),
               "fp32+sparse": dict(sparse_threshold=THRESHOLD, block_size=8),
               "int8+sparse": dict(kv_dtype="int8",
                                   sparse_threshold=THRESHOLD, block_size=8),
               "dense": dict(paged=False)}
    for name, kw in layouts.items():
        graph_lockstep_traced(torch, cfg2, params, name, lens, gens, 6,
                              **kw)
    # more refill shapes than the cache holds (MAX_GRAPHS + 8 lengths and
    # the wave's shape): MAX_GRAPHS / 2 + 8 captured, the rest admitted
    # over them, the first two admitted again (eager) and captured again,
    # a resident one replayed
    n_a = MAX_GRAPHS // 2 + 8
    a = list(range(8, 8 + n_a))
    b = list(range(a[-1] + 1, 8 + MAX_GRAPHS + 8))
    evict = [a[0]] * 3 + [n for n in a[1:] for _ in range(2)] + b + \
        [a[0]] * 3 + [a[1]] * 2 + [a[-1]]
    graph_lockstep_traced(torch, cfg2, params, "fp32 evicting",
                          [PROMPT] * SLOTS + evict,
                          [3] * SLOTS + [2] * len(evict), 6, evicting=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = TF.init_lm(cfg, torch.Generator(device="cuda").manual_seed(0),
                        "cuda")
    graph_lockstep_traced(torch, cfg, params, "full-width bf16 float pool",
                          [PROMPT] * SLOTS + [24, 24, 24, 40],
                          [8, 4, 8, 7, 5, 4, 3, 4], 6)
    log(f"phase 2: {len(TRACE_RERUNS)} lockstep reruns for lost profiler "
        f"records {[n for n, _ in TRACE_RERUNS]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if profile:
        from repro_torch.profiling import decode_profile, prefill_profile

        for prof in (decode_profile, prefill_profile):
            prof.report(prof.run())
            gc.collect()
            torch.cuda.empty_cache()
    return {}


def phase_cnn_card_vs_cpu(torch):
    """ResNet-50, GoogLeNet and VGG-16 at 224, fp32, batch 2: the same
    weights (one seed, drawn on the CPU by ``init_cnn`` for both devices)
    through the kernels on the card and the plain versions on the CPU.
    Returns each net's card parameters for phase 3 and the conv shapes its
    CPU forward passed to the conv2d wrapper, {(H, Cin, Cout, k, stride):
    calls per forward}, for phase 1's conv2d checks."""
    from collections import Counter

    from repro_torch.models import cnn
    from repro_torch.profiling.conv2d_ab import recording_conv

    card, shapes = {}, {}
    real_conv = cnn.conv2d
    for i, name in enumerate(CNN_NETS):
        params = {dev: cnn.init_cnn(torch.Generator().manual_seed(10 + i),
                                    name, device=dev)
                  for dev in ("cpu", "cuda")}
        x = torch.randn((CNN_CHECK_BATCH, 224, 224, 3),
                        generator=torch.Generator().manual_seed(20 + i))
        got = cnn.apply_cnn(params["cuda"], name, x.to("cuda")).cpu()
        calls = shapes[name] = Counter()
        cnn.conv2d = recording_conv(calls, real_conv)
        try:
            want = cnn.apply_cnn(params["cpu"], name, x)
        finally:
            cnn.conv2d = real_conv
        if got.shape != (CNN_CHECK_BATCH, 1000) or \
                not torch.isfinite(got).all():
            fail(f"card vs CPU {name}: logits of shape {tuple(got.shape)}, "
                 f"finite {bool(torch.isfinite(got).all())}")
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        if err > CNN_TOL * scale:
            fail(f"card vs CPU {name}: max abs logit err {err:.3g} > "
                 f"{CNN_TOL} * max|cpu| {scale:.3g}")
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            fail(f"card vs CPU {name}: argmax differs ({got.argmax(-1)} vs "
                 f"{want.argmax(-1)})")
        log(f"phase 2: {name} at 224, fp32, batch {CNN_CHECK_BATCH}, card "
            f"(kernels) vs CPU (plain): max abs logit err {err:.3g} = "
            f"{err / scale:.3g} x max|cpu| ({scale:.4g}), tolerance "
            f"{CNN_TOL}; identical argmax; {sum(calls.values())} convs at "
            f"{len(calls)} distinct shapes")
        card[name] = params["cuda"]
        del params
    return card, shapes


# ---------------------------------------------------------------------------
# phase 3: the slice, through the serving CLI
# ---------------------------------------------------------------------------


def serve_run(torch, cfg, wrappers, name, argv, n_req, gen, lever=None,
              after=None):
    """One serve CLI run with every count set to 0 just before it and read
    just after; every request must complete.  ``after(engines)``, when
    given, runs on the fleet's engines once the checks pass.  Returns the
    run's record."""
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import serve

    for w in wrappers.values():
        w.launches = 0
    mm_ops.matmul.routes.update(dict.fromkeys(mm_ops.matmul.routes, 0))
    mm_ops.matmul.staged = 0
    for w in (pa_ops.paged_decode_sparse, pa_ops.paged_decode_quant):
        w.dropped_blocks.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engines = []
    outs = serve.main(argv, engines_out=engines)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    routes = dict(mm_ops.matmul.routes)
    staged = mm_ops.matmul.staged
    dropped = {k: w.dropped_blocks.value for k, w in
               (("paged_decode_sparse", pa_ops.paged_decode_sparse),
                ("paged_decode_quant", pa_ops.paged_decode_quant))}
    gs = [e.graph for e in engines]
    graphs = dict(eager=sum(g.n_eager for g in gs),
                  replays=sum(g.n_replays for g in gs),
                  captures=sum(g.graph is not None for g in gs),
                  capture_s=sum(g.capture_s for g in gs))
    tokens = sum(len(s) for s in outs)
    if graphs["replays"] == 0 or \
            any(g.n_eager != 1 or g.graph is None for g in gs):
        fail(f"serve {name}: decode graphs {graphs}: every engine must run "
             "one eager step, capture once and replay the rest")
    # one prefill cache for the fleet: each shape one eager run, a capture
    # at its second use and replays after that; nothing evicted
    pg = engines[0].prefill_graphs
    uses = list(pg.uses.values())
    prefills = dict(shapes=len(uses), uses=sum(uses), eager=pg.n_eager,
                    captures=pg.n_captures, replays=pg.n_replays,
                    evictions=pg.n_evictions, capture_s=pg.capture_s)
    if any(e.prefill_graphs is not pg for e in engines) or \
            sum(uses) != sum(e.n_prefills + e.n_refills for e in engines) \
            or pg.n_evictions or pg.n_eager != len(uses) or \
            pg.n_captures != sum(u >= 2 for u in uses) or \
            pg.n_replays != sum(u - 1 for u in uses):
        fail(f"serve {name}: prefill graphs {prefills} over uses {uses}: "
             "the fleet must share one cache, and each shape run eagerly "
             "once, be captured at its second use and replay the rest")
    if tokens != n_req * gen:
        fail(f"serve {name}: {tokens} tokens generated, expected {n_req} "
             f"requests x {gen} (a request did not complete)")
    if any(not 0 <= t < cfg.vocab for s in outs for t in s):
        fail(f"serve {name}: a generated token is outside the vocabulary")
    log(f"phase 3 [{name}]: served {n_req}/{n_req} requests, {tokens} "
        f"tokens in {wall:.2f} s wall ({tokens / wall:.2f} generated tokens "
        f"per wall second), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
        f"{launches}, matmul launches by route {routes} ({staged} staged), "
        "dropped blocks "
        f"{dropped}; decode steps {graphs['eager']} eager, "
        f"{graphs['replays']} replayed, {graphs['captures']} captures in "
        f"{graphs['capture_s']:.3f} s; prefills ({prefills['shapes']} "
        f"shapes) {prefills['eager']} eager, {prefills['replays']} replayed, "
        f"{prefills['captures']} captures in {prefills['capture_s']:.3f} s, "
        f"{sum(e.n_refills for e in engines)} of them refills")
    if after is not None:
        after(engines)
    return dict(launches=launches, routes=routes, staged=staged,
                dropped=dropped, wall=wall, tokens=tokens, graphs=graphs,
                prefills=prefills)


# the kernels each phase-3 run must launch (launch count above 0); the
# refill-heavy run and the long lever runs carry their counterparts'
CARRIES = {"baseline": ("matmul", "flash_attention", "paged_decode"),
           "paged": ("matmul", "flash_attention", "paged_decode"),
           "int8+sparse": ("matmul", "flash_attention",
                           "paged_decode_quant"),
           "fp8": ("matmul", "flash_attention", "paged_decode_quant"),
           "sparse+prefix": ("matmul", "flash_attention",
                             "paged_decode_sparse"),
           "dense": ("matmul", "flash_attention", "flash_decode")}
CARRIES["refill-heavy"] = CARRIES["baseline"]
CARRIES.update({f"long {k}": CARRIES[k] for k in LEVER_RUNS})


def phase_serve(torch, cfg, wrappers):
    loads = [("baseline", SERVE_ARGS)]
    loads += [(name, LEVER_ARGS + flags) for name, flags in LEVER_RUNS.items()]
    loads += [("refill-heavy", REFILL_ARGS)]
    loads += [(f"long {name}", LONG_LEVER_ARGS + flags)
              for name, flags in LEVER_RUNS.items()]
    runs = {}
    for name, argv in loads:
        gc.collect()            # the last run's 15 GB of weights, engines
        torch.cuda.empty_cache()  # and pools may sit in reference cycles
        runs[name] = serve_run(torch, cfg, wrappers, name, argv,
                               flag(argv, "--requests"), flag(argv, "--gen"))
    for name, kernels in CARRIES.items():
        for k in kernels:
            if runs[name]["launches"][k] == 0:
                fail(f"serve {name}: kernel {k} was never launched on the "
                     f"run that carries it")
    # every prefill wave (M = slots x prompt > 16, bf16) on the tensor cores
    for name, r in runs.items():
        if r["routes"]["mma"] == 0 or r["routes"]["tiled"] != 0:
            fail(f"serve {name}: matmul launches by route {r['routes']}: the "
                 f"bf16 prefill matmuls did not all take mm_mma")
    for name, k in (("int8+sparse", "paged_decode_quant"),
                    ("sparse+prefix", "paged_decode_sparse")):
        for run in (name, f"long {name}"):
            if runs[run]["dropped"][k] == 0:
                fail(f"serve {run}: the keep masks dropped no block")
    # the loads that repeat a prefill shape replay it
    for name in ["refill-heavy"] + [f"long {k}" for k in LEVER_RUNS]:
        if runs[name]["prefills"]["replays"] == 0:
            fail(f"serve {name}: no prefill replayed")
    return runs


def check_in_forward(torch, name, got, want, tol, worst):
    """A wrapper's output inside a real forward against its plain version
    on the same inputs: |got - want| <= tol * (rms(want) + |want|), the
    reference's absolute-plus-relative tolerance with its absolute term
    taken at the output's own scale.  The reference states 2e-4 for
    operands of unit scale; without a norm inside its residual blocks
    ResNet-50's last stage reaches an RMS near 1e3, where reordering the
    f32 sums alone moves a near-zero output past an absolute 2e-4.
    ``worst`` gathers the largest ratio to this limit ("scaled") and to the
    unscaled tol + tol * |want| ("unscaled"), which is logged."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = float(w.pow(2).mean().sqrt())
    scaled = float((err / (tol * (rms + w.abs()))).max())
    worst["scaled"] = max(worst["scaled"], scaled)
    worst["unscaled"] = max(worst["unscaled"],
                            float((err / (tol + tol * w.abs())).max()))
    worst["rms"] = max(worst["rms"], rms)
    worst["calls"] += 1
    if not bool(torch.isfinite(g).all()) or scaled > 1:
        fail(f"{name}: kernel disagrees with its plain version inside the "
             f"forward (max abs err {float(err.max()):.3g}, output rms "
             f"{rms:.3g}, {scaled:.3g} x the limit {tol} * (rms + |want|))")


def phase_cnn(torch, wrappers, card_params):
    """The CNN slice on the card, each net at 224, batch 64, fp32.  A first
    forward holds every conv2d and matmul call against its plain version on
    the call's own inputs; a second brackets every conv2d kernel and matmul
    launch with CUDA events (their device time inside a forward, cold
    weights included); then the timed forwards, with the counts set to 0
    just before them and read just after.  Then the paper's partition sweep
    on the host.  Returns one run record per net."""
    from repro_torch.core.shaping_sim import partition_sweep
    from repro_torch.kernels.conv2d import ops as cv_ops
    from repro_torch.kernels.conv2d import ref as cv_ref
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.models import cnn

    real_conv, real_mm, real_launch = cnn.conv2d, cnn.matmul, cv_ops.launch
    tol = TOL["float32"]
    runs = {}
    for i, name in enumerate(CNN_NETS):
        params = card_params.pop(name)
        x = torch.randn((CNN_BATCH, 224, 224, 3), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            30 + i))
        worst = {k: dict(scaled=0.0, unscaled=0.0, rms=0.0, calls=0)
                 for k in ("conv2d", "matmul")}

        def conv_checked(x, w, *, stride=1, padding="SAME"):
            got = real_conv(x, w, stride=stride, padding=padding)
            xp = cv_ops.pad_same(x, w.shape[0], w.shape[1], stride) \
                if padding == "SAME" else x
            check_in_forward(torch, f"cnn {name} conv2d x {tuple(x.shape)} "
                             f"w {tuple(w.shape)} s{stride}", got,
                             cv_ref.conv2d(xp, w, stride=stride), tol,
                             worst["conv2d"])
            return got

        def mm_checked(a, b):
            got = real_mm(a, b)
            check_in_forward(torch, f"cnn {name} matmul {tuple(a.shape)} x "
                             f"{tuple(b.shape)}", got, mm_ref.matmul(a, b),
                             tol, worst["matmul"])
            return got

        events = {"conv2d": [], "matmul": []}

        def timed(real, key):
            def call(*args, **kw):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = real(*args, **kw)
                t1.record()
                events[key].append((t0, t1))
                return out
            return call

        cnn.conv2d, cnn.matmul = conv_checked, mm_checked
        try:
            cnn.apply_cnn(params, name, x)
        finally:
            cnn.conv2d, cnn.matmul = real_conv, real_mm
        checked = (worst["conv2d"]["calls"], worst["matmul"]["calls"])
        if checked != CNN_LAUNCHES[name]:
            fail(f"cnn {name}: (conv2d, matmul) calls checked {checked}, "
                 f"expected {CNN_LAUNCHES[name]}")
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)   # the host queues ahead of the card
        cv_ops.launch = timed(real_launch, "conv2d")
        cnn.matmul = timed(real_mm, "matmul")
        try:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            cnn.apply_cnn(params, name, x)
            t1.record()
        finally:
            cv_ops.launch, cnn.matmul = real_launch, real_mm
        t1.synchronize()
        fwd_ms = t0.elapsed_time(t1)
        in_fwd = {k: sum(a.elapsed_time(b) for a, b in ev)
                  for k, ev in events.items()}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        cv_ops.conv2d.routes.update(dict.fromkeys(cv_ops.conv2d.routes, 0))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(CNN_REPS):
            out = cnn.apply_cnn(params, name, x)
        t1.record()
        t1.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        routes = dict(cv_ops.conv2d.routes)
        ms = t0.elapsed_time(t1) / CNN_REPS
        peak = torch.cuda.max_memory_allocated() / 1e9
        if out.shape != (CNN_BATCH, 1000) or not torch.isfinite(out).all():
            fail(f"cnn {name}: logits of shape {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
        per = (launches["conv2d"] / CNN_REPS, launches["matmul"] / CNN_REPS)
        if launches["conv2d"] == 0 or per != CNN_LAUNCHES[name]:
            fail(f"cnn {name}: (conv2d, matmul) launches per forward {per}, "
                 f"expected {CNN_LAUNCHES[name]}")
        # every conv but the C = 3 stem on the tensor cores, by plan
        want = {"mma": CNN_CONV_MMA[name] * CNN_REPS,
                "cuda_core": (CNN_LAUNCHES[name][0] - CNN_CONV_MMA[name])
                * CNN_REPS}
        if routes != want:
            fail(f"cnn {name}: conv2d launches by route {routes} in "
                 f"{CNN_REPS} forwards, expected {want}")
        for k, wk in worst.items():
            log(f"phase 3 [cnn {name}]: all {wk['calls']} {k} calls of a "
                f"batch-{CNN_BATCH} forward match their plain version on "
                f"their own inputs: worst {wk['scaled']:.3g} x the limit "
                f"{tol} * (rms + |want|) (output rms up to {wk['rms']:.4g}); "
                f"{wk['unscaled']:.3g} x an unscaled {tol} + {tol} * |want|")
        log(f"phase 3 [cnn {name}]: batch {CNN_BATCH} at 224, fp32: "
            f"{ms:.3f} device ms per forward ({CNN_BATCH / ms * 1e3:.1f} "
            f"images/s), max_memory_allocated {peak:.2f} GB, launches per "
            f"forward conv2d {per[0]:g} (by route, {CNN_REPS} forwards: "
            f"{routes}) matmul {per[1]:g}; inside one "
            f"event-bracketed forward ({fwd_ms:.3f} ms) the conv2d kernels "
            f"take {in_fwd['conv2d']:.3f} ms and the matmuls "
            f"{in_fwd['matmul']:.3f} ms")
        runs[f"cnn {name}"] = dict(launches=launches, conv_routes=routes,
                                   ms=ms, peak_gb=peak,
                                   conv_ms=in_fwd["conv2d"],
                                   matmul_ms=in_fwd["matmul"])
        del params, x, out
        torch.cuda.empty_cache()

    # the paper's Fig. 5 protocol on each net's layer trace, held to the
    # reference's reproduction gates (tests/test_shaping_sim.py)
    for name in CNN_NETS:
        t0 = time.perf_counter()
        rows = partition_sweep(cnn.model_traces(name), list(CNN_SWEEP),
                               total_batch=SWEEP_BATCH, n_passes=6)
        best = max(rows, key=lambda p: rows[p]["perf"])
        gain = rows[best]["perf"] - 1
        band = (0.0, 0.10) if name == "vgg16" else (0.03, 0.25)
        if not (band[0] < gain < band[1]
                and rows[best]["bw_std"] < rows[1]["bw_std"]
                and rows[best]["bw_mean"] > rows[1]["bw_mean"]):
            fail(f"partition sweep {name}: best P={best} perf {gain:+.4f} "
                 f"(band {band}), bw std {rows[best]['bw_std']:.4g} vs "
                 f"{rows[1]['bw_std']:.4g}, mean {rows[best]['bw_mean']:.4g} "
                 f"vs {rows[1]['bw_mean']:.4g}")
        log(f"phase 3 [sweep {name}]: Fig. 5 on the paper's KNL pricing, "
            f"{time.perf_counter() - t0:.2f} s host: " + ", ".join(
                f"P={p} perf {r['perf']:.4f} bw_mean {r['bw_mean'] / 1e9:.1f}"
                f" GB/s bw_std {r['bw_std'] / 1e9:.1f} GB/s"
                for p, r in rows.items()))
    return runs


# ---------------------------------------------------------------------------
# the eleventh slice: the MoE and VLM families, the dense family's others
# ---------------------------------------------------------------------------


def family_cfg(arch, **kw):
    from repro_torch.configs import get_config

    return get_config(arch).replace(**kw)


def projections(cfg):
    """(K, N) of every matmul a block issues through the wrapper (the
    q / k / v / o projections; the dense MLP's or the shared experts')."""
    d, hd = cfg.d_model, cfg.head_dim
    out = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d)]
    f = cfg.d_ff * (cfg.n_shared_experts if cfg.n_experts else 1)
    if f and (not cfg.n_experts or cfg.n_shared_experts):
        out += [(d, f), (f, d)]
    return out


def phase_family_kernels(torch):
    """Phase 1 at the new configs' shapes: the matmul against its plain
    version at each projection at a decode step's M (SLOTS) and a prefill
    wave's (SLOTS x the prompt, the image prefix included) and the LM head
    at M = SLOTS, bf16 and fp32; flash attention at each config's prefill
    wave (internvl2's prompts are 256 image rows and the text); then the
    decode-attention template's four entry points at each config's (Hq,
    Hkv, D) and serve contexts (``phase_decode_kernels``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref

    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    shapes, heads = set(), set()
    for arch in FAMILY_RUNS:
        cfg = family_cfg(arch)
        S = PROMPT + (cfg.n_img_tokens or 0)
        shapes |= {(M, K, N) for K, N in projections(cfg)
                   for M in (SLOTS, SLOTS * S)}
        shapes.add((SLOTS, cfg.d_model, cfg.vocab))
        heads.add((S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim))
    worst = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[1]
        for M, K, N in sorted(shapes):
            a, b = rnd((M, K), dt), rnd((K, N), dt, 1 / math.sqrt(K))
            e = check_close(torch, f"matmul {M}x{K}x{N} {name}",
                            mm_ops.matmul(a, b), mm_ref.matmul(a, b),
                            TOL[name])
            worst[f"matmul {name}"] = max(worst.get(f"matmul {name}", 0), e)
            del a, b
        for S, hq, hkv, D in sorted(heads):
            q = rnd((SLOTS, S, hq, D), dt)
            k, v = rnd((SLOTS, S, hkv, D), dt), rnd((SLOTS, S, hkv, D), dt)
            e = check_close(torch, f"flash_attention S={S} Hq={hq} "
                            f"Hkv={hkv} {name}",
                            fa_ops.flash_attention(q, k, v),
                            fa_ref.attention(q, k, v), TOL[name])
            worst[f"flash_attention {name}"] = max(
                worst.get(f"flash_attention {name}", 0), e)
    log(f"phase 1: the new configs' shapes: matmul at {len(shapes)} (M, K, "
        f"N) and flash attention at {len(heads)} prefill waves "
        f"{sorted(heads)} match their plain versions in bf16 and fp32 (max "
        f"abs err {', '.join(f'{k} {v:.3g}' for k, v in worst.items())})")
    for arch in FAMILY_RUNS:
        cfg = family_cfg(arch)
        phase_decode_kernels(torch, cfg, prefix=cfg.n_img_tokens or 0,
                             label=f"[{arch} Hq={cfg.n_heads} "
                                   f"Hkv={cfg.n_kv_heads}] ")


class Routing:
    """Every ``moe.route`` call's expert ids and sorted probabilities, and
    every ``moe.dispatch`` call's slot tables, while installed, on the
    device the call ran on, kept on the host."""

    def __init__(self, moe):
        self.moe, self.calls, self.tables = moe, [], []
        self.real = moe.route, moe.dispatch

    def __enter__(self):
        route, dispatch = self.real

        def record(p, cfg, xf):
            probs, gate, eid = route(p, cfg, xf)
            top = probs.sort(dim=-1, descending=True).values
            top = top[:, :cfg.top_k + 1]
            self.calls.append((eid.cpu(), top.cpu()))
            return probs, gate, eid

        def tables(eid, E, C):
            inv_slot, buf_tok = dispatch(eid, E, C)
            self.tables.append((inv_slot.cpu(), buf_tok.cpu()))
            return inv_slot, buf_tok
        self.moe.route, self.moe.dispatch = record, tables
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.dispatch = self.real


def plain_dispatch(eid, E: int, C: int):
    """The reference's slot tables (``_moe_group`` of the JAX package) by
    a loop over the stably sorted token copies, a later write to one slot
    replacing an earlier one as on the reference's CPU: (inv_slot,
    buf_tok, the number of experts over capacity)."""
    T, K = eid.shape
    flat = eid.reshape(-1).tolist()
    buf_tok, inv_slot, load = [T] * (E * C), [E * C] * (T * K), [0] * E
    for i in sorted(range(T * K), key=flat.__getitem__):    # stable
        e, pos = flat[i], load[flat[i]]
        load[e] += 1
        slot = e * C + min(pos, C - 1)
        buf_tok[slot] = i // K if pos < C else T
        if pos < C:
            inv_slot[i] = slot
    return inv_slot, buf_tok, sum(n > C for n in load)


def phase_family_card_vs_cpu(torch):
    """Phase 2 for the new configs: each at full width in fp32 (2 layers;
    dbrx 1, FAMILY_CHECK_LAYERS), the same weights on the card (kernels)
    and the CPU (plain versions): a ragged wave (internvl2's with seeded
    patch embeddings before the text; slot 0's prompt one token repeated,
    so its rows route alike and experts overflow) into a float pool, then
    4 decode steps.  The expert ids of every routed row must equal the
    CPU's, but for flips where the CPU's gap between the k-th and the
    (k+1)-th probability is below 1e-6 (each printed and counted; its slot
    leaves the logit comparison).  Logits within MODEL_TOL with the same
    argmax over the other slots.  Then the graph lockstep of phase 2 at 2
    layers for qwen3-moe and internvl2."""
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as TF
    from repro_torch.serving import kv_pool as KV

    lens = [PROMPT, 20, 27, 9]
    for arch in FAMILY_RUNS:
        cfg2 = family_cfg(arch, dtype="float32",
                          n_layers=FAMILY_CHECK_LAYERS.get(arch, 2))
        n_img = cfg2.n_img_tokens or 0
        max_len = n_img + PROMPT + 16
        gen = torch.Generator().manual_seed(3)
        tokens = torch.randint(1, cfg2.vocab, (len(lens), PROMPT),
                               generator=gen)
        tokens[0] = tokens[0, 0]                       # one token repeated
        img = torch.randn((len(lens), n_img, cfg2.d_model), generator=gen)
        params = {"cuda": TF.init_lm(cfg2, torch.Generator(
            device="cuda").manual_seed(2), "cuda")}
        params["cpu"] = tree_to(params["cuda"], "cpu")
        logits, routing = {}, {}
        for dev in ("cuda", "cpu"):
            p, bs = params[dev], 16
            T = -(-max_len // bs)
            pool = KV.BlockPool(1 + len(lens) * T, bs)
            tables = torch.tensor([pool.alloc(T) for _ in lens],
                                  dtype=torch.int32, device=dev)
            batch = {"tokens": tokens.to(dev)}
            if n_img:
                batch["img_embeds"] = img.to(dev)
            with Routing(MOE) as routing[dev]:
                lg, cache = TF.prefill(p, cfg2, batch, max_len=max_len,
                                       lens=torch.tensor(lens))
                pages = KV.init_pages(cfg2, pool.n_blocks, bs, device=dev)
                KV.write_prefix_pages(pages, cache["k"], cache["v"], tables)
                pc = dict(pages, tables=tables, lens=torch.tensor(
                    lens, dtype=torch.int32, device=dev) + n_img)
                steps = [lg.cpu()]
                for _ in range(4):
                    lg, pc = TF.decode_step_paged(p, cfg2,
                                                  lg.argmax(-1)[:, None], pc)
                    lg = lg[:, 0]
                    steps.append(lg.cpu())
            logits[dev] = steps
            del p, pages, pc, cache
        del params
        gc.collect()
        torch.cuda.empty_cache()
        flipped, flips, overflows = set(), [], 0
        card, cpu = routing["cuda"].calls, routing["cpu"].calls
        if len(card) != len(cpu):
            fail(f"card vs CPU {arch}: {len(card)} routed calls on the card, "
                 f"{len(cpu)} on the CPU")
        for call, ((ea, _), (eb, top)) in enumerate(zip(card, cpu)):
            rows = eb.shape[0]
            per_slot = rows // len(lens)          # prefill: B x S; decode: B
            C = MOE.capacity(rows, cfg2.n_experts, cfg2.top_k,
                             cfg2.capacity_factor)
            # each device's slot tables against the plain loop on its own
            # expert ids: the dispatch, the C-1 overflow slot included
            for dev, e in (("cuda", ea), ("cpu", eb)):
                inv_slot, buf_tok, over = plain_dispatch(e, cfg2.n_experts,
                                                         C)
                got = routing[dev].tables[call]
                if got[0].tolist() != inv_slot or \
                        got[1].tolist() != buf_tok:
                    fail(f"card vs CPU {arch}: routed call {call}: the "
                         f"{dev} dispatch's slot tables differ from the "
                         "plain loop's")
                if dev == "cpu":
                    overflows += over
            for r in (ea != eb).any(-1).nonzero().flatten().tolist():
                k = cfg2.top_k
                gap = float(top[r, k - 1] - top[r, k])
                if gap >= 1e-6:
                    fail(f"card vs CPU {arch}: routed call {call} row {r}: "
                         f"experts {ea[r].tolist()} on the card, "
                         f"{eb[r].tolist()} on the CPU (the CPU's gap between "
                         f"the {k}-th and the next probability {gap:.3g} >= "
                         "1e-6)")
                flips.append(f"call {call} row {r} gap {gap:.3g}")
                flipped.add(r // max(per_slot, 1))
        if cfg2.n_experts and not overflows:
            fail(f"card vs CPU {arch}: no expert overflowed")
        keep = [b for b in range(len(lens)) if b not in flipped]
        worst = 0.0
        for i, (a, b) in enumerate(zip(logits["cuda"], logits["cpu"])):
            a, b = a[keep], b[keep]
            if not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"card vs CPU {arch}: argmax differs at step {i}")
            worst = max(worst, check_close(
                torch, f"card vs CPU {arch} step {i}", a, b, MODEL_TOL))
        routed = (f"; {len(cpu)} routed calls, expert ids equal but for "
                  f"{len(flips)} flips below a 1e-6 gap {flips} (slots "
                  f"{sorted(flipped)} left out); slot tables equal the "
                  f"plain loop's on both, {overflows} overflowing experts"
                  if cfg2.n_experts else "")
        log(f"phase 2: {arch} at full width, {cfg2.n_layers} of "
            f"{family_cfg(arch).n_layers} layers, fp32, "
            f"card vs CPU: prefill (prompts {[n_img + n for n in lens]}) + 4 "
            f"decode steps on a float pool agree (max abs logit err "
            f"{worst:.3g}, tolerance {MODEL_TOL}), identical argmax{routed}")
    for arch in FAMILY_LOCKSTEP:
        cfg2 = family_cfg(arch, n_layers=2, dtype="float32")
        params = TF.init_lm(cfg2, torch.Generator(device="cuda").manual_seed(
            2), "cuda")
        graph_lockstep_traced(torch, cfg2, params, f"{arch} fp32",
                              [PROMPT, 20, 27, 9, 14, 14, 14, 25],
                              [8, 3, 7, 6, 5, 4, 3, 4], 6)
        del params
        gc.collect()
        torch.cuda.empty_cache()


def tree_to(tree, dev):
    return {k: tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def depth_of(serve, n_layers):
    """Serve at ``n_layers`` layers: ``serve.get_config`` wrapped for one
    run (one card's 80 GB cannot hold the full depth)."""
    real = serve.get_config

    def cut(name, smoke=False):
        cfg = real(name, smoke=smoke)
        return cfg if n_layers is None else cfg.replace(n_layers=n_layers)
    return real, cut


def step_measure(torch, engines, cfg):
    """After a serve run, on its first engine's captured decode graph: the
    device ms of a replayed step (CUDA events over bare replays), the wall
    ms of the engine's own step (fill, replay, read back; median of
    STEP_CALLS, the slots idle by then) and the idle share 1 - device /
    wall; the step's bytes bound (every weight but the embedding read
    once, a tied embedding included as the LM head; for the SSM families
    every slot's SSM state read and written).  For MoE also the expert
    products' ms per step, timed on the engine's weights at the step's
    buffer (E, C, d) layer after layer, and their bytes bound; for the SSM
    families the SSM path's ms alone (``ssm_path_ms``)."""
    from repro_torch.models import moe as MOE
    from repro_torch.profiling.decode_profile import replay_ms, timed

    eng = engines[0]
    dev = eng.device
    device_ms = replay_ms(eng.graph.graph, dev)
    wall_ms = 1e3 * float(sorted(timed(eng._run_decode, dev, STEP_CALLS))[
        STEP_CALLS // 2])
    params = eng.params
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in leaves(params))
    if not cfg.tie_embeddings:
        weight_bytes -= params["embed"].numel() * \
            params["embed"].element_size()
    state_bytes = 0
    if "ssm_state" in ssm_arrays(eng):
        st = ssm_arrays(eng)["ssm_state"]
        state_bytes = 2 * st.numel() * st.element_size()
    out = dict(device_ms=device_ms, wall_ms=wall_ms,
               idle=1 - device_ms / wall_ms,
               bound_ms=(weight_bytes + state_bytes) / H100_BW * 1e3,
               weight_gb=weight_bytes / 1e9, state_gb=state_bytes / 1e9)
    if state_bytes:
        out["ssm_ms"] = ssm_path_ms(torch, eng, cfg)
    if cfg.n_experts:
        moe = params["blocks"]["moe"]
        C = MOE.capacity(eng.slots, cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
        buf = torch.randn((cfg.n_experts, C, cfg.d_model), device=dev).to(
            moe["w1"].dtype)
        L = cfg.n_layers

        def layer(i):
            MOE.expert_ffn(buf, moe["w1"][i], moe["w2"][i], moe["w3"][i])
        out["expert_ms"] = time_ms(torch, layer, L, 2 * L) * L
        out["expert_bound_ms"] = sum(
            moe[k].numel() * moe[k].element_size()
            for k in ("w1", "w2", "w3")) / H100_BW * 1e3
    return out


def ssm_arrays(eng) -> dict:
    """The engine's per-slot SSM arrays: beside the pool, or in the slab
    (empty for a family without them)."""
    src = (eng.pages if eng.paged else eng.cache) or {}
    return {k: src[k] for k in SSM_STATE if k in src}


def ssm_path_ms(torch, eng, cfg) -> float:
    """Device ms of a decode step's SSM path alone: every layer's
    ``ssm_decode`` (its two projections included) on the engine's weights,
    SSM state and conv window, at the step's (slots, 1, d), captured as one
    CUDA graph and timed over bare replays.  ``ssm_decode`` returns the new
    state without writing it, so the engine's state is left as it was."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models.transformer import _layer
    from repro_torch.profiling.decode_profile import replay_ms
    from repro_torch.serving.step_graph import CapturedOp

    st, cv = ssm_arrays(eng)["ssm_state"], ssm_arrays(eng)["ssm_conv"]
    h = torch.randn((eng.slots, 1, cfg.d_model), device=eng.device).to(
        st.dtype)
    layers = [_layer(eng.params["blocks"], li)["ssm"]
              for li in range(cfg.n_layers)]

    def path():
        return [SSM.ssm_decode(p, cfg, h, {"state": st[li], "conv": cv[li]})
                for li, p in enumerate(layers)]
    op = CapturedOp(path, [], eng.device)
    op()            # eager
    op()            # captured, replayed
    return replay_ms(op.graph, eng.device)


def leaves(tree):
    for v in tree.values():
        yield from leaves(v) if isinstance(v, dict) else (v,)


def phase_family_serve(torch, wrappers):
    """Phase 3 for the new configs: ``serve.main`` at full width, bf16,
    phase 3's load (8 requests, prompt 32, 16 tokens, 2 partitions x 4
    slots, stagger demand), each at the depth FAMILY_RUNS gives, then
    int8 pages + sparse decode on qwen3-moe at the lever load.  Each run
    must complete every request, launch the matmul, flash attention and
    its decode kernel, run one eager decode step, one capture and replays
    per engine and its prefills as an LRU does (``serve_run``); it logs its
    wall, tokens per wall second, peak memory, launches and the replayed
    step's device ms and idle share beside its bytes bound (for MoE the
    expert products' too).  Each model is freed before the next."""
    from repro_torch.launch import serve

    runs = {}
    loads = [(arch, ["--arch", arch] + SERVE_ARGS[2:], n)
             for arch, n in FAMILY_RUNS.items()]
    loads.append((f"{FAMILY_LEVER} int8+sparse",
                  ["--arch", FAMILY_LEVER] + LEVER_ARGS[2:]
                  + LEVER_RUNS["int8+sparse"], None))
    for name, argv, n_layers in loads:
        gc.collect()
        torch.cuda.empty_cache()
        real, cut = depth_of(serve, n_layers)
        serve.get_config = cut
        try:
            cfg = cut(argv[1])
            measured = {}
            runs[name] = serve_run(
                torch, cfg, wrappers, name, argv, flag(argv, "--requests"),
                flag(argv, "--gen"), after=lambda engines: measured.update(
                    step_measure(torch, engines, cfg)))
        finally:
            serve.get_config = real
        kernel = "paged_decode_quant" if "int8" in name else "paged_decode"
        for k in ("matmul", "flash_attention", kernel):
            if runs[name]["launches"][k] == 0:
                fail(f"serve {name}: kernel {k} was never launched")
        if "int8" in name and runs[name]["dropped"][kernel] == 0:
            fail(f"serve {name}: the keep masks dropped no block")
        m = measured
        depth = "" if n_layers is None else (
            f"; {n_layers} of {real(argv[1]).n_layers} layers, the depth "
            "one 80 GB card holds at full width in bf16")
        expert = "" if "expert_ms" not in m else (
            f"; expert products {m['expert_ms']:.3f} ms a step (bytes bound "
            f"{m['expert_bound_ms']:.3f} ms)")
        log(f"phase 3 [{name}]: {cfg.name} d={cfg.d_model} "
            f"layers={cfg.n_layers}{depth}: replayed decode step "
            f"{m['device_ms']:.3f} ms device, {m['wall_ms']:.3f} ms wall, "
            f"idle share {m['idle']:.3f}; bytes bound {m['bound_ms']:.3f} ms "
            f"({m['weight_gb']:.2f} GB of weights but the embedding)"
            f"{expert}")
        runs[name].update(step=m)
    return runs


# ---------------------------------------------------------------------------
# the twelfth slice: the SSM and hybrid families
# ---------------------------------------------------------------------------

SSM_ARCHS = ("mamba2-130m", "hymba-1.5b")
# phase 2's prompt: hymba's 128 meta rows and 1152 text tokens are 1280
# positions, past its 1024-key window (and a whole number of 256-row SSD
# chunks); 2 layers of mamba2, 3 of hymba (global layers (0, 15, 31) mod 3
# leave layer 2 windowed)
SSM_LONG = 1152
SSM_CHECK_LAYERS = {"mamba2-130m": 2, "hymba-1.5b": 3}
SSM_STEPS = 8
# the graph lockstep's load: a wave of two prompt lengths (two groups),
# then four refills, three of one shape
SSM_LOCKSTEP = ([PROMPT, 20, PROMPT, 20, 25, 25, 25, 30],
                [8, 3, 7, 6, 5, 4, 3, 4])


def ssm_matmuls(cfg):
    """(name, K, N) of every matmul an SSM or hybrid block issues."""
    d_inner = cfg.ssm_heads * cfg.ssm_head_dim
    n_in = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
    out = [("in_proj", cfg.d_model, n_in), ("out_proj", d_inner, cfg.d_model)]
    if cfg.family == "hybrid":
        names = ("wq", "wk", "wo", "w1", "w2")
        out += [(n, K, N) for n, (K, N) in zip(names, projections(cfg))]
    return out


def phase_ssm_kernels(torch):
    """Phase 1 at the twelfth slice's shapes, each kernel against its plain
    version in bf16 (3e-2) and fp32 (2e-4), then timed in bf16 beside its
    plain version, one library call and its bound: the matmul at every
    (M, K, N) of mamba2-130m and hymba-1.5b at a decode step's M (SLOTS)
    and a prefill wave's (SLOTS x the prompt, hymba's 128 meta rows
    included) and each LM head, on weight buffers past the L2, with the
    route each takes; flash attention at hymba's (Hq 25, Hkv 5, D 64) at
    the wave's 160 rows and a 1,280-row prompt, windows 0 and 1024 (which
    bites there); ``paged_decode`` and ``flash_decode`` at (25, 5, 64),
    contexts 163-174 and ~1,290, windows 0 and 1024, through the wrapper
    and at forced splits.  Returns the timings by kernel."""
    from repro_torch.kernels import decode_split
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_decode import flash_decode as fd_k
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.matmul.matmul import launch, plan_for
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import paged_attention as pa_k
    from repro_torch.kernels.paged_attention import ref as pa_ref

    g = torch.Generator(device="cuda").manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    def name_of(dt):
        return str(dt).split(".")[1]

    # -- the matmul: every shape, both dtypes; then routes and times
    shapes, per_step = {}, {}
    for arch in SSM_ARCHS:
        cfg = family_cfg(arch)
        wave = SLOTS * ((cfg.n_meta_tokens or 0) + PROMPT)
        for name, K, N in ssm_matmuls(cfg):
            calls = 2 if name in ("wk", "w1") else 1    # wv, w3: same shape
            for M in (SLOTS, wave):
                shapes.setdefault((M, K, N), []).append(f"{arch} {name}")
            per_step.setdefault(arch, []).append(((SLOTS, K, N),
                                                  calls * cfg.n_layers))
        shapes.setdefault((SLOTS, cfg.d_model, cfg.vocab), []).append(
            f"{arch} head")
        per_step[arch].append(((SLOTS, cfg.d_model, cfg.vocab), 1))
    worst = {}
    for dt in (bf, f32):
        for M, K, N in sorted(shapes):
            a, b = rnd((M, K), dt), rnd((K, N), dt, 1 / math.sqrt(K))
            e = check_close(torch, f"matmul {M}x{K}x{N} {name_of(dt)}",
                            mm_ops.matmul(a, b), mm_ref.matmul(a, b),
                            TOL[name_of(dt)])
            worst[f"matmul {name_of(dt)}"] = max(
                worst.get(f"matmul {name_of(dt)}", 0.0), e)
            del a, b
    times = {}
    for M, K, N in sorted(shapes):
        n_sets = max(1, min(64, math.ceil(120e6 / (2 * K * N))))
        sets = [(rnd((M, K), bf), rnd((K, N), bf, 1 / math.sqrt(K)))
                for _ in range(n_sets)]
        plans = [plan_for(a, b) for a, b in sets]
        route = plans[0].route + (" staged" if any(plans[0].staged) else "")
        if any((p.route, p.staged) != (plans[0].route, plans[0].staged)
               for p in plans):
            fail(f"matmul {M}x{K}x{N}: one shape took plans {plans}")
        t_k = time_ms(torch, lambda i: launch(*sets[i], plans[i]), n_sets)
        t_p = time_ms(torch, lambda i: mm_ref.matmul(*sets[i]), n_sets, 5)
        t_l = time_ms(torch, lambda i: torch.matmul(*sets[i]), n_sets)
        b_ms, by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K,
                         H100_BF16)
        times[(M, K, N)] = dict(route=route, ms=t_k, plain_ms=t_p,
                                library_ms=t_l, bound_ms=b_ms, bound_by=by)
        log(f"  matmul bf16 {M}x{K}x{N} [{', '.join(shapes[(M, K, N)])}]: "
            f"route {route}, kernel_ms {t_k:.4f} plain_ms {t_p:.4f} "
            f"library_ms {t_l:.4f} bound_ms {b_ms:.4f} ({by})")
        del sets
    steps = {arch: {key: sum(times[s][key] * n for s, n in calls)
                    for key in ("ms", "library_ms", "bound_ms")}
             for arch, calls in per_step.items()}
    log(f"phase 1 [ssm]: matmul at {len(shapes)} (M, K, N) matches its "
        f"plain version in bf16 and fp32 ({worst}); routes "
        f"{ {f'{M}x{K}x{N}': t['route'] for (M, K, N), t in times.items()} }"
        f"; a decode step's matmuls (bf16, M = {SLOTS}) "
        + ", ".join(f"{a} {s['ms']:.3f} ms (torch.matmul {s['library_ms']:.3f}"
                    f", bound {s['bound_ms']:.3f})" for a, s in steps.items()))
    cfg = family_cfg("hymba-1.5b")
    for name, M, K, N in (("in_proj", SLOTS, 1600, 3257),
                          ("in_proj", SLOTS * 160, 1600, 3257),
                          ("head", SLOTS, 1600, cfg.vocab)):
        if times[(M, K, N)]["route"] != "mma staged":
            fail(f"matmul hymba {name} {M}x{K}x{N}: route "
                 f"{times[(M, K, N)]['route']}, want mma staged (its rows "
                 "are not 16 bytes)")

    # -- flash attention at hymba's heads, windows 0 and 1024
    hq, hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_window
    wave_s = (cfg.n_meta_tokens or 0) + PROMPT
    long_s = (cfg.n_meta_tokens or 0) + SSM_LONG
    fa = {}
    for B, S in ((SLOTS, wave_s), (1, long_s)):
        for w in (0, W):
            for dt in (bf, f32):
                q = rnd((B, S, hq, D), dt)
                k, v = rnd((B, S, hkv, D), dt), rnd((B, S, hkv, D), dt)
                e = check_close(torch, f"flash_attention ({B},{S},{hq},{hkv},"
                                f"{D}) window={w} {name_of(dt)}",
                                fa_ops.flash_attention(q, k, v, window=w),
                                fa_ref.attention(q, k, v, window=w),
                                TOL[name_of(dt)])
                worst[f"flash_attention {name_of(dt)}"] = max(
                    worst.get(f"flash_attention {name_of(dt)}", 0.0), e)
            q = rnd((B, S, hq, D), bf)
            k, v = rnd((B, S, hkv, D), bf), rnd((B, S, hkv, D), bf)
            t_k = time_ms(torch, lambda i: fa_ops.flash_attention(
                q, k, v, window=w), 1)
            t_p = time_ms(torch, lambda i: fa_ref.attention(q, k, v,
                                                            window=w), 1, 5)
            pairs = sum(min(i + 1, w or S) for i in range(S))
            b_ms, by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                             4 * B * hq * D * pairs, H100_BF16)
            fa[(B, S, w)] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                 bound_by=by)
            log(f"  flash_attention bf16 ({B},{S},{hq},{hkv},{D}) window "
                f"{w}: kernel_ms {t_k:.4f} plain_ms {t_p:.4f} bound_ms "
                f"{b_ms:.5f} ({by}; {pairs} causal pairs a head)")

    # -- paged_decode and flash_decode at (25, 5, 64)
    bs, sms = 16, decode_split.sm_count(torch.device("cuda"))
    dec = {}
    for tag, curs in (("serve", [wave_s + o for o in (3, 9, 1, 14)]),
                      ("long", [long_s + o for o in LONG_OFFSETS])):
        B = len(curs)
        tables, N = paged_tables(torch, curs, bs, "cuda", inactive=False)
        cur = torch.tensor(curs, dtype=torch.int32, device="cuda")
        walk = tables.shape[1] * bs
        forced = sorted({1, decode_split.plan(B, hkv, walk, sms),
                         -(-walk // decode_split.KT) + 3})
        for w in (0, W):
            for dt in (bf, f32):
                tol = TOL[name_of(dt)]
                qd = rnd((B, hq, D), dt)
                kp, vp = rnd((N, bs, hkv, D), dt), rnd((N, bs, hkv, D), dt)
                want = pa_ref.paged_decode_attention(qd, kp, vp, tables, cur,
                                                     window=w)
                got = [pa_ops.paged_decode(qd, kp, vp, tables, cur,
                                           window=w)]
                got += [pa_k.paged_decode_cuda(qd, kp, vp, tables, cur,
                                               window=w, splits=n)
                        for n in forced]
                for n, o in zip(["plan"] + forced, got):
                    e = check_close(torch, f"paged_decode {tag} window={w} "
                                    f"splits={n} {name_of(dt)}", o, want, tol)
                    worst[f"paged_decode {name_of(dt)}"] = max(
                        worst.get(f"paged_decode {name_of(dt)}", 0.0), e)
                kc, vc = rnd((B, walk, hkv, D), dt), rnd((B, walk, hkv, D), dt)
                want = fd_ref.decode_attention(qd, kc, vc, cur, window=w)
                got = [fd_ops.flash_decode(qd, kc, vc, cur, window=w)]
                got += [fd_k.flash_decode_cuda(qd, kc, vc, cur, window=w,
                                               splits=n) for n in forced]
                for n, o in zip(["plan"] + forced, got):
                    e = check_close(torch, f"flash_decode {tag} window={w} "
                                    f"splits={n} {name_of(dt)}", o, want, tol)
                    worst[f"flash_decode {name_of(dt)}"] = max(
                        worst.get(f"flash_decode {name_of(dt)}", 0.0), e)
            qd = rnd((B, hq, D), bf)
            kp, vp = rnd((N, bs, hkv, D), bf), rnd((N, bs, hkv, D), bf)
            kc, vc = rnd((B, walk, hkv, D), bf), rnd((B, walk, hkv, D), bf)
            rows = sum(min(c + 1, w or c + 1) for c in curs) * hkv
            b_ms, by = bound(2 * 2 * D * rows + 2 * 2 * qd.numel(),
                             4 * D * rows * (hq // hkv), H100_BF16)
            for kern, fn, plain in (
                    ("paged_decode",
                     lambda i: pa_k.paged_decode_cuda(qd, kp, vp, tables,
                                                      cur, window=w),
                     lambda i: pa_ref.paged_decode_attention(
                         qd, kp, vp, tables, cur, window=w)),
                    ("flash_decode",
                     lambda i: fd_k.flash_decode_cuda(qd, kc, vc, cur,
                                                      window=w),
                     lambda i: fd_ref.decode_attention(qd, kc, vc, cur,
                                                       window=w))):
                t_k = time_ms(torch, fn, 1)
                t_p = time_ms(torch, plain, 1, 5)
                dec[(kern, tag, w)] = dict(ms=t_k, plain_ms=t_p,
                                           bound_ms=b_ms, bound_by=by)
                log(f"  {kern} bf16 {tag} contexts {curs[0]}-{max(curs)} "
                    f"(25, 5, 64) window {w}: kernel_ms {t_k:.4f} plain_ms "
                    f"{t_p:.4f} bound_ms {b_ms:.5f} ({by}), plan's splits "
                    f"{decode_split.plan(B, hkv, walk, sms)}")
    log(f"phase 1 [ssm]: flash attention at (25, 5, 64), {len(fa)} shapes "
        f"x windows 0 / {W}, and paged_decode / flash_decode at 2 context "
        f"sets x windows x splits {forced} match their plain versions in "
        "bf16 and fp32; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    return {"matmul": {f"{M}x{K}x{N}": t for (M, K, N), t in times.items()},
            "matmul_step": steps,
            "flash_attention": {f"{B}x{S} window {w}": t
                                for (B, S, w), t in fa.items()},
            "decode": {f"{k} {tag} window {w}": t
                       for (k, tag, w), t in dec.items()}}


def phase_ssm_card_vs_cpu(torch):
    """Phase 2 for the SSM and hybrid families: each at full width in fp32
    (mamba2 2 layers, hymba 3, SSM_CHECK_LAYERS), the same weights on the
    card (kernels) and the CPU (plain versions): 2 prompts of SSM_LONG
    tokens (hymba's 1,280 positions with its meta rows: the 1024 window
    bites) prefilled, then SSM_STEPS greedy decode steps on a paged pool
    (hymba's K/V; mamba2 has no pages): logits within MODEL_TOL with the
    same argmax every step, and the SSM state and conv window after the
    prefill and after the last step within MODEL_TOL.  Then the graph
    lockstep of phase 2 for both, a wave of two prompt lengths (two
    groups) and four refills, and the PD oracle on hymba: a wave handed
    from one engine to another over the wire, its KV pages and SSM state
    with it, decodes bit for bit as the never-migrated engine."""
    from repro_torch.models import api as mapi
    from repro_torch.models import transformer as TF
    from repro_torch.serving import PrefillGraphs
    from repro_torch.serving import kv_pool as KV

    for arch in SSM_ARCHS:
        cfg2 = family_cfg(arch, dtype="float32",
                          n_layers=SSM_CHECK_LAYERS[arch])
        n_meta = cfg2.n_meta_tokens or 0
        max_len, bs, B = n_meta + SSM_LONG + 2 * SSM_STEPS, 16, 2
        tokens = torch.randint(1, cfg2.vocab, (B, SSM_LONG),
                               generator=torch.Generator().manual_seed(3))
        params = {"cuda": TF.init_lm(cfg2, torch.Generator(
            device="cuda").manual_seed(2), "cuda")}
        params["cpu"] = tree_to(params["cuda"], "cpu")
        got = {}
        for dev in ("cuda", "cpu"):
            p = params[dev]
            T = -(-max_len // bs)
            pool = KV.BlockPool(1 + B * T, bs)
            tables = torch.tensor([pool.alloc(T) for _ in range(B)],
                                  dtype=torch.int32, device=dev)
            lg, cache = TF.prefill(p, cfg2, {"tokens": tokens.to(dev)},
                                   max_len=max_len)
            pages = KV.init_pages(cfg2, pool.n_blocks, bs, device=dev)
            if "k" in cache:
                KV.write_prefix_pages(pages, cache["k"], cache["v"], tables)
            pc = dict(pages, tables=tables, lens=torch.full(
                (B,), n_meta + SSM_LONG, dtype=torch.int32, device=dev),
                ssm_state=cache["ssm_state"], ssm_conv=cache["ssm_conv"])
            # copies: on the CPU ``.cpu()`` returns the tensor itself, which
            # the decode steps then update in place
            rec = {"logits": [lg.cpu()],
                   "prefill state": [cache[k].to("cpu", copy=True)
                                     for k in SSM_STATE]}
            for _ in range(SSM_STEPS):
                lg, pc = TF.decode_step_paged(p, cfg2, lg.argmax(-1)[:, None],
                                              pc)
                lg = lg[:, 0]
                rec["logits"].append(lg.cpu())
            rec["decoded state"] = [pc[k].cpu() for k in SSM_STATE]
            got[dev] = rec
            del p, pages, pc, cache
        worst = 0.0
        for i, (a, b) in enumerate(zip(got["cuda"]["logits"],
                                       got["cpu"]["logits"])):
            if not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"card vs CPU {arch}: argmax differs at step {i}")
            worst = max(worst, check_close(
                torch, f"card vs CPU {arch} step {i}", a, b, MODEL_TOL))
        state = {}
        for when in ("prefill state", "decoded state"):
            for key, a, b in zip(SSM_STATE, got["cuda"][when],
                                 got["cpu"][when]):
                state[f"{when} {key}"] = check_close(
                    torch, f"card vs CPU {arch} {when} {key}", a, b,
                    MODEL_TOL)
        log(f"phase 2: {arch} at full width, {cfg2.n_layers} of "
            f"{family_cfg(arch).n_layers} layers, fp32, card vs CPU: prefill "
            f"of {B} x {n_meta + SSM_LONG} positions + {SSM_STEPS} decode "
            f"steps agree (max abs logit err {worst:.3g}, tolerance "
            f"{MODEL_TOL}), identical argmax; SSM state and conv window "
            f"max abs err " + ", ".join(f"{k} {v:.3g}"
                                        for k, v in state.items()))
        cuda_params = params["cuda"]
        del params, got
        gc.collect()
        torch.cuda.empty_cache()
        lens, gens = SSM_LOCKSTEP
        graph_lockstep_traced(torch, cfg2, cuda_params, f"{arch} fp32",
                              lens, gens, 6)
        if cfg2.family == "hybrid":
            api = mapi.build(cfg2, "cuda")
            launches, nbytes = pd_oracle(torch, cfg2, api, cuda_params,
                                         f"{arch} fp32", PrefillGraphs(api))
            for k in ("matmul", "paged_decode"):
                if launches[k] == 0:
                    fail(f"pd oracle {arch}: engine B never launched {k}")
        del cuda_params
        gc.collect()
        torch.cuda.empty_cache()


def phase_ssm_serve(torch, wrappers):
    """Phase 3 for the SSM and hybrid families: ``serve.main`` at full
    width and full depth (mamba2-130m 24 layers, hymba-1.5b 32), bf16, at
    phase 3's load (8 requests, prompt 32, 16 tokens, 2 partitions x 4
    slots, stagger demand), then hymba on the dense slab (``--dense``),
    with ``serve_run``'s gates; each must launch the matmul (hymba also
    flash attention and ``paged_decode``, or ``flash_decode`` on the
    slab), and every matmul must take the tensor cores, hymba's in_proj and
    head staged (their rows are not 16 bytes).  Each
    logs the replayed decode step's device ms, wall ms, idle share and
    bytes bound (``step_measure``: the weights, mamba2's tied embedding
    included, and every slot's SSM state read and written)."""
    from repro_torch.launch import serve

    runs = {}
    loads = [(arch, ["--arch", arch] + SERVE_ARGS[2:]) for arch in SSM_ARCHS]
    loads.append(("hymba-1.5b dense",
                  ["--arch", "hymba-1.5b"] + SERVE_ARGS[2:] + ["--dense"]))
    for name, argv in loads:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = family_cfg(argv[1])
        measured = {}
        runs[name] = serve_run(
            torch, cfg, wrappers, name, argv, flag(argv, "--requests"),
            flag(argv, "--gen"), after=lambda engines: measured.update(
                step_measure(torch, engines, cfg)))
        decode = "flash_decode" if "--dense" in argv else "paged_decode"
        carries = ("matmul",) if cfg.family == "ssm" else (
            "matmul", "flash_attention", decode)
        for k in carries:
            if runs[name]["launches"][k] == 0:
                fail(f"serve {name}: kernel {k} was never launched")
        routes, staged = runs[name]["routes"], runs[name]["staged"]
        if routes["skinny"] + routes["tiled"] or \
                (cfg.family == "ssm") != (staged == 0):
            fail(f"serve {name}: matmul routes {routes}, {staged} staged "
                 "(every matmul on mm_mma, hymba's in_proj and head staged, "
                 "none of mamba2's)")
        m = measured
        log(f"phase 3 [{name}]: {cfg.name} d={cfg.d_model} "
            f"layers={cfg.n_layers}: replayed decode step "
            f"{m['device_ms']:.3f} ms device, {m['wall_ms']:.3f} ms wall, "
            f"idle share {m['idle']:.3f}; bytes bound {m['bound_ms']:.3f} ms "
            f"({m['weight_gb']:.4f} GB of weights"
            f"{', the tied embedding included' if cfg.tie_embeddings else ''}"
            f" + {m['state_gb']:.4f} GB of SSM state read and written); "
            f"its SSM path alone (every layer's ssm_decode, captured) "
            f"{m['ssm_ms']:.3f} ms, {m['ssm_ms'] / m['device_ms']:.3f} of "
            "the step")
        runs[name].update(step=m)
    return runs


def phase_ssm(torch) -> dict:
    """``--only ssm``: the twelfth slice's phase 1, 2 and 3 checks alone."""
    stats = phase_ssm_kernels(torch)
    phase_ssm_card_vs_cpu(torch)
    phase_ssm_serve(torch, serving_wrappers())
    return stats


# ---------------------------------------------------------------------------
# the thirteenth slice: the enc-dec family (whisper-base)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-base"
# flash attention's bidirectional tile edges: Sq and Skv apart (cross
# attention) and equal, on both sides of the 64-row and 64-key tiles; a
# window only where every query keeps a key (Sq - Skv < window)
ENC_LENGTHS = (1, 63, 64, 65, 100, 129)
ENC_GROUPS = (1, 4)
ENC_WINDOWS = (0, 16)
ENC_DIMS = (64, 80)
ENC_CHECK_LAYERS = 2    # phase 2: 2 encoder + 2 decoder layers, fp32
ENC_STEPS = 8
ENC_DEC_LEN = 32        # the teacher-forced tokens: the cross Sq
# the graph lockstep: three waves of SLOTS requests, each wave of another
# prompt width (one prefill-cache key serves them all)
ENC_LOCKSTEP = ([PROMPT] * SLOTS + [20] * SLOTS + [27] * SLOTS,
                [8, 3, 7, 6, 5, 4, 3, 4, 6, 2, 5, 3])


def encdec_matmuls(cfg):
    """(M, K, N): calls of whisper's matmuls in an encoder wave (SLOTS x
    enc_seq rows: q, k, v, o, w1, w2 a layer, and each decoder layer's
    cross K and V) and in a decode step (M = SLOTS: the self q, k, v, o,
    the cross q, o, w1, w2 a layer, and the tied head)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    M, el, dl = SLOTS * cfg.enc_seq, cfg.enc_layers, cfg.n_layers
    wave, step = {}, {}
    for shape, n in (((M, d, hd), 3 * el + 2 * dl), ((M, hd, d), el),
                     ((M, d, f), el), ((M, f, d), el)):
        wave[shape] = wave.get(shape, 0) + n
    for shape, n in (((SLOTS, d, hd), 4 * dl), ((SLOTS, hd, d), 2 * dl),
                     ((SLOTS, d, f), dl), ((SLOTS, f, d), dl),
                     ((SLOTS, d, cfg.vocab), 1)):
        step[shape] = step.get(shape, 0) + n
    return wave, step


def phase_encdec_kernels(torch):
    """Phase 1 at whisper-base's shapes, each kernel against its plain
    version in bf16 (3e-2) and fp32 (2e-4), then timed in bf16 beside its
    plain version, one library call and its bound: flash attention's
    bidirectional mode (``causal=False``) at the encoder's (SLOTS, 1500,
    8, 64), the cross shape (ENC_DEC_LEN and 1 rows over 1500 frames) and
    the tile edges (ENC_GROUPS x ENC_LENGTHS^2 x ENC_WINDOWS x ENC_DIMS),
    timed at the encoder beside SDPA (``is_causal=False``); flash decode at
    G = 1, D 64 over the 1500-row cross K/V at a device scalar position
    and over the self slab at a position vector, through the wrapper and at
    forced splits, timed beside SDPA (every key valid, no mask: the same
    function); the matmul at every (M, K, N) of an encoder wave (M = SLOTS
    x 1500) and a decode step (M = SLOTS, the 51,865-column head staged),
    with its route, on weight buffers past the L2.  Returns
    the timings by kernel."""
    from repro_torch.kernels import decode_split
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.flash_decode import flash_decode as fd_k
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref
    from repro_torch.kernels.matmul.matmul import launch, plan_for

    cfg = family_cfg(ENCDEC_ARCH)
    T, H, D = cfg.enc_seq, cfg.n_heads, cfg.head_dim
    g = torch.Generator(device="cuda").manual_seed(24)
    bf, f32 = torch.bfloat16, torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {}

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    def name_of(dt):
        return str(dt).split(".")[1]

    def held(kernel, tag, dt, got, want):
        e = check_close(torch, f"{kernel} {tag} {name_of(dt)}", got, want,
                        TOL[name_of(dt)])
        worst[f"{kernel} {name_of(dt)}"] = max(
            worst.get(f"{kernel} {name_of(dt)}", 0.0), e)

    # -- flash attention, bidirectional
    cases = [("encoder", SLOTS, T, T, H, H, D, 0),
             ("cross", SLOTS, ENC_DEC_LEN, T, H, H, D, 0),
             ("cross one row", SLOTS, 1, T, H, H, D, 0)]
    cases += [(f"G={G} Sq={Sq} Skv={Skv} window={w} D={Dh}", 2, Sq, Skv,
               2 * G, 2, Dh, w)
              for G in ENC_GROUPS for Sq in ENC_LENGTHS
              for Skv in ENC_LENGTHS for w in ENC_WINDOWS for Dh in ENC_DIMS
              if w == 0 or Sq - Skv < w]
    for tag, B, Sq, Skv, hq, hkv, Dh, w in cases:
        for dt in (bf, f32):
            q = rnd((B, Sq, hq, Dh), dt)
            k, v = rnd((B, Skv, hkv, Dh), dt), rnd((B, Skv, hkv, Dh), dt)
            held("flash_attention bidirectional", tag, dt,
                 fa_ops.flash_attention(q, k, v, causal=False, window=w),
                 fa_ref.attention(q, k, v, causal=False, window=w))
    q, k, v = (rnd((SLOTS, T, H, D), bf) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fa = dict(ms=time_ms(torch, lambda i: fa_ops.flash_attention(
        q, k, v, causal=False), 1),
        plain_ms=time_ms(torch, lambda i: fa_ref.attention(
            q, k, v, causal=False), 1, 5),
        library_ms=time_ms(torch, lambda i: sdpa(qt, kt, vt,
                                                 is_causal=False), 1))
    flops = 4 * SLOTS * H * D * T * T
    fa["bound_ms"], fa["bound_by"] = bound(2 * 4 * q.numel(), flops,
                                           H100_BF16)
    fa.update(shape=f"one encoder layer: q = k = v ({SLOTS},{T},{H},{D}), "
                    "causal=False, bf16",
              tflops=flops / fa["ms"] / 1e9,
              max_abs_err=worst["flash_attention bidirectional bfloat16"])
    log(f"  flash_attention bidirectional bf16 ({SLOTS},{T},{H},{D}): "
        f"kernel_ms {fa['ms']:.4f} ({fa['tflops']:.1f} TFLOP/s) plain_ms "
        f"{fa['plain_ms']:.4f} library_ms {fa['library_ms']:.4f} (SDPA, "
        f"is_causal=False) bound_ms {fa['bound_ms']:.5f} ({fa['bound_by']})")

    # -- flash decode at G = 1: the cross K/V and the self slab
    sms = decode_split.sm_count(torch.device("cuda"))
    self_len = PROMPT + 4 * GEN
    fd = {}
    for tag, S, cur in (
            ("cross", T, torch.tensor(T - 1, dtype=torch.int32,
                                      device="cuda")),
            ("self", self_len, torch.tensor([GEN - 1] * SLOTS,
                                            dtype=torch.int32,
                                            device="cuda"))):
        forced = sorted({1, decode_split.plan(SLOTS, H, S, sms),
                         -(-S // decode_split.KT) + 3})
        for dt in (bf, f32):
            qd = rnd((SLOTS, H, D), dt)
            kc, vc = rnd((SLOTS, S, H, D), dt), rnd((SLOTS, S, H, D), dt)
            want = fd_ref.decode_attention(qd, kc, vc, cur)
            held("flash_decode", f"{tag} plan", dt,
                 fd_ops.flash_decode(qd, kc, vc, cur), want)
            for n in forced:
                held("flash_decode", f"{tag} splits={n}", dt,
                     fd_k.flash_decode_cuda(qd, kc, vc, cur, splits=n), want)
        if tag == "cross":
            qd = rnd((SLOTS, H, D), bf)
            kc, vc = rnd((SLOTS, S, H, D), bf), rnd((SLOTS, S, H, D), bf)
            q4, k4, v4 = (qd[:, :, None], kc.transpose(1, 2).contiguous(),
                          vc.transpose(1, 2).contiguous())
            fd = dict(ms=time_ms(torch, lambda i: fd_ops.flash_decode(
                qd, kc, vc, cur), 1),
                plain_ms=time_ms(torch, lambda i: fd_ref.decode_attention(
                    qd, kc, vc, cur), 1, 5),
                library_ms=time_ms(torch, lambda i: sdpa(q4, k4, v4), 1))
            fd["bound_ms"], fd["bound_by"] = bound(
                2 * (2 * kc.numel() + 2 * qd.numel()),
                4 * SLOTS * H * D * S, H100_BF16)
            fd.update(shape=f"one decode step's cross attention: q "
                            f"({SLOTS},{H},{D}), k/v ({SLOTS},{S},{H},{D}), "
                            f"G = 1, cur a device scalar {T - 1}, bf16",
                      splits=decode_split.plan(SLOTS, H, S, sms))
    fd["max_abs_err"] = worst["flash_decode bfloat16"]
    log(f"  flash_decode bf16 cross ({SLOTS},{T},{H},{D}) G = 1: kernel_ms "
        f"{fd['ms']:.4f} plain_ms {fd['plain_ms']:.4f} library_ms "
        f"{fd['library_ms']:.4f} (SDPA, no mask) bound_ms "
        f"{fd['bound_ms']:.5f} ({fd['bound_by']}), {fd['splits']} splits")

    # -- the matmul at an encoder wave's and a decode step's shapes
    wave, step = encdec_matmuls(cfg)
    for dt in (bf, f32):
        for M, K, N in sorted(set(wave) | set(step)):
            a, b = rnd((M, K), dt), rnd((K, N), dt, 1 / math.sqrt(K))
            held("matmul", f"{M}x{K}x{N}", dt, mm_ops.matmul(a, b),
                 mm_ref.matmul(a, b))
            del a, b
    mm = {}
    for M, K, N in sorted(set(wave) | set(step)):
        n_sets = max(1, min(64, math.ceil(120e6 / (2 * K * N))))
        sets = [(rnd((M, K), bf), rnd((K, N), bf, 1 / math.sqrt(K)))
                for _ in range(n_sets)]
        p0 = plan_for(*sets[0])
        route = p0.route + (" staged" if any(p0.staged) else "")
        want = "mma staged" if N == cfg.vocab else "mma"
        if route != want:
            fail(f"matmul whisper {M}x{K}x{N}: route {route}, want {want}")
        plans = [plan_for(a, b) for a, b in sets]
        b_ms, by = bound(2 * (M * K + K * N + M * N), 2 * M * N * K,
                         H100_BF16)
        mm[(M, K, N)] = dict(
            route=route,
            ms=time_ms(torch, lambda i: launch(*sets[i], plans[i]), n_sets),
            plain_ms=time_ms(torch, lambda i: mm_ref.matmul(*sets[i]),
                             n_sets, 5),
            library_ms=time_ms(torch, lambda i: torch.matmul(*sets[i]),
                               n_sets),
            bound_ms=b_ms, bound_by=by)
        t = mm[(M, K, N)]
        log(f"  matmul bf16 {M}x{K}x{N} (whisper): route {route}, kernel_ms "
            f"{t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms "
            f"{t['library_ms']:.4f} bound_ms {b_ms:.4f} ({by})")
        del sets
    sums = {what: {key: sum(mm[s][key] * n for s, n in calls.items())
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            for what, calls in (("wave", wave), ("step", step))}
    log(f"phase 1 [encdec]: flash attention bidirectional at {len(cases)} "
        f"shapes, flash decode at G = 1 (cross {T} rows, self {self_len}), "
        f"the matmul at {len(mm)} (M, K, N) match their plain versions in "
        "bf16 and fp32; max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items()))
        + f"; an encoder wave's {sum(wave.values())} matmuls "
        f"{sums['wave']['ms']:.3f} ms (torch.matmul "
        f"{sums['wave']['library_ms']:.3f}, bound "
        f"{sums['wave']['bound_ms']:.3f}), a decode step's "
        f"{sum(step.values())} {sums['step']['ms']:.3f} ms (torch.matmul "
        f"{sums['step']['library_ms']:.3f}, bound "
        f"{sums['step']['bound_ms']:.3f})")
    return {"flash_attention": fa, "flash_decode": fd,
            "matmul": {f"{M}x{K}x{N}": t for (M, K, N), t in mm.items()},
            "matmul_wave": sums["wave"], "matmul_step": sums["step"]}


def encdec_lockstep(torch, cfg, params, name):
    """A graph engine and a ``cuda_graph=False`` engine, one seed, in
    lockstep over three waves (ENC_LOCKSTEP, wave-only): after every wave
    and step the same tokens, live logits and slab bit for bit (the self
    K/V and the cross K/V).  The graph engine's waves go through its
    prefill cache, one key for all three (eager, captured, replayed), its
    steps through its decode graph (eager, captured, replays across the
    waves, whose slab is copied into the captured addresses); the
    wrappers' counts of its eager and captured waves and steps equal the
    eager engine's, and a replay adds none."""
    import numpy as np

    from repro_torch.kernels import counts
    from repro_torch.models import api as mapi
    from repro_torch.serving import PartitionEngine, RequestQueue
    from repro_torch.serving.step_graph import WRAPPERS

    api = mapi.build(cfg, "cuda")
    lens, gens = ENC_LOCKSTEP
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, cfg.vocab, size=(n,)).astype(np.int32)
               for n in lens]
    engines = {}
    for mode in ("graph", "eager"):
        eng = PartitionEngine(cfg, api, params, slots=SLOTS,
                              max_len=max(lens) + max(gens), seed=3,
                              cuda_graph=mode == "graph")
        q = RequestQueue()
        for p, n in zip(prompts, gens):
            q.submit(p, n)
        eng.assign(q.pop(len(prompts)))
        engines[mode] = eng
    ge, ee = engines["graph"], engines["eager"]
    zero = tuple((0, {}) for _ in WRAPPERS)
    n_waves = n_steps = 0
    while ee.busy or ee.wants_prefill:
        wave = ee.wants_prefill
        seen = {}
        for mode, eng in engines.items():
            before = counts.snapshot(WRAPPERS)
            if wave:
                eng.prefill_wave(0.0)
            else:
                eng.decode_step(0.0)
            seen[mode] = counts.diff(counts.snapshot(WRAPPERS), before)
        where = f"wave {n_waves}" if wave else f"step {n_steps}"
        n = n_waves if wave else n_steps
        want = seen["eager"] if n < 2 else zero
        if [(c, {k: v for k, v in r.items() if v}) for c, r in
                seen["graph"]] != [(c, {k: v for k, v in r.items() if v})
                                   for c, r in want]:
            fail(f"encdec lockstep {name}: {where}: the graph engine's "
                 f"counts {seen['graph']}, want {want}")
        if ge.slot_tokens != ee.slot_tokens:
            fail(f"encdec lockstep {name}: tokens differ after {where}")
        for key in ("k", "v", "xk", "xv"):
            if not torch.equal(ge.cache[key].view(torch.uint8),
                               ee.cache[key].view(torch.uint8)):
                fail(f"encdec lockstep {name}: {key} differs after {where}")
        if wave:
            n_waves += 1
        else:
            if not np.array_equal(ge.last_logits, ee.last_logits):
                fail(f"encdec lockstep {name}: logits differ at {where}")
            n_steps += 1
    pg, gr = ge.prefill_graphs, ge.graph
    if n_waves != 3 or len(pg.uses) != 1 or (
            pg.n_eager, pg.n_captures, pg.n_replays) != (1, 1, 2) or \
            gr.n_eager != 1 or gr.n_replays != n_steps - 1:
        fail(f"encdec lockstep {name}: {n_waves} waves, prefill cache "
             f"{len(pg.uses)} keys, {pg.n_eager} eager, {pg.n_captures} "
             f"captures, {pg.n_replays} replays; decode {gr.n_eager} eager, "
             f"{gr.n_replays} replays of {n_steps} steps")
    log(f"  encdec graph lockstep {name}: {n_waves} waves (one prefill key: "
        f"eager, captured, replayed; capture {pg.capture_s:.3f} s) and "
        f"{n_steps} decode steps (1 eager + {gr.n_replays} replays, capture "
        f"{gr.capture_s:.3f} s) equal the eager engine bit for bit in "
        "tokens, logits, self K/V and cross K/V; the wrappers issued the "
        "eager and captured waves and steps as the eager engine did and "
        "nothing on a replay")


def phase_encdec_card_vs_cpu(torch):
    """Phase 2 for whisper-base: full width, ENC_CHECK_LAYERS encoder and
    decoder layers, fp32, the same weights on the card (kernels) and the
    CPU (plain versions), SLOTS x 1500 seeded frames: the teacher-forced
    ``forward_encdec`` over ENC_DEC_LEN tokens (causal self attention and
    bidirectional cross attention at Sq != Skv), the wave's cross K/V and
    ENC_STEPS greedy decode steps from token 1 within MODEL_TOL, the same
    argmax every step; then the graph lockstep at that size."""
    import numpy as np

    from repro_torch.models import api as mapi
    from repro_torch.models import encdec as ED

    cfg2 = family_cfg(ENCDEC_ARCH, dtype="float32",
                      n_layers=ENC_CHECK_LAYERS, enc_layers=ENC_CHECK_LAYERS)
    rng = np.random.default_rng(24)
    frames = rng.standard_normal((SLOTS, cfg2.enc_seq, cfg2.d_model),
                                 dtype=np.float32)
    tokens = rng.integers(1, cfg2.vocab, (SLOTS, ENC_DEC_LEN)).astype(
        np.int32)
    params = {"cuda": ED.init_encdec(cfg2, torch.Generator(
        device="cuda").manual_seed(2), "cuda")}
    params["cpu"] = tree_to(params["cuda"], "cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        api, p = mapi.build(cfg2, dev), params[dev]
        fr = torch.from_numpy(frames).to(dev)
        lf, _ = ED.forward_encdec(p, cfg2, {
            "enc_embeds": fr, "tokens": torch.from_numpy(tokens).to(dev)})
        _, cache = api.prefill(p, {"enc_embeds": fr},
                               max_len=ENC_STEPS + 1)
        rec = {"forward": [lf.cpu()], "cross K/V": [cache["xk"].cpu(),
                                                    cache["xv"].cpu()],
               "logits": []}
        tok = torch.ones((SLOTS, 1), dtype=torch.int32, device=dev)
        for _ in range(ENC_STEPS):
            lg, cache = api.decode(p, tok, cache)
            rec["logits"].append(lg[:, 0].cpu())
            tok = lg[:, 0].argmax(-1).to(torch.int32)[:, None]
        got[dev] = rec
        del cache
    errs = {}
    for what in ("forward", "cross K/V", "logits"):
        for i, (a, b) in enumerate(zip(got["cuda"][what], got["cpu"][what])):
            if what == "logits" and not torch.equal(a.argmax(-1),
                                                    b.argmax(-1)):
                fail(f"card vs CPU whisper: argmax differs at step {i}")
            errs[what] = max(errs.get(what, 0.0), check_close(
                torch, f"card vs CPU whisper {what} {i}", a, b, MODEL_TOL))
    log(f"phase 2: whisper-base at full width, {ENC_CHECK_LAYERS} + "
        f"{ENC_CHECK_LAYERS} layers, fp32, {SLOTS} x {cfg2.enc_seq} frames, "
        f"card vs CPU: the teacher-forced forward over {ENC_DEC_LEN} tokens, "
        f"the cross K/V and {ENC_STEPS} greedy decode steps agree (max abs "
        "err " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f", tolerance {MODEL_TOL}), identical argmax every step")
    cuda_params = params["cuda"]
    del params, got
    gc.collect()
    torch.cuda.empty_cache()
    encdec_lockstep(torch, cfg2, cuda_params, "whisper fp32 2+2 layers")


def encdec_measure(torch, engines, cfg):
    """After whisper's serve run, on its first engine: the replayed decode
    step's device ms (CUDA events over bare replays of its graph), the
    engine's own step's wall ms (median of STEP_CALLS) and the idle share;
    the step's bytes bound (the decoder's weights but the cross K and V
    projections, the tied head, the wave's cross K/V and the self K/V up
    to the step's position); the encoder wave's device ms (bare replays
    of the fleet's one captured prefill) beside its operations bound; the
    fleet's peak memory."""
    from repro_torch.profiling.decode_profile import replay_ms, timed

    eng = engines[0]
    dev = eng.device
    peak = torch.cuda.max_memory_allocated()
    device_ms = replay_ms(eng.graph.graph, dev)
    rows = int(eng.graph.buffers[1][0]) + 1     # the replay's position
    wall_ms = 1e3 * float(sorted(timed(eng._run_decode, dev, STEP_CALLS))[
        STEP_CALLS // 2])

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))
    p = eng.params
    cross = p["dec_blocks"]["cross_attn"]
    weights = nbytes({k: p[k] for k in ("dec_blocks", "ln_dec", "embed")}) \
        - nbytes({k: cross[k] for k in ("wk", "wv", "bk", "bv")})
    c = eng.cache
    self_kv = 2 * c["k"][:, :, :rows].numel() * c["k"].element_size()
    xkv = nbytes({k: c[k] for k in ("xk", "xv")})
    step_bytes = weights + xkv + self_kv
    (_, op), = eng.prefill_graphs._entries.items()
    wave_ms = replay_ms(op.graph, dev)
    M, d, f = SLOTS * cfg.enc_seq, cfg.d_model, cfg.d_ff
    hd = cfg.n_heads * cfg.head_dim
    wave_flops = cfg.enc_layers * (
        2 * M * (3 * d * hd + hd * d + 2 * d * f)
        + 4 * SLOTS * cfg.n_heads * cfg.head_dim * cfg.enc_seq ** 2) + \
        cfg.n_layers * 2 * M * 2 * d * hd
    wave_bound, wave_by = bound(nbytes(p["enc_blocks"]) + M * d * 4,
                                wave_flops, H100_BF16)
    return dict(device_ms=device_ms, wall_ms=wall_ms,
                idle=1 - device_ms / wall_ms,
                bound_ms=step_bytes / H100_BW * 1e3, step_gb=step_bytes / 1e9,
                weight_gb=weights / 1e9, xkv_gb=xkv / 1e9,
                wave_ms=wave_ms, wave_bound_ms=wave_bound, wave_by=wave_by,
                wave_gflop=wave_flops / 1e9, peak_gb=peak / 1e9)


def phase_encdec_serve(torch, wrappers):
    """Phase 3 for whisper-base: ``serve.main`` at full width and depth (6
    + 6 layers), bf16, phase 3's load (8 requests, prompt 32, 16 tokens, 2
    partitions x 4 slots, stagger demand) with ``serve_run``'s gates (each
    engine's wave through the fleet's one prefill key: eager, then
    captured); it must launch the matmul, flash attention and flash decode
    and no paged kernel, with every matmul on the tensor cores, the 4
    issued LM heads (51,865 columns) staged.  Logs the replayed
    step and the encoder wave beside their bounds, the idle share and the
    peak memory (``encdec_measure``); then the graph lockstep at full
    width and depth in bf16."""
    from repro_torch.models import encdec as ED

    cfg = family_cfg(ENCDEC_ARCH)
    argv = ["--arch", ENCDEC_ARCH] + SERVE_ARGS[2:]
    measured = {}
    gc.collect()
    torch.cuda.empty_cache()
    run = serve_run(torch, cfg, wrappers, ENCDEC_ARCH, argv,
                    flag(argv, "--requests"), flag(argv, "--gen"),
                    after=lambda engines: measured.update(
                        encdec_measure(torch, engines, cfg)))
    for k, n in run["launches"].items():
        if (n == 0) == (k in ("matmul", "flash_attention", "flash_decode")):
            fail(f"serve {ENCDEC_ARCH}: kernel {k} launched {n} times")
    routes = run["routes"]
    if routes["tiled"] or routes["skinny"] or run["staged"] != 4:
        fail(f"serve {ENCDEC_ARCH}: matmul routes {routes}, {run['staged']} "
             "staged (want every matmul on mm_mma, the 4 issued heads "
             "staged)")
    m = measured
    log(f"phase 3 [{ENCDEC_ARCH}]: {cfg.name} d={cfg.d_model} "
        f"layers={cfg.enc_layers}+{cfg.n_layers}: replayed decode step "
        f"{m['device_ms']:.3f} ms device, {m['wall_ms']:.3f} ms wall, idle "
        f"share {m['idle']:.3f}; bytes bound {m['bound_ms']:.4f} ms "
        f"({m['step_gb']:.4f} GB: {m['weight_gb']:.4f} of weights, the tied "
        f"head included, {m['xkv_gb']:.4f} of cross K/V); encoder wave "
        f"({SLOTS} x {cfg.enc_seq} frames, replayed) {m['wave_ms']:.3f} ms "
        f"device, bound {m['wave_bound_ms']:.4f} ms ({m['wave_gflop']:.1f} "
        f"GFLOP, {m['wave_by']}); peak memory {m['peak_gb']:.2f} GB")
    run.update(step=m)
    params = ED.init_encdec(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    encdec_lockstep(torch, cfg, params, "whisper-base full width bf16")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {ENCDEC_ARCH: run}


def phase_encdec(torch) -> dict:
    """``--only encdec``: the thirteenth slice's phase 1, 2 and 3 checks
    alone."""
    stats = phase_encdec_kernels(torch)
    phase_encdec_card_vs_cpu(torch)
    phase_encdec_serve(torch, serving_wrappers())
    return stats


# ---------------------------------------------------------------------------
# phase 4: the cluster on the card
# ---------------------------------------------------------------------------


def pd_oracle(torch, cfg, api, params, name, pg, **kw):
    """4a: prefill a wave on engine A, hand each request to engine B over
    the wire (``export_handoff``, the codec both ways, ``apply_handoff``),
    and run B beside an oracle C that prefilled the same wave and never
    migrated it.  A, B and C are graph engines on one ``PrefillGraphs``;
    B and C are also given the load's next SLOTS requests, which they
    refill into the slots the migrated ones free (so B's and C's refills
    replay).  After the import and after every decode step B's tokens,
    live slots' logits and KV state must equal C's bit for bit.  Returns
    the wrappers' launches while B decoded and refilled (counted around
    B's steps alone) and the handoff's bytes per request."""
    import numpy as np

    from repro_torch.kernels import counts
    from repro_torch.serving import PartitionEngine, RequestQueue
    from repro_torch.serving.cluster import protocol as P
    from repro_torch.serving.pd import apply_handoff, export_handoff
    from repro_torch.serving.step_graph import WRAPPERS

    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, cfg.vocab, size=(PROMPT,)).astype(np.int32)
               for _ in range(2 * SLOTS)]
    max_len = (cfg.n_meta_tokens or 0) + PROMPT + 4 * GEN
    engines = []
    for pid, load in enumerate((prompts[:SLOTS], prompts, prompts)):
        eng = PartitionEngine(cfg, api, params, slots=SLOTS, max_len=max_len,
                              pid=pid, prefill_graphs=pg, **kw)
        q = RequestQueue()
        for p in load:
            q.submit(p, GEN)
        eng.assign(q.pop(len(load)))
        engines.append(eng)
    a, b, c = engines
    a.prefill_wave(0.0)
    c.prefill_wave(0.0)
    b.backlog = b.backlog[SLOTS:]     # B's wave arrives over the wire
    t0 = time.perf_counter()
    nbytes = []
    for req in [r for r in a.active if r is not None]:
        h = export_handoff(a, req.rid)
        wire = P.encode(P.ImportKv(handoff=h))
        nbytes.append(sum(len(pa.data) for pa in h.pages))
        apply_handoff(b, P.decode(wire).handoff)
    torch.cuda.synchronize()
    handoff_s = time.perf_counter() - t0

    def seen(eng):
        """(rid, tokens) of each slot, then of each completed request."""
        return [r and (r.rid, r.tokens) for r in eng.active] + \
            sorted((r.rid, r.tokens) for r in eng.completed)

    def same(where):
        if seen(b) != seen(c):
            fail(f"pd oracle {name}: tokens or occupancy differ {where}")
        x, y = live_state(torch, b), live_state(torch, c)
        bad = [k for k in y if not torch.equal(x[k], y[k])]
        if bad:
            fail(f"pd oracle {name}: KV state {bad} differs {where}")

    same("after the import")
    # each engine's own launches: B's is what the import must lead to
    launches = {e: dict.fromkeys((w.__name__ for w in WRAPPERS), 0)
                for e in "bc"}
    steps = 0
    while c.busy:
        live = [i for i, r in enumerate(c.active) if r is not None]
        for e, eng in zip("bc", (b, c)):
            before = counts.snapshot(WRAPPERS)
            eng.decode_step(0.0)
            for w, (n, _) in zip(WRAPPERS, counts.diff(
                    counts.snapshot(WRAPPERS), before)):
                launches[e][w.__name__] += n
        steps += 1
        if not np.array_equal(b.last_logits[live], c.last_logits[live]):
            fail(f"pd oracle {name}: step {steps} logits differ")
        same(f"after step {steps}")
    if b.busy or len(b.completed) != 2 * SLOTS or b.n_refills != SLOTS or \
            b.graph.n_replays == 0:
        fail(f"pd oracle {name}: B completed {len(b.completed)}, refills "
             f"{b.n_refills}, replays {b.graph.n_replays}")
    log(f"phase 4a [{name}]: {SLOTS} requests prefilled on A, handed to B "
        f"over the wire ({min(nbytes)}-{max(nbytes)} bytes of pages each, "
        f"{handoff_s * 1e3:.1f} ms for the {SLOTS} exports, codec and "
        f"imports), then {SLOTS} refills: B's tokens, live logits and KV "
        f"state equal the never-migrated C's bit for bit over {steps} steps "
        f"(B: {b.graph.n_eager} eager steps, {b.graph.n_replays} replays; "
        f"prefills {pg.n_eager} eager, {pg.n_captures} captured, "
        f"{pg.n_replays} replayed); launches while B decoded and refilled "
        f"{launches['b']}, while C did {launches['c']}")
    return launches["b"], nbytes


def in_process_fleet(torch, cfg, api, params, specs, n_req, seed):
    """The in-process ``EventScheduler`` fleet (policy 'none') of the
    engines ``specs`` describe, on ``run_cluster``'s load and pipe, over
    one set of weights (the workers' seed): (queue, metrics, wall s)."""
    import numpy as np

    from repro_torch.profiling import make_cost_model
    from repro_torch.serving import (EventScheduler, PartitionEngine,
                                     PrefillGraphs, RequestQueue)
    from repro_torch.serving.trace_sim import phase_balanced_bandwidth

    pg = PrefillGraphs(api)
    engines = [PartitionEngine(
        cfg, api, params, paged=s.paged, slots=s.slots, max_len=s.max_len,
        pid=s.wid, peak_flops=s.peak_flops, wave_only=s.wave_only,
        block_size=s.block_size, prefix_cache=s.prefix_cache,
        kv_dtype=s.kv_dtype, sparse_threshold=s.sparse_threshold,
        cost_model=make_cost_model(s.cost_model, cfg, s.peak_flops,
                                   kv_dtype=s.kv_dtype),
        prefill_graphs=pg) for s in specs]
    q = RequestQueue()
    rng = np.random.default_rng(seed)
    for _ in range(n_req):
        q.submit(rng.integers(1, cfg.vocab, size=(PROMPT,)).astype(np.int32),
                 GEN, arrival=0.0)
    bw = phase_balanced_bandwidth(cfg, total_slots=len(specs) * SLOTS,
                                  prompt_len=PROMPT, gen=GEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = EventScheduler(engines, q, policy="none", bandwidth=bw).run()
    torch.cuda.synchronize()
    return q, m, time.perf_counter() - t0


def launches_of(report: dict) -> dict:
    """A worker's kernel launch counts from its metrics snapshot."""
    return {k.split(".")[1]: int(v) for k, v in report.items()
            if k.startswith("kernel.")}


def cluster_run(name, **kw):
    """One ``run_cluster`` over real worker processes on the card (the
    cluster CLI's entry point), timed on the wall clock, with each
    worker's boot seconds, peak memory and launch counts read back from
    its last status snapshot."""
    from repro_torch.launch.cluster import run_cluster

    t0 = time.perf_counter()
    ctl, m = run_cluster(arch="qwen2-7b", smoke=False, workers=2,
                         slots=SLOTS, prompt_len=PROMPT, gen=GEN,
                         n_requests=CLUSTER_REQUESTS, transport="mp",
                         simulated=False, heartbeat_timeout=HEARTBEAT_S,
                         seed=0, device="cuda", **kw)
    wall = time.perf_counter() - t0
    # each worker's last metrics snapshot, by wid
    report = {w: dict(v.status.metrics) for w, v in sorted(ctl.views.items())}
    tokens = sum(len(r.tokens) for r in ctl.queue.completed)
    boot = max(r["worker.boot_seconds"] for r in report.values())
    for w, r in report.items():
        kernels = {k: n for k, n in launches_of(r).items() if n}
        log(f"phase 4 [{name}] worker {w}: boot {r['worker.boot_seconds']:.2f}"
            f" s from process start to Hello: {r['worker.start_seconds']:.2f}"
            f" s to worker_main (the interpreter, the spawn's imports), "
            f"{r['worker.context_seconds']:.2f} s the CUDA context, "
            f"{r['worker.build_seconds']:.2f} s the engine build; peak memory "
            f"{r['worker.peak_memory_bytes'] / 1e9:.2f} GB, "
            f"{int(r['engine.prefills'])} waves, {int(r['engine.refills'])} "
            f"refills, {int(r['engine.decode_steps'])} decode steps, "
            f"{int(r['engine.exports'])} exports, {int(r['engine.imports'])} "
            f"imports; launches {kernels}")
    log(f"phase 4 [{name}]: {len(ctl.queue.completed)}/{CLUSTER_REQUESTS} "
        f"requests, {tokens} tokens in {wall:.2f} s wall from spawn to "
        f"shutdown ({tokens / wall:.2f} generated tokens per wall second); "
        f"the controller's run after the handshake, shutdown included, "
        f"{m.wall_seconds:.2f} s ({tokens / m.wall_seconds:.2f}); slower "
        f"boot {boot:.2f} s")
    if len(ctl.queue.completed) != CLUSTER_REQUESTS or \
            tokens != CLUSTER_REQUESTS * GEN or ctl.n_failovers:
        fail(f"cluster {name}: {len(ctl.queue.completed)} requests, {tokens} "
             f"tokens, {ctl.n_failovers} failovers")
    return ctl, m, report


def phase_cluster(torch, cfg):
    """Phase 4, the cluster on the card, at full-width bf16 qwen2-7b:
    4a the migrated-decode oracle on graph engines in paged float, int8
    and dense; 4b two real workers over ``--transport mp`` against the
    in-process fleet; 4c PD with tracing.  Returns the runs' launch
    counts for the kernels JSON."""
    import numpy as np

    from repro_torch.models import api as mapi
    from repro_torch.obs import trace_bw_segments, validate_chrome
    from repro_torch.serving import PrefillGraphs, make_worker_specs

    runs = {}
    api = mapi.build(cfg, "cuda")
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    carries = {"paged": ({}, "paged_decode"),
               "int8": (dict(kv_dtype="int8"), "paged_decode_quant"),
               "dense": (dict(paged=False), "flash_decode")}
    handoff_bytes = {}
    for name, (kw, kernel) in carries.items():
        launches, nbytes = pd_oracle(torch, cfg, api, params, name,
                                     PrefillGraphs(api), **kw)
        if launches[kernel] == 0 or launches["matmul"] == 0:
            fail(f"pd oracle {name}: {kernel} or matmul never launched on B "
                 f"after the import ({launches})")
        runs[f"cluster 4a {name}"] = {"launches": launches}
        handoff_bytes[name] = nbytes
        gc.collect()

    # 4b: the process boundary against the in-process fleet
    specs = make_worker_specs("qwen2-7b", 2, smoke=False, slots=SLOTS,
                              max_len=PROMPT + 4 * GEN, engine="real",
                              seed=0, device="cuda")
    q_ref, m_ref, ref_wall = in_process_fleet(torch, cfg, api, params, specs,
                                              CLUSTER_REQUESTS, seed=0)
    tokens = sum(len(r.tokens) for r in q_ref.completed)
    log(f"phase 4b: in-process fleet (2 x {SLOTS} slots, policy none): "
        f"{len(q_ref.completed)} requests, {tokens} tokens in "
        f"{ref_wall:.2f} s wall ({tokens / ref_wall:.2f} generated tokens "
        "per wall second)")
    del api, params
    gc.collect()
    torch.cuda.empty_cache()
    ctl, m, report = cluster_run("4b mp round_robin", router="round_robin")

    def stamps(q):
        return sorted((r.rid, tuple(r.tokens), r.t_first_token, r.t_done)
                      for r in q.completed)

    def no_wall(m):
        return {k: v for k, v in m.summary().items() if "wall" not in k}

    if stamps(ctl.queue) != stamps(q_ref):
        fail("cluster 4b: request stamps or tokens differ from the "
             "in-process fleet's")
    if no_wall(m) != no_wall(m_ref):
        fail(f"cluster 4b: summary {no_wall(m)} != in-process "
             f"{no_wall(m_ref)}")
    for w, r in report.items():
        got = launches_of(r)
        if not all(got[k] for k in ("matmul", "flash_attention",
                                    "paged_decode")):
            fail(f"cluster 4b worker {w}: launches {got}")
        runs[f"cluster 4b worker {w}"] = {"launches": got}
    log("phase 4b: the mp cluster's request stamps, generated tokens and "
        "summary (wall time aside) equal the in-process fleet's")

    # 4c: PD with tracing
    path = ROOT / "build" / "cluster_pd_trace.json"
    path.parent.mkdir(exist_ok=True)
    ctl, m, report = cluster_run("4c mp pd 1:1 traced", router="pd",
                                 pd_split=(1, 1), trace=str(path))
    pools = ctl.router.pool_of
    for w, r in report.items():
        got = launches_of(r)
        runs[f"cluster 4c {pools[w]} worker {w}"] = {"launches": got}
        if pools[w] == "prefill":
            bad = r["engine.decode_steps"] or not r["engine.exports"] or \
                got["paged_decode"] or not got["flash_attention"]
        else:
            bad = r["engine.prefills"] or r["engine.refills"] or \
                not r["engine.imports"] or got["flash_attention"] or \
                not got["paged_decode"]
        if bad:
            fail(f"cluster 4c: the {pools[w]} worker {w} left its phase: "
                 f"{r}")
    doc = json.loads(path.read_text())
    errs = validate_chrome(doc)
    flows = [[e for e in doc["traceEvents"]
              if e["ph"] == ph and e["name"] == "kv_handoff"]
             for ph in ("s", "f")]
    segs = trace_bw_segments(doc)
    w = np.array([b - a for a, b, _ in segs])
    v = np.array([val for _, _, val in segs])
    mean = float(np.average(v, weights=w))
    std = float(np.sqrt(np.average((v - mean) ** 2, weights=w)))
    m_mean, m_std = m.bw_stats(0.0)
    if errs or len(flows[0]) != ctl.router.n_handoffs or \
            len(flows[1]) != len(flows[0]) or \
            ctl.router.n_handoffs != CLUSTER_REQUESTS or \
            abs(mean - m_mean) > 1e-9 * abs(m_mean) or \
            abs(std - m_std) > 1e-9 * abs(m_std):
        fail(f"cluster 4c trace: {len(errs)} schema errors {errs[:3]}, "
             f"{len(flows[0])} / {len(flows[1])} kv_handoff flow starts / "
             f"ends for {ctl.router.n_handoffs} handoffs, bw mean {mean!r} "
             f"vs {m_mean!r}, std {std!r} vs {m_std!r}")
    log(f"phase 4c: pools pure, {ctl.router.n_handoffs} handoffs "
        f"({ctl.router.n_deferrals} deferrals), trace of "
        f"{len(doc['traceEvents'])} events valid with one kv_handoff flow "
        f"per handoff; its bw integral {mean!r} / {std!r} equals bw_stats "
        f"{m_mean!r} / {m_std!r} to 1e-9; handoff page bytes per request "
        + ", ".join(f"{k} {min(b)}-{max(b)}" for k, b in
                    handoff_bytes.items()))
    return runs


# ---------------------------------------------------------------------------
# the fourteenth slice: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen2-7b"
TRAIN_SEQ = 4096            # the reference's train_4k length
TRAIN_BATCH = 2             # of train_4k's 256 (one card)
TRAIN_ACCUM = 2             # two microbatches of 1 x 4096 a step
TRAIN_LAYERS = 8            # of 28: full depth is 91 GB of weights, grads
TRAIN_STEPS = 4             # and moments, more than one 80 GB card
TRAIN_RESUME = 2
# The card's machine takes at most 45 GiB of disk writes a call, and a
# checkpoint at 8 layers is 35 GB (f32 params, m and v: 12 bytes a
# parameter), so the CLI's runs, which save at their end, run at
# CLI_LAYERS (15.9 GB a checkpoint, the 1.09 B of the embedding and head
# being most of it; two of them) and the 8-layer steps through
# make_train_step, the step the CLI runs
CLI_LAYERS = 1
PART_LAYERS = 2             # the partitioned run: two replicas of 2 layers,
PART_STEPS = 4              # no checkpoint (--ckpt-every 0)
PART_ARGS = ["--partitions", "2", "--sync-every", "2", "--fail-at", "3:1",
             "--ckpt-every", "0"]
TRAIN_CHECK_LAYERS = 2      # phase 2: fp32 card against CPU
TRAIN_CHECK_SHAPE = (2, 128)   # (batch, seq) of phase 2's batches
LOSS_CHUNK = 256            # models/transformer.loss_fn's default
# phase 2 holds the update where |m| > UPDATE_MASK x the RMS of m's nonzero
# entries (at 1 % of the RMS over all of the embedding's entries, mostly
# zero rows, one near-zero update on the card missed by 3.69x: PERF.md)
UPDATE_MASK = 0.1
# the backward's tile edges (64-row query tiles, 64-key tiles): ragged Sq
# and Skv on both sides of a tile, Sq != Skv both ways; a window only where
# every query row sees a key (Sq <= Skv: a row past Skv + window - 1 sees
# none, and the kernels leave it out).  A single query row only
# bidirectional (BWD_ONE_ROW): causal, it sees one key, and its dQ and its
# key's dK are 0 in exact arithmetic, rounding noise that no bound relative
# to the output holds
BWD_GROUPS = (1, 7, 16)
BWD_LENGTHS = ((9, 9), (63, 63), (65, 65), (100, 100), (65, 100),
               (130, 33), (33, 130))
BWD_ONE_ROW = (1, 65)
BWD_WINDOWS = (0, 16)
BWD_DIMS = (16, 64, 128)


def check_rms(torch, name, got, want, tol, failures=None):
    """|got - want| <= tol * (rms(want) + |want|), the absolute term scaled
    by the output's RMS; returns the largest absolute error.  With a
    ``failures`` list a miss is recorded there (name, fraction of the
    bound, max abs err) instead of failing at once."""
    w = want.float()
    err = (got.float() - w).abs()
    rms = float(w.pow(2).mean().sqrt())
    ratio = float((err / (tol * (rms + w.abs()))).max())
    if not torch.isfinite(got.float()).all() or ratio > 1:
        msg = (f"{name}: kernel disagrees with its plain version (max abs "
               f"err {float(err.max()):.3g}, rms {rms:.3g}, {ratio:.3g} x the "
               f"limit {tol} * (rms + |want|))")
        if failures is None:
            fail(msg)
        failures.append((name, ratio, float(err.max())))
    return float(err.max())


def train_wrappers():
    """The wrappers of the training path, by kernel name."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops

    return {"matmul": mm_ops.matmul, "flash_attention": fa_ops.flash_attention,
            "flash_attention_backward": fa_ops.flash_attention_backward}


def zero_counts(torch):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops

    for w in train_wrappers().values():
        w.launches = 0
    mm_ops.matmul.routes.update(dict.fromkeys(mm_ops.matmul.routes, 0))
    mm_ops.matmul.staged = 0
    kernels = fa_ops.flash_attention_backward.kernels
    kernels.update(dict.fromkeys(kernels, 0))


def read_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops

    return dict(launches={k: w.launches for k, w in
                          train_wrappers().items()},
                routes=dict(mm_ops.matmul.routes),
                staged=mm_ops.matmul.staged,
                bwd_kernels=dict(fa_ops.flash_attention_backward.kernels))


def train_rnd(torch, seed):
    """``rnd(shape, dtype)``: standard normal draws on the card from one
    seeded generator, cast to ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    return rnd


def bwd_case(torch, rnd, tag, dt, shape, failures):
    """Flash attention's forward with LSE and its backward at ``shape`` =
    (B, Sq, Skv, Hq, Hkv, D, causal, window) in ``dt`` against their plain
    versions: the output by phase 1's rule, the LSE, dQ, dK and dV within
    tol x (rms + |want|) of the f32 plain backward (a miss recorded in
    ``failures``); a second launch bit for bit.  Returns each output's
    max abs error."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, Sq, Skv, hq, hkv, D, causal, w = shape
    q, k, v = (rnd((B, Sq, hq, D), dt), rnd((B, Skv, hkv, D), dt),
               rnd((B, Skv, hkv, D), dt))
    do = rnd((B, Sq, hq, D), dt)
    tol = TOL[str(dt).split(".")[1]]
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=w,
                                     lse=True)
    po, plse = fa_ref.attention_lse(q, k, v, causal=causal, window=w)
    name = f"flash_attention backward {tag} {dt}"
    # the forward's output by its own phase-1 rule (tol + tol |want|: it
    # rounds the unnormalized weights to bf16, the plain version the
    # normalized ones), the rest scaled by each output's RMS
    errs = {"out": check_close(torch, name + " out", o, po, tol),
            "lse": check_rms(torch, name + " lse", lse, plse, tol, failures)}
    del po, plse
    got = fa.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                      window=w)
    # the plain backward in f32 on the same (bf16) inputs: run in bf16 it
    # rounds P before P V and dP at the cast's backward, and at 4096 rows
    # those roundings alone reach 1.5x the bound on dV (PERF.md)
    want = fa_ref.attention_backward(
        *(t.float() for t in (q, k, v, do)), causal=causal, window=w)
    for n_, a, b in zip(("dq", "dk", "dv"), got, want):
        errs[n_] = check_rms(torch, f"{name} {n_}", a, b, tol, failures)
    twice = fa.flash_attention_bwd_cuda(q, k, v, lse, do, causal=causal,
                                        window=w)
    if not all(torch.equal(a, b) for a, b in zip(got, twice)):
        fail(f"{name}: two launches on the same inputs differ")
    if tag == "train":    # for the record: the plain version in bf16
        plain16 = fa_ref.attention_backward(q, k, v, do, causal=causal,
                                            window=w)
        errs["vs_bf16_plain"] = {}
        for n_, a, b in zip(("dq", "dk", "dv"), got, plain16):
            bf = b.float()
            rms = float(bf.pow(2).mean().sqrt())
            errs["vs_bf16_plain"][n_] = float(
                ((a.float() - bf).abs() / (tol * (rms + bf.abs()))).max())
    del q, k, v, do, o, lse, got, want, twice
    torch.cuda.empty_cache()
    return errs


def bwd_timed(torch, rnd, tag, shape):
    """The backward in bf16 at ``shape`` (as ``bwd_case``), its 3 launches
    together and each alone, beside its plain version (autograd through
    ref.attention, the forward included), SDPA's forward + backward with
    K/V expanded to the query heads (a window as a boolean mask) and its
    bound; at the training shape also the forward with LSE."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, Sq, Skv, hq, hkv, D, causal, w = shape
    q, k, v, do = (rnd((B, Sq, hq, D), torch.bfloat16),
                   rnd((B, Skv, hkv, D), torch.bfloat16),
                   rnd((B, Skv, hkv, D), torch.bfloat16),
                   rnd((B, Sq, hq, D), torch.bfloat16))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=causal, window=w,
                                     lse=True)
    t_bwd = time_ms(torch, lambda i: fa.flash_attention_bwd_cuda(
        q, k, v, lse, do, causal=causal, window=w), 1, 10)
    _, launches = fa.flash_attention_bwd_launches(q, k, v, lse, do,
                                                  causal=causal, window=w)
    # in launch order: each kernel's inputs are written by the one before
    # (time_ms runs each once before it times it)
    per = {name: time_ms(torch, lambda i, run=run: run(), 1, 10)
           for name, run in launches.items()}
    t_plain = time_ms(torch, lambda i: fa_ref.attention_backward(
        q, k, v, do, causal=causal, window=w), 1, 3)
    G = hq // hkv
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    dot = do.transpose(1, 2).contiguous()
    mask = None
    if w:
        pos_q = torch.arange(Sq, device="cuda")[:, None]
        pos_k = torch.arange(Skv, device="cuda")[None, :]
        mask = (pos_q >= pos_k) & (pos_q - pos_k < w)

    def library(i, masked=True):
        with torch.enable_grad():
            out = (sdpa(qt, kt, vt, attn_mask=mask) if w and masked else
                   sdpa(qt, kt, vt, is_causal=causal))
            return torch.autograd.grad(out, (qt, kt, vt), dot)

    t_lib = time_ms(torch, library, 1, 10)
    # a boolean mask takes SDPA off its flash backend: its causal call, more
    # work but the fastest single library call at the shape, is timed too
    t_lib_causal = time_ms(torch, lambda i: library(i, False), 1, 10) \
        if w else None
    if causal and Sq == Skv:      # the (query, key) pairs each query sees
        n = min(w, Sq) if w else Sq
        pairs = n * (n + 1) / 2 + (Sq - n) * n
    else:
        pairs = Sq * Skv
    fwd_flops = 4 * B * hq * D * pairs
    b_ms, by = bound(2 * (3 * q.numel() + 4 * k.numel())
                     + 4 * lse.numel(), 2.5 * fwd_flops, H100_BF16)
    mode = "bidirectional" if not causal else (
        f"causal, window {w}" if w else "causal")
    r = dict(shape=f"q ({B},{Sq},{hq},{D}), k/v ({B},{Skv},{hkv},{D}), "
                   f"{mode}, bf16",
             ms=t_bwd, kernel_ms=per, plain_ms=t_plain, library_ms=t_lib,
             bound_ms=b_ms, bound_by=by,
             tflops=2.5 * fwd_flops / t_bwd / 1e9)
    masked = ""
    if w:
        r["library_causal_ms"] = t_lib_causal
        masked = (f"; a boolean window mask, off SDPA's flash backend: its "
                  f"causal call without the window {t_lib_causal:.4f}")
    by_kernel = ", ".join(f"{n} {t:.4f}" for n, t in per.items())
    log(f"  flash_attention backward {tag} {r['shape']}: kernel_ms "
        f"{t_bwd:.4f} ({r['tflops']:.1f} TFLOP/s at 2.5x the forward's "
        f"FLOPs; by kernel {by_kernel}) plain_ms {t_plain:.4f} "
        f"library_ms {t_lib:.4f} (SDPA forward + backward, K/V "
        f"expanded{masked}) bound_ms {b_ms:.4f} ({by})")
    if tag == "train":
        t_fwd = time_ms(torch, lambda i: fa.flash_attention_cuda(
            q, k, v, causal=causal, lse=True), 1, 10)
        f_ms, fby = bound(2 * (2 * q.numel() + 2 * k.numel())
                          + 4 * lse.numel(), fwd_flops, H100_BF16)
        log(f"  the forward with LSE {t_fwd:.4f} ms (bound {f_ms:.4f}, "
            f"{fby})")
        r.update(forward_lse_ms=t_fwd, forward_lse_bound_ms=f_ms)
    del q, k, v, do, o, lse, qt, kt, vt, dot, mask
    torch.cuda.empty_cache()
    return r


def phase_train_kernels(torch, cfg):
    """Phase 1 [train]: the forward's log-sum-exp and the three backward
    kernels against their plain versions on the card (autograd through
    ``ref.attention``), at qwen2-7b's training shape (q (1, 4096, 28, 128),
    k / v (1, 4096, 4, 128), bf16, causal), over the backward's tile edges
    (BWD_*: G, ragged and unequal Sq / Skv, window, D; causal in both
    dtypes, bidirectional too), at whisper's encoder (4, 1500, 8, 64)
    bidirectional and its cross attention (32 rows over 1500 frames), bf16
    and fp32; then the matmul's training products (every projection's
    forward at M = 4096 tokens and its two backward products, the loss
    chunk's head product and its two) against ``ref.matmul``.  Each is
    timed beside its plain version, the library's call and its bound: the
    backward at the training shape and at whisper's two, its three kernels
    together and each alone."""
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref

    t0 = time.perf_counter()
    rnd = train_rnd(torch, 14)

    failures = []
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    main = (1, TRAIN_SEQ, TRAIN_SEQ, Hq, Hkv, hd, True, 0)
    main_err = bwd_case(torch, rnd, "train", torch.bfloat16, main, failures)
    log(f"phase 1 [train]: flash attention's forward with LSE and backward "
        f"at q (1,{TRAIN_SEQ},{Hq},{hd}) bf16 causal: max abs err {main_err}")
    worst = {}
    shapes = [("train f32", torch.float32, (1, 512, 512, Hq, Hkv, hd, True,
                                            0)),
              ("encoder", torch.bfloat16, (4, 1500, 1500, 8, 8, 64, False, 0)),
              ("encoder", torch.float32, (4, 1500, 1500, 8, 8, 64, False, 0)),
              ("cross", torch.bfloat16, (4, 32, 1500, 8, 8, 64, False, 0)),
              ("cross", torch.float32, (4, 32, 1500, 8, 8, 64, False, 0))]
    for G in BWD_GROUPS:
        for Sq, Skv in BWD_LENGTHS:
            for D in BWD_DIMS:
                for w in BWD_WINDOWS:
                    if w and Sq > Skv:
                        continue
                    for dt in (torch.bfloat16, torch.float32):
                        shapes.append((f"G={G} Sq={Sq} Skv={Skv} D={D} w={w}",
                                       dt, (2, Sq, Skv, 2 * G, 2, D, True, w)))
                shapes.append((f"G={G} Sq={Sq} Skv={Skv} D={D} bidir",
                               torch.bfloat16,
                               (2, Sq, Skv, 2 * G, 2, D, False, 0)))
        for D in BWD_DIMS:
            for dt in (torch.bfloat16, torch.float32):
                Sq, Skv = BWD_ONE_ROW
                shapes.append((f"G={G} Sq={Sq} Skv={Skv} D={D} bidir", dt,
                               (2, Sq, Skv, 2 * G, 2, D, False, 0)))
    for tag, dt, shape in shapes:
        errs = bwd_case(torch, rnd, tag, dt, shape, failures)
        key = str(dt).split(".")[1]
        for k_, e in errs.items():
            if k_ != "vs_bf16_plain":
                worst[f"{key} {k_}"] = max(worst.get(f"{key} {k_}", 0.0), e)
    if failures:
        worst_first = sorted(failures, key=lambda f: -f[1])
        fail(f"phase 1 [train]: {len(failures)} outputs outside their bound "
             f"(name, fraction of the bound, max abs err), worst first: "
             f"{worst_first[:40]}")
    log(f"phase 1 [train]: LSE, dQ, dK, dV match their plain versions at "
        f"{len(shapes) + 1} shapes (encoder, cross, {len(shapes) - 5} tile "
        f"edges, both dtypes), each bit for bit on a second launch; worst "
        f"max abs errors {worst}")

    # timings: the backward beside its plain version and SDPA's forward +
    # backward at the training shape and at whisper's encoder and cross
    # attention (bidirectional)
    bwd_stats = bwd_timed(torch, rnd, "train", main)
    bwd_stats.update(
        max_abs_err=max(main_err[k] for k in ("dq", "dk", "dv")),
        errs=main_err, worst=worst, shapes=len(shapes) + 1,
        whisper={tag: bwd_timed(torch, rnd, tag, shape) for tag, shape in (
            ("encoder", (4, 1500, 1500, 8, 8, 64, False, 0)),
            ("cross", (4, 32, 1500, 8, 8, 64, False, 0)))})

    # the matmul's training products at M = 4096 tokens (a microbatch)
    d, kv, ff, V = cfg.d_model, Hkv * hd, cfg.d_ff, cfg.vocab
    M = TRAIN_SEQ
    projs = [("wq", d, Hq * hd), ("wk", d, kv), ("wv", d, kv),
             ("wo", Hq * hd, d), ("w1", d, ff), ("w3", d, ff), ("w2", ff, d)]
    rows = {}
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    mm_worst = 0.0
    # units a step: a layer's product per microbatch, or a loss chunk's
    units = {"layer": TRAIN_LAYERS * TRAIN_ACCUM,
             "head": TRAIN_SEQ // LOSS_CHUNK * TRAIN_ACCUM}
    for name, K, N, m_rows, per in (
            [(n, K, N, M, units["layer"]) for n, K, N in projs]
            + [("head", d, V, LOSS_CHUNK, units["head"])]):
        a, b, dc = (rnd((m_rows, K), torch.bfloat16),
                    rnd((K, N), torch.bfloat16),
                    rnd((m_rows, N), torch.bfloat16))
        bt, at = b.t().contiguous(), a.t().contiguous()
        calls = {"forward": (a, b), "dA = dC B^T": (dc, bt),
                 "dB = A^T dC": (at, dc)}
        for kind, (x, y) in calls.items():
            err = check_rms(torch, f"matmul train {name} {kind}",
                            mm_ops.matmul(x, y), mm_ref.matmul(x, y),
                            TOL["bfloat16"])
            mm_worst = max(mm_worst, err)
            t_k = time_ms(torch, lambda i: mm_ops.matmul(x, y), 1, 10)
            t_p = time_ms(torch, lambda i: mm_ref.matmul(x, y), 1, 3)
            t_l = time_ms(torch, lambda i: torch.matmul(x, y), 1, 10)
            Mx, Kx = x.shape
            Nx = y.shape[1]
            b_ms, _ = bound(2 * (Mx * Kx + Kx * Nx + Mx * Nx),
                            2 * Mx * Kx * Nx, H100_BF16)
            # a step issues each forward twice (remat), each backward once
            n = per * (2 if kind == "forward" else 1)
            rows[f"{name} {kind} ({Mx},{Kx},{Nx})"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                calls_per_step=n, route=mm_ops.plan_for(x, y).route)
            for key, t in (("ms", t_k), ("plain_ms", t_p),
                           ("library_ms", t_l), ("bound_ms", b_ms)):
                totals[key] += n * t
        del a, b, dc, bt, at
    for shape, r in rows.items():
        log(f"  matmul train {shape} [{r['route']}]: kernel_ms "
            f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
            f"{r['library_ms']:.4f} (torch.matmul) bound_ms "
            f"{r['bound_ms']:.4f}; {r['calls_per_step']} a step")
    log(f"phase 1 [train]: the matmul's training products match (max abs "
        f"err {mm_worst:.3g}); a step's {sum(r['calls_per_step'] for r in rows.values())}"
        f" products (seq {TRAIN_SEQ} x batch {TRAIN_BATCH} in {TRAIN_ACCUM} "
        f"microbatches, {TRAIN_LAYERS} layers): kernel {totals['ms']:.2f} ms, "
        f"torch.matmul {totals['library_ms']:.2f}, bound "
        f"{totals['bound_ms']:.2f}, plain {totals['plain_ms']:.2f} "
        f"({time.perf_counter() - t0:.1f} s for phase 1 [train])")
    torch.cuda.empty_cache()
    return {"flash_attention_backward": bwd_stats,
            "matmul_train": dict(shapes=rows, step=totals,
                                 max_abs_err=mm_worst)}


def nz_rms(t) -> float:
    """The RMS of ``t``'s nonzero entries (0 when it has none)."""
    nz = t[t != 0]
    return float(nz.float().pow(2).mean().sqrt()) if nz.numel() else 0.0


def token_rms(torch, path, w, targets=None):
    """The RMS that scales the absolute term of leaf ``path``'s comparison.
    With ``targets`` (the ids the batch's labels name) a vocabulary table's
    is taken over the slices the batch touches: the embedding's rows with a
    nonzero entry (the rows of the tokens it holds; every row of a tied
    table) and an untied LM head's target columns (the others carry only
    the softmax weight, ~1/vocab of a target's: internvl2's batch names ~95
    of 92,553); every other leaf's, and every leaf's without ``targets``,
    over all of its entries."""
    if targets is not None and path == "embed":
        w = w[w.abs().amax(-1) > 0]
    elif targets is not None and path == "lm_head":
        w = w[:, targets.to(w.device)]
    return w.pow(2).mean().sqrt() if w.numel() else w.new_zeros(())


def ratio(torch, err, scale, w, tol):
    """err / (tol x (scale + |w|)) element by element; 0 where both the
    error and the bound are 0 (a row no token used)."""
    lim = tol * (scale + w.abs())
    return torch.where(err == 0, torch.zeros_like(err), err / lim)


def train_tree_close(torch, what, got, want, tol, masks=None, noise=None,
                     targets=None):
    """Each leaf of ``got`` (on the card) within tol * (rms + |want|) of
    the same leaf of ``want`` (on the CPU), compared on the card one leaf
    at a time, rms the CPU leaf's (``token_rms``: with ``targets``, a
    vocabulary table's over the rows and columns the batch touches).
    ``masks`` (path -> the CPU leaf
    whose large entries are compared) limits a leaf's comparison to
    entries above UPDATE_MASK of the RMS of that leaf's nonzero entries.
    ``noise`` (path -> the path of a scale leaf) names leaves that are
    rounding noise on both devices: a key bias without rotary positions,
    whose gradient is 0 in exact arithmetic (the softmax ignores a shift
    common to all keys), against the same layer's query bias.  Each side's
    largest entry must stay below tol x the scale leaf's RMS, as
    ``tests/_torch_train_common.py`` holds it against the reference; with
    ``masks``, the scale leaf's mask RMS selects the entries (Adam's update
    of noise is noise).  Returns the worst error as a fraction of its
    bound."""
    from repro_torch.tree import leaves_with_paths

    noise = noise or {}
    want = dict(leaves_with_paths(want))
    worst = 0.0
    for path, g in leaves_with_paths(got):
        g = g.float()
        w = want[path].to(g.device).float()
        if path in noise and masks is None:
            scale = tol * nz_rms(want[noise[path]])
            r = max(float(g.abs().max()), float(w.abs().max())) / scale
        else:
            rat = ratio(torch, (g - w).abs(),
                        token_rms(torch, path, w, targets), w, tol)
            if masks is not None:
                m = masks[path].to(g.device).abs()
                rat = rat[m > UPDATE_MASK * nz_rms(
                    masks[noise.get(path, path)])]
                del m
            r = float(rat.max()) if rat.numel() else 0.0
            del rat
        if not bool(torch.isfinite(g).all()) or r > 1:
            fail(f"{what} {path}: card and CPU disagree (max abs err "
                 f"{float((g - w).abs().max()):.3g}, {r:.3g} x the limit "
                 f"{tol} * (rms + |cpu|))")
        worst = max(worst, r)
        del g, w
    return worst


def phase_train_card_vs_cpu(torch, cfg):
    """Phase 2 [train]: qwen2-7b at full width, TRAIN_CHECK_LAYERS layers,
    fp32, on batches of TRAIN_CHECK_SHAPE (``train_card_vs_cpu``)."""
    return train_card_vs_cpu(torch, cfg.replace(
        n_layers=TRAIN_CHECK_LAYERS, dtype="float32"), TRAIN_CHECK_SHAPE[1],
        "train")


def train_card_vs_cpu(torch, cfg2, seq, tag, tables=False):
    """``cfg2`` (fp32) with the same weights on the card and the CPU; two
    ``make_train_step`` steps (warmup 1: the first step's rate is 0) on
    ``synth_lm_batch`` batches of TRAIN_CHECK_SHAPE's batch x ``seq``
    positions (the prefix included).  After each step: every gradient the
    step's update took (recorded at its ``adamw_update`` call), the loss
    and metrics, m, v and the params' update where the CPU's m is above
    UPDATE_MASK of the RMS of its nonzero entries (Adam's early updates are
    ~ sign(m) x lr, so an entry whose m is near the card's rounding flips;
    an embedding's gradient is zero on every row the batch does not use),
    each within MODEL_TOL x (rms + |cpu|), rms the CPU leaf's; with
    ``tables`` a vocabulary table's over the rows and columns the batch
    touches (``token_rms``: the step's targets for its gradient, every
    step's so far for m, v and the update).  An MoE's expert ids, every
    routed call's (the forward's, the recompute's), must be equal on both
    devices: a row that differs fails, with its token and the CPU's margin
    between the k-th and the (k+1)-th probability."""
    import contextlib

    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synth_lm_batch
    from repro_torch.models import api as mapi
    from repro_torch.models import moe as MOE
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import steps as RS
    from repro_torch.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    devs = {"card": "cuda", "cpu": "cpu"}
    apis = {k: mapi.build(cfg2, dev) for k, dev in devs.items()}
    params = {"card": apis["card"].init(
        torch.Generator(device="cuda").manual_seed(4))}
    params["cpu"] = tree_map(lambda t: t.to("cpu", copy=True), params["card"])
    opts = {dev: adamw_init(p) for dev, p in params.items()}
    steps = {dev: RS.make_train_step(api, warmup=1, total=50)
             for dev, api in apis.items()}
    B = TRAIN_CHECK_SHAPE[0]
    shape = ShapeCell("train", seq, B, "train")
    worst = {}
    used = []                     # the gradients each step's update took
    update = RS.adamw_update
    routed = 0
    seen = torch.zeros(0, dtype=torch.long)    # every step's targets so far
    # key biases without rotary positions: rounding noise on both devices
    noise = {p: p[:-2] + "bq" for p, _ in leaves_with_paths(params["cpu"])
             if p.endswith("/bk")} if not cfg2.rope_theta else {}

    def recorded(grads, *a, **kw):
        used.append(grads)
        return update(grads, *a, **kw)

    for step in range(2):
        batch = synth_lm_batch(cfg2, shape, step)
        step_ids = torch.unique(torch.from_numpy(batch["labels"]).long())
        seen = torch.unique(torch.cat([seen, step_ids]))
        targets, so_far = (step_ids, seen) if tables else (None, None)
        prev = {dev: dict((k, v.detach().clone()) for k, v in
                          leaves_with_paths(p)) for dev, p in params.items()}
        mets, grads, routing = {}, {}, {}
        for dev in devs:
            used.clear()
            RS.adamw_update = recorded
            try:
                with (Routing(MOE) if cfg2.n_experts
                      else contextlib.nullcontext()) as routing[dev]:
                    params[dev], opts[dev], mets[dev] = steps[dev](
                        params[dev], opts[dev], batch)
            finally:
                RS.adamw_update = update
            grads[dev] = used.pop()
        if cfg2.n_experts:
            card, cpu = routing["card"].calls, routing["cpu"].calls
            if len(card) != len(cpu):
                fail(f"phase 2 [{tag}] step {step}: {len(card)} routed calls "
                     f"on the card, {len(cpu)} on the CPU")
            flips = []
            for call, ((ea, _), (eb, top)) in enumerate(zip(card, cpu)):
                k = cfg2.top_k
                for r in (ea != eb).any(-1).nonzero().flatten().tolist():
                    flips.append(
                        f"call {call} token {r}: card {ea[r].tolist()}, CPU "
                        f"{eb[r].tolist()}, the CPU's margin between the "
                        f"{k}-th and the next probability "
                        f"{float(top[r, k - 1] - top[r, k]):.3g}")
            if flips:
                fail(f"phase 2 [{tag}] step {step}: expert ids differ between "
                     f"the card and the CPU in {len(flips)} rows: {flips}")
            routed += len(cpu)
        worst["grads"] = max(worst.get("grads", 0), train_tree_close(
            torch, f"phase 2 [{tag}] step {step} gradient", grads["card"],
            grads["cpu"], MODEL_TOL, noise=noise, targets=targets))
        del grads
        worst["metrics"] = max(worst.get("metrics", 0), train_tree_close(
            torch, f"phase 2 [{tag}] step {step} loss and metrics",
            mets["card"], mets["cpu"], MODEL_TOL))
        for part in ("m", "v"):
            worst[part] = max(worst.get(part, 0), train_tree_close(
                torch, f"phase 2 [{tag}] step {step} {part}",
                getattr(opts["card"], part), getattr(opts["cpu"], part),
                MODEL_TOL, noise=noise, targets=so_far))
        upd = {dev: {k: v.detach() - prev[dev][k] for k, v in
                     leaves_with_paths(p)} for dev, p in params.items()}
        worst["update"] = max(worst.get("update", 0), train_tree_close(
            torch, f"phase 2 [{tag}] step {step} update", upd["card"],
            upd["cpu"], MODEL_TOL, masks=dict(leaves_with_paths(
                opts["cpu"].m)), noise=noise, targets=so_far))
        del prev, upd
        aux = (f", aux card {float(mets['card']['aux']):.6g} cpu "
               f"{float(mets['cpu']['aux']):.6g}" if "aux" in mets["cpu"]
               else "")
        log(f"phase 2 [{tag}] step {step}: loss card "
            f"{float(mets['card']['loss']):.6f} cpu "
            f"{float(mets['cpu']['loss']):.6f}{aux}, lr "
            f"{float(mets['cpu']['lr']):.3g}")
    del params, opts
    gc.collect()
    torch.cuda.empty_cache()
    experts = (f"; expert ids equal on both devices in all {routed} routed "
               "calls" if cfg2.n_experts else "")
    log(f"phase 2 [{tag}]: {cfg2.name} d={cfg2.d_model} {cfg2.n_layers} "
        f"layers fp32, batch {B} x {seq}, 2 steps: card and CPU agree within "
        f"{MODEL_TOL} x (rms + |cpu|); worst fraction of the bound {worst}"
        f"{experts} ({time.perf_counter() - t0:.1f} s)")
    return worst


def train_measure(torch, cfg, api, params, opt, step_fn, batch):
    """Steps of bf16 training at full width, measured: one step's wall ms
    (host clock to a synchronize) and peak memory; one step under the
    profiler (device ms = the kernels', copies' and memsets' time; idle =
    1 - device / that step's wall; the port's kernels by name); then one
    step split into each microbatch's forward and backward, the f32
    accumulation and the optimizer by CUDA events.  The step's bound: the
    products' forward and backward FLOPs at the tensor cores' rate, an MoE
    router's and the SSD's at the CUDA cores' (``train_flops``)."""
    from repro_torch.optim import adamw_update, cosine_lr
    from repro_torch.profiling.decode_profile import PORT_KERNEL, _device_us
    from repro_torch.profiling.train_counts import train_flops
    from repro_torch.runtime import steps as RS
    from repro_torch.tree import leaves, tree_map, unflatten

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, _ = step_fn(params, opt, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CPU,
                                  prof.ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        traced_wall = (time.perf_counter() - t0) * 1e3
    rows = p.key_averages()
    device = sum(_device_us(e) for e in rows) / 1e3
    by_kernel = {}
    for e in rows:
        m = PORT_KERNEL.search(e.key)
        if m and _device_us(e):
            by_kernel[m.group(1)] = by_kernel.get(m.group(1), 0.0) \
                + _device_us(e) / 1e3
    # the parts of one step, as make_train_step runs them
    tb = RS.to_device(batch, api.device)
    micro = {k: v.reshape((TRAIN_ACCUM, v.shape[0] // TRAIN_ACCUM)
                          + v.shape[1:]) for k, v in tb.items()}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    parts = dict(forward=0.0, backward=0.0, accumulate=0.0)
    gacc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
    for i in range(TRAIN_ACCUM):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        ev[0].record()
        with torch.enable_grad():
            loss, _ = api.loss(live, {k: v[i] for k, v in micro.items()})
            ev[1].record()
            grads = torch.autograd.grad(loss, leaves(live))
        ev[2].record()
        for a, b in zip(leaves(gacc), grads):
            a.add_(b.float() / TRAIN_ACCUM)
        ev[3].record()
        torch.cuda.synchronize()
        parts["forward"] += ev[0].elapsed_time(ev[1])
        parts["backward"] += ev[1].elapsed_time(ev[2])
        parts["accumulate"] += ev[2].elapsed_time(ev[3])
        del live, grads, loss
    ev[4].record()
    grads = unflatten(params, [g.to(p.dtype) for g, p in
                               zip(leaves(gacc), leaves(params))])
    del gacc
    lr = cosine_lr(opt.step, peak=3e-4, warmup=100, total=100)
    params, opt, _ = adamw_update(grads, opt, params, lr=lr)
    ev[5].record()
    torch.cuda.synchronize()
    parts["optimizer"] = ev[4].elapsed_time(ev[5])
    del grads
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_SEQ, TRAIN_BATCH)
    return dict(wall_ms=wall, traced_wall_ms=traced_wall, device_ms=device,
                idle=1 - device / traced_wall, parts_ms=parts,
                kernels_ms=by_kernel, tokens_per_s=tokens / (wall / 1e3),
                peak_gb=peak, flops=flops, bound_ms=flops.pop("bound_ms"))


def train_straight(torch, cfg, n_steps, keep=None, snap=None):
    """``n_steps`` of what ``train.main`` runs without partitions, from its
    seed, on its batches (its total as it sets it), without checkpoints;
    returns the losses.  ``keep`` (a dict) receives the api, step function,
    params and optimizer state at the end; ``snap`` (a dict with key
    "at") receives a host copy of the params after that many steps."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synth_lm_batch
    from repro_torch.models import api as mapi
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import steps as RS
    from repro_torch.tree import leaves_with_paths

    shape = ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    api = mapi.build(cfg, "cuda")
    step_fn = RS.make_train_step(api, peak_lr=3e-4, accum=TRAIN_ACCUM,
                                 total=max(TRAIN_STEPS + TRAIN_RESUME, 100))
    params = api.init(torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    out = []
    for step in range(n_steps):
        params, opt, m = step_fn(params, opt, synth_lm_batch(cfg, shape, step))
        out.append(float(m["loss"]))
        if snap is not None and step + 1 == snap["at"]:
            snap["params"] = {k: v.to("cpu", copy=True)
                              for k, v in leaves_with_paths(params)}
    if keep is not None:
        keep.update(api=api, step_fn=step_fn, params=params, opt=opt)
    return out


def train_step_logged(torch, name, cfg, state):
    """``train_measure`` on the trained state ``state`` (api, step_fn,
    params, opt; cleared after), logged; returns the record."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synth_lm_batch

    shape = ShapeCell("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    meas = train_measure(torch, cfg, state["api"], state["params"],
                         state["opt"], state["step_fn"],
                         synth_lm_batch(cfg, shape, TRAIN_STEPS))
    state.clear()
    flops = ", ".join(f"{k} {v / 1e12:.3f}" for k, v in meas["flops"].items())
    log(f"phase 3 [{name}]: {cfg.name} {cfg.n_layers} layers at full width, "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in {TRAIN_ACCUM} microbatches: "
        f"wall {meas['wall_ms']:.1f} ms ({meas['tokens_per_s']:.0f} tokens "
        f"per s); under the profiler wall {meas['traced_wall_ms']:.1f} ms, "
        f"device {meas['device_ms']:.1f} ms, idle share {meas['idle']:.3f}; "
        f"parts (ms) { {k: round(v, 2) for k, v in meas['parts_ms'].items()} }"
        f"; the port's kernels (device ms) "
        f"{ {k: round(v, 2) for k, v in meas['kernels_ms'].items()} }; peak "
        f"{meas['peak_gb']:.2f} GB; bound {meas['bound_ms']:.1f} ms (TFLOP "
        f"{flops}: products at 989 TFLOP/s, router and SSD at 67)")
    return meas


def counted(torch, name, want, fn):
    """``fn()`` with every count set to 0 just before it and read just
    after; the launches must equal ``want``.  Returns (fn's result, the
    record)."""
    gc.collect()
    torch.cuda.empty_cache()
    zero_counts(torch)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    bwd = counts["bwd_kernels"]
    if counts["launches"] != want or \
            set(bwd.values()) != {want["flash_attention_backward"]}:
        fail(f"phase 3 [{name}]: launches {counts['launches']} (backward "
             f"kernels {bwd}), the code issues {want}")
    return out, dict(counts, wall=wall,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def train_cli_resume(torch, arch, n_layers, n_steps, n_resume, ckpt_dir,
                     tag):
    """The train CLI (``launch/train.main``) on ``arch`` at ``n_layers``
    layers (None: its full depth), bf16, seq TRAIN_SEQ x batch TRAIN_BATCH
    in TRAIN_ACCUM microbatches: ``n_steps`` steps to a checkpoint in
    ``ckpt_dir``, then ``--resume`` for ``n_resume``; their losses must
    equal a straight run's (``train_straight``) bit for bit, and each run's
    launches what the code issues.  Returns the three runs' records, named
    "<tag> cli", "<tag> resume" and "<tag> straight"."""
    import shutil

    from repro_torch.launch import train
    from repro_torch.profiling.train_counts import train_issues

    real, cut = depth_of(train, n_layers)
    full_layers = real(arch).n_layers
    cfg = cut(arch)
    sync_args = ["--arch", arch, "--seq", str(TRAIN_SEQ), "--batch",
                 str(TRAIN_BATCH), "--accum", str(TRAIN_ACCUM)]
    losses, runs = {}, {}
    train.get_config = cut
    try:
        for name, extra, n in (
                (f"{tag} cli", ["--steps", str(n_steps)], n_steps),
                (f"{tag} resume", ["--steps", str(n_resume), "--resume"],
                 n_resume)):
            argv = sync_args + extra + ["--ckpt-dir", str(ckpt_dir)]
            losses[name], runs[name] = counted(
                torch, name, train_issues(cfg, TRAIN_SEQ, n * TRAIN_ACCUM),
                lambda: train.main(argv))
            if not all(math.isfinite(x) for x in losses[name]):
                fail(f"phase 3 [{name}]: losses {losses[name]}")
            runs[name]["losses"] = losses[name]
            log(f"phase 3 [{name}]: {cfg.name} d={cfg.d_model} "
                f"{cfg.n_layers} of {full_layers} layers, bf16, seq "
                f"{TRAIN_SEQ} x batch {TRAIN_BATCH} (accum {TRAIN_ACCUM}), "
                f"{n} steps in {runs[name]['wall']:.2f} s wall (model "
                f"init, checkpoint restore and save included), losses "
                f"{losses[name]}, peak {runs[name]['peak_gb']:.2f} GB, "
                f"launches {runs[name]['launches']} (= what the code "
                f"issues), backward kernels {runs[name]['bwd_kernels']}")
    finally:
        train.get_config = real
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    n_all = n_steps + n_resume
    name = f"{tag} straight"
    losses[name], runs[name] = counted(
        torch, name, train_issues(cfg, TRAIN_SEQ, n_all * TRAIN_ACCUM),
        lambda: train_straight(torch, cfg, n_all))
    runs[name]["losses"] = losses[name]
    if losses[f"{tag} cli"] + losses[f"{tag} resume"] != losses[name]:
        fail(f"phase 3 [{tag}]: {n_steps} steps + resume "
             f"{losses[f'{tag} cli']} + {losses[f'{tag} resume']} differ "
             f"from the straight run {losses[name]}")
    log(f"phase 3 [{tag}]: the CLI's {n_steps} steps and its resumed "
        f"{n_resume} equal a straight run's losses bit for bit "
        f"({losses[name]})")
    return runs


def phase_train_run(torch):
    """Phase 3 [train], at qwen2-7b's full width in bf16 on the card, seq
    TRAIN_SEQ, batch TRAIN_BATCH in TRAIN_ACCUM microbatches.  The CLI
    (``launch/train.main``) at CLI_LAYERS layers: TRAIN_STEPS steps to a
    checkpoint, then --resume for TRAIN_RESUME more; a straight run of both
    through ``make_train_step`` (what the CLI runs, from its seed, on its
    batches, without its checkpoints) must give the same losses bit for
    bit.  Then TRAIN_LAYERS layers through ``make_train_step``:
    TRAIN_STEPS steps, then steps measured (``train_measure``).  Then the
    CLI's partitioned path at PART_LAYERS layers: 2 partitions syncing
    every 2 steps, partition 1 failing at step 3, every sync leaving the
    live replicas equal bit for bit.  Every run's launch counts must equal
    what the code issues, and its losses be finite."""
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.profiling.train_counts import train_issues
    from repro_torch.runtime import partition_runtime as PR
    from repro_torch.tree import leaves

    runs = {}
    base = ["--arch", TRAIN_ARCH, "--seq", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH)]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))

    # the CLI and its resume, at CLI_LAYERS layers
    runs.update(train_cli_resume(torch, TRAIN_ARCH, CLI_LAYERS, TRAIN_STEPS,
                                 TRAIN_RESUME, tmp / "sync", "train"))
    real, cut = depth_of(train, CLI_LAYERS)
    full_layers = real(TRAIN_ARCH).n_layers
    losses = {}

    # TRAIN_LAYERS layers through make_train_step, then measured
    cfg = cut(TRAIN_ARCH).replace(n_layers=TRAIN_LAYERS)
    state = {}
    losses["train"], runs["train"] = counted(
        torch, "train", train_issues(cfg, TRAIN_SEQ,
                                     TRAIN_STEPS * TRAIN_ACCUM),
        lambda: train_straight(torch, cfg, TRAIN_STEPS, keep=state))
    if not all(math.isfinite(x) for x in losses["train"]):
        fail(f"phase 3 [train]: losses {losses['train']}")
    runs["train"]["losses"] = losses["train"]
    log(f"phase 3 [train]: {cfg.name} {cfg.n_layers} of {full_layers} "
        f"layers, bf16, seq {TRAIN_SEQ} x batch {TRAIN_BATCH} (accum "
        f"{TRAIN_ACCUM}), {TRAIN_STEPS} steps through make_train_step in "
        f"{runs['train']['wall']:.2f} s wall (init included): losses "
        f"{losses['train']}, peak {runs['train']['peak_gb']:.2f} GB, "
        f"launches {runs['train']['launches']} (= what the code issues), "
        f"backward kernels {runs['train']['bwd_kernels']}, matmul routes "
        f"{runs['train']['routes']}")
    runs["train"]["step"] = train_step_logged(torch, "train step", cfg,
                                              state)

    # the partitioned path: every sync leaves the live replicas equal
    real, cut = depth_of(train, PART_LAYERS)
    cfg_p = cut(TRAIN_ARCH)
    syncs = []
    sync = PR.PartitionRuntime.sync

    def checked_sync(self):
        out = sync(self)
        alive = self.alive_parts()
        syncs.append((len(alive), all(
            torch.equal(a, b) for p in alive[1:]
            for a, b in zip(leaves(alive[0].params), leaves(p.params)))))
        return out

    fail_step = int(PART_ARGS[PART_ARGS.index("--fail-at") + 1]
                    .split(":")[0])
    part_steps = 2 * fail_step + (PART_STEPS - fail_step)
    argv = base + ["--steps", str(PART_STEPS), "--ckpt-dir",
                   str(tmp / "p")] + PART_ARGS
    train.get_config = cut
    PR.PartitionRuntime.sync = checked_sync
    try:
        part_losses, rec = counted(
            torch, "train partitioned", train_issues(cfg_p, TRAIN_SEQ,
                                                     part_steps),
            lambda: train.main(argv))
    finally:
        train.get_config = real
        PR.PartitionRuntime.sync = sync
    if [sorted(x) for x in part_losses] != \
            [[0, 1]] * fail_step + [[0]] * (PART_STEPS - fail_step) or \
            not all(math.isfinite(v) for x in part_losses
                    for v in x.values()):
        fail(f"phase 3 [train partitioned]: losses {part_losses}")
    if syncs != [(2, True), (1, True)]:
        fail(f"phase 3 [train partitioned]: syncs (live replicas, equal) "
             f"{syncs}, expected [(2, True), (1, True)]")
    runs["train partitioned"] = dict(rec, losses=part_losses, syncs=syncs)
    log(f"phase 3 [train partitioned]: {cfg_p.name} {PART_LAYERS} layers, "
        f"bf16, seq {TRAIN_SEQ} x batch {TRAIN_BATCH}, {' '.join(PART_ARGS)},"
        f" {PART_STEPS} steps ({part_steps} partition steps) in "
        f"{rec['wall']:.2f} s wall: losses {part_losses}; syncs (live "
        f"replicas, equal bit for bit) {syncs}; peak {rec['peak_gb']:.2f} "
        f"GB; launches {rec['launches']} (= what the code issues)")
    shutil.rmtree(tmp, ignore_errors=True)
    return runs


def phase_train(torch) -> dict:
    """``--only train``: the fourteenth slice's phase 1, 2 and 3 checks."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    stats = phase_train_kernels(torch, cfg)
    phase_train_card_vs_cpu(torch, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    runs = phase_train_run(torch)
    return dict(stats, runs={k: {kk: vv for kk, vv in v.items()
                                 if kk in ("launches", "wall", "losses",
                                           "step", "peak_gb", "syncs")}
                             for k, v in runs.items()})


# ---------------------------------------------------------------------------
# the sixteenth slice: training the other families
# ---------------------------------------------------------------------------

# one config a family at published width, and the layers phase 3 trains on
# one card (None: all), leaving at least 10 GB of its 80 free: 16 bytes a
# parameter (bf16 params and grads, the f32 accumulator, m and v) and the
# optimizer's f32 temporaries of a leaf; qwen3-moe's 623 M a layer and
# internvl2's 390 M beside 622 M / 1,137 M of embedding and head
TRAIN_FAMILIES = {"qwen3-moe-30b-a3b": 4, "internvl2-26b": 6,
                  "mamba2-130m": None, "hymba-1.5b": None,
                  "whisper-base": None}
# the CLI and its resume only where a checkpoint is small: whisper-base's
# ~1.1 GB and mamba2's ~1.6 GB (f32 params, m and v); qwen2-7b's CLI runs
# already write ~32 GB of a call's 45 GiB
TRAIN_FAMILY_CLI = ("whisper-base", "mamba2-130m")
FAMILY_CLI_STEPS, FAMILY_CLI_RESUME = 2, 1
FAMILY_BITWISE_STEPS = 2    # two runs from one seed, equal bit for bit
# phase 2: fp32 at 2 layers on batches of 2 x (prefix + text): hymba at 3
# layers and 1152 text rows, since its global layers (0, 15, 31) taken
# modulo 2 layers leave no windowed layer, and 128 meta rows + 1152 make
# 1280 > its 1024-key window; the two largest at 1 layer, for the full
# run's time (its CPU steps took 111 and 135 s of the 994 s run at 2)
TRAIN_FAMILY_CHECK = {"hymba_1p5b": (3, 1152),          # by config name
                      "qwen3_moe_30b_a3b": (1, 128), "internvl2_26b": (1, 128)}
TRAIN_CHECK_TEXT = 128


def train_check_seq(cfg) -> tuple:
    """(layers, positions) of phase 2 [train families] for ``cfg``: the
    prefix (image or meta rows) + the text rows (TRAIN_FAMILY_CHECK, or 2
    layers and TRAIN_CHECK_TEXT)."""
    layers, text = TRAIN_FAMILY_CHECK.get(cfg.name, (2, TRAIN_CHECK_TEXT))
    return layers, (cfg.n_img_tokens or 0) + (cfg.n_meta_tokens or 0) + text


def train_family_cfg(arch):
    depth = TRAIN_FAMILIES[arch]
    return family_cfg(arch) if depth is None else family_cfg(
        arch, n_layers=depth)


def train_family_attention():
    """(tag, (B, Sq, Skv, Hq, Hkv, D, causal, window)) of each attention
    the families' training step runs at TRAIN_SEQ positions a microbatch:
    each distinct window of an LM's layers; whisper's decoder self
    attention and its cross attention over the encoder's frames."""
    from repro_torch.models.transformer import layer_windows

    out = []
    for arch in TRAIN_FAMILIES:
        cfg = family_cfg(arch)
        if cfg.family == "ssm":
            continue
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        if cfg.family == "encdec":
            out += [(f"{arch} self", (1, TRAIN_SEQ, TRAIN_SEQ, *heads, True,
                                      0)),
                    (f"{arch} cross", (1, TRAIN_SEQ, cfg.enc_seq, *heads,
                                       False, 0))]
            continue
        for w in sorted({int(x) for x in layer_windows(cfg)}, reverse=True):
            out.append((f"{arch} window {w}" if w else f"{arch} global",
                        (1, TRAIN_SEQ, TRAIN_SEQ, *heads, True, w)))
    return out


def train_family_products():
    """(tag, M, K, N, forward calls a step, backward calls a step) of each
    training product whose forward or backward has an operand whose rows
    are not 16 bytes (a dimension off 8 elements: staged on the tensor
    cores):
    a block's over TRAIN_SEQ rows, forward twice under remat; a loss
    chunk's head over the chunk, forward twice (its recompute); whisper's
    head over the whole sequence, once."""
    from repro_torch.profiling.train_counts import _chunk, block_products

    out = []
    for arch in TRAIN_FAMILIES:
        cfg = train_family_cfg(arch)
        if cfg.family == "encdec":
            head = (TRAIN_SEQ, TRAIN_ACCUM, TRAIN_ACCUM)
        else:
            text = TRAIN_SEQ - (cfg.n_img_tokens or 0) - (
                cfg.n_meta_tokens or 0)
            rows = _chunk(text, LOSS_CHUNK)
            n = text // rows * TRAIN_ACCUM
            head = (rows, 2 * n, n)
            prods = block_products(cfg)
            for K, N in sorted(set(prods)):
                n = prods.count((K, N)) * cfg.n_layers * TRAIN_ACCUM
                if K % 8 or N % 8:
                    out.append((f"{arch} block", TRAIN_SEQ, K, N, 2 * n, n))
        if head[0] % 8 or cfg.d_model % 8 or cfg.vocab % 8:
            out.append((f"{arch} head", head[0], cfg.d_model, cfg.vocab,
                        *head[1:]))
    return out


def phase_train_family_kernels(torch):
    """Phase 1 [train families]: flash attention's forward with LSE and its
    backward at each family's training shapes (``train_family_attention``)
    in bf16 and fp32 against the f32 plain backward, bit for bit on a
    second launch, and each timed in bf16 beside SDPA and its bound; then
    the products whose rows are not 16 bytes (``train_family_products``):
    forward, dA and dB against ``ref.matmul`` within tol x (rms + |want|),
    on the tensor cores with the misaligned operand staged, bit for bit on
    a second launch, timed beside ``torch.matmul`` and the bound (the
    parent's route against another checkout: ``profiling/matmul_ab``)."""
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.matmul import ref as mm_ref

    t0 = time.perf_counter()
    rnd = train_rnd(torch, 16)
    failures, worst, attn = [], {}, {}
    shapes = train_family_attention()
    for tag, shape in shapes:
        for dt in (torch.bfloat16, torch.float32):
            errs = bwd_case(torch, rnd, tag, dt, shape, failures)
            key = str(dt).split(".")[1]
            for k_, e in errs.items():
                worst[f"{key} {k_}"] = max(worst.get(f"{key} {k_}", 0.0), e)
    if failures:
        fail(f"phase 1 [train families]: {len(failures)} outputs outside "
             f"their bound (name, fraction of the bound, max abs err), worst "
             f"first: {sorted(failures, key=lambda f: -f[1])}")
    log(f"phase 1 [train families]: LSE, dQ, dK, dV match their plain "
        f"versions at {len(shapes)} training shapes in bf16 and fp32, each "
        f"bit for bit on a second launch; worst max abs errors {worst}")
    for tag, shape in shapes:
        attn[tag] = bwd_timed(torch, rnd, tag, shape)

    rows, mm_worst = {}, 0.0
    for tag, M, K, N, n_fwd, n_bwd in train_family_products():
        a, b, dc = (rnd((M, K), torch.bfloat16), rnd((K, N), torch.bfloat16),
                    rnd((M, N), torch.bfloat16))
        bt, at = b.t().contiguous(), a.t().contiguous()
        for kind, (x, y) in {"forward": (a, b), "dA = dC B^T": (dc, bt),
                             "dB = A^T dC": (at, dc)}.items():
            name = f"matmul train {tag} {kind}"
            got = mm_ops.matmul(x, y)
            mm_worst = max(mm_worst, check_rms(
                torch, name, got, mm_ref.matmul(x, y), TOL["bfloat16"]))
            if not torch.equal(got, mm_ops.matmul(x, y)):
                fail(f"{name}: two launches on the same inputs differ")
            p = mm_ops.plan_for(x, y)
            if p.route != "mma" or not any(p.staged):
                fail(f"{name}: plan {p}, want mma with a staged operand")
            del got
            t_k = time_ms(torch, lambda i: mm_ops.matmul(x, y), 1, 10)
            t_p = time_ms(torch, lambda i: mm_ref.matmul(x, y), 1, 3)
            t_l = time_ms(torch, lambda i: torch.matmul(x, y), 1, 10)
            Mx, Kx = x.shape
            Nx = y.shape[1]
            b_ms, by = bound(2 * (Mx * Kx + Kx * Nx + Mx * Nx),
                             2 * Mx * Kx * Nx, H100_BF16)
            n = n_fwd if kind == "forward" else n_bwd
            rows[f"{tag} {kind} ({Mx},{Kx},{Nx})"] = dict(
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=by, calls_per_step=n,
                route=f"{p.route} staged {p.staged}",
                tflops=2 * Mx * Kx * Nx / t_k / 1e9)
        del a, b, dc, bt, at
        torch.cuda.empty_cache()
    for shape, r in rows.items():
        log(f"  matmul train {shape} [{r['route']}]: kernel_ms "
            f"{r['ms']:.4f} ({r['tflops']:.1f} TFLOP/s) plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} "
            f"(torch.matmul) bound_ms {r['bound_ms']:.4f} ({r['bound_by']}); "
            f"{r['calls_per_step']} a step")
    log(f"phase 1 [train families]: the staged products match "
        f"ref.matmul (max abs err {mm_worst:.3g}), bit for bit on a second "
        f"launch ({time.perf_counter() - t0:.1f} s for phase 1 [train "
        f"families])")
    return {"attention": attn, "attention_worst": worst,
            "attention_shapes": len(shapes),
            "matmul": dict(shapes=rows, max_abs_err=mm_worst)}


def phase_train_family_card_vs_cpu(torch):
    """Phase 2 [train families]: each family at full width in fp32, the
    card against the CPU over two steps (``train_card_vs_cpu``) at
    ``train_check_seq``'s depth and positions, a vocabulary table's
    absolute term over the rows and columns the batch touches
    (``token_rms``; qwen2-7b's phase 2 keeps the leaf's)."""
    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = family_cfg(arch, dtype="float32")
        layers, seq = train_check_seq(cfg)
        cfg2 = cfg.replace(n_layers=layers, **(
            {"enc_layers": layers} if cfg.family == "encdec" else {}))
        out[arch] = train_card_vs_cpu(torch, cfg2, seq,
                                      f"train families {arch}", tables=True)
    return out


def phase_train_family_run(torch):
    """Phase 3 [train families]: each family in bf16 at full width and the
    depth of TRAIN_FAMILIES, seq TRAIN_SEQ x batch TRAIN_BATCH in
    TRAIN_ACCUM microbatches, through ``make_train_step`` (what the CLI
    runs): TRAIN_STEPS steps, then one measured (``train_measure``); a
    second run of FAMILY_BITWISE_STEPS steps from the same seed must give
    the first run's losses and parameters at that step bit for bit; the
    families of ``train_family_products`` must stage some matmul operands,
    the others none.  For
    TRAIN_FAMILY_CLI, the CLI's steps and resume against a straight run
    (``train_cli_resume``).  Every run's launches must equal what the code
    issues, and every loss be finite."""
    import shutil
    import tempfile

    from repro_torch.profiling.train_counts import train_issues
    from repro_torch.tree import leaves_with_paths

    runs = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_families_"))
    # the families whose products stage an operand (rows not 16 bytes)
    staged_archs = {tag.split()[0] for tag, *_ in train_family_products()}
    for arch in TRAIN_FAMILIES:
        cfg = train_family_cfg(arch)
        full = family_cfg(arch).n_layers
        name = f"train {arch}"
        state, snap = {}, {"at": FAMILY_BITWISE_STEPS}
        losses, runs[name] = counted(
            torch, name, train_issues(cfg, TRAIN_SEQ,
                                      TRAIN_STEPS * TRAIN_ACCUM),
            lambda: train_straight(torch, cfg, TRAIN_STEPS, keep=state,
                                   snap=snap))
        if not all(math.isfinite(x) for x in losses):
            fail(f"phase 3 [{name}]: losses {losses}")
        if (runs[name]["staged"] > 0) != (arch in staged_archs):
            fail(f"phase 3 [{name}]: {runs[name]['staged']} staged matmul "
                 f"launches (staged families: {sorted(staged_archs)})")
        runs[name]["losses"] = losses
        log(f"phase 3 [{name}]: {cfg.name} {cfg.n_layers} of {full} "
            f"layers, bf16, seq {TRAIN_SEQ} x batch {TRAIN_BATCH} (accum "
            f"{TRAIN_ACCUM}), {TRAIN_STEPS} steps through make_train_step in "
            f"{runs[name]['wall']:.2f} s wall (init included): losses "
            f"{losses}, peak {runs[name]['peak_gb']:.2f} GB, launches "
            f"{runs[name]['launches']} (= what the code issues), backward "
            f"kernels {runs[name]['bwd_kernels']}, matmul routes "
            f"{runs[name]['routes']} ({runs[name]['staged']} staged)")
        runs[name]["step"] = train_step_logged(torch, f"{name} step", cfg,
                                               state)
        gc.collect()
        torch.cuda.empty_cache()
        again = {}
        bit, runs[f"{name} bitwise"] = counted(
            torch, f"{name} bitwise", train_issues(
                cfg, TRAIN_SEQ, FAMILY_BITWISE_STEPS * TRAIN_ACCUM),
            lambda: train_straight(torch, cfg, FAMILY_BITWISE_STEPS,
                                   keep=again))
        differ = [k for k, v in leaves_with_paths(again["params"])
                  if not torch.equal(v, snap["params"][k].to(v.device))]
        again.clear()
        snap.clear()
        if bit != losses[:FAMILY_BITWISE_STEPS] or differ:
            fail(f"phase 3 [{name}]: two runs of {FAMILY_BITWISE_STEPS} "
                 f"steps from one seed differ: losses {bit} against "
                 f"{losses[:FAMILY_BITWISE_STEPS]}, parameters {differ}")
        runs[f"{name} bitwise"]["losses"] = bit
        log(f"phase 3 [{name}]: a second run of {FAMILY_BITWISE_STEPS} "
            f"steps from the same seed equals the first bit for bit (losses "
            f"{bit}, every parameter)")
        gc.collect()
        torch.cuda.empty_cache()
        if arch in TRAIN_FAMILY_CLI:
            runs.update(train_cli_resume(
                torch, arch, TRAIN_FAMILIES[arch], FAMILY_CLI_STEPS,
                FAMILY_CLI_RESUME, tmp / arch, name))
            gc.collect()
            torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    return runs


def phase_train_families(torch) -> dict:
    """``--only train_families``: the sixteenth slice's phase 1, 2 and 3
    checks."""
    stats = phase_train_family_kernels(torch)
    phase_train_family_card_vs_cpu(torch)
    runs = phase_train_family_run(torch)
    return dict(stats, runs={k: {kk: vv for kk, vv in v.items()
                                 if kk in ("launches", "wall", "losses",
                                           "step", "peak_gb")}
                             for k, v in runs.items()})


# ---------------------------------------------------------------------------
# the eighteenth slice: the SPMD tooling
# ---------------------------------------------------------------------------

SPMD_LAYERS = 1              # of qwen2-7b's 28: P copies of params, grads,
SPMD_PARTS = 2               # m and v (~13.2 GB a partition) and one more
SPMD_STEPS = 2               # copy for the separate steps: ~45 GB
SPMD_CKPT_ARCH = "mamba2-130m"   # the restore's checkpoint: 0.5 GB of f32


def spmd_partitioned_step(torch) -> dict:
    """Phase 3 [spmd]: ``make_partitioned_train_step`` at qwen2-7b's full
    width, SPMD_LAYERS layer, SPMD_PARTS partitions of 1 x TRAIN_SEQ
    tokens, bf16, ``warmup=1``, SPMD_STEPS steps, partition i's params
    drawn from seed i and stacked.  Counted: the launches must equal what
    ``train_issues`` says the code issues for P x steps microbatches, all
    products on ``mm_mma``.  Then each partition again through
    ``make_train_step`` alone, from its seed, on its half of each batch:
    losses, metrics, params, m and v bit for bit against the stacked
    run's slice; and ``sync_params`` against the f32 mean of the
    partitions.  Logs each step's device ms (CUDA events), wall ms and
    the peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.pipeline import synth_lm_batch
    from repro_torch.models import api as mapi
    from repro_torch.optim import AdamWState, adamw_init
    from repro_torch.profiling.train_counts import train_issues
    from repro_torch.runtime import steps as RS
    from repro_torch.tree import leaves_with_paths, tree_map

    full = get_config(TRAIN_ARCH).n_layers
    cfg = get_config(TRAIN_ARCH).replace(n_layers=SPMD_LAYERS)
    api = mapi.build(cfg, "cuda")
    kw = dict(peak_lr=3e-4, warmup=1, total=100)
    shape = ShapeCell("train", TRAIN_SEQ, SPMD_PARTS, "train")
    batches = []
    for step in range(SPMD_STEPS):
        b = synth_lm_batch(cfg, shape, step)
        batches.append({k: torch.from_numpy(v).reshape(
            (SPMD_PARTS, 1) + v.shape[1:]).cuda() for k, v in b.items()})

    def init(i):
        return api.init(torch.Generator(device="cuda").manual_seed(i))

    gc.collect()
    torch.cuda.empty_cache()
    parts = [init(i) for i in range(SPMD_PARTS)]
    stacked = tree_map(lambda *xs: torch.stack(xs), *parts)
    del parts
    opt = adamw_init(stacked)
    opt = AdamWState(torch.zeros((SPMD_PARTS,), dtype=torch.int32,
                                 device="cuda"), opt.m, opt.v)
    step_fn = RS.make_partitioned_train_step(api, stack_axis="part", **kw)
    want = train_issues(cfg, TRAIN_SEQ, SPMD_PARTS * SPMD_STEPS)
    torch.cuda.synchronize()
    zero_counts(torch)
    torch.cuda.reset_peak_memory_stats()
    steps, losses, metrics = [], [], []
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        stacked, opt, m = step_fn(stacked, opt, b)
        ev[1].record()
        torch.cuda.synchronize()
        steps.append(dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                          device_ms=ev[0].elapsed_time(ev[1])))
        losses.append([float(x) for x in m["loss"]])
        metrics.append(m)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    bwd = counts["bwd_kernels"]
    if counts["launches"] != want or \
            set(bwd.values()) != {want["flash_attention_backward"]} or \
            counts["routes"]["mma"] != want["matmul"]:
        fail(f"phase 3 [spmd]: launches {counts['launches']} (backward "
             f"kernels {bwd}, matmul routes {counts['routes']}), the code "
             f"issues {want}")
    if not all(math.isfinite(x) for row in losses for x in row):
        fail(f"phase 3 [spmd]: losses {losses}")
    smi = card_line()
    for i, st in enumerate(steps):
        log(f"phase 3 [spmd]: partitioned step {i} ({SPMD_PARTS} partitions "
            f"x 1 x {TRAIN_SEQ} tokens, {cfg.name} {SPMD_LAYERS} of {full} "
            f"layers at full width, bf16): device {st['device_ms']:.1f} ms "
            f"(CUDA events), wall {st['wall_ms']:.1f} ms, losses "
            f"{losses[i]} [{smi}]")
    log(f"phase 3 [spmd]: peak {peak:.2f} GB; launches {counts['launches']}"
        f" (= what the code issues for {SPMD_PARTS} x {SPMD_STEPS} "
        f"microbatches), backward kernels {bwd}, matmul routes "
        f"{counts['routes']} [{smi}]")

    # each partition alone, from its seed: bit for bit
    stacked_l = dict(leaves_with_paths(stacked))
    m_l, v_l = dict(leaves_with_paths(opt.m)), dict(leaves_with_paths(opt.v))
    base = RS.make_train_step(api, **kw)
    for i in range(SPMD_PARTS):
        p_i = init(i)
        o_i = adamw_init(p_i)
        for s_, b in enumerate(batches):
            p_i, o_i, m_i = base(p_i, o_i, {k: v[i] for k, v in b.items()})
            for k, v in m_i.items():
                if not torch.equal(torch.as_tensor(v), metrics[s_][k][i]):
                    fail(f"phase 3 [spmd]: partition {i} step {s_} metric "
                         f"{k}: {float(v)} alone, "
                         f"{float(metrics[s_][k][i])} partitioned")
        bad = [path for path, x in leaves_with_paths(p_i)
               if not torch.equal(x, stacked_l[path][i])]
        bad += [f"m/{path}" for path, x in leaves_with_paths(o_i.m)
                if not torch.equal(x, m_l[path][i])]
        bad += [f"v/{path}" for path, x in leaves_with_paths(o_i.v)
                if not torch.equal(x, v_l[path][i])]
        if bad or int(o_i.step) != int(opt.step[i]):
            fail(f"phase 3 [spmd]: partition {i} alone differs from the "
                 f"partitioned run at {bad[:8]} (step {int(o_i.step)} / "
                 f"{int(opt.step[i])})")
        del p_i, o_i
        torch.cuda.empty_cache()
    log(f"phase 3 [spmd]: each of the {SPMD_PARTS} partitions alone "
        "(make_train_step from its seed) equals the partitioned run bit for "
        "bit: losses, metrics, params, m, v and the step count")
    avg = RS.sync_params(stacked)
    avg_l = dict(leaves_with_paths(avg))
    for path, x in stacked_l.items():
        mean = x.float().mean(0).to(x.dtype)
        if not all(torch.equal(avg_l[path][i], mean)
                   for i in range(SPMD_PARTS)):
            fail(f"phase 3 [spmd]: sync_params at {path} is not the f32 mean")
    log("phase 3 [spmd]: sync_params gives every partition the f32 mean of "
        "the partitions' params")
    p0 = tree_map(lambda x: x[0].clone(), stacked)
    del avg, avg_l, stacked, stacked_l, opt, m_l, v_l, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return {"spmd partitioned": dict(counts, steps=steps, losses=losses,
                                     peak_gb=peak, card=smi)}, cfg, p0


def spmd_one_rank_mesh(torch, cfg, params) -> dict:
    """Phase 3 [spmd]: a one-rank NCCL process group and its (1, 1)
    ``DeviceMesh`` (``launch.mesh.device_mesh``): ``params`` placed by
    ``param_shardings`` have local shards bit for bit the whole tensors
    and the specs' placements; a checkpoint of SPMD_CKPT_ARCH at full
    width lands on the mesh through ``restore(shardings=)``, bit for
    bit."""
    import os
    import socket
    import tempfile

    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as SH
    from repro_torch.models import api as mapi
    from repro_torch.tree import leaves_with_paths, tree_map

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_spmd_"))
    try:
        plan = M.make_host_mesh(1, 1)
        dm = M.device_mesh(plan, "cuda")

        def held(placed, whole, specs, what):
            want = dict(leaves_with_paths(whole))
            n = 0
            for path, x in leaves_with_paths(placed):
                if list(x.placements) != SH.to_placements(specs[path], plan):
                    fail(f"phase 3 [spmd]: {what} {path}: placements "
                         f"{x.placements}, spec {specs[path]}")
                if not torch.equal(x.to_local(), want[path]):
                    fail(f"phase 3 [spmd]: {what} {path}: the local shard "
                         "is not the whole tensor")
                n += 1
            return n

        n_p = held(SH.distribute(params, SH.param_shardings(params, cfg, dm)),
                   params, SH.param_pspecs(params, cfg, plan), "qwen2-7b")
        ccfg = get_config(SPMD_CKPT_ARCH)
        cparams = mapi.build(ccfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(0))
        mgr = CheckpointManager(tmp)
        mgr.save(1, {"params": cparams})
        template = {"params": tree_map(lambda t: t.to("meta"), cparams)}
        restored, _ = mgr.restore(template, shardings=SH.param_shardings(
            template, ccfg, dm))
        n_c = held(restored, {"params": cparams}, SH.param_pspecs(
            template, ccfg, plan), "restore")
    finally:
        dist.destroy_process_group()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    log(f"phase 3 [spmd]: a one-rank NCCL mesh {plan.shape}: {n_p} qwen2-7b "
        f"params placed by param_shardings, each local shard bit for bit "
        f"the whole tensor; a {SPMD_CKPT_ARCH} checkpoint restored onto it "
        f"by restore(shardings=), {n_c} leaves bit for bit ({wall:.1f} s)")
    return {"mesh_s": wall}


def spmd_dryrun() -> dict:
    """Phase 3 [spmd]: ``python -m repro_torch.launch.dryrun --all --mesh
    both`` on the host (meta tensors, no device); every cell must be OK."""
    import os

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--all", "--mesh", "both"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    m = re.search(r"dryrun: (\d+)/(\d+) cells OK in ([\d.]+) s", out.stdout)
    if out.returncode or not m or m.group(1) != m.group(2):
        fail(f"phase 3 [spmd]: the dry run failed (exit {out.returncode}): "
             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    log(f"phase 3 [spmd]: dry run {m.group(1)}/{m.group(2)} cells OK, "
        f"{m.group(3)} s inside, {wall:.2f} s with the interpreter "
        f"(host only)")
    return {"dryrun_cells": int(m.group(1)), "dryrun_s": wall}


def phase_spmd(torch) -> dict:
    """``--only spmd`` and the full run's phase 3 [spmd]: the partitioned
    step, the one-rank mesh and the dry run.  Returns the run record."""
    t0 = time.perf_counter()
    runs, cfg, p0 = spmd_partitioned_step(torch)
    runs["spmd partitioned"].update(spmd_one_rank_mesh(torch, cfg, p0))
    del p0
    gc.collect()
    torch.cuda.empty_cache()
    runs["spmd partitioned"].update(spmd_dryrun())
    log(f"phase 3 [spmd]: {time.perf_counter() - t0:.1f} s [{card_line()}]")
    return runs


# --only NAME: the sources to build and the phase-1 function to run
ONLY = {"matmul": (["matmul"], lambda torch, cfg: phase_matmul(
            torch, cfg, sweep=True)),
        "flash_attention": (["flash_attention"], phase_flash_attention),
        "decode_attention": (["paged_attention", "flash_decode"],
                             phase_decode_kernels),
        "conv2d": (["conv2d"], lambda torch, cfg: phase_conv_kernel(
            torch, cnn_conv_shapes(), sweep=True)),
        "serving_graph": (["matmul", "flash_attention", "paged_attention",
                           "flash_decode"], lambda torch, cfg: phase_graph(
            torch, cfg, profile=True)),
        "cluster": (["matmul", "flash_attention", "paged_attention",
                     "flash_decode"], lambda torch, cfg: (
            phase_cluster(torch, cfg), {})[1]),
        "families": (["matmul", "flash_attention", "paged_attention",
                      "flash_decode"], lambda torch, cfg: phase_families(
            torch)),
        "ssm": (["matmul", "flash_attention", "paged_attention",
                 "flash_decode"], lambda torch, cfg: phase_ssm(torch)),
        "encdec": (["matmul", "flash_attention", "paged_attention",
                    "flash_decode"], lambda torch, cfg: phase_encdec(torch)),
        "train": (["matmul", "flash_attention", "flash_attention_bwd"],
                  lambda torch, cfg: phase_train(torch)),
        "train_families": (["matmul", "flash_attention",
                            "flash_attention_bwd"],
                           lambda torch, cfg: phase_train_families(torch)),
        "spmd": (["matmul", "flash_attention", "flash_attention_bwd"],
                 lambda torch, cfg: phase_spmd(torch))}


def serving_wrappers():
    """The kernel wrappers of the serving path, by kernel name."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    return {"matmul": mm_ops.matmul,
            "flash_attention": fa_ops.flash_attention,
            "paged_decode": pa_ops.paged_decode,
            "paged_decode_quant": pa_ops.paged_decode_quant,
            "paged_decode_sparse": pa_ops.paged_decode_sparse,
            "flash_decode": fd_ops.flash_decode}


def phase_families(torch) -> dict:
    """``--only families``: the eleventh slice's phase 1, 2 and 3 checks
    alone."""
    phase_family_kernels(torch)
    phase_family_card_vs_cpu(torch)
    phase_family_serve(torch, serving_wrappers())
    return {}


def cnn_conv_shapes():
    """{net: {(H, Cin, Cout, k, stride): calls per forward}} of each CNN at
    224, recorded by the shape-only forward of ``profiling/conv2d_ab``."""
    from repro_torch.profiling.conv2d_ab import conv_shapes

    return {name: conv_shapes(name) for name in CNN_NETS}


def ptxas_entries(text: str):
    """(kernel, registers, spill-store bytes) of each entry function in an
    ``-Xptxas=-v`` report."""
    out = []
    for chunk in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        out.append((chunk.split("'", 1)[0], int(regs.group(1)) if regs else 0,
                    int(spill.group(1)) if spill else 0))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=sorted(ONLY),
                    help="build these kernels alone and run their phase-1 "
                         "checks and timings; prints no result line")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import ops as cv_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    smi = card_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    report = _build.build(ONLY[args.only][0] if args.only
                          else _build.SOURCES)
    log(f"phase 0: built {sorted(report)} in {time.perf_counter() - t0:.1f} s"
        f" ({_build.BUILD_DIR})")
    for name, r in report.items():
        entries = ptxas_entries(r["ptxas"])
        regs = [n for _, n, _ in entries]
        log(f"  {name}: {len(regs)} kernel instances, {min(regs, default=0)}"
            f"-{max(regs, default=0)} registers, at most "
            f"{max((n for _, _, n in entries), default=0)} bytes of spill "
            "stores")
        if args.only:                   # each kernel instance
            for fn, n_regs, spill in entries:
                log(f"    {fn}: {n_regs} registers, {spill} bytes of spill "
                    "stores")

    cfg = get_config("qwen2-7b")
    if args.only:
        stats = ONLY[args.only][1](torch, cfg)
        log(smi)
        print(json.dumps({"kernels": stats}), flush=True)
        log(f"chip_smoke: --only {args.only} passed (one kernel's phase 1, "
            "not a full run: no result line)")
        return
    stats = phase_matmul(torch, cfg)
    stats.update(phase_flash_attention(torch, cfg))
    stats.update(phase_decode_kernels(torch, cfg))
    phase_family_kernels(torch)
    ssm_stats = phase_ssm_kernels(torch)
    encdec_stats = phase_encdec_kernels(torch)
    train_stats = phase_train_kernels(torch, cfg)
    family_train_stats = phase_train_family_kernels(torch)
    phase_card_vs_cpu(torch, cfg)
    phase_family_card_vs_cpu(torch)
    phase_ssm_card_vs_cpu(torch)
    phase_encdec_card_vs_cpu(torch)
    phase_graph(torch, cfg)
    phase_train_card_vs_cpu(torch, cfg)
    phase_train_family_card_vs_cpu(torch)
    gc.collect()
    torch.cuda.empty_cache()
    cnn_params, conv_shapes = phase_cnn_card_vs_cpu(torch)
    stats.update(phase_conv_kernel(torch, conv_shapes))
    torch.cuda.empty_cache()
    wrappers = dict(serving_wrappers(), conv2d=cv_ops.conv2d)
    runs = phase_cnn(torch, wrappers, cnn_params)
    stats["conv2d"]["in_forward_ms"] = runs["cnn resnet50"]["conv_ms"]
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_serve(torch, cfg, wrappers))
    del cnn_params      # qwen3-moe's 60.5 GB of weights come next
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_family_serve(torch, wrappers))
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_ssm_serve(torch, wrappers))
    runs.update(phase_encdec_serve(torch, wrappers))
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_train_run(torch))
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_train_family_run(torch))
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_spmd(torch))
    gc.collect()
    torch.cuda.empty_cache()
    runs.update(phase_cluster(torch, cfg))

    meta = {"matmul": ("matmul.cu", "src/repro/kernels/matmul/matmul.py:49"),
            "flash_attention": (
                "flash_attention.cu",
                "src/repro/kernels/flash_attention/flash_attention.py:92"),
            "paged_decode": (
                "paged_attention.cu",
                "src/repro/kernels/paged_attention/paged_attention.py:101"),
            "paged_decode_quant": (
                "paged_attention.cu",
                "src/repro/kernels/paged_attention/paged_attention.py:189"),
            "paged_decode_sparse": (
                "paged_attention.cu",
                "src/repro/kernels/paged_attention/paged_attention.py:282"),
            "flash_decode": (
                "flash_decode.cu",
                "src/repro/kernels/flash_decode/flash_decode.py:83"),
            "conv2d": ("conv2d.cu", "src/repro/kernels/conv2d/conv2d.py:51"),
            # the reverse pass of the reference's training step: autodiff of
            # its XLA chunked attention (the Pallas kernel has no backward)
            "flash_attention_backward": (
                "flash_attention_bwd.cu", "src/repro/models/layers.py:107")}
    # the fourteenth slice's training shapes (phase 1 [train])
    stats["flash_attention_backward"] = dict(
        train_stats["flash_attention_backward"],
        kernels=list(fa_ops.BWD_KERNELS))
    stats["matmul"]["train"] = train_stats["matmul_train"]
    # the sixteenth slice's (phase 1 [train families])
    stats["flash_attention_backward"]["families"] = dict(
        family_train_stats["attention"],
        worst=family_train_stats["attention_worst"],
        shapes=family_train_stats["attention_shapes"])
    stats["matmul"]["train_families"] = family_train_stats["matmul"]
    bwd = train_stats["flash_attention_backward"]
    stats["flash_attention"]["train"] = dict(
        shape=bwd["shape"], forward_lse_ms=bwd["forward_lse_ms"],
        forward_lse_bound_ms=bwd["forward_lse_bound_ms"],
        lse_max_abs_err=bwd["errs"]["lse"])
    # the twelfth slice's shapes (phase 1 [ssm]), beside the main path's
    ssm_of = {"matmul": dict(ssm_stats["matmul"],
                             decode_step=ssm_stats["matmul_step"]),
              "flash_attention": ssm_stats["flash_attention"]}
    for k, t in ssm_stats["decode"].items():
        ssm_of.setdefault(k.split()[0], {})[k] = t
    # the thirteenth slice's shapes (phase 1 [encdec]); flash attention's
    # bidirectional mode beside its causal one
    encdec_of = {"matmul": dict(encdec_stats["matmul"],
                                encoder_wave=encdec_stats["matmul_wave"],
                                decode_step=encdec_stats["matmul_step"]),
                 "flash_decode": {"cross": encdec_stats["flash_decode"]}}
    stats["flash_attention"].update(
        modes=["causal", "bidirectional"],
        bidirectional=encdec_stats["flash_attention"])
    kernels = []
    for name, (src, replaces) in meta.items():
        s = stats[name]
        by_run = {run: r["launches"][name] for run, r in runs.items()
                  if r["launches"].get(name)}
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/kernels/csrc/{src}",
                        "replaces": replaces,
                        "launches": sum(by_run.values()),
                        "launches_by_run": by_run,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"], "shape": s["shape"],
                        **{key: s[key] for key in (
                            "long_ms", "long_library_ms", "long_bound_ms",
                            "splits", "long_splits", "prefill_ms",
                            "prefill_plain_ms", "prefill_library_ms",
                            "prefill_bound_ms", "route_ms", "route_bound_ms",
                            "library_tf32_ms", "bf16_ms", "bf16_plain_ms",
                            "bf16_library_ms", "bf16_bound_ms",
                            "bf16_bound_by",
                            "bf16_route_ms", "bf16_route_bound_ms", "modes",
                            "bidirectional", "train", "kernels", "errs",
                            "worst", "shapes", "forward_lse_ms",
                            "forward_lse_bound_ms", "kernel_ms", "whisper",
                            "families", "train_families")
                           if key in s},
                        **({"routes_by_run": {
                            run: r["routes"] for run, r in runs.items()
                            if "routes" in r}} if name == "matmul" else {}),
                        **({"routes": {
                            run: r["conv_routes"] for run, r in runs.items()
                            if "conv_routes" in r}} if name == "conv2d"
                           else {}),
                        **({"in_forward_ms": s["in_forward_ms"]}
                           if "in_forward_ms" in s else {}),
                        **({"ssm_shapes": ssm_of[name]} if name in ssm_of
                           else {}),
                        **({"encdec_shapes": encdec_of[name]}
                           if name in encdec_of else {})})
    log(f"chip_smoke: {len(TRACE_RERUNS)} phase-2 lockstep reruns for lost "
        f"profiler records {[n for n, _ in TRACE_RERUNS]}")
    log(smi)      # again here: long runs push the first lines out of a tail
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
