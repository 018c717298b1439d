#!/usr/bin/env python3
"""Builds and drives the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each on its own lines of output; any failure exits non-zero:

1. the card's name and power limit, as nvidia-smi reports them;
2. build the CUDA kernels K1-K5 from ``src/repro_torch/kernels/csrc`` (timed);
3. K1 binarize + bitpack against its plain version, det and stoch with the
   same words, at 2048x2048 and ragged shapes: the words must be equal; and
   K1's on-chip variant (in-kernel Philox words, ``on_chip_prng=True``)
   against its plain version, bit for bit, at 2048x2048, 512x512 and
   ragged shapes (K < 32, K % 32 != 0, N % 32 != 0, word rows past grid.y's
   65,535), with the Eq.-3 frequency within 4 sigma and the exact
   endpoints on the card; then the threefry twin (``core.prng``) that
   draws every stochastic pack's words: its words on the card equal its
   words on the CPU, and full-width mnist_fc and VGG-16 stochastic packs on
   the card equal the same packs on the CPU at the same key;
4. K2 packed-weight matmul against its plain version, f32 and bf16, with
   and without scale, at M in {4, 256} x 2048 x 2048, 4 x 512 x 512 and a
   ragged shape, within rtol 1e-4 / atol 1e-3 (f32: only the order of the
   f32 sum differs) or 3e-2 (bf16); and two calls bit-identical;
5. K3 sign + pack, K4 XNOR-popcount matmul and K5 patch pack against their
   plain versions, word for word and bit for bit, at every serving shape of
   the xnor paths and at ragged shapes (K % 32 != 0, M not a multiple of 8,
   allow_extra_words layouts, scaled and unscaled, stride 2, VALID, ragged
   H/W, C % 32 != 0, 0.0 / -0.0 / NaN planted); K5 also at the edges of its
   tiling (a row wider than a column tile, a channel row and a kernel window
   wider than a block's shared memory, H = W = 1, a batch past grid.z's
   65,535, an input off 16-byte alignment, three inputs past 2^31
   elements and an output past 2^31 words, these cases from
   ``xnor.conv.cases``); K3 with its producer prologue (bias, eval batch
   norm, Eq.-1 sign: ``bn_sign_pack``) against the unfused chain, exact, at
   the serving shapes, ragged K and M past the grid, with BN outputs planted
   at 0.0, -0.0, NaN, +-2^-149 and exactly 0 or one step either side of it
   (``xnor.cases``), and the prologue's rsqrt against ``torch.rsqrt`` over
   every positive finite f32; then the Eq.-1 threshold: values either side
   of 2^-126 (subnormals of both signs, 2^-126 and the next value, -2^-126,
   +-0, NaN; ``xnor.cases.sign_plants``) through K1 det, plain K3, fused K3
   (planted as BN outputs) and K5, f32 and bf16, exact against the plain
   versions, with the planted bits +1 only at 2^-126 and above;
   K4 with the conv border correction and scale fused into its flush,
   through ``xnor_conv2d``, against the plain conv route on the CPU at
   VGG's 11 conv geometries and a layout sweep; and K2 at
   M = 65535 * 4 + 1 and K4 at N = 65535 * 64 + 1,
   one past the grid limits earlier kernels had; and the dense f32 conv
   against an f64 conv (cuDNN's TF32 must stay off);
6. the main path: serve full-width mnist_fc (784-2048x3-10) in det, stoch
   and xnor, and full-width VGG-16/CIFAR-10 in det, stoch and xnor, through
   ``repro_torch.launch.serve.serve_classifier``, 4 slots, 64 requests after
   one untimed warm-up batch. Every launch counter is set to 0 just before
   each serve and read just after, and must equal the per-batch counts times
   17 batches plus the pack-time K1 launches. The served words are held
   against a plain pack of the same master weights, and the served logits
   against the same forward with the plain kernel versions on the same
   card (so the dense ops are identical and any difference is the
   kernels'); the difference from the plain forward on the CPU and the
   count of sign activations that differ from it (at the fused K3 sites,
   the bits read back from its words) are printed, with the device kernel
   launches per batch; in xnor the forward with every sign site on the
   unfused chain must give the same logits bit for bit, and its device time
   and launches per batch are printed beside the fused forward's;
6b. the plan manifests, for each of the six (net, mode) pairs at full
   width: the compiled plan equals ``benchmarks/golden_plans`` as a dict and,
   saved, as file text; the saved plan loaded and packed on the card gives
   every leaf equal to the compiled plan's pack; a serve from the golden
   manifest (``plan_from``) gives the compiled serve's launch counts and
   logits bit for bit. Then VGG-16 xnor with ``conv/3=binarized_dense``
   overridden (one K4 and one K5 launch fewer a batch, one K1 fewer at
   pack time) and mnist_fc det and xnor packed without scales, each held
   against the plain-kernel forward;
6c. the stochastic ensemble: mnist_fc and VGG-16 stoch at full width, K = 8
   replicas, 4 slots, 64 requests, through ``serve_classifier(ensemble=8)``;
   counters exact (K1's operand mode 8 x the stochastic leaves at pack time,
   K2 8 x its single-sample count a batch); a K = 1 ensemble gives the
   single-sample serve's logits bit for bit; every replica's words on the
   card equal a CPU pack at the same key; each replica's logits match its
   plain-kernel forward; ms/batch, device ms and launches a batch, vote
   agreement and the replicas' bytes are printed;
7. time each kernel at the path shapes with CUDA events, beside its plain
   version, a library call where one computes the same function, and the
   least time the card could take (the stochastic pack route, twin words +
   K1, beside K1 alone; the on-chip K1 variant, which no path runs, beside
   that route; K3 with its prologue beside the unfused chain's device time
   and launches, and K3 without it; K4 at each VGG shape as the conv path
   calls it, fused; K5 at each VGG conv input); and
   each xnor conv layer as a whole against F.conv2d on +-1 f32, with the
   device kernels it launches counted by the profiler; bn_sign at the sites
   it serves, beside the eager ops it replaced.

Since the batch-norm sign sites flush subnormals as the reference does:
phase 5 also holds ``bn_sign`` (the flushed bias, eval batch norm and sign,
unpacked: every sign site K3's prologue does not take) against its plain
version at the sites it serves, and ``bn_sign`` and fused K3 against the
plain chain on the CPU with a subnormal planted at each flushed step
(``xnor.cases.FLUSH_PLANTS``), with the reference's bits; phase 6 counts
its launches (mnist_fc xnor 1 a batch, VGG-16 xnor 12), and with K3's
prologue route off counts one bn_sign and one plain K3 a site in place of
one fused K3. A phase 6d trains on the card (Alg. 1, the paper's recipe
through ``launch.train.build_paper_model``): full-width mnist_fc 5 det and
5 stoch steps and VGG-16 3 det steps, each step also run on the CPU from
the same state and batch (step 1: equal binarized weights, grads and the
new state within ``TRAIN_TOL``; every step's loss within
``TRAIN_LOSS_RTOL``; binarized weights that differ are counted), with
steps/s and each step's device ms; TF32 off through VGG-16's backward
(f32 grads against f64 on the card, beside a TF32 backward); a run with
injected failures restored from its checkpoints on the card, bit for bit
against a clean run; and the training CLI for 50 mnist_fc stoch steps.

Since the dense LM serve (phase 6e, about a minute and a half more):
K2 at StarCoder2-3B's four projection shapes in bf16 at M = 4 and 32
(f32 tolerance), K3 on bf16 activations at its widths and K4 over its
96- and 384-word rows (exact); then StarCoder2-3B at its full CONFIG
width (30 layers, d_model 3072, d_ff 12288, vocab 49152, bf16
activations) served in det, stoch and xnor through
``launch.serve.serve_lm`` (16 requests, 4 slots, 32-token prompts, 16 new
tokens, seed 0): launch counters exact (120 K1 at pack time; 120 K2, or
120 K3 + 120 K4, per prefill and per decode step); every packed
per-layer leaf equal to a plain pack of the same masters (stoch: two
layers also against a CPU pack at their split keys); the first four
requests' greedy logits against the plain kernels on the card (first
step within ``LM_LOGIT_TOL`` of the largest logit, xnor bit for bit,
tokens equal up to the first step whose top-2 margin is under it); every
stream equal to the one-shot ``generate`` of its request; pack seconds,
dense and served MB, tok/s, median TTFT and latency, the decode step's
wall ms, device ms and device launches, and peak allocated bytes; and a
traced serve (``--trace``, written to ``build/lm_trace.json``) that
``validate_trace`` passes at coverage >= 0.95, with the dispatch/device
split of ``decode_step`` and ``prefill_into``. Phase 7 times K2, K3 and K4
at the LM decode shapes.

Since the rest of the dense LM serve engine (phase 6f, about two minutes
more; since the hybrid's phase 6i, StarCoder2-3B at full width cut to
``LM_6F_LAYERS`` = 10 of its 30 layers, so the counts below are 4 a layer, 40
a call), from StarCoder2-3B masters at full width: chunked prefill
with the prefix cache in det and xnor (``LM_CHUNK``: 16 requests sharing a
16-token prompt prefix plus one repeating request ``LM_REPEAT_OF``'s
prompt, 4 slots, chunks of 8, a 32-entry cache): launch counters exact
(120 K2, or 120 K3 + 120 K4, per decode step and per chunk, so a fused
step runs both), at least one prefix hit and tokens skipped, the repeated
prompt's full-prompt hit emitting its twin's stream, every stream equal to
the same engine's whole-prompt stream up to a near tie under
``LM_6F_LOGIT_TOL`` (``LM_LOGIT_TOL`` scaled by the depth, 10/30; the
smallest margin printed); wall ms, device ms and
device launches of a decode step, a chunk alone and a fused step; tok/s
and median TTFT; and a traced chunked det serve (``build/
lm_chunked_trace.json``, coverage >= 0.95) with the dispatch/device split
of ``decode_prefill``, ``prefill_chunk``, ``decode_step`` and
``prefix_splice``. Temperature sampling (det, T = 0.8, key 5): the uniform
words under the first draw on the card equal the CPU twin's, and the
sampled tokens equal the same sampling with the plain kernels up to a
near tie of logits / T + gumbel (under ``LM_6F_LOGIT_TOL``). The K = 4 stochastic ensemble (8
requests, 8 new tokens): K1 120 x 4 at pack and K2 120 x 4 per prefill and
decode step, every stream equal to the ensemble's one-shot ``generate``,
agreement in [0, 1] and variance >= 0, a K = 1 ensemble's tokens and
logprobs equal to the stoch-packed engine's bit for bit; replica bytes,
pack seconds, tok/s and the decode step's wall and device ms.

Since the MoE family (phase 6g, about three minutes more): the
expert-batched K2 (``binary_matmul_batched``: all 64 experts of a
projection in one launch) against its plain version at Moonlight's expert
shapes (``MOE_K2``, f32 and bf16, scaled and not, a ragged shape and K past
2048), with every row live and routed (``rows``, the per-expert counts
``moe_ffn`` hands it: all experts empty, one full, a decode step's 4
tokens x top-6, counts past M), each expert's live rows bit for bit the
2-D K2 on its slices, the rows past its count +0, two calls bit-identical
and one launch a call, and K2 at Moonlight's attention shapes; then
Moonlight-16B-A3B at full width, cut to ``MOE_LAYERS`` = 16 of its 48
layers (the f32 masters of all 48 would not fit the card), served in det
and stoch through ``launch.serve.serve_lm(n_layers=16)`` with
``LM_SERVE``: counters exact (3,104 K1 at pack time; 32 K2 and 48
expert-batched K2 per prefill and decode step), every served slice equal
to a plain pack (stoch: two expert slices against a CPU pack at their split
keys), the first four requests' logits against the plain kernels at every
step (the plain run decoding the kernel run's tokens on its routing, with
the routing flips counted and held to ``MOE_ROUTE_TIE``; within
``LM_LOGIT_TOL``; greedy tokens equal up to a near tie), every stream equal
to one-shot ``generate``, the dropped fraction at the prefill and decode
capacity, pack s, MB, tok/s, TTFT, the decode step's wall ms, device ms and
launches, and peak GB; and a chunked det serve with the prefix cache
(``MOE_CHUNK``): counters exact, its streams equal to the same chunked
admission without the cache bit for bit, and against the whole-prompt
streams, where a request may part only if its whole-prompt prefill
dropped assignments (a chunk of 8 tokens never overflows an expert), its
routing met a near tie, or its logits did. The det serve's decode step
records each layer's counts; phase 7 times the expert-batched K2 at the
expert shapes with every row live and at that served routing, beside
``torch.bmm``, with the routed bound (the live experts' words) and the
all-expert one.

Since the SSM family (phase 6h, about a minute and a half more): K2 at
mamba2-130m's projection shapes (768 x 3352, the first ragged N on an LM
path, and 1536 x 768) in bf16 at M = 4 and 200, scaled and not, K3 on its
inputs and K4 at N = 3352 and 768 (exact); then mamba2-130m at its full
CONFIG width (all 24 layers, d_model 768, d_inner 1536, state 128, bf16
activations) served in det, stoch and xnor through ``serve_lm`` with
``LM_SERVE``: counters exact (48 K1 at pack time; 48 K2, or 48 K3 + 48 K4,
per prefill and decode step), every served leaf equal to a plain pack, the
first four requests' greedy logits against the plain kernels (first step
within ``LM_LOGIT_TOL``, xnor bit for bit, tokens equal up to a near tie),
a ``SSM_LONG_PROMPT`` = 200-token prefill (two SSD chunks, the second
padded) against the plain kernels (logits within ``LM_LOGIT_TOL``; xnor's
logits, final states and conv windows bit for bit; 48 projection
launches), every stream equal to one-shot ``generate``, pack s, MB, tok/s,
TTFT, the decode step's wall ms, device ms and launches with K2/K3/K4's
share of the device time; and a chunked det serve with the prefix cache
(``SSM_CHUNK``): counters exact, at least one hit, streams against the
whole-prompt ones up to a near tie. Phase 7 times K1, K2, K3 and K4 at
mamba2's shapes.

Since the hybrid (phase 6i, about four minutes more): K2 at jamba-1.5-large's
projection shapes (``HYB_KN``: K up to 24576, N up to 33280; bf16, M = 4
and 32) and the expert-batched K2 at its expert shapes (``HYB_K2``: 16
experts x 8 rows, all rows and routed) against their plain versions, two
calls bit-identical, live rows bit for bit the 2-D K2; the draw-and-pack
route (``ExecutionPlan.pack_drawn``) against ``plan.pack(init_lm(...))`` at
SMOKE width on the card, det and stoch, bit for bit, with the plan compiled
from the masters' shapes; jamba at full width with all 72 layers in det
through ``serve_lm`` with ``LM_SERVE`` (each (K, N) master drawn and packed
at once: ~50 GB of words where the f32 masters would be ~1.6 TB): counters
exact (1,980 K1 at pack; 252 K2 and 108 expert-batched K2 a model call), the
first four streams equal to their one-shot ``generate``, pack s,
served GB against bf16 dense, peak allocated, tok/s, median TTFT, the decode
step's wall ms, device ms and launches with the 2-D and batched K2's shares;
one period (8 layers) in det and stoch: counters exact, det words equal to
a plain pack of the same draws, a stoch expert matrix equal to a CPU pack at
its split key, logits of the first four requests against the plain kernels
(on the kernel run's routing; flips counted) within ``LM_LOGIT_TOL``, every
stream equal to ``generate``; and a chunked det serve of one period with
the prefix cache (``HYB_CHUNK``) against whole-prompt admission. Phase 7
times K2 at a period's 28 decode projections and the expert-batched K2 at
the routing the 72-layer decode step produced.

Since the LM training slice (phase 6j, about two minutes more; ``LmTraining``),
Alg.-1 training of the decoder LMs through ``launch.train.build_lm``, none
of it launching a port kernel (training runs the dense +-1 masters through
``torch.matmul``, as the reference's einsums run outside any Pallas
kernel): StarCoder2-3B at its full CONFIG (30 layers) at batch 8 x 128
tokens, the CLI's step once (its grads reach ~1e29 through 30 layers of
unscaled +-1 projections, and the masters after it overflow the next
forward: reported), then ``TRAIN_LM_STEPS`` det and stoch steps with the
grads clipped to a global norm, each with a finite loss, clipped masters
and no kernel launch: wall ms, a det step's device ms and launches, peak
allocated against the reckoned peak, and the threefry twin's share of a
stoch step; the same cut to 2 layers on the card and on the CPU
(``TRAIN_LM_CUT_RUNS``: bf16 det and stoch, f32 det; losses, binarized
weights and the head's grads held, the rest printed beside f64);
musicgen-large from its stub's frame embeddings, the CLI's step at all 48
layers (grads past f32's range: reported) and clipped det steps at
``TRAIN_FRONTEND_LAYERS``; ``python -m repro_torch.launch.train --arch
mamba2_130m --steps 12 --ckpt-every 4 --fail-at 6`` (1 recovery, final
masters bit for bit those of a run without the crash); and one det step of
Moonlight and jamba at SMOKE width against the CPU (the MoE backward:
``lb_loss`` and the router's grads).

Since the dense family's mesh serving (phase 6k, after 6f; about two
minutes more): StarCoder2-3B at its full CONFIG on a (2, 2) ("data",
"model") mesh whose four positions share the card (``LM_MESH``), placed
from 6e's packed det and xnor trees (``ServeEngine(mesh=, plan=)``): every
projection's shards (K2 on N/2; xnor K3 + K4 on N/2, or on K/2 with K4's
int32 partials summed, then scaled) equal the single-device call bit for
bit; the ``LM_SERVE`` streams equal 6e's up to near ties (counted); the
counters give 120 projections at each of a decode step's 4 positions and a
slot's prefill's 2, the collectives the plan's prediction
(``obs.collectives.predict_call_collectives``) for the serve and for one
decode step; the first 4 requests' logits hold 2^-5 of the largest against
the single-device engine's on the same tokens; tok/s, TTFT, the decode
step's wall and device ms and launches, bytes a position and peak
allocated; then a chunked det serve with the prefix cache at
``LM_6F_LAYERS`` layers cut from 6e's det tree against whole-prompt
admission on the mesh. Phase 7 times K2, K3 and K4 at a position's decode
shapes (M = 2, ``LM_MESH_K2`` / ``LM_MESH_K4``).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data sheet (700 W): HBM3 bandwidth, the f32 rate of the CUDA
# cores (the non-tensor-core f32 peak) and the dense bf16 tensor-core rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# XNOR-popcount words: popc issues 16 a clock per SM on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput), the
# slowest of the XOR / popc / add each word needs; 132 SMs at the H100 SXM's
# 1,980 MHz maximum SM clock.
PEAK_POPC_WORDS_PER_S = 16 * 132 * 1.98e9
# 32-bit integer multiply, add and logic: 64 a clock per SM on compute
# capability 9.0 (same table), at the same clock.
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Integer instructions per Philox4x32-10 call: 10 rounds of four multiply
# halves, two three-way XORs and two key bumps (csrc/binarize_pack.cu).
PHILOX_INT32_OPS = 10 * 8

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2, to time pack-time calls cold
BATCHES = 17                   # 64 requests / 4 slots + 1 warm-up

# Kernel launches per batch and per pack on each served path (PERF.md's
# table): K2 binary_matmul, K3 sign_pack (every one with the batch-norm
# prologue: sign_pack_fused), K4 xnor_matmul, K5 patch_pack, bn_sign (the
# sign sites K3 does not take: mnist_fc's 2->3, VGG's conv 1-11 and fc/1)
# per batch; K1 binarize_pack once per packed leaf.
SERVES = [
    ("mnist_fc", "det", {"binary_matmul": 2}, 2),
    ("mnist_fc", "stoch", {"binary_matmul": 2}, 2),
    ("mnist_fc", "xnor", {"sign_pack": 2, "sign_pack_fused": 2, "xnor_matmul": 2,
                          "bn_sign": 1}, 2),
    ("vgg16_cifar10", "det", {"binary_matmul": 1}, 1),
    ("vgg16_cifar10", "stoch", {"binary_matmul": 1}, 13),
    ("vgg16_cifar10", "xnor", {"sign_pack": 1, "sign_pack_fused": 1, "xnor_matmul": 12,
                               "patch_pack": 11, "bn_sign": 12}, 12),
]

# The sign sites bn_sign serves at batch 4, as (M, K): mnist_fc's 2->3, then
# VGG-16's conv 1-11 outputs (B*H*W, C) and fc/1.
MNIST_BN_SIGN = [(4, 2048)]
VGG_BN_SIGN = [(4096, 64), (1024, 128), (1024, 128), (256, 256), (256, 256), (256, 256),
               (64, 512), (64, 512), (64, 512), (16, 512), (16, 512), (4, 512)]

# Alg.-1 training on the card: (net, mode, steps), the paper's recipe at
# batch 4 through launch.train.build_paper_model, each step held against
# the same step on the CPU. Step 1's grads, masters, momentum and batch-norm
# stats hold rtol = atol / (the tree's largest value) = TRAIN_TOL (the f32
# sum order of cuBLAS/cuDNN against the CPU's; VGG's training batch norm
# over batch 4 amplifies it, as the CPU parity tests state); every step's
# loss holds TRAIN_LOSS_RTOL, and the binarized weights that differ are
# counted.
TRAIN_RUNS = [("mnist_fc", "det", 5), ("mnist_fc", "stoch", 5), ("vgg16_cifar10", "det", 3)]
TRAIN_TOL = {"mnist_fc": 1e-4, "vgg16_cifar10": 1e-3}
TRAIN_LOSS_RTOL = {"mnist_fc": 1e-3, "vgg16_cifar10": 1e-2}

# The ensemble serves: (net, K2 launches a batch of one replica, stochastic
# leaves K1 packs once a replica).
ENSEMBLE_K = 8
ENSEMBLES = [("mnist_fc", {"binary_matmul": 2}, 2),
             ("vgg16_cifar10", {"binary_matmul": 1}, 13)]

# The dense LM serve (phase 6e): StarCoder2-3B at its full CONFIG width (30
# layers, d_model 3072, 24 heads with 2 KV heads of 128, d_ff 12288, vocab
# 49152, bf16 activations) through launch.serve.serve_lm at the reference
# CLI's defaults. A prefill or decode step runs each of the 4 projections of
# each layer once: 120 K2 launches (det, stoch) or 120 K3 + 120 K4 (xnor);
# the pack runs K1 once a layer and projection.
LM_ARCH = "starcoder2_3b"
LM_MODES = ("det", "stoch", "xnor")
LM_SERVE = dict(requests=16, slots=4, prompt_len=32, max_new=16, seed=0)
# (K, N) of the 4 projections of a layer: qkv, w_o, wi, wo
LM_KN = [(3072, 3584), (3072, 3072), (3072, 12288), (12288, 3072)]
# Phase 6k: StarCoder2-3B served on a (2, 2) ("data", "model") mesh whose
# four positions share the card, placed from 6e's packed det and xnor trees
# (ServeEngine(mesh=, plan=)). A data group decodes 2 of the 4 slots; each
# model position runs its shard of every projection: det, N/2 of each (K, N)
# of LM_KN (column parallel, the outputs gathered); xnor, w_qkv and wi on N/2
# (scaled K4) and w_o and wo on K/2 (row parallel: K3 on the activation's
# range, then K4's unscaled int32 partial of the word range; the partials
# summed, then scaled once). A decode step runs every projection at all 4
# positions (4 x 120 K2, or K3 + K4), a slot's prefill at its group's 2.
LM_MESH = ((2, 2), ("data", "model"))
LM_MESH_K2 = [(k, n // 2) for k, n in LM_KN]
# (K of the range, N of the shard, scaled) of the 4 xnor projections' K3 + K4
LM_MESH_K4 = [(3072, 1792, True), (1536, 3072, False), (3072, 6144, True),
              (6144, 3072, False)]
# Logits against the same forward with the plain kernels on the card: the
# largest |difference| at most LM_LOGIT_TOL x the largest |logit|, about four
# bf16 ulps of it (K2's f32 sums differ from the plain version's only in
# order, but every op rounds its output to bf16, and 30 layers carry a
# one-ulp difference on); xnor's integer popcounts must agree exactly.
# Greedy tokens must agree up to the first step whose top-2 logit margin
# (of the plain run) is under that tolerance.
LM_LOGIT_TOL = 2.0 ** -5
# The rest of the serve engine (phase 6f), from the same masters: chunked
# prefill with a prefix cache (det, xnor): 16 requests whose first 16 prompt
# tokens are shared, then one more repeating request LM_REPEAT_OF's prompt
# (a full-prompt hit), chunks of 8 tokens, a 32-entry cache; temperature
# sampling (det) at T = 0.8 from key 5; and the K = 4 stochastic ensemble on
# 8 requests of 8 new tokens. A fused step runs 120 K2 for its decode and
# 120 for its chunk (xnor: 120 K3 + 120 K4 each); an ensemble step 120 x K.
LM_CHUNK = dict(requests=16, slots=4, prompt_len=32, max_new=16, prefill_chunk=8,
                prefix_cache=32, shared_prefix=16)
LM_REPEAT_OF = 2
LM_TEMPERATURE, LM_TEMPERATURE_KEY = 0.8, 5
LM_ENSEMBLE = dict(k=4, requests=8, slots=4, prompt_len=32, max_new=8)
# 6f's depth: StarCoder2-3B at full width cut to 10 of its 30 layers (6e
# serves all 30), so that the whole run, phase 6i's 72-layer hybrid included,
# stays near 800 s; at 30 layers 6f's chunked, tempered and ensemble serves
# took 216 s of an 880 s run on an H100 80GB HBM3 (700 W)
LM_6F_LAYERS = 10
# LM_LOGIT_TOL is four bf16 ulps of the largest logit over 30 layers; 6f's
# near-tie checks scale it by their depth (the same budget a layer), so the
# depth cut leaves them no looser than 6e's
LM_6F_LOGIT_TOL = LM_LOGIT_TOL * LM_6F_LAYERS / 30
# The MoE family (phase 6g): Moonlight-16B-A3B at its full CONFIG width
# (d_model 2048, 16 heads of 128, 64 experts of GLU d_ff 1408, top-6, vocab
# 163840, bf16 activations) at MOE_LAYERS of its 48 layers: its f32 masters
# are 2.28 GB a layer (the experts' 553.6 M weights and attention's 16.8 M)
# and 2.68 GB for the embedding and head, ~112 GB at 48 layers against the
# card's 80 GB. A prefill or decode step runs 2 K2 (attention) and 3
# expert-batched K2 (w_gate, w_up, w_down over all 64 experts) a layer; the
# pack runs K1 once per attention layer and once per expert slice.
MOE_ARCH = "moonshot_v1_16b_a3b"
MOE_LAYERS = 16
MOE_MODES = ("det", "stoch")
# the expert-batched K2 at the expert shapes, (E, M, K, N): M = 8 rows, the
# capacity of a decode step's 4 tokens (and of a 32-token prefill)
MOE_K2 = [(64, 8, 2048, 1408), (64, 8, 1408, 2048)]
# (K, N) of a layer's attention projections, on the 2-D K2: w_qkv, w_o
MOE_ATTN_KN = [(2048, 6144), (2048, 2048)]
# A token whose router scores two experts within rounding of each other may
# route to either in two runs whose hidden states differ in their last bits
# (the kernels' f32 sum order against the plain versions'). Such a flip is
# accepted where the expert taken in place of the token's own k-th one
# scores at most MOE_ROUTE_TIE below it in router logits (log
# probabilities): 1/8, several times what a few bf16 ulps of the hidden
# state move an O(1) router logit.
MOE_ROUTE_TIE = 0.125
# chunked admission with the prefix cache (det): 8 requests sharing a
# 16-token prompt prefix, chunks of 8 (a chunk's 8 x 6 assignments never
# overflow an expert's 8 rows; a whole 32-token prompt's 192 may)
MOE_CHUNK = dict(requests=8, slots=4, prompt_len=32, max_new=8, prefill_chunk=8,
                 prefix_cache=16, shared_prefix=16)

# The SSM family (phase 6h): mamba2-130m at its full CONFIG width (24 layers,
# d_model 768, d_inner 1536, state 128, 24 heads of 64, vocab 50280, bf16
# activations; f32 masters ~0.5 GB, so no depth cut) through serve_lm with
# LM_SERVE in det, stoch and xnor. A prefill or decode step runs each layer's
# in_proj and out_proj once: 48 K2, or 48 K3 + 48 K4; the pack runs K1 once
# a layer and projection. The SSD between them is plain torch (the
# reference's is jnp outside any Pallas kernel).
SSM_ARCH = "mamba2_130m"
# (K, N) of a layer's projections: in_proj (N = 2 d_inner + 2 state + heads,
# the first ragged N on an LM path: 26 x 128 + 24) and out_proj
SSM_KN = [(768, 3352), (1536, 768)]
# a prefill past one SSD chunk of 128 that is not a multiple of it (padded)
SSM_LONG_PROMPT = 200
SSM_CHUNK = dict(requests=8, slots=4, prompt_len=32, max_new=8, prefill_chunk=8,
                 prefix_cache=16, shared_prefix=16)

# The hybrid (phase 6i): jamba-1.5-large at its full CONFIG width (d_model
# 8192, 64 heads with 8 KV heads of 128, GLU d_ff 24576, 16 experts top-2 on
# odd layers, Mamba2 d_inner 16384 in 256 heads of 64 with state 128, vocab
# 65536, untied head, bf16), in periods of 8 layers with attention at j = 4.
# Its f32 masters are ~180 GB a period, so serve_lm draws each (K, N) matrix
# and packs it at once (ExecutionPlan.pack_drawn); packed, all 72 layers are
# ~50 GB of words. A period runs K1 220 times at pack (2 attention + 14 mixer
# + 12 dense GLU + 192 expert matrices), and a model call 28 2-D K2
# (attention 2, the mixers' in_proj and out_proj, the dense GLUs' 3) and 12
# expert-batched K2 (the MoE layers' 3) a period.
HYB_ARCH = "jamba_1_5_large"
# (K, N) of a period's 2-D K2 projections and how many a period runs: w_qkv,
# w_o, in_proj, out_proj, the dense GLU's w_gate and w_up, w_down
HYB_KN = [((8192, 10240), 1), ((8192, 8192), 1), ((8192, 33280), 7), ((16384, 8192), 7),
          ((8192, 24576), 8), ((24576, 8192), 4)]
# the expert-batched K2 at the expert shapes, (E, M, K, N): M = 8 rows, the
# capacity of a decode step's 4 tokens x top-2 (and of a 32-token prefill)
HYB_K2 = [(16, 8, 8192, 24576), (16, 8, 24576, 8192)]
# one period (8 layers) against the plain kernels and with chunked admission:
# 72 bf16 layers would carry the kernels' rounding past LM_LOGIT_TOL, and the
# twin draws ~1 G stochastic words a second on the card (a period's 44 G)
HYB_CHUNK = dict(requests=8, slots=4, prompt_len=32, max_new=8, prefill_chunk=8,
                 prefix_cache=16, shared_prefix=16)

# Alg.-1 training of the decoder LMs (phase 6j), through launch.train.build_lm
# (its masters and batches) and the step function (the Trainer is not used:
# no 25 GB checkpoints): StarCoder2-3B at its full CONFIG (30 layers, remat
# "full") at the CLI's batch 8 x 128 tokens, SGD momentum, TRAIN_LM_STEPS det
# steps then stoch steps from the same state. Training runs the dense f32
# masters, binarized to +-1 and cast to bf16 in the layers, through
# torch.matmul, as the reference runs its einsums outside any Pallas kernel:
# no port kernel may launch.
TRAIN_LM_ARCH = "starcoder2_3b"
TRAIN_LM = dict(batch=8, seq=128, lr=3e-3, optimizer="sgd", seed=0)
TRAIN_LM_STEPS = {"det": 4, "stoch": 2}
# At full depth the CLI's step (no clipping) diverges: each unscaled +-1
# projection multiplies activations and their grads by ~sqrt(K), so 30 layers
# give grads of ~1e29 and, after one step at lr 3e-3, embedding masters of
# ~3e27, whose next forward overflows to NaN (H100 80GB HBM3, 700 W). 6j runs
# that step once and reports it, then trains with the grads clipped to this
# global norm by its own clip (LmTraining.step_fn), which sums the norm's
# squares in f64: the port's optim.sgd.clip_by_global_norm sums them in f32,
# as the reference's does, which overflows past a norm of ~1.8e19 and then
# zeroes every grad (these grads' norms are ~1e30).
TRAIN_LM_GRAD_CLIP = 1.0
# The same at full width cut to 2 layers and batch 2 (the CPU's share of the
# run), on the card and on the CPU from the same masters and batches:
# TRAIN_LM_CUT_RUNS (activation dtype, mode, steps), each step of the CPU from
# the card's state (a step's grads differ between the two, so their states
# would), step 1's grads also against the same step in f64 on the card. At this width the forward is
# well conditioned (losses agree to TRAIN_LM_LOSS_RTOL) but the grads before
# the last attention are not: its scores reach ~1e4, the softmax is near an
# argmax, and a rounding flips which key wins; the f32 grads of both devices
# are 0.2-0.35 (relative l2) from f64 there, the bf16 ones 30-180 (H100 80GB
# HBM3, 700 W, and its host's CPU). So the head's grads and updates
# (lm_head, final_norm) are held to TRAIN_LM_HEAD_TOL card against CPU; in
# the f32 run every other leaf's are held to TRAIN_LM_REST_TOL too (card vs
# CPU 0.043 at most, either side vs f64 0.20-0.22, my H100 run), and the
# bf16 ones are printed beside f64.
TRAIN_LM_CPU_LAYERS = 2
TRAIN_LM_CUT_BATCH = 2
TRAIN_LM_CUT_RUNS = [("bfloat16", "det", 2), ("bfloat16", "stoch", 1), ("float32", "det", 1)]
TRAIN_LM_HEAD_LEAVES = ("lm_head/kernel", "final_norm/scale")
TRAIN_LM_HEAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
TRAIN_LM_REST_TOL = {"float32": 0.1}
TRAIN_LM_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# musicgen-large at full width from its stub's frame embeddings (B, S,
# d_model) with lm_tokens labels: one CLI step of all 48 layers (its grads
# pass f32's range: reported), then TRAIN_FRONTEND_STEPS clipped det steps at
# TRAIN_FRONTEND_LAYERS of its layers, where they stay finite
TRAIN_FRONTEND_ARCH = "musicgen_large"
TRAIN_FRONTEND_STEPS = 3
TRAIN_FRONTEND_LAYERS = 24
# mamba2-130m (all 24 layers) through the training CLI, a crash at step 6
# restored from the step-4 checkpoint and replayed, against a clean run
TRAIN_CLI_ARGS = ["--arch", "mamba2_130m", "--steps", "12", "--ckpt-every", "4"]
TRAIN_CLI_FAIL_AT = 6
# one det step of the MoE and hybrid families at SMOKE width (f32) on the card
# against the CPU, held as the CPU parity tests hold the port to the
# reference: loss rtol 1e-4, momentum atol 2e-5 + 1e-2 x the leaf's largest
# |grad|, masters atol 2e-5 + 1e-2 x the leaf's largest update
TRAIN_SMOKE_ARCHS = ("moonshot_v1_16b_a3b", "jamba_1_5_large")
TRAIN_SMOKE_TOL = 1e-2

# VGG-16's xnor convs at batch 4: (input NHWC shape, output channels).
VGG_XNOR_CONVS = [((4, 16, 16, 64), 128), ((4, 16, 16, 128), 128),
                  ((4, 8, 8, 128), 256), ((4, 8, 8, 256), 256), ((4, 8, 8, 256), 256),
                  ((4, 4, 4, 256), 512), ((4, 4, 4, 512), 512), ((4, 4, 4, 512), 512),
                  ((4, 2, 2, 512), 512), ((4, 2, 2, 512), 512), ((4, 2, 2, 512), 512)]


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def fmt_count(n: float | None) -> str:
    return "not measured" if n is None else f"{n:g}"


class LmTraining:
    """Phase 6j: Alg.-1 training of the decoder LMs on the card (see the
    TRAIN_* constants). ``card`` is nvidia-smi's name and power limit,
    printed with every number; ``launch_counts()`` reads the port kernels'
    counters and ``zero_counts()`` sets them to 0: training must launch
    none. Each section fills ``rows`` for the summary."""

    def __init__(self, card: str, launch_counts, zero_counts):
        self.card, self.launch_counts, self.zero_counts = card, launch_counts, zero_counts
        self.rows: dict = {}

    def run(self) -> dict:
        for section in (self.full_lm, self.cut, self.frontend, self.cli, self.smoke):
            t0 = time.perf_counter()
            section()
            print(f"  ({section.__name__}: {time.perf_counter() - t0:.1f} s)")
        return self.rows

    # -- helpers ---------------------------------------------------------------------
    @staticmethod
    def leaves(tree):
        from repro_torch.engine.plan import tree_leaves_with_path

        return list(tree_leaves_with_path(tree))

    def check(self, tag, state, m):
        """Finite loss and xent, clipped masters, no port kernel launched."""
        import torch

        from repro_torch.core.policy import DEFAULT_POLICY

        for k in ("loss", "xent"):
            if not torch.isfinite(m[k]).item():
                raise AssertionError(f"{tag}: {k} is {float(m[k])}")
        top = max(float(t.abs().max()) for p, t in self.leaves(state["params"])
                  if DEFAULT_POLICY.selects(p))
        if top > 1.0:
            raise AssertionError(f"{tag}: a binarized master reaches |w| = {top}")
        if any(self.launch_counts().values()):
            raise AssertionError(f"{tag}: training launched a port kernel "
                                 f"{self.launch_counts()}")

    @staticmethod
    def step_fn(cfg, mode, clip=None):
        """The CLI's step (SGD momentum at its constant rate, the LM loss).
        With ``clip``, the grads are scaled to that global norm, its squares
        summed in f64 (see TRAIN_LM_GRAD_CLIP), and the metrics'
        ``grad_norm`` is the norm before. That step's update runs SGD
        momentum a leaf at a time and lets each grad go once its leaf is
        updated (it empties the step's grads tree, which the step does not
        read after the update): StarCoder2-3B's whole-tree update (5 x 12.7
        GB at once) ran out of memory after the earlier phases, with 9-11
        GiB of the card's cache fragmented."""
        import torch

        from repro_torch.core.policy import DEFAULT_POLICY
        from repro_torch.engine.plan import tree_leaves_with_path, tree_unflatten
        from repro_torch.optim import schedules
        from repro_torch.optim.sgd import Optimizer, sgd_momentum
        from repro_torch.train import steps as ST

        opt = sgd_momentum(schedules.constant(TRAIN_LM["lr"]))
        loss_fn = ST.make_lm_loss(cfg)
        if clip is None:
            return ST.make_train_step(loss_fn, opt, mode, DEFAULT_POLICY)
        seen = {}

        def clipped_update(grads, opt_state, params, step):
            gs = [g for _, g in tree_leaves_with_path(grads)]
            grads.clear()
            sq = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float64) ** 2
                              for g in gs]).sum()
            norm = torch.sqrt(sq).to(torch.float32)
            factor = torch.clamp(clip / (norm + 1e-9), max=1.0)
            mus = [m for _, m in tree_leaves_with_path(opt_state["mu"])]
            new_p, new_mu = [], []
            for (_, p), m in zip(tree_leaves_with_path(params), mus):
                (p1,), o = opt.update([gs.pop(0) * factor], {"mu": [m]}, [p], step)
                new_p.append(p1)
                new_mu.append(o["mu"][0])
            seen["grad_norm"] = norm
            return tree_unflatten(params, new_p), {"mu": tree_unflatten(params, new_mu)}

        inner = ST.make_train_step(loss_fn, Optimizer(opt.init, clipped_update), mode,
                                   DEFAULT_POLICY)

        def step(state, batch):
            new, m = inner(state, batch)
            return new, {**m, "grad_norm": seen.pop("grad_norm")}

        return step

    def cli_step_once(self, tag, step_fn, state, batch) -> dict:
        """One step of the CLI's own step function (no clipping) from
        ``state``: its loss, largest |grad| (the momentum from zero), how
        many grad leaves hold a non-finite value, and the largest master
        after it; the new state is dropped."""
        import torch

        new, m = step_fn(state, batch)
        grads = [t for _, t in self.leaves(new["opt"]["mu"])]
        r = {"loss": float(m["loss"]),
             "grad": max(float(t.abs().max()) for t in grads),
             "nonfinite_leaves": sum(not bool(torch.isfinite(t).all()) for t in grads),
             "master": max(float(t.abs().max()) for _, t in self.leaves(new["params"]))}
        print(f"  {tag}, the CLI's step without clipping: loss {r['loss']:.6f}, largest "
              f"|grad| {r['grad']:.3g} ({r['nonfinite_leaves']} of {len(grads)} grad leaves "
              f"not finite), largest |master| after it {r['master']:.3g} [{self.card}]")
        del new, grads
        torch.cuda.empty_cache()
        return r

    def timed_step(self, step_fn, state, batch, profile=False):
        """(new state, metrics, wall ms, device ms, device launches): one
        synchronised step; under torch.profiler when ``profile`` (its wall
        then includes the profiler's cost)."""
        import torch
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        prof = (torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                if profile else contextlib.nullcontext())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof:
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        dev_ms = n_launch = None
        if profile:
            ev = [e for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
            if ev:
                dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
                n_launch = sum(e.count for e in ev)
        return state, m, wall, dev_ms, n_launch

    def run_steps(self, tag, holder, steps, live, reckoned_gb):
        """Runs ``steps`` [(mode, step_fn, batch)] from the state in the list
        ``holder`` (taken out, so no caller keeps a state a step replaces),
        checking each and profiling the second det step. Returns
        (state, per-step rows, peak allocated GB above ``live``, the bytes
        allocated before the state was built)."""
        import torch

        state = holder.pop()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, seen = [], {}
        for i, (mode, step_fn, batch) in enumerate(steps):
            seen[mode] = seen.get(mode, 0) + 1
            profile = seen[mode] == 2 and mode == "det"
            state, m, wall, dms, nl = self.timed_step(step_fn, state, batch, profile=profile)
            self.check(f"{tag} step {i + 1} ({mode})", state, m)
            r = {"mode": mode, "loss": float(m["loss"]), "xent": float(m["xent"]),
                 "lb_loss": float(m["lb_loss"]), "grad_norm": float(m["grad_norm"]),
                 "wall_ms": wall, "device_ms": dms, "launches": nl, "profiled": profile}
            out.append(r)
            print(f"    step {i + 1} ({mode}): loss {r['loss']:.6f}, xent {r['xent']:.6f}, "
                  f"grad norm before the clip {r['grad_norm']:.3g}, wall {wall:.1f} ms"
                  f"{' (profiled)' if r['profiled'] else ''}, device {fmt(dms)} ms in "
                  f"{fmt_count(nl)} device kernel launches; masters clipped, 0 port kernel "
                  f"launches [{self.card}]")
        peak = (torch.cuda.max_memory_allocated() - live) / 1e9
        print(f"  {tag}: peak allocated {peak:.2f} GB, the state included (reckoned "
              f"{reckoned_gb:.1f} GB) [{self.card}]")
        return state, out, peak

    @staticmethod
    def reckon_gb(leaves) -> float:
        """Peak of a clipped step in f32 bytes, activations left out: the
        larger of the backward's end (masters, momentum, grads and the +-1
        copies of the selected masters) and the update's, leaf by leaf in
        ``leaves``' order (masters and momentum; at leaf i the new masters
        and momentum of the leaves before it, the grads of it and of those
        after it, and its new momentum, new masters and one temporary)."""
        from repro_torch.core.policy import DEFAULT_POLICY

        sizes = [t.numel() for _, t in leaves]
        n = sum(sizes)
        n_sel = sum(t.numel() for p, t in leaves if DEFAULT_POLICY.selects(p))
        done = update = 0
        for size in sizes:
            update = max(update, 2 * n + 2 * done + (n - done) + 3 * size)
            done += size
        return max(3 * n + n_sel, update) * 4 / 1e9

    def rel_errors(self, got, want, old=None, only=None) -> dict:
        """Per leaf (of the paths in ``only``, when given): the relative l2
        error ||got - want|| / ||want|| (of the update from ``old`` when
        given), in f64 on the card; leaves whose ``want`` is 0 skipped."""
        import torch

        out = {}
        olds = dict(self.leaves(old)) if old is not None else None
        for (p, x), (_, y) in zip(self.leaves(got), self.leaves(want)):
            if only is not None and p not in only:
                continue
            x, y = x.to("cuda", torch.float64), y.to("cuda", torch.float64)
            if olds is not None:
                o = olds[p].to("cuda", torch.float64)
                x, y = x - o, y - o
            ref = float(y.norm())
            if ref > 0.0:
                out[p] = float((x - y).norm()) / ref
        return out

    # -- sections --------------------------------------------------------------------
    def full_lm(self):
        """StarCoder2-3B at full width and depth: the CLI's step once, then
        det and stoch steps with the grads clipped; the twin's share."""
        import torch

        from repro_torch.configs import base as cb
        from repro_torch.core import prng
        from repro_torch.core.policy import DEFAULT_POLICY
        from repro_torch.launch import train as train_cli

        cfg = cb.get_config(TRAIN_LM_ARCH)
        print(f"== training {TRAIN_LM_ARCH} at its full CONFIG ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
              f"remat {cfg.remat!r}) through launch.train.build_lm, {TRAIN_LM}: "
              f"{TRAIN_LM_STEPS} steps [{self.card}]")
        self.zero_counts()
        torch.cuda.empty_cache()
        live = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, cli_step, batch_fn = train_cli.build_lm(TRAIN_LM_ARCH, binarize="det",
                                                       device="cuda", **TRAIN_LM)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        sizes = [t.numel() for _, t in self.leaves(state["params"])]
        reckoned = self.reckon_gb(self.leaves(state["params"]))
        print(f"  {sum(sizes) / 1e9:.3f} B parameters, init {init_s:.2f} s on the card")
        diverge = self.cli_step_once(TRAIN_LM_ARCH, cli_step, state, batch_fn(0))
        del cli_step
        fns = {mode: self.step_fn(cfg, mode, TRAIN_LM_GRAD_CLIP) for mode in TRAIN_LM_STEPS}
        modes = [mode for mode in TRAIN_LM_STEPS for _ in range(TRAIN_LM_STEPS[mode])]
        steps = [(mode, fns[mode], batch_fn(i)) for i, mode in enumerate(modes)]
        # the twin's share of a stoch step: its uniform draws over every selected
        # master, timed alone (CUDA events), at the first stoch step's key
        sel = [t for p, t in self.leaves(state["params"]) if DEFAULT_POLICY.selects(p)]
        keys = prng.split(prng.fold_in(state["key"], TRAIN_LM_STEPS["det"]), len(sel))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for k, t in zip(keys, sel):
            prng.uniform(k, t.shape, t.device)
        b.record()
        torch.cuda.synchronize()
        twin_ms = a.elapsed_time(b)
        n_sel = sum(t.numel() for t in sel)
        del sel
        holder = [state]
        del state
        state, out, peak = self.run_steps(TRAIN_LM_ARCH, holder, steps, live, reckoned)
        stoch = [r["wall_ms"] for r in out if r["mode"] == "stoch" and not r["profiled"]]
        print(f"  the twin's uniforms over the {n_sel / 1e9:.3f} G selected masters: "
              f"{twin_ms:.1f} ms, {100 * twin_ms / stoch[0]:.1f}% of the first stoch step's "
              f"wall {stoch[0]:.1f} ms [{self.card}]")
        self.rows["lm"] = {"params_b": sum(sizes) / 1e9, "steps": out, "peak_gb": peak,
                           "reckoned_gb": reckoned, "twin_ms": twin_ms, "init_s": init_s,
                           "diverge": diverge}
        del state, steps, fns
        torch.cuda.empty_cache()

    def cut(self):
        """StarCoder2-3B at full width cut to TRAIN_LM_CPU_LAYERS layers, the
        TRAIN_LM_CUT_RUNS on the card and on the CPU."""
        import dataclasses

        import torch

        from repro_torch.configs import base as cb
        from repro_torch.core import binarize as B
        from repro_torch.core import prng
        from repro_torch.core.policy import DEFAULT_POLICY
        from repro_torch.engine.plan import tree_map
        from repro_torch.launch import train as train_cli
        from repro_torch.train import steps as ST

        kw = dict(TRAIN_LM, batch=TRAIN_LM_CUT_BATCH)
        print(f"== training {TRAIN_LM_ARCH} at full width cut to {TRAIN_LM_CPU_LAYERS} "
              f"layers, {kw}, on the card and on the CPU from the same masters and batches: "
              f"{TRAIN_LM_CUT_RUNS} (activations, mode, steps); step 1's grads also against "
              f"f64 on the card; held: losses {TRAIN_LM_LOSS_RTOL}, the head's momentum and "
              f"update (relative l2) {TRAIN_LM_HEAD_TOL}, every other leaf's "
              f"{TRAIN_LM_REST_TOL} [{self.card}]")
        self.rows["cut"] = {}
        base = dataclasses.replace(cb.get_config(TRAIN_LM_ARCH), n_layers=TRAIN_LM_CPU_LAYERS)
        for dtype, mode, n_steps in TRAIN_LM_CUT_RUNS:
            self.zero_counts()
            state, _, batch_fn = train_cli.build_lm(
                TRAIN_LM_ARCH, binarize=mode, device="cuda", n_layers=TRAIN_LM_CPU_LAYERS, **kw)
            g64 = ST.binarized_value_and_grad(
                ST.make_lm_loss(dataclasses.replace(base, dtype="float64")),
                tree_map(lambda t: t.double(), state["params"]), batch_fn(0), mode=mode,
                policy=DEFAULT_POLICY, key=prng.fold_in(state["key"], 0))[1]
            step_fn = self.step_fn(dataclasses.replace(base, dtype=dtype), mode)
            flips, cpu_s, losses, heads = [], 0.0, [], []
            for i in range(n_steps):
                cpu_state = {k: (v if k == "key" else tree_map(lambda t: t.cpu(), v))
                             for k, v in state.items()}
                batch = batch_fn(i)
                key = prng.fold_in(state["key"], int(state["step"]))
                wb = B.binarize_tree(state["params"], mode, DEFAULT_POLICY, key)
                wb_cpu = B.binarize_tree(cpu_state["params"], mode, DEFAULT_POLICY, key)
                flips.append(sum(int((x.cpu() != y).sum()) for (p, x), (_, y) in zip(
                    self.leaves(wb), self.leaves(wb_cpu)) if DEFAULT_POLICY.selects(p)))
                del wb, wb_cpu
                if flips[-1]:
                    raise AssertionError(f"{dtype} {mode} cut step {i + 1}: the binarized "
                                         f"weights differ on the card")
                new, m = step_fn(state, batch)
                t0 = time.perf_counter()
                new_cpu, m_cpu = step_fn(cpu_state, tree_map(lambda t: t.cpu(), batch))
                cpu_s += time.perf_counter() - t0
                self.check(f"{dtype} {mode} cut step {i + 1}", new, m)
                losses.append((float(m["loss"]), float(m_cpu["loss"])))
                mu = self.rel_errors(new["opt"]["mu"], new_cpu["opt"]["mu"])
                upd = self.rel_errors(new["params"], new_cpu["params"], state["params"])
                held = {**{f"{p} momentum": e for p, e in mu.items()},
                        **{f"{p} update": e for p, e in upd.items()}}
                head = {k: e for k, e in held.items() if k.split()[0] in TRAIN_LM_HEAD_LEAVES}
                rest = {k: e for k, e in held.items() if k not in head}
                heads.append(max(head.values()))
                if heads[-1] > TRAIN_LM_HEAD_TOL[dtype]:
                    raise AssertionError(f"{dtype} {mode} cut step {i + 1}: the head's "
                                         f"momentum or update, card vs CPU: {head}")
                if dtype in TRAIN_LM_REST_TOL and max(rest.values()) > TRAIN_LM_REST_TOL[dtype]:
                    raise AssertionError(f"{dtype} {mode} cut step {i + 1}: a leaf's "
                                         f"momentum or update, card vs CPU: {rest}")
                if i == 0:
                    # from zero, the momentum is the step's grads
                    err = {"grads card vs CPU": mu, "update card vs CPU": upd,
                           "grads card vs f64": self.rel_errors(new["opt"]["mu"], g64),
                           "grads CPU vs f64": self.rel_errors(new_cpu["opt"]["mu"], g64)}
                    for what, per_leaf in err.items():
                        print(f"    {dtype} {mode} step 1, {what} (relative l2): "
                              + ", ".join(f"{p} {e:.3g}" for p, e in per_leaf.items()))
                loss, loss_cpu = losses[-1]
                print(f"    {dtype} {mode} step {i + 1}: loss {loss:.6f} (CPU {loss_cpu:.6f}), "
                      f"binarized weights differing from the CPU's {flips[-1]}, momentum and "
                      f"update card vs CPU (relative l2): the head's within {heads[-1]:.3g}, "
                      f"the other leaves' within {max(rest.values()):.3g}"
                      f"{'' if dtype in TRAIN_LM_REST_TOL else ' (not held)'} [{self.card}]")
                if not abs(loss - loss_cpu) <= TRAIN_LM_LOSS_RTOL[dtype] * abs(loss_cpu):
                    raise AssertionError(f"{dtype} {mode} cut step {i + 1}: loss {loss} vs "
                                         f"CPU {loss_cpu}")
                state = new
            self.rows["cut"][(dtype, mode)] = {
                "flips": flips, "losses": losses, "cpu_s": cpu_s, "heads": heads,
                "head": {k: max(e for p, e in v.items() if p in TRAIN_LM_HEAD_LEAVES)
                         for k, v in err.items()},
                "rest": {k: max(e for p, e in v.items() if p not in TRAIN_LM_HEAD_LEAVES)
                         for k, v in err.items()}}
            print(f"    ({dtype} {mode}: {cpu_s:.1f} s of CPU steps)")
            del state, cpu_state, new, new_cpu, g64
            torch.cuda.empty_cache()

    def frontend(self):
        """musicgen-large at full width from frame embeddings: the CLI's step
        at all 48 layers once, then clipped det steps at
        TRAIN_FRONTEND_LAYERS."""
        import dataclasses

        import torch

        from repro_torch.configs import base as cb
        from repro_torch.core import prng
        from repro_torch.data import synthetic as syn
        from repro_torch.launch import train as train_cli
        from repro_torch.models import frontends

        cfg = cb.get_config(TRAIN_FRONTEND_ARCH)
        spec = syn.SyntheticSpec("lm", batch_size=TRAIN_LM["batch"], seq_len=TRAIN_LM["seq"],
                                 vocab_size=cfg.vocab_size, seed=TRAIN_LM["seed"])

        def batch(i):
            """The stub's frame embeddings (B, S, d_model), lm_tokens labels."""
            return {"tokens": frontends.frame_embeddings(
                        prng.key(100 + i), TRAIN_LM["batch"], TRAIN_LM["seq"], cfg.d_model,
                        device="cuda"),
                    "labels": syn.lm_tokens(spec, i, device="cuda")[:, 1:]}

        print(f"== training {TRAIN_FRONTEND_ARCH} at full width (d_model {cfg.d_model}, "
              f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) from "
              f"frontends.frame_embeddings ({TRAIN_LM['batch']}, {TRAIN_LM['seq']}, "
              f"{cfg.d_model}) with lm_tokens labels: the CLI's step at all "
              f"{cfg.n_layers} layers, then {TRAIN_FRONTEND_STEPS} det steps at "
              f"{TRAIN_FRONTEND_LAYERS} layers [{self.card}]")
        self.zero_counts()
        torch.cuda.empty_cache()
        state, cli_step, _ = train_cli.build_lm(TRAIN_FRONTEND_ARCH, binarize="det",
                                                device="cuda", **TRAIN_LM)
        full = self.cli_step_once(f"all {cfg.n_layers} layers", cli_step, state, batch(0))
        del state, cli_step
        torch.cuda.empty_cache()
        live = torch.cuda.memory_allocated()
        state, _, _ = train_cli.build_lm(TRAIN_FRONTEND_ARCH, binarize="det", device="cuda",
                                         n_layers=TRAIN_FRONTEND_LAYERS, **TRAIN_LM)
        sizes = [t.numel() for _, t in self.leaves(state["params"])]
        reckoned = self.reckon_gb(self.leaves(state["params"]))
        step_fn = self.step_fn(dataclasses.replace(cfg, n_layers=TRAIN_FRONTEND_LAYERS), "det",
                               TRAIN_LM_GRAD_CLIP)
        steps = [("det", step_fn, batch(i)) for i in range(TRAIN_FRONTEND_STEPS)]
        holder = [state]
        del state
        state, out, peak = self.run_steps(f"{TRAIN_FRONTEND_ARCH} at {TRAIN_FRONTEND_LAYERS} "
                                          f"layers", holder, steps, live, reckoned)
        self.rows["frontend"] = {"params_b": sum(sizes) / 1e9, "steps": out, "peak_gb": peak,
                                 "reckoned_gb": reckoned, "full": full}
        del state, steps, step_fn
        torch.cuda.empty_cache()

    def cli(self):
        """mamba2-130m through the training CLI: a crash, a restore, a
        replay, against a clean run."""
        import shutil

        import torch

        from repro_torch.launch import train as train_cli

        ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
        argv = TRAIN_CLI_ARGS + ["--ckpt-dir"]
        print(f"== training CLI: python -m repro_torch.launch.train "
              f"{' '.join(TRAIN_CLI_ARGS)} --fail-at {TRAIN_CLI_FAIL_AT} (all 24 layers, full "
              f"width), against the same run without the crash [{self.card}]")
        shutil.rmtree(ckpt_root, ignore_errors=True)
        self.zero_counts()
        t0 = time.perf_counter()
        crash = train_cli.main(argv + [str(ckpt_root / "crash"), "--fail-at",
                                       str(TRAIN_CLI_FAIL_AT)])
        crash_s = time.perf_counter() - t0
        clean = train_cli.main(argv + [str(ckpt_root / "clean")])
        if any(self.launch_counts().values()):
            raise AssertionError(f"the training CLI launched a port kernel "
                                 f"{self.launch_counts()}")
        if crash.recoveries != 1:
            raise AssertionError(f"expected 1 recovery, got {crash.recoveries}")
        pairs = list(zip(self.leaves(crash.state["params"]), self.leaves(clean.state["params"])))
        if not all(torch.isfinite(y).all() for _, (_, y) in pairs):
            raise AssertionError("the clean run's final masters are not finite")
        differ = [p for (p, x), (_, y) in pairs if not torch.equal(x, y)]
        last = clean.history[-1] if clean.history else {}
        print(f"  recoveries {crash.recoveries}; the crash run's final masters "
              f"{'equal' if not differ else 'differ from'} the clean run's "
              f"{'bit for bit' if not differ else differ} after {int(crash.state['step'])} "
              f"steps (the crash run {crash_s:.2f} s, checkpoints and replay included; last "
              f"logged loss {last.get('loss', float('nan')):.6f}) [{self.card}]")
        if differ:
            raise AssertionError(f"the replayed run ends away from the clean run: {differ}")
        self.rows["cli"] = {"recoveries": crash.recoveries, "crash_s": crash_s,
                            "loss": last.get("loss")}
        del crash, clean
        shutil.rmtree(ckpt_root, ignore_errors=True)
        torch.cuda.empty_cache()

    def smoke(self):
        """Moonlight and jamba at SMOKE width: one det step, card vs CPU."""
        import torch

        from repro_torch.engine.plan import tree_map
        from repro_torch.launch import train as train_cli

        print(f"== training {', '.join(TRAIN_SMOKE_ARCHS)} at SMOKE width (f32), one det step "
              f"on the card against the CPU (loss rtol 1e-4; momentum and masters atol 2e-5 + "
              f"{TRAIN_SMOKE_TOL:g} x the leaf's largest grad / update) [{self.card}]")
        self.rows["smoke"] = {}
        for arch in TRAIN_SMOKE_ARCHS:
            self.zero_counts()
            state, step_fn, batch_fn = train_cli.build_lm(arch, binarize="det", smoke=True,
                                                          device="cuda", batch=4, seq=16)
            cpu_state = {k: (v if k == "key" else tree_map(lambda t: t.cpu(), v))
                         for k, v in state.items()}
            batch = batch_fn(0)
            new, m = step_fn(state, batch)
            new_cpu, m_cpu = step_fn(cpu_state, tree_map(lambda t: t.cpu(), batch))
            self.check(f"{arch} SMOKE", new, m)
            worst = {}
            for name in ("mu", "params"):
                got = new["opt"]["mu"] if name == "mu" else new["params"]
                want = new_cpu["opt"]["mu"] if name == "mu" else new_cpu["params"]
                worst[name] = 0.0
                for (p, x), (_, y), (_, o) in zip(self.leaves(got), self.leaves(want),
                                                  self.leaves(cpu_state["params"])):
                    scale = float((y if name == "mu" else y - o).abs().max())
                    d = float((x.cpu().double() - y.double()).abs().max())
                    worst[name] = max(worst[name], d / max(scale, 1e-30))
                    if d > 2e-5 + TRAIN_SMOKE_TOL * scale:
                        raise AssertionError(f"{arch} SMOKE {name} {p}: card vs CPU {d:.3g} "
                                             f"(scale {scale:.3g})")
            for k in ("loss", "xent", "lb_loss"):
                a_, b_ = float(m[k]), float(m_cpu[k])
                if not abs(a_ - b_) <= 1e-4 * abs(b_) + 1e-7:
                    raise AssertionError(f"{arch} SMOKE {k}: card {a_} vs CPU {b_}")
            router = [p for p, _ in self.leaves(new["opt"]["mu"]) if "router" in p]
            print(f"  {arch}: loss {float(m['loss']):.6f} (CPU {float(m_cpu['loss']):.6f}), "
                  f"lb_loss {float(m['lb_loss']):.6f} (CPU {float(m_cpu['lb_loss']):.6f}); "
                  f"momentum (grads; {', '.join(router)} among them) within "
                  f"{worst['mu']:.3g} of the leaf's largest, masters within "
                  f"{worst['params']:.3g} of its largest update [{self.card}]")
            self.rows["smoke"][arch] = {"loss": float(m["loss"]),
                                        "loss_cpu": float(m_cpu["loss"]),
                                        "lb": float(m["lb_loss"]),
                                        "lb_cpu": float(m_cpu["lb_loss"]), **worst}
            del state, cpu_state, new, new_cpu
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.kernels.ops as kops_mod
    import repro_torch.xnor.conv.ops as cops_mod
    import repro_torch.xnor.ops as xops_mod
    from repro_torch.core import prng
    from repro_torch.core.packing import unpack_bits
    from repro_torch.core.policy import make_paper_policy
    from repro_torch.engine import ExecutionPlan, compile_plan
    from repro_torch.engine.plan import tree_leaves_with_path, tree_map
    from repro_torch.kernels import _build
    from repro_torch.kernels.binary_matmul import (binary_matmul, binary_matmul_batched,
                                                   binary_matmul_batched_plain,
                                                   binary_matmul_plain)
    from repro_torch.kernels.stoch_binarize import binarize_pack, binarize_pack_plain
    from repro_torch.launch.serve import build_model, serve_classifier
    from repro_torch.models import mnist_fc, vgg
    from repro_torch.models.layers import XnorConv, apply_conv2d, conv2d_nhwc
    from repro_torch.stoch import ensemble_forward, ensemble_stats, sample_replicas
    from repro_torch.xnor import cases as k3_cases
    from repro_torch.xnor.conv import cases as k5_cases
    from repro_torch.xnor.conv.kernel import patch_pack, patch_pack_plain, patch_pack_tiles
    from repro_torch.xnor.conv.ops import xnor_conv2d
    from repro_torch.xnor.conv.packing import conv_geometry, pack_conv_kernel
    from repro_torch.xnor.kernel import (ConvBorder, bn_sign, bn_sign_pack,
                                         bn_sign_pack_plain, bn_sign_plain, sign_pack,
                                         sign_pack_plain, xnor_matmul, xnor_matmul_plain)
    from repro_torch.xnor.packing import unpack_activations
    from repro_torch.core.binarize import deterministic_binarize
    from repro_torch.models.layers import batch_norm

    torch.backends.cuda.matmul.allow_tf32 = False    # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # name -> (wrapper, its counter attribute); binarize_pack counts its
    # on-chip-PRNG launches apart as well, and sign_pack those with the
    # batch-norm prologue (bn_sign_pack's)
    counters = {"binarize_pack": (binarize_pack, "launches"),
                "binarize_pack_on_chip": (binarize_pack, "launches_on_chip"),
                "binary_matmul": (binary_matmul, "launches"),
                "binary_matmul_batched": (binary_matmul_batched, "launches"),
                "sign_pack": (sign_pack, "launches"),
                "sign_pack_fused": (sign_pack, "launches_fused"),
                "xnor_matmul": (xnor_matmul, "launches"), "patch_pack": (patch_pack, "launches"),
                "bn_sign": (bn_sign, "launches")}

    def launch_counts() -> dict[str, int]:
        return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}

    @contextlib.contextmanager
    def plain_kernels():
        """Every call site of a kernel wrapper takes its plain version, on
        whatever device the tensors are; no kernel may launch meanwhile."""
        swaps = [(kops_mod, "binarize_pack",
                  lambda w, bits=None, *, stochastic: binarize_pack_plain(
                      w, bits, stochastic=stochastic)),
                 (kops_mod, "_binary_matmul", binary_matmul_plain),
                 (kops_mod, "_binary_matmul_batched", binary_matmul_batched_plain),
                 (xops_mod, "_sign_pack", sign_pack_plain),
                 (xops_mod, "_bn_sign_pack", bn_sign_pack_plain),
                 (xops_mod, "_bn_sign", bn_sign_plain),
                 (xops_mod, "_xnor_matmul", xnor_matmul_plain),
                 (cops_mod, "patch_pack", patch_pack_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        before = launch_counts()
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        if launch_counts() != before:
            raise AssertionError("a kernel launched inside plain_kernels()")

    @contextlib.contextmanager
    def record_signs(module, into: list):
        """Records the model's sign activations (> 0): the outputs of its
        bn_sign sites, and the bits its fused K3 sites pack."""
        orig, orig_fused = module.bn_sign, module.bn_sign_words

        def rec(x, *vecs):
            out = orig(x, *vecs)
            into.append((out > 0).cpu())
            return out

        def rec_fused(x, *vecs):
            sw = orig_fused(x, *vecs)
            into.append((unpack_activations(sw.words)[..., : sw.k] > 0).cpu())
            return sw

        module.bn_sign, module.bn_sign_words = rec, rec_fused
        try:
            yield
        finally:
            module.bn_sign, module.bn_sign_words = orig, orig_fused

    @contextlib.contextmanager
    def unfused(module):
        """The model's forward with every sign site off K3's prologue: bn_sign
        (bias add, eval batch norm and sign in one kernel), then K3 packs
        its +-1 output."""
        orig = module.takes_sign_words
        module.takes_sign_words = lambda w: False
        try:
            yield
        finally:
            module.takes_sign_words = orig

    def profiled(fn, reps: int) -> dict[str, float] | None:
        """Device time per rep of each CUDA kernel ``fn`` launches, in ms, by
        kernel name, from torch.profiler; None if the profiler records no
        device activity on this machine."""
        events = profile_events(fn, reps)
        if events is None:
            return None
        return {k: t / reps / 1e3 for k, (t, _) in events.items()} or None

    def kernels_per_rep(fn, reps: int = 20) -> float | None:
        """Device kernels ``fn`` launches per rep, counted by torch.profiler."""
        events = profile_events(fn, reps)
        return None if not events else sum(c for _, c in events.values()) / reps

    def profile_events(fn, reps: int) -> dict[str, tuple[float, int]] | None:
        """(device us, launches) over ``reps`` reps of ``fn``, by CUDA kernel
        name; None if the profiler could not start or stop."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        # only entering and leaving the profiler may fail here (no CUPTI);
        # a fault of the kernels surfaces at the synchronize outside the try
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        try:
            prof.__enter__()
        except RuntimeError as e:
            print(f"  torch.profiler failed to start ({e}); device times not measured")
            return None
        try:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        except BaseException:
            prof.__exit__(None, None, None)
            raise
        try:
            prof.__exit__(None, None, None)
        except RuntimeError as e:
            print(f"  torch.profiler failed to stop ({e}); device times not measured")
            return None
        return {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0}

    def device_ms(fn, kernel: str, reps: int = 20) -> float | None:
        """Device time of one launch of the named kernel inside ``fn`` (of
        each kernel whose name holds ``kernel``, summed): its time over the
        launches the profiler recorded. The profiler now and then records no
        event for a launch that ran, so the time is not divided by ``reps``
        (that reads low), and up to three profiles are taken."""
        for _ in range(3):
            events = profile_events(fn, reps)
            hits = [t / n / 1e3 for k, (t, n) in (events or {}).items() if kernel in k]
            if hits:
                return sum(hits)
        return None

    t_start = time.perf_counter()
    phase_start = {"1-2": t_start}   # phase -> perf_counter at its start
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print("== card (name, power limit)")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    print(f"== build: {lib_path.name} in {time.perf_counter() - t0:.1f}s")
    for line in (lib_path.parent / f"{lib_path.name}.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    g = torch.Generator(device=dev).manual_seed(1234)
    errs: dict[str, float] = {}

    def rand_words(shape):
        """Uniform uint32 test words, as int32 bit patterns."""
        return torch.randint(-(1 << 31), 1 << 31, tuple(shape), dtype=torch.int32,
                             generator=g, device=dev)

    def exact(tag, got, want):
        torch.cuda.synchronize()
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        print(f"  {tag}: out {tuple(got.shape)} {str(got.dtype)[6:]}, mismatched {bad}")
        if not torch.equal(got, want):
            raise AssertionError(f"{tag} differs from its plain version")

    phase_start["3"] = time.perf_counter()
    # 3. K1 against its plain version
    print("== K1 binarize_pack vs plain (exact)")
    for (k, n), dtype in [((2048, 2048), torch.float32), ((784, 2048), torch.float32),
                          ((784, 2048), torch.bfloat16), ((100, 300), torch.float32)]:
        w = torch.randn(k, n, generator=g, device=dev) * 0.7
        w[0], w[1], w[2], w[3, :7] = 1.0, -1.0, -0.0, float("nan")   # endpoints
        w[4] = torch.rand(n, generator=g, device=dev) + 1.0           # all-positive column
        w = w.to(dtype)
        bits = rand_words((k, n))
        top = torch.arange(k * 3, device=dev, dtype=torch.int32).reshape(k, 3) % 128
        bits[:, :3] = -1 - top                   # uint32 words >= 2^32 - 128
        for stoch in (False, True):
            mode = "stoch" if stoch else "det"
            exact(f"K1 {mode} {k}x{n} {str(dtype)[6:]}",
                  binarize_pack(w, bits if stoch else None, stochastic=stoch),
                  binarize_pack_plain(w, bits if stoch else None, stochastic=stoch))
            errs[f"k1_{mode}"] = 0.0

    print("== K1 binarize_pack on-chip Philox variant vs plain (exact)")
    # K < 32, K % 32 != 0, N % 32 != 0, and word rows past grid.y's 65,535
    for (k, n), dtype in [((2048, 2048), torch.float32), ((2048, 2048), torch.bfloat16),
                          ((512, 512), torch.float32), ((100, 300), torch.float32),
                          ((33, 1), torch.bfloat16), ((31, 5), torch.float32),
                          ((65, 33), torch.bfloat16), ((65535 * 32 + 100, 3), torch.float32)]:
        w = (torch.randn(k, n, generator=g, device=dev) * 0.7).to(dtype)
        seed = k * 7919 + n
        exact(f"K1 on-chip {k}x{n} {str(dtype)[6:]}",
              binarize_pack(w, stochastic=True, seed=seed, on_chip_prng=True),
              binarize_pack_plain(w, None, stochastic=True, seed=seed, on_chip_prng=True))
    # 512 columns per level; p = clip((w + 1) / 2, 0, 1); p = 0 and 1 must be exact
    w_levels = [-1.5, -1.0, -0.8, -0.5, 0.0, 0.5, 0.8, 1.0, 1.5]
    ps = [min(max((v + 1) / 2, 0.0), 1.0) for v in w_levels]
    w = torch.tensor(w_levels, device=dev).repeat_interleave(512)[None, :].expand(2048, -1)
    ones = unpack_bits(binarize_pack(w.contiguous(), stochastic=True, seed=99,
                                     on_chip_prng=True)) > 0
    fracs = ones.float().reshape(2048, len(ps), 512).mean(dim=(0, 2)).tolist()
    print("  Eq.-3 frequency over 2048x512 words per level: " + ", ".join(
        f"p={p} -> {f:.5f}" for p, f in zip(ps, fracs)))
    for p, f in zip(ps, fracs):
        if abs(f - p) > 4 * (p * (1 - p) / (2048 * 512)) ** 0.5:
            raise AssertionError(f"on-chip K1: frequency {f} at p={p} is off by > 4 sigma")
    errs["k1_onchip"] = 0.0

    print("== threefry twin (core.prng): words on the card vs the CPU, and stochastic "
          "packs on the card vs the CPU at the same key (exact)")
    tk = prng.split(prng.fold_in(prng.key(1), 2), 1)[0]
    # (2100, 2100): one whole chunk of the card's prng.WORDS_CHUNK and a ragged one
    for shape in [(2048, 2048), (1024, 2048), (2100, 2100), (300, 500)]:
        exact(f"twin bits {shape}", prng.bits(tk, shape, dev).cpu(), prng.bits(tk, shape))
    exact("twin uniform (3, 3, 64, 64)", prng.uniform(tk, (3, 3, 64, 64), dev).cpu(),
          prng.uniform(tk, (3, 3, 64, 64)))
    for arch in ("mnist_fc", "vgg16_cifar10"):
        tree, _, _, n_fc = build_model(arch, 0, device=dev)
        plan = compile_plan(tree["params"], make_paper_policy(n_fc), "stoch")
        on_card = plan.pack(tree["params"], key=prng.key(1))
        on_cpu = plan.pack(tree_map(lambda t: t.cpu(), tree["params"]), key=prng.key(1))
        n_leaves = 0
        for (path, a), (_, b) in zip(tree_leaves_with_path(on_card),
                                     tree_leaves_with_path(on_cpu)):
            if hasattr(a, "packed"):
                n_leaves += 1
                if not torch.equal(a.packed.cpu(), b.packed):
                    raise AssertionError(f"{arch} stoch {path}: card words differ from CPU")
        print(f"  {arch} stoch, full width: {n_leaves} packed leaves on the card == the "
              f"CPU pack at key(1)")
    errs["twin"] = 0.0

    # 4. K2 against its plain version
    print("== K2 binary_matmul vs plain")
    for m, k, n in [(4, 2048, 2048), (4, 512, 512), (256, 2048, 2048), (5, 100, 300)]:
        x32 = torch.randn(m, k, generator=g, device=dev)
        wp = binarize_pack(torch.randn(k, n, generator=g, device=dev), stochastic=False)
        scale = torch.rand(n, generator=g, device=dev) + 0.5
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x = x32.to(dtype)
            for s in (None, scale):
                got = binary_matmul(x, wp, s)
                want = binary_matmul_plain(x, wp, s)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                tag = (f"{m}x{k}x{n} {str(dtype)[6:]} "
                       f"{'scaled' if s is not None else 'unscaled'}")
                print(f"  {tag}: max_abs_err {err:.3e} (|want| max "
                      f"{want.abs().max().item():.3e})")
                torch.testing.assert_close(got, want, **tol, msg=f"K2 {tag}")
                if m == 4 and dtype == torch.float32 and s is not None:
                    errs[f"k2_{k}"] = err
                again = [binary_matmul(x, wp, s) for _ in range(3)]
                if not all(torch.equal(a, got) for a in again):
                    raise AssertionError(f"K2 {tag}: two calls differ")
    print("  every case bit-identical over 4 calls")
    print(f"== K2 at {LM_ARCH}'s projection shapes, bf16 (decode M=4, prefill M=32), scaled: "
          f"f32 tolerance (products with +-1 are exact, both sides sum in f32)")
    lm_k2_cases = [(m, k, n, "k2_lm") for m in (4, 32) for k, n in LM_KN]
    lm_k2_cases += [(m, k, n, "k2_ssm") for m in (4, SSM_LONG_PROMPT) for k, n in SSM_KN]
    lm_k2_cases += [(m, k, n, "k2_mesh") for m in (2, 32) for k, n in LM_MESH_K2]
    for m, k, n, key_ in lm_k2_cases:
        if key_ == "k2_ssm" and (m, k) == (4, SSM_KN[0][0]):
            print(f"== K2 at {SSM_ARCH}'s projection shapes, bf16 (decode M=4, a "
                  f"{SSM_LONG_PROMPT}-token prefill), scaled; in_proj's N = {SSM_KN[0][1]} "
                  f"is ragged against the 128-column tiles")
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        wp = binarize_pack(torch.randn(k, n, generator=g, device=dev), stochastic=False)
        scale = torch.rand(n, generator=g, device=dev) + 0.5
        for s_ in (scale, None) if key_ == "k2_ssm" else (scale,):
            got, want = binary_matmul(x, wp, s_), binary_matmul_plain(x, wp, s_)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"  {m}x{k}x{n} bf16 {'scaled' if s_ is not None else 'unscaled'}: "
                  f"max_abs_err {err:.3e} (|want| max {want.abs().max().item():.3e})")
            torch.testing.assert_close(got, want, **F32_TOL, msg=f"K2 LM {m}x{k}x{n}")
            if not torch.equal(binary_matmul(x, wp, s_), got):
                raise AssertionError(f"K2 LM {m}x{k}x{n}: two calls differ")
            if m == (2 if key_ == "k2_mesh" else 4):
                errs[key_] = max(errs.get(key_, 0.0), err)

    # 5. K3, K4, K5 against their plain versions, exact
    def acts(shape, dtype=torch.float32):
        x = torch.randn(shape, generator=g, device=dev)
        flat = x.view(-1)
        flat[: min(flat.numel(), 3)] = torch.tensor([0.0, -0.0, float("nan")],
                                                    device=dev)[: flat.numel()]
        return x.to(dtype)

    words = rand_words

    print("== K3 sign_pack vs plain (exact; 0.0, -0.0, NaN planted)")
    for (m, k) in [(4, 2048), (4, 512), (5, 100), (7, 33), (1024, 96)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = acts((m, k), dtype)
            exact(f"K3 {m}x{k} {str(dtype)[6:]}", sign_pack(x), sign_pack_plain(x))
    for (m, k) in [(4, 3072), (4, 12288), (32, 3072), (32, 12288)]:
        x = acts((m, k), torch.bfloat16)
        exact(f"K3 {LM_ARCH} input {m}x{k} bf16", sign_pack(x), sign_pack_plain(x))
    for m in (2, 32):
        for k in sorted({k for k, _, _ in LM_MESH_K4}):
            x = acts((m, k), torch.bfloat16)
            exact(f"K3 {LM_ARCH} mesh position input {m}x{k} bf16", sign_pack(x),
                  sign_pack_plain(x))
    for m in (4, SSM_LONG_PROMPT):
        for k, _ in SSM_KN:
            x = acts((m, k), torch.bfloat16)
            exact(f"K3 {SSM_ARCH} input {m}x{k} bf16", sign_pack(x), sign_pack_plain(x))

    print("== K3 with the producer prologue (bias, eval batch norm, Eq.-1 sign) vs its "
          "plain chain (exact; BN outputs 0.0, -0.0, NaN, 0 * inf, +-2^-149 planted, and "
          "exactly 0 or one step either side of it through the chain's own rounding)")
    for i, (m, k) in enumerate(k3_cases.FUSED_SHAPES + [k3_cases.PAST_GRID_SHAPE]):
        case = k3_cases.plant_near_zero(k3_cases.bn_inputs(m, k, 100 + i, dev))
        got = bn_sign_pack(*case)
        exact(f"K3 fused {m}x{k} f32 ({m * ((k + 31) // 32)} words)", got,
              bn_sign_pack_plain(*case))
    t0 = time.perf_counter()
    n_swept = k3_cases.rsqrt_sweep(dev)
    torch.cuda.synchronize()
    print(f"  rsqrt sweep: the prologue's rsqrtf equals torch.rsqrt on all {n_swept} "
          f"positive normal f32 values ({time.perf_counter() - t0:.1f}s; control: a 1-ulp "
          f"difference sets every bit)")
    errs["k3_fused"] = 0.0

    print("== the Eq.-1 threshold 2^-126: subnormals of both signs, 2^-126 and the next "
          "value, -2^-126, +-0 and NaN planted through K1 det, plain K3, fused K3 and K5 "
          "(exact against plain; planted bits +1 only at 2^-126 and above)")

    def planted(tag, bits, want):
        """``bits``: 0/1 with the planted dim last; ``want``: -1 where unplanted."""
        bits, m = bits.cpu().long(), want >= 0
        if not torch.equal(bits[..., m], want[m].expand_as(bits[..., m])):
            raise AssertionError(f"{tag}: a planted value signs against Eq. 1")
        print(f"  {tag}: {int(m.sum())} planted positions a row sign as Eq. 1 says")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        w = torch.randn(100, 40, generator=g, device=dev).to(dtype)
        want = k3_cases.plant_signs(w, 0)
        got = binarize_pack(w, stochastic=False)
        exact(f"K1 det 100x40 {name} planted", got, binarize_pack_plain(w, None, stochastic=False))
        planted(f"K1 det {name}", (unpack_bits(got)[:100] > 0).T, want)
        x = torch.randn(5, 100, generator=g, device=dev).to(dtype)
        want = k3_cases.plant_signs(x, 1)
        got = sign_pack(x)
        exact(f"K3 5x100 {name} planted", got, sign_pack_plain(x))
        planted(f"K3 {name}", unpack_activations(got)[:, :100] > 0, want)
        x = torch.randn(2, 5, 6, 40, generator=g, device=dev).to(dtype)
        want = k3_cases.plant_signs(x, 3)
        for ks, pad in (((1, 1), "VALID"), ((3, 3), "SAME")):
            got = patch_pack(x, ksize=ks, padding=pad)
            exact(f"K5 (2, 5, 6, 40) k={ks} {pad} {name} planted", got,
                  patch_pack_plain(x, ksize=ks, padding=pad))
        planted(f"K5 {name} (1x1 taps)", unpack_activations(
            patch_pack(x, ksize=(1, 1), padding="VALID"))[..., :40] > 0, want)
    for m, kk in [(4, 2048), (4, 512), (7, 100)]:
        case, want = k3_cases.plant_bn_signs(k3_cases.bn_inputs(m, kk, 300 + kk, "cpu"))
        case = tuple(t.to(dev) for t in case)
        got = bn_sign_pack(*case)
        exact(f"K3 fused {m}x{kk} f32, planted BN outputs", got, bn_sign_pack_plain(*case))
        planted(f"K3 fused {m}x{kk}", unpack_activations(got)[:, :kk] > 0, want)
    errs["eq1"] = 0.0

    print("== bn_sign (the flushed prologue and sign, unpacked) vs its plain version on the "
          "card (exact) at the sites it serves, ragged K and M * K past the grid; and a "
          "subnormal at each flushed step (xnor.cases.FLUSH_PLANTS) through bn_sign and "
          "fused K3 against the plain chain on the CPU, with the reference's bits")
    for i, (m, kk) in enumerate(dict.fromkeys(MNIST_BN_SIGN + VGG_BN_SIGN + [
            (7, 100), (3, 31), (70000, 300)])):
        case = k3_cases.plant_near_zero(k3_cases.bn_inputs(m, kk, 500 + i, dev))
        got = bn_sign(*case)
        exact(f"bn_sign {m}x{kk}", got, bn_sign_plain(*case))
        exact(f"bn_sign {m}x{kk} packed == fused K3", sign_pack(got), bn_sign_pack(*case))
    for m in (1, 5):
        for eps, case, bits in k3_cases.flush_cases(m, "cpu"):
            on_card = tuple(t.to(dev) for t in case)
            got = bn_sign(*on_card, eps=eps)
            exact(f"bn_sign flush plants M={m} eps={eps}", got.cpu(),
                  bn_sign_plain(*case, eps=eps))
            exact(f"fused K3 flush plants M={m} eps={eps}", bn_sign_pack(*on_card, eps=eps).cpu(),
                  bn_sign_pack_plain(*case, eps=eps))
            planted(f"bn_sign flush plants M={m} eps={eps}", got > 0, bits)
    for m, kk in [(4, 2048), (7, 100)]:
        case, want = k3_cases.plant_bn_signs(k3_cases.bn_inputs(m, kk, 700 + kk, "cpu"))
        got = bn_sign(*(t.to(dev) for t in case))
        exact(f"bn_sign {m}x{kk}, planted BN outputs", got.cpu(), bn_sign_plain(*case))
        planted(f"bn_sign {m}x{kk}", got > 0, want)
    errs["bn_sign"] = 0.0

    print("== K4 xnor_matmul vs plain (exact)")
    k4_cases = [(4, 64, 2048, 2048, "mnist_fc layers/1-2")]
    k4_cases += [(b * h * w_, 9 * (c // 32), n, 9 * c, f"vgg conv {b}x{h}x{w_}x{c}->{n}")
                 for (b, h, w_, c), n in VGG_XNOR_CONVS]
    k4_cases += [(4, 16, 512, 512, "vgg fc/1"), (5, 4, 300, 100, "ragged K=100"),
                 (33, 9 * 2, 65, 9 * 40, "extra words C=40"), (3, 1, 1, 7, "tiny"),
                 (65, 9 * 2, 65, 9 * 40, "extra words C=40, ragged 4-row group"),
                 (4096, 72, 256, 2304, "large M")]
    k4_cases += [(m, k // 32, n, k, f"{LM_ARCH} {'decode' if m == 4 else 'prefill'} {k}x{n}")
                 for m in (4, 32) for k, n in LM_KN]
    k4_cases += [(m, k // 32, n, k, f"{SSM_ARCH} {'decode' if m == 4 else 'prefill'} {k}x{n}")
                 for m in (4, SSM_LONG_PROMPT) for k, n in SSM_KN]
    k4_cases += [(m, k // 32, n, k, f"{LM_ARCH} mesh position {'decode' if m == 2 else 'prefill'}"
                                    f" {k}x{n}") for m in (2, 32) for k, n, _ in LM_MESH_K4]
    for m, wds, n, k, what in k4_cases:
        a, w = words((m, wds)), words((wds, n))
        for s in (None, torch.rand(n, generator=g, device=dev) + 0.5):
            tag = f"K4 {what} {m}x{wds}w x{n} k={k} {'scaled' if s is not None else 'int'}"
            exact(tag, xnor_matmul(a, w, s, k_total=k), xnor_matmul_plain(a, w, s, k_total=k))
    errs["k3"] = errs["k4"] = 0.0

    print("== K4 with the conv border correction and scale in its flush, through "
          "xnor_conv2d, vs the plain conv route on the CPU (exact)")
    fused_cases = [(shape, n, (3, 3), (1, 1), "SAME") for shape, n in VGG_XNOR_CONVS] + [
        ((2, 8, 8, 32), 48, (3, 3), (2, 2), "SAME"), ((2, 9, 7, 40), 65, (3, 3), (2, 2), "SAME"),
        ((1, 9, 7, 16), 32, (3, 3), (1, 1), "SAME"), ((2, 8, 8, 3), 16, (3, 3), (1, 1), "SAME"),
        ((1, 7, 7, 8), 8, (3, 3), (2, 2), "VALID"), ((2, 6, 6, 32), 32, (1, 1), (1, 1), "VALID"),
        ((1, 10, 6, 24), 40, (5, 3), (2, 1), "SAME"),
        ((1, 5, 6, 40), 8, (3, 3), (1, 1), ((2, 0), (1, 1)))]
    for shape, n, ks, st, pad in fused_cases:
        x = acts(shape)
        wk = torch.randn(*ks, shape[-1], n, generator=g, device=dev)
        for scaled in (False, True):
            leaf = XnorConv(pack_conv_kernel(wk), wk.abs().mean(dim=(0, 1, 2)) if scaled
                            else None, ks, shape[-1])
            kw = dict(ksize=ks, c_in=shape[-1], stride=st, padding=pad)
            cpu = leaf.to("cpu")
            exact(f"K4 fused conv {shape}->{n} k={ks} s={st} {pad} "
                  f"{'scaled' if scaled else 'int'}",
                  xnor_conv2d(x, leaf.packed, leaf.scale, tap_sums=leaf.tap_sums, **kw).cpu(),
                  xnor_conv2d(x.cpu(), cpu.packed, cpu.scale, **kw))

    print("== K2 and K4 one past the grid limits of earlier kernels")
    m = 65535 * 4 + 1
    x = torch.randn(m, 32, generator=g, device=dev)
    wp = binarize_pack(torch.randn(32, 8, generator=g, device=dev), stochastic=False)
    got = binary_matmul(x, wp)
    torch.testing.assert_close(got, binary_matmul_plain(x, wp), **F32_TOL)
    if not torch.equal(binary_matmul(x, wp), got):
        raise AssertionError("K2 at M = 65535 * 4 + 1: two calls differ")
    print(f"  K2 {m}x32x8 f32: within tolerance of plain, bit-identical over 2 calls")
    n = 65535 * 64 + 1
    for m in (4, 64):
        a, w4 = words((m, 1)), words((1, n))
        exact(f"K4 {m}x1w x{n}", xnor_matmul(a, w4, k_total=32),
              xnor_matmul_plain(a, w4, k_total=32))

    def acts_planted(shape, dtype):
        return k5_cases.planted_acts(shape, sum(shape), dtype, dev)

    print("== K5 patch_pack vs plain (exact; the tile each case launches with)")
    k5_cases_run = [(shape, (3, 3), (1, 1), "SAME", acts) for shape, _ in VGG_XNOR_CONVS]
    k5_cases_run += [((2, 9, 7, 40), (3, 3), (2, 2), "SAME", acts),
                     ((1, 7, 7, 8), (3, 3), (2, 2), "VALID", acts),
                     ((2, 10, 6, 24), (5, 3), (2, 1), ((2, 0), (1, 1)), acts)]
    # the edges of the tiling, a batch past grid.z's 65,535, and VGG's conv
    # inputs with 0.0 / -0.0 / NaN planted throughout
    k5_cases_run += [(*case, acts_planted)
                     for case in k5_cases.TILE_EDGES + [k5_cases.BATCH_PAST_GRID]]
    k5_cases_run += [(shape, (3, 3), (1, 1), "SAME", acts_planted)
                     for shape in dict.fromkeys(shape for shape, _ in VGG_XNOR_CONVS)]
    for shape, ks, st, pad, make in k5_cases_run:
        oh, ow, _ = conv_geometry(shape[1], shape[2], ks, st, pad)
        tiles = tuple(patch_pack_tiles(oh, ow, shape[3], ks, st))
        for dtype in (torch.float32, torch.bfloat16):
            x = make(shape, dtype)
            kw = dict(ksize=ks, stride=st, padding=pad)
            exact(f"K5 {shape} k={ks} s={st} {pad} {str(dtype)[6:]}"
                  f"{' planted' if make is acts_planted else ''} tile {tiles}",
                  patch_pack(x, **kw), patch_pack_plain(x, **kw))
    for shape in [(2, 9, 11, 40), (4, 8, 8, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = acts_planted(shape, dtype)
            xu = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(shape)
            xu.copy_(x)
            exact(f"K5 {shape} {str(dtype)[6:]} input one element past a 16-byte boundary",
                  patch_pack(xu, ksize=(3, 3)), patch_pack_plain(x, ksize=(3, 3)))
    # 64-bit indexing: inputs past 2^31 elements, whose output pixel (1, 1)
    # reads a pixel past offset 2^31, and an output past 2^31 words
    for shape, dtype, st in k5_cases.PAST_2_31_INPUTS:
        x = torch.randn(shape, generator=g, dtype=dtype, device=dev)
        k5_cases.corner_planted(x, st)
        kw = dict(ksize=(1, 1), stride=st, padding="VALID")
        got = patch_pack(x, **kw)
        if (got[..., 0] & 1).flatten().tolist() != [1, 0, 0, 1]:
            raise AssertionError(f"K5 {shape}: planted corner bits wrong")
        exact(f"K5 {shape} {str(dtype)[6:]} ({x.numel()} elements) k=(1, 1) s={st}",
              got, patch_pack_plain(x, **kw))
        del x, got
        torch.cuda.empty_cache()
    shape, ks, st, pad = k5_cases.PAST_2_31_OUTPUT
    x = torch.randn(shape, generator=g, device=dev)
    x[torch.rand(shape, generator=g, device=dev) < 0.05] = float("nan")
    x[::7, 1, 2], x[::11, 2, 1] = 0.0, -0.0
    kw = dict(ksize=ks, stride=st, padding=pad)
    got = patch_pack(x, **kw)
    step = k5_cases.PAST_2_31_OUTPUT_CHUNK
    for b0 in range(0, shape[0], step):
        if not torch.equal(got[b0:b0 + step], patch_pack_plain(x[b0:b0 + step], **kw)):
            raise AssertionError(f"K5 {shape} output past 2^31 words: images {b0}.. differ")
    print(f"  K5 {shape} f32 k={ks} {pad} ({got.numel()} output words): exact "
          f"against plain in chunks of {step} images")
    del x, got
    torch.cuda.empty_cache()
    errs["k5"] = 0.0

    print("== dense conv (conv/1 shape) against f64: cuDNN TF32 must stay off")
    torch.backends.cudnn.allow_tf32 = True     # the default the conv apply overrides
    xc, wc = acts((4, 32, 32, 64)).nan_to_num(), acts((3, 3, 64, 64)).nan_to_num()
    got = conv2d_nhwc(xc, wc, (1, 1), ((1, 1), (1, 1)))
    want = conv2d_nhwc(xc.double(), wc.double(), (1, 1), ((1, 1), (1, 1)))
    err = (got.double() - want).abs().max().item()
    print(f"  max_abs_err {err:.3e} against f64 (|out| max {want.abs().max().item():.1f}); "
          f"global allow_tf32 restored: {torch.backends.cudnn.allow_tf32}")
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)
    torch.backends.cudnn.allow_tf32 = False

    phase_start["6"] = time.perf_counter()
    # 6. the main path: serve both nets in every mode
    launches = {name: {} for name in counters}
    run_mode = {}        # (net, run) -> the plan mode it served
    serve_ms = {}

    def counted_serve(arch, run, per_batch, packs, **kw):
        """One serve with every launch counter set to 0 just before it and
        read just after; the counts must be ``per_batch`` x 17 batches and
        ``packs`` K1 launches at pack time."""
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        res = serve_classifier(arch=arch, slots=4, requests=64, seed=0, device="cuda", **kw)
        got = launch_counts()
        n_batches = len(res.batch_seconds) + res.warmup
        want = {name: per_batch.get(name, 0) * n_batches for name in counters}
        want["binarize_pack"] = packs
        print(f"  launches {got} over {n_batches} batches ({res.warmup} untimed warm-up); "
              f"{res.img_per_s:.1f} img/s, {res.ms_per_batch:.4f} ms/batch median, "
              f"packed {res.packed_bytes} B vs {res.dense_bytes} B bf16 dense")
        if n_batches != BATCHES or got != want:
            raise AssertionError(f"{arch} {run}: expected launches {want}")
        for name, count in got.items():
            launches[name][(arch, run)] = count
        run_mode[(arch, run)] = res.plan.mode
        return res

    served = {}
    for arch, mode, per_batch, packs in SERVES:
        print(f"== serve {arch} full width, --binarize {mode}, 4 slots, 64 requests")
        res = served[(arch, mode)] = counted_serve(arch, mode, per_batch, packs,
                                                   binarize=mode)
        serve_ms[(arch, mode)] = {"ms": res.ms_per_batch, "ips": res.img_per_s}
        # the served words against a plain pack of the same master weights
        # and words (the serve packs at key(seed + 1))
        tree, apply_fn, _, n_fc = build_model(arch, 0, device=dev)
        plan = compile_plan(tree["params"], make_paper_policy(n_fc), mode)
        with plain_kernels():
            plain = plan.pack(tree["params"], key=prng.key(1))
        n_leaves = 0
        for (path, a), (_, b) in zip(tree_leaves_with_path(res.params),
                                     tree_leaves_with_path(plain)):
            if type(a) is not type(b):
                raise AssertionError(f"{arch} {mode}: {path} served as {type(a).__name__}")
            if hasattr(a, "packed"):
                n_leaves += 1
                if not torch.equal(a.packed, b.packed):
                    raise AssertionError(f"{arch} {mode}: served {path} words differ from plain")
        # the served logits against the plain kernels on this card, and on the CPU
        binary_act = mode == "xnor"
        logits = res.last_logits
        if logits.shape != (4, 10) or not torch.isfinite(logits).all():
            raise AssertionError(f"{arch} {mode}: bad logits {tuple(logits.shape)}")
        model = mnist_fc if arch == "mnist_fc" else vgg
        signs_gpu, signs_cpu = [], []
        with torch.inference_mode(), record_signs(model, signs_gpu):
            again = apply_fn(res.params, res.state, res.last_x, binary_act=binary_act)
        with torch.inference_mode(), plain_kernels():
            plain_gpu = apply_fn(res.params, res.state, res.last_x, binary_act=binary_act)
        to_cpu = (lambda t: t.to("cpu"))
        with torch.inference_mode(), plain_kernels(), record_signs(model, signs_cpu):
            plain_cpu = apply_fn(tree_map(to_cpu, res.params), tree_map(to_cpu, res.state),
                                 res.last_x.cpu(), binary_act=binary_act)
        flips = sum(int((a != b).sum()) for a, b in zip(signs_gpu, signs_cpu))
        err_gpu = (again - plain_gpu).abs().max().item()
        err_cpu = (again.cpu() - plain_cpu).abs().max().item()
        print(f"  {n_leaves} served packed leaves == plain pack; logits vs plain kernels on "
              f"the card: max_abs_err {err_gpu:.3e}; vs plain CPU forward: {err_cpu:.3e}, "
              f"sign activations differing {flips} of {sum(s.numel() for s in signs_cpu)}")
        def forward():
            return apply_fn(res.params, res.state, res.last_x, binary_act=binary_act)

        with torch.inference_mode():
            kern = profiled(forward, reps=5)
            per_batch_kernels = kernels_per_rep(forward, reps=5)
        serve_ms[(arch, mode)]["launches"] = per_batch_kernels
        if kern is None:
            print("  device time per batch: not measured (no device activity profiled)")
        else:
            busy = sum(kern.values())
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:4]
            serve_ms[(arch, mode)]["busy"] = busy
            print(f"  device time per batch (torch.profiler, 5 batches): {busy:.4f} ms in "
                  f"{len(kern)} distinct kernels, {fmt_count(per_batch_kernels)} device kernel "
                  f"launches, {100 * busy / res.ms_per_batch:.1f}% of the "
                  f"{res.ms_per_batch:.4f} ms median; top: "
                  + "; ".join(f"{k[:60]} {v:.4f}" for k, v in top))
        if binary_act:
            # the same forward with K3's prologue route switched off: every
            # fused site takes bn_sign, then K3 packs its +-1 output. Equal
            # logits; by the counters, one bn_sign and one plain K3 a site
            # in place of one fused K3
            sites = per_batch["sign_pack_fused"]
            with torch.inference_mode(), unfused(model):
                before = launch_counts()
                chain_logits = forward()
                delta = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
                chain_kern = profiled(forward, reps=5)
                chain_kernels = kernels_per_rep(forward, reps=5)
            if not torch.equal(chain_logits, again):
                raise AssertionError(f"{arch} xnor: the fused route's logits differ from "
                                     f"the unfused route's")
            want_delta = {k: v for k, v in per_batch.items() if k != "sign_pack_fused"}
            want_delta["bn_sign"] = per_batch["bn_sign"] + sites
            if delta != want_delta:
                raise AssertionError(f"{arch} xnor, route off: launches {delta}, expected "
                                     f"{want_delta}")
            print(f"  route off at the {sites} fused site(s) (bn_sign, then plain K3): logits "
                  f"equal bit for bit; counters a batch {delta}; device ms/batch "
                  f"{fmt(chain_kern and sum(chain_kern.values()))}, "
                  f"{fmt_count(chain_kernels)} device kernel launches per batch (fused: "
                  f"{fmt_count(per_batch_kernels)})")
            serve_ms[(arch, mode)]["chain_launches"] = chain_kernels
        torch.testing.assert_close(again, logits, **F32_TOL)
        torch.testing.assert_close(again, plain_gpu, **F32_TOL)
        if arch == "mnist_fc" and not binary_act:
            torch.testing.assert_close(again.cpu(), plain_cpu, **F32_TOL)

    def plain_forward_close(tag, res, binary_act):
        """The serve's last logits against the same forward with the plain
        kernel versions on this card."""
        apply_fn = mnist_fc.apply if res.last_x.ndim == 2 else vgg.apply
        with torch.inference_mode(), plain_kernels():
            plain = apply_fn(res.params, res.state, res.last_x, binary_act=binary_act)
        err = (res.last_logits - plain).abs().max().item()
        print(f"  {tag}: logits vs the plain kernels on the card, max_abs_err {err:.3e}")
        torch.testing.assert_close(res.last_logits, plain, **F32_TOL)

    phase_start["6b"] = time.perf_counter()
    # 6b. the plan manifests
    golden_dir = Path(__file__).resolve().parent / "benchmarks" / "golden_plans"
    plan_dir = Path(__file__).resolve().parent / "build" / "plans"
    plan_dir.mkdir(parents=True, exist_ok=True)
    print("== plan manifests: compile == golden (dict and saved text), save -> load -> pack "
          "on the card == the compiled pack, and a serve from the golden manifest == the "
          "compiled serve (launches, logits bit for bit)")
    for arch, mode, per_batch, packs in SERVES:
        tree, _, _, n_fc = build_model(arch, 0, device=dev)
        plan = compile_plan(tree["params"], make_paper_policy(n_fc), mode)
        golden = golden_dir / f"{arch}_{mode}.json"
        saved = Path(plan.save(plan_dir / golden.name))
        if plan.to_json() != json.loads(golden.read_text()):
            raise AssertionError(f"{arch} {mode}: the compiled plan differs from {golden.name}")
        if saved.read_text() != golden.read_text():
            raise AssertionError(f"{arch} {mode}: the saved manifest's text differs from "
                                 f"{golden.name}")
        loaded = ExecutionPlan.load(saved)
        n_leaves = 0
        for (path, a), (_, b) in zip(
                tree_leaves_with_path(plan.pack(tree["params"], key=prng.key(1))),
                tree_leaves_with_path(loaded.pack(tree["params"], key=prng.key(1)))):
            if type(a) is not type(b):
                raise AssertionError(f"{arch} {mode} {path}: loaded plan packs "
                                     f"{type(b).__name__}, compiled {type(a).__name__}")
            for t_a, t_b in ([(a, b)] if isinstance(a, torch.Tensor) else
                             [(a.packed, b.packed), (a.scale, b.scale)]):
                if not torch.equal(t_a, t_b):
                    raise AssertionError(f"{arch} {mode} {path}: loaded pack differs")
            n_leaves += 1
        print(f"== serve {arch} {mode} from {golden.name}: {len(plan.layers)} rows equal "
              f"as a dict and as text; {n_leaves} leaves of the loaded plan's pack equal "
              f"the compiled pack on the card")
        res = counted_serve(arch, f"{mode} from golden", per_batch, packs, binarize=mode,
                            plan_from=str(golden))
        if not torch.equal(res.last_logits, served[(arch, mode)].last_logits):
            raise AssertionError(f"{arch} {mode}: logits served from the golden differ "
                                 f"from the compiled plan's")
        print("  logits equal the compiled plan's serve bit for bit")

    print("== serve vgg16_cifar10 xnor with --override conv/3=binarized_dense: one K4 and "
          "one K5 fewer a batch, one K1 fewer at pack time")
    res = counted_serve("vgg16_cifar10", "xnor, conv/3 binarized_dense",
                        {"sign_pack": 1, "sign_pack_fused": 1, "xnor_matmul": 11,
                         "patch_pack": 10, "bn_sign": 12}, 11, binarize="xnor",
                        override=["conv/3=binarized_dense"])
    if (res.plan["conv/3/kernel"].backend != "binarized_dense"
            or not isinstance(res.params["conv"][3]["kernel"], torch.Tensor)):
        raise AssertionError("the override did not put conv/3 on binarized_dense")
    plain_forward_close("override", res, True)
    for mode, per_batch in (("det", {"binary_matmul": 2}),
                            ("xnor", {"sign_pack": 2, "sign_pack_fused": 2, "xnor_matmul": 2,
                                      "bn_sign": 1})):
        print(f"== serve mnist_fc {mode} packed without scales (with_scale=False)")
        res = counted_serve("mnist_fc", f"{mode}, no scale", per_batch, 2, binarize=mode,
                            with_scale=False)
        if any(getattr(leaf, "scale", None) is not None
               for _, leaf in tree_leaves_with_path(res.params)):
            raise AssertionError(f"mnist_fc {mode}: a leaf packed with_scale=False has a scale")
        plain_forward_close("no scale", res, mode == "xnor")

    phase_start["6c"] = time.perf_counter()
    # 6c. the stochastic ensemble
    for arch, per_batch, packs in ENSEMBLES:
        k = ENSEMBLE_K
        print(f"== serve {arch} stoch full width as a K={k} ensemble, 4 slots, 64 requests")
        res = counted_serve(arch, f"stoch ensemble K={k}",
                            {n: c * k for n, c in per_batch.items()}, packs * k,
                            binarize="stoch", ensemble=k, abstain_threshold=0.6)
        rs, single = res.replicas, served[(arch, "stoch")]
        tree, apply_fn, _, _ = build_model(arch, 0, device=dev)

        def fn(t, x=res.last_x):
            return apply_fn(t, res.state, x)

        with torch.inference_mode():
            one = sample_replicas(tree["params"], res.plan, prng.key(1), 1)
            if not torch.equal(ensemble_forward(one, lambda t: fn(t, single.last_x)).mean_logits,
                               single.last_logits):
                raise AssertionError(f"{arch}: a K = 1 ensemble differs from the "
                                     f"single-sample serve")
            on_cpu = sample_replicas(tree_map(lambda t: t.cpu(), tree["params"]), res.plan,
                                     prng.key(1), k)
            for path in rs.paths:
                if not torch.equal(rs.stacked[path].packed.cpu(), on_cpu.stacked[path].packed):
                    raise AssertionError(f"{arch} ensemble {path}: replica words on the card "
                                         f"differ from the CPU's")
            rep_logits = ensemble_forward(rs, fn, stats=False)
            with plain_kernels():
                rep_plain = ensemble_forward(rs, fn, stats=False)
            if not torch.equal(ensemble_stats(rep_logits).mean_logits, res.last_logits):
                raise AssertionError(f"{arch} ensemble: the mean logits differ from the serve's")
            err = (rep_logits - rep_plain).abs().max().item()
            torch.testing.assert_close(rep_logits, rep_plain, **F32_TOL)
            kern = profiled(lambda: ensemble_forward(rs, fn), reps=5)
            n_kern = kernels_per_rep(lambda: ensemble_forward(rs, fn), reps=5)
        busy = kern and sum(kern.values())
        serve_ms[(arch, f"stoch ensemble K={k}")] = {
            "ms": res.ms_per_batch, "ips": res.img_per_s, "launches": n_kern,
            **({"busy": busy} if busy else {})}
        print(f"  K = 1 == the single-sample serve bit for bit; {len(rs.paths)} stochastic "
              f"leaves x {k} replicas on the card == the CPU's at key(1); replica logits vs "
              f"plain kernels max_abs_err {err:.3e}")
        print(f"  ensemble: {res.ms_per_batch:.4f} ms/batch median, device "
              f"{fmt(busy)} ms/batch, {fmt_count(n_kern)} device kernel launches a batch "
              f"(single sample: {single.ms_per_batch:.4f} ms, "
              f"{fmt(serve_ms[(arch, 'stoch')].get('busy'))} device ms, "
              f"{fmt_count(serve_ms[(arch, 'stoch')]['launches'])} launches); vote agreement "
              f"mean {res.mean_agreement:.4f} min {res.min_agreement:.4f}, abstained "
              f"{res.abstained}/{res.requests} at 0.6; {k} replicas {res.packed_bytes} B "
              f"(shared leaves once) vs {res.dense_bytes} B bf16 dense, one copy")

    phase_start["6d"] = time.perf_counter()
    # 6d. Alg.-1 training on the card
    from repro_torch.core import binarize as B
    from repro_torch.ft.failures import FailureInjector
    from repro_torch.launch import train as train_cli
    from repro_torch.train import steps as ST
    from repro_torch.train.trainer import Trainer, TrainerConfig

    ckpt_root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"

    def on_cpu(state):
        """A train state's tensors on the CPU (its key is no tensor)."""
        return {k: (v if k == "key" else tree_map(lambda t: t.cpu(), v))
                for k, v in state.items()}

    def tree_err(got, want) -> tuple[float, float]:
        """(largest |got - want| over the leaves, the largest |want|)."""
        pairs = list(zip(tree_leaves_with_path(got), tree_leaves_with_path(want)))
        return (max(float((a.cpu().double() - b.double()).abs().max()) for (_, a), (_, b) in pairs),
                max(float(b.abs().max()) for _, (_, b) in pairs))

    def hold(tag, got, want, tol):
        err, scale = tree_err(got, want)
        print(f"    {tag}: max_abs_err {err:.3e} (largest |value| {scale:.3e}; tolerance "
              f"rtol {tol:g}, atol {tol:g} x largest)")
        for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
            torch.testing.assert_close(a.cpu(), b, rtol=tol, atol=tol * scale,
                                       msg=lambda m, p=path: f"{tag} {p}: {m}")

    def step_events(fn) -> tuple[float, float | None, float | None, object]:
        """(wall ms of one synchronised call, device ms and device kernel
        launches of a second, profiled call of the same pure step, result)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"    torch.profiler failed ({e}); device time not measured")
            return wall, None, None, out
        ev = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if not ev:
            return wall, None, None, out
        return (wall, sum(e.self_device_time_total for e in ev) / 1e3,
                sum(e.count for e in ev), out)

    train_ms = {}
    print("== training (Alg. 1) on the card through launch.train.build_paper_model: the "
          "paper's recipe (SGD momentum 0.9, eta0 1e-3 with Eq. 4, batch 4), full width; "
          "each step also run on the CPU from the same state and batch")
    for arch, mode, n_steps in TRAIN_RUNS:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        tol = TRAIN_TOL[arch]
        state, step_fn, batch_fn = train_cli.build_paper_model(arch, binarize=mode,
                                                               device="cuda")
        cpu_state = on_cpu(state)
        pol = make_paper_policy(4 if arch == "mnist_fc" else 3)
        loss_fn = ST.make_classifier_loss(mnist_fc.apply if arch == "mnist_fc" else vgg.apply)
        print(f"  {arch} {mode}, {n_steps} steps")
        walls, devs, n_launch, flips = [], [], [], []
        for i in range(n_steps):
            batch = batch_fn(i)
            cpu_batch = tree_map(lambda t: t.cpu(), batch)
            key = prng.fold_in(state["key"], int(state["step"]))
            wb = B.binarize_tree(state["params"], mode, pol, key)
            wb_cpu = B.binarize_tree(cpu_state["params"], mode, pol, key)
            flips.append(sum(int((a.cpu() != b).sum()) for (p, a), (_, b) in zip(
                tree_leaves_with_path(wb), tree_leaves_with_path(wb_cpu)) if pol.selects(p)))
            if i == 0:
                if flips[0]:
                    raise AssertionError(f"{arch} {mode}: step 1's binarized weights differ "
                                         f"on the card")
                _, grads = ST.binarized_value_and_grad(
                    loss_fn, state["params"], batch, mode=mode, policy=pol, key=key,
                    model_state=state["model_state"])
                _, grads_cpu = ST.binarized_value_and_grad(
                    loss_fn, cpu_state["params"], cpu_batch, mode=mode, policy=pol, key=key,
                    model_state=cpu_state["model_state"])
                hold("step 1 grads vs CPU", grads, grads_cpu, tol)
            wall, dms, nl, (new, m) = step_events(lambda s=state, b=batch: step_fn(s, b))
            new_cpu, m_cpu = step_fn(cpu_state, cpu_batch)
            if i == 0:
                for name in ("params", "opt", "model_state"):
                    hold(f"step 1 {name} vs CPU", new[name], new_cpu[name], tol)
            loss, loss_cpu = float(m["loss"]), float(m_cpu["loss"])
            print(f"    step {i + 1}: loss {loss:.6f} (CPU {loss_cpu:.6f}), binarized weights "
                  f"differing from the CPU's {flips[-1]}, wall {wall:.3f} ms, device "
                  f"{fmt(dms)} ms in {fmt_count(nl)} device kernel launches")
            if not abs(loss - loss_cpu) <= TRAIN_LOSS_RTOL[arch] * abs(loss_cpu):
                raise AssertionError(f"{arch} {mode} step {i + 1}: loss {loss} vs CPU {loss_cpu}")
            walls.append(wall)
            devs.append(dms)
            n_launch.append(nl)
            state, cpu_state = new, new_cpu
        if any(launch_counts().values()):
            raise AssertionError(f"{arch} {mode}: training launched a port kernel "
                                 f"{launch_counts()}")
        steady = walls[1:]
        train_ms[(arch, mode)] = {"wall_ms": walls, "device_ms": devs, "launches": n_launch,
                                  "flips": flips,
                                  "steps_per_s": 1e3 * len(steady) / sum(steady)}
        print(f"    {1e3 * len(steady) / sum(steady):.2f} steps/s over steps 2-{n_steps} "
              f"(median wall {statistics.median(steady):.3f} ms; step 1 {walls[0]:.3f} ms); "
              f"device ms per step {[fmt(d) for d in devs]}; no port kernel launched (dense "
              f"ops on the binarized weights)")

    print("== training: TF32 stays off through VGG-16's backward (width 1.0, batch 4): "
          "the step's f32 grads against f64 on the card, beside a backward left to cuDNN's "
          "TF32 default")
    vtree, _, _, _ = build_model("vgg16_cifar10", 0, device=dev)
    gv = torch.Generator(device=dev).manual_seed(5)
    vb = {"x": torch.rand(4, 32, 32, 3, generator=gv, device=dev),
          "y": torch.randint(0, 10, (4,), generator=gv, device=dev)}
    vloss = ST.make_classifier_loss(vgg.apply)
    vpol = make_paper_policy(3)

    def vgg_grads(dtype, tf32_backward=False):
        t = tree_map(lambda x: x.to(dtype), vtree)
        b = {"x": vb["x"].to(dtype), "y": vb["y"]}
        if not tf32_backward:
            return ST.binarized_value_and_grad(vloss, t["params"], b, mode="det", policy=vpol,
                                               key=None, model_state=t["state"])[1]
        from repro_torch.engine.plan import tree_unflatten
        leaves = [x.detach().requires_grad_(True) for _, x in tree_leaves_with_path(t["params"])]
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            loss, _ = vloss(B.binarize_tree(tree_unflatten(t["params"], leaves), "det", vpol),
                            b, t["state"])
            return tree_unflatten(t["params"], list(torch.autograd.grad(loss, leaves)))
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    g64 = tree_map(lambda x: x.cpu(), vgg_grads(torch.float64))
    f32_err, g_scale = tree_err(vgg_grads(torch.float32), g64)
    tf32_err, _ = tree_err(vgg_grads(torch.float32, tf32_backward=True), g64)
    print(f"  grads vs f64: the step's {f32_err:.3e}, TF32 backward {tf32_err:.3e} (largest "
          f"|grad| {g_scale:.3e}; bound on the step's: 1e-3 x largest)")
    if not f32_err <= 1e-3 * g_scale:
        raise AssertionError("VGG grads: the step's backward is not full f32")
    if not tf32_err > f32_err:
        print("  the TF32 backward came no further from f64 than the step's: this control "
              "shows nothing on this card")
    train_ms["tf32"] = {"f32_err": f32_err, "tf32_err": tf32_err, "scale": g_scale}

    print("== training: checkpoint save -> restore -> replay on the card (mnist_fc stoch, "
          "full width): a run with failures injected at steps 3 and 5, restored from its "
          "checkpoints, ends bit for bit where a clean run does")
    import shutil
    shutil.rmtree(ckpt_root, ignore_errors=True)
    finals = {}
    for tag, fail_at in (("clean", ()), ("crash", (3, 5))):
        state, step_fn, batch_fn = train_cli.build_paper_model("mnist_fc", binarize="stoch",
                                                               device="cuda")
        trainer = Trainer(TrainerConfig(total_steps=6, checkpoint_dir=str(ckpt_root / tag),
                                        checkpoint_every=2, log_every=1),
                          step_fn, batch_fn, state, failure_injector=FailureInjector(fail_at))
        trainer.run()
        finals[tag] = trainer
    a, b = finals["clean"], finals["crash"]
    if b.recoveries != 2:
        raise AssertionError(f"expected 2 recoveries, got {b.recoveries}")
    for (path, x), (_, y) in zip(tree_leaves_with_path(a.state), tree_leaves_with_path(b.state)):
        if not ((x == y) if isinstance(x, prng.Key) else torch.equal(x, y)):
            raise AssertionError(f"replay on the card: {path} differs from the clean run")
    restored = b.ckpt.restore(b._template)
    for (path, x), (_, y) in zip(tree_leaves_with_path(a.state), tree_leaves_with_path(restored)):
        if not ((x == y) if isinstance(x, prng.Key) else torch.equal(x, y)):
            raise AssertionError(f"restored checkpoint: {path} differs from the clean run")
    clean_loss = {h["step"]: h["loss"] for h in a.history}
    if any(h["loss"] != clean_loss[h["step"]] for h in b.history):
        raise AssertionError("a replayed step's loss differs from the clean run's")
    print(f"  clean 6 steps == crash run (recoveries {b.recoveries}, {len(b.history)} logged "
          f"steps, replays included) bit for bit, every leaf and every loss; its last "
          f"checkpoint restores to the same state")

    print("== training CLI: python -m repro_torch.launch.train --arch mnist_fc --binarize "
          "stoch --steps 50 (full width, the default device)")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    t0 = time.perf_counter()
    train_cli.main(["--arch", "mnist_fc", "--binarize", "stoch", "--steps", "50",
                    "--ckpt-dir", str(ckpt_root)])
    print(f"  the CLI took {time.perf_counter() - t0:.2f} s in all")
    shutil.rmtree(ckpt_root, ignore_errors=True)

    phase_start["6e"] = time.perf_counter()
    # 6e. the dense LM serve: StarCoder2-3B at full width in det, stoch, xnor
    import cProfile
    import pstats

    from repro_torch.configs import base as cb
    from repro_torch.core.policy import DEFAULT_POLICY
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import transformer as T
    from repro_torch.obs import validate_trace

    lm_cfg = cb.get_config(LM_ARCH)
    n_proj = 4 * lm_cfg.n_layers                  # projection launches a prefill or step
    lm_rows = {}
    lm_keep = {}       # mode -> the served det / xnor tree, its plan and streams, for 6k

    def lm_greedy(engine, prompts, max_new):
        """(B, max_new, V) f32: each step's logits of greedy generation from
        ``prompts``, the computation ``engine.generate`` runs."""
        out = []
        cfg_ = engine.cfg
        with torch.inference_mode():
            lg, cache = T.prefill(cfg_, engine.params, prompts,
                                  max_len=prompts.shape[1] + max_new)
            for i in range(max_new):
                out.append(lg.to(torch.float32))
                if i < max_new - 1:
                    tok = torch.argmax(lg, dim=-1).to(torch.int32)
                    lg, cache = T.decode_step(cfg_, engine.params, cache, tok[:, None])
        return torch.stack(out, 1)

    def top2_margin(logits):
        top2 = torch.topk(logits, 2, dim=-1).values
        return top2[..., 0] - top2[..., 1]

    def span_split(tracer, parents) -> dict[str, tuple[int, float, float]]:
        """parent span -> (spans, mean dispatch ms, mean device ms) of a
        fenced trace: each entry point's time split into the host issuing
        kernels and the fence's wait for the card."""
        spans = [e for e in tracer.events if e["ph"] == "X"]
        split = {}
        for parent in parents:
            outer = [e for e in spans if e["name"] == parent]
            kids = {"dispatch": 0.0, "device": 0.0}
            for o in outer:
                for e in spans:
                    if (e["name"] in kids and e["args"]["depth"] == o["args"]["depth"] + 1
                            and o["ts"] <= e["ts"] <= o["ts"] + o["dur"]):
                        kids[e["name"]] += e["dur"] / 1e3
            n = max(len(outer), 1)
            split[parent] = (len(outer), kids["dispatch"] / n, kids["device"] / n)
            print(f"  {parent}: {len(outer)} spans, dispatch {split[parent][1]:.3f} ms + "
                  f"device {split[parent][2]:.3f} ms a call (means)")
        return split

    for mode in LM_MODES:
        print(f"== serve {LM_ARCH} full width ({lm_cfg.n_layers} layers, d_model "
              f"{lm_cfg.d_model}, d_ff {lm_cfg.d_ff}, vocab {lm_cfg.vocab_size}, "
              f"{lm_cfg.dtype}) --packed --binarize {mode}: {LM_SERVE}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()        # earlier phases' tensors still held
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        res = serve_lm(arch=LM_ARCH, packed=True, binarize=mode, device="cuda", **LM_SERVE)
        got = launch_counts()
        peak = torch.cuda.max_memory_allocated() - live
        calls = LM_SERVE["requests"] + res.steps - 1      # prefills + decode steps
        want = {name: 0 for name in counters}
        want["binarize_pack"] = n_proj
        for name in (("sign_pack", "xnor_matmul") if mode == "xnor" else ("binary_matmul",)):
            want[name] = n_proj * calls
        print(f"  launches {got}: {LM_SERVE['requests']} prefills + {res.steps - 1} decode "
              f"steps x {n_proj} projections, {n_proj} K1 at pack time")
        if got != want:
            raise AssertionError(f"{LM_ARCH} {mode}: expected launches {want}")
        for name, count in got.items():
            launches[name][(LM_ARCH, mode)] = count
        run_mode[(LM_ARCH, mode)] = mode
        engine = res.engine
        done = sorted(res.batcher.completed, key=lambda r: r.uid)
        if len(done) != LM_SERVE["requests"] or res.tokens != 16 * LM_SERVE["max_new"]:
            raise AssertionError(f"{LM_ARCH} {mode}: served {len(done)} requests, "
                                 f"{res.tokens} tokens")

        # the served words against a plain pack of the same masters at key(seed + 1)
        masters = T.init_lm(lm_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        plan = compile_plan(masters, DEFAULT_POLICY, mode)
        with plain_kernels():
            plain = plan.pack(masters, key=prng.key(1))
        n_layers_checked = 0
        for (path, a), (_, b) in zip(tree_leaves_with_path(engine.params),
                                     tree_leaves_with_path(plain)):
            if hasattr(a, "packed"):
                if type(a) is not type(b) or not torch.equal(a.packed, b.packed):
                    raise AssertionError(f"{LM_ARCH} {mode}: served {path} differs from "
                                         f"the plain pack")
                n_layers_checked += a.packed.shape[0]
        stoch_note = ""
        if mode == "stoch":
            # the threefry twin on the card against the CPU, through a whole
            # layer pack: layers 0 and L-1 of w_o, packed on the CPU
            row = plan["layers/attn/w_o"]
            keys = prng.split(prng.fold_in(prng.key(1), row.index), lm_cfg.n_layers)
            served = engine.params["layers"]["attn"]["w_o"].packed
            for layer in range(lm_cfg.n_layers):
                cpu = kops_mod.binarize_and_pack(masters["layers"]["attn"]["w_o"][layer].cpu(),
                                                 keys[layer], stochastic=True)
                if not torch.equal(served[layer].cpu(), cpu):
                    raise AssertionError(f"{LM_ARCH} stoch: w_o layer {layer} words differ "
                                         f"from the CPU's")
            stoch_note = (f"; w_o layers 0 and {lm_cfg.n_layers - 1} equal a CPU pack at "
                          f"their split keys")
        del masters, plain
        print(f"  {n_layers_checked} served per-layer leaves (K1) == plain pack{stoch_note}")

        # greedy streams against the plain kernels on this card, first 4 requests
        prompts = torch.from_numpy(np.stack([r.prompt for r in done[:4]])).to(dev)
        k_lg = lm_greedy(engine, prompts, LM_SERVE["max_new"])
        with plain_kernels():
            p_lg = lm_greedy(engine, prompts, LM_SERVE["max_new"])
        tol = LM_LOGIT_TOL * p_lg.abs().amax(dim=-1)           # (4, steps)
        err0 = (k_lg[:, 0] - p_lg[:, 0]).abs().amax(dim=-1)
        print(f"  first step's logits vs the plain kernels: max_abs_err per request "
              f"{[round(e, 5) for e in err0.tolist()]} (tolerance "
              f"{[round(t, 5) for t in tol[:, 0].tolist()]})")
        if (err0 > tol[:, 0]).any() or (mode == "xnor" and not torch.equal(k_lg, p_lg)):
            raise AssertionError(f"{LM_ARCH} {mode}: logits differ from the plain kernels")
        margin = top2_margin(p_lg)
        same = k_lg.argmax(-1) == p_lg.argmax(-1)
        for b in range(prompts.shape[0]):
            bad = (~same[b]).nonzero()
            if not len(bad):
                print(f"  request {b}: {LM_SERVE['max_new']} greedy tokens equal the plain "
                      f"kernels' (smallest top-2 margin {margin[b].min().item():.4g})")
                continue
            i = bad[0].item()
            print(f"  request {b}: tokens equal up to step {i}, where the plain run's top-2 "
                  f"margin is {margin[b, i].item():.4g} (tolerance {tol[b, i].item():.4g})")
            if margin[b, i] >= tol[b, i]:
                raise AssertionError(f"{LM_ARCH} {mode}: request {b} diverges at step {i} "
                                     f"with a top-2 margin above the tolerance")
        err_lm = err0.max().item()

        # every stream equals the one-shot generate of its request
        for r in done:
            one = engine.generate(r.prompt[None], r.max_new).tokens[0].tolist()
            if one != r.generated:
                raise AssertionError(f"{LM_ARCH} {mode}: request {r.uid}'s stream differs "
                                     f"from its one-shot generate")
        print(f"  all {len(done)} streams equal the one-shot generate of their request")
        if mode in ("det", "xnor"):
            lm_keep[mode] = {"params": engine.params, "plan": res.plan,
                             "prompts": [r.prompt for r in done],
                             "streams": {r.uid: list(r.generated) for r in done}}

        # decode step: wall (synced), device time and launches (profiler)
        state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])
        for slot in range(4):
            state = engine.prefill_into(state, slot, done[slot].prompt)
        tok = torch.argmax(state.logits, dim=-1)
        step_wall = []
        for _ in range(LM_SERVE["max_new"] - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = engine.decode_step(state, tok)
            torch.cuda.synchronize()
            step_wall.append(time.perf_counter() - t0)
        step_ms = statistics.median(step_wall) * 1e3
        step_state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])

        def one_step():
            engine.decode_step(step_state, tok)

        step_kern = profiled(one_step, reps=5)
        step_dev = step_kern and sum(step_kern.values())
        step_n = kernels_per_rep(one_step, reps=5)
        # where the host's time goes: cProfile over 3 decode steps (it adds a
        # cost to every Python call, so read it for ranking, not for totals)
        host = cProfile.Profile()
        host.enable()
        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        host.disable()
        host_top = sorted(pstats.Stats(host).stats.items(), key=lambda kv: -kv[1][2])[:6]
        print("  host (cProfile, tottime a decode step): " + "; ".join(
            f"{fn} ({Path(file).name}:{line}) {tt / 3 * 1e3:.2f} ms in {nc // 3} calls"
            for (file, line, fn), (_, nc, tt, _, _) in host_top))
        top = sorted((step_kern or {}).items(), key=lambda kv: -kv[1])[:4]
        lm_rows[mode] = {
            "pack_s": res.pack_seconds, "dense_mb": res.dense_bytes / 1e6,
            "served_mb": res.packed_bytes / 1e6, "tok_s": res.tok_per_s,
            "ttft_ms": res.median_ttft * 1e3, "latency_ms": res.median_latency * 1e3,
            "step_ms": step_ms, "step_device_ms": step_dev, "step_launches": step_n,
            "peak_gb": peak / 1e9, "seconds": res.seconds, "steps": res.steps,
            "max_abs_err": err_lm}
        print(f"  pack {res.pack_seconds:.3f} s; {res.dense_bytes / 1e6:.1f} MB bf16 dense -> "
              f"{res.packed_bytes / 1e6:.1f} MB served ({res.dense_bytes / res.packed_bytes:.2f}x); "
              f"{res.tok_per_s:.1f} tok/s, median TTFT {res.median_ttft * 1e3:.1f} ms, median "
              f"latency {res.median_latency * 1e3:.1f} ms; decode step {step_ms:.3f} ms median "
              f"(synced), device {fmt(step_dev)} ms in {fmt_count(step_n)} device launches "
              f"(torch.profiler, 5 steps); peak allocated {peak / 1e9:.2f} GB above the "
              f"{live / 1e9:.2f} GB earlier phases hold; top: "
              + "; ".join(f"{k[:50]} {v:.4f}" for k, v in top))
        del res, engine, state, step_state, k_lg, p_lg

    # a traced serve: the trace validates and splits each entry point's time
    # into dispatch (the host issuing kernels) and device (the fence's wait)
    trace_path = Path(__file__).resolve().parent / "build" / "lm_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    print(f"== traced serve {LM_ARCH} det (--trace {trace_path.name}; fenced)")
    torch.cuda.empty_cache()
    res = serve_lm(arch=LM_ARCH, packed=True, binarize="det", device="cuda",
                   trace=str(trace_path), **LM_SERVE)
    info = validate_trace(str(trace_path))
    if info["root"] != "stream_serve" or info["coverage"] < 0.95:
        raise AssertionError(f"trace: {info}")
    split = span_split(res.tracer, ("decode_step", "prefill_into"))
    print(f"  trace: {info['spans']} spans, coverage {info['coverage'] * 100:.1f}%; traced "
          f"{res.tok_per_s:.1f} tok/s")
    lm_rows["trace"] = {"coverage": info["coverage"], "split": split,
                        "tok_s": res.tok_per_s}
    del res
    torch.cuda.empty_cache()

    phase_start["6f"] = time.perf_counter()
    # 6f. the rest of the dense LM serve engine at StarCoder2-3B's full width,
    # LM_6F_LAYERS of its layers, masters from seed 0: chunked prefill with the
    # prefix cache (det, xnor), temperature sampling (det), the K-replica
    # ensemble
    lm_cfg = dataclasses.replace(lm_cfg, n_layers=LM_6F_LAYERS)
    n_proj = 4 * lm_cfg.n_layers                  # projection launches a model call
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serve import PrefixCache, ServeEngine, SlotBatcher, stream_serve
    from repro_torch.serve.engine import tempered

    def reset_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def expect_counts(tag, run, want_nonzero):
        """Reads the counters after ``run`` and holds them against
        ``want_nonzero`` (every other counter 0); records them as a main-path
        run."""
        got = launch_counts()
        want = {name: 0 for name in counters}
        want.update(want_nonzero)
        print(f"  launches {got}")
        if got != want:
            raise AssertionError(f"{tag}: expected launches {want}")
        for name, count in got.items():
            launches[name][(LM_ARCH, run[0])] = count
        run_mode[(LM_ARCH, run[0])] = run[1]

    def serve_streams(engine, prompts, max_new, slots, **kw):
        """(streams by uid, batcher, steps, synced seconds) of one stream_serve."""
        b = SlotBatcher(slots, len(prompts[0]))
        for p_ in prompts:
            b.submit(p_, max_new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = stream_serve(engine, b, max_new_cap=max_new, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if len(b.completed) != len(prompts) or b.tokens_generated != len(prompts) * max_new:
            raise AssertionError(f"served {len(b.completed)} of {len(prompts)} requests")
        return {r.uid: list(r.generated) for r in b.completed}, b, steps, secs

    def synced_ms(fn, reps):
        wall = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        return statistics.median(wall) * 1e3

    def step_costs(fn, reps=5):
        """(wall ms synced median, device ms, device launches) of one call."""
        dev_k = profiled(fn, reps=3)
        return synced_ms(fn, reps), dev_k and sum(dev_k.values()), kernels_per_rep(fn, reps=3)

    def first_diff(a, b):
        return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)

    masters = T.init_lm(lm_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    vocab = lm_cfg.vocab_size
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, LM_CHUNK["shared_prefix"])
    chunk_prompts = []
    for _ in range(LM_CHUNK["requests"]):
        p_ = rng.integers(0, vocab, LM_CHUNK["prompt_len"])
        p_[:len(shared)] = shared
        chunk_prompts.append(p_)
    chunk_prompts.append(chunk_prompts[LM_REPEAT_OF].copy())
    n_req, repeat = len(chunk_prompts), len(chunk_prompts) - 1
    c_new, c_slots, c_len = LM_CHUNK["max_new"], LM_CHUNK["slots"], LM_CHUNK["prefill_chunk"]
    lm_packed, lm6f = {}, {}
    for mode in ("det", "xnor"):
        print(f"== serve {LM_ARCH} full width, {LM_6F_LAYERS} of 30 layers --packed --binarize "
              f"{mode}, chunked prefill "
              f"and the prefix cache: {LM_CHUNK}, request {repeat} repeating request "
              f"{LM_REPEAT_OF}'s prompt")
        lm_packed[mode] = packed = compile_plan(masters, DEFAULT_POLICY, mode).pack(
            masters, key=prng.key(1))
        engine = ServeEngine(lm_cfg, packed)
        whole, wb, _, wsecs = serve_streams(engine, chunk_prompts, c_new, c_slots)
        w_ttft = statistics.median(r.ttft for r in wb.completed) * 1e3
        print(f"  whole-prompt admission of the same requests: "
              f"{wb.tokens_generated / wsecs:.1f} tok/s, median TTFT {w_ttft:.1f} ms")
        pc, reg = PrefixCache(max_entries=LM_CHUNK["prefix_cache"]), MetricsRegistry()
        reset_counts()
        streams, b, steps, secs = serve_streams(engine, chunk_prompts, c_new, c_slots,
                                                prefill_chunk=c_len, prefix_cache=pc,
                                                metrics=reg)
        chunks = int(reg["serve_prefill_chunks_total"].value)
        # every decode (steps - 1: the last emission needs none) and every
        # chunk runs the n_proj projections once; a fused step does both
        calls = steps - 1 + chunks
        print(f"  {steps - 1} decode steps + {chunks} prefill chunks, x {n_proj} projections")
        expect_counts(f"{LM_ARCH} {mode} chunked", (f"{mode} chunked", mode),
                      {name: n_proj * calls for name in
                       (("sign_pack", "xnor_matmul") if mode == "xnor" else ("binary_matmul",))})
        st = pc.stats()
        print(f"  prefix cache: {st}")
        if st["hits"] < 1 or st["tokens_skipped"] <= 0:
            raise AssertionError(f"{LM_ARCH} {mode}: no prefix hit")
        if streams[repeat] != streams[LM_REPEAT_OF]:
            raise AssertionError(f"{LM_ARCH} {mode}: request {repeat}'s full-prompt hit "
                                 f"differs from request {LM_REPEAT_OF}'s stream")
        # every chunked stream against the same engine's whole-prompt stream,
        # up to a near tie on the whole-prompt greedy path
        lg = lm_greedy(engine, torch.from_numpy(np.stack(chunk_prompts)).to(dev), c_new)
        tol = LM_6F_LOGIT_TOL * lg.abs().amax(dim=-1)
        margin = top2_margin(lg)
        n_equal = 0
        for uid in range(n_req):
            if streams[uid] == whole[uid]:
                n_equal += 1
                continue
            i = first_diff(streams[uid], whole[uid])
            print(f"  request {uid}: chunked stream equals the whole-prompt one up to step "
                  f"{i}, where the top-2 margin is {margin[uid, i].item():.4g} (tolerance "
                  f"{tol[uid, i].item():.4g})")
            if margin[uid, i] >= tol[uid, i]:
                raise AssertionError(f"{LM_ARCH} {mode}: request {uid}'s chunked stream "
                                     f"diverges with a top-2 margin above the tolerance")
        print(f"  {n_equal}/{n_req} chunked streams equal the whole-prompt streams (smallest "
              f"top-2 margin on the whole-prompt path {margin.min().item():.4g}); request "
              f"{repeat}'s full-prompt hit emits request {LM_REPEAT_OF}'s stream")

        # a decode step, a chunk alone and the fused step: slots 0-2 decoding,
        # slot 3 with its first chunk in, its second chunk next
        state = engine.init_decode(c_slots, LM_CHUNK["prompt_len"], c_new)
        for slot in range(c_slots - 1):
            state = engine.prefill_into(state, slot, chunk_prompts[slot])
        mid = chunk_prompts[c_slots - 1]
        state = engine.prefill_chunk_into(state, c_slots - 1, mid[:c_len], 0)
        tok = torch.argmax(state.logits, dim=-1)
        keep = [False] * (c_slots - 1) + [True]
        parts = {
            "decode_step": lambda: engine.decode_step(state, tok),
            "prefill_chunk_into": lambda: engine.prefill_chunk_into(
                state, c_slots - 1, mid[c_len:2 * c_len], c_len),
            "fused_step": lambda: engine.fused_step(state, tok, keep, c_slots - 1,
                                                    mid[c_len:2 * c_len], c_len)}
        costs = {name: step_costs(fn) for name, fn in parts.items()}
        for name, (w_ms, d_ms, n_k) in costs.items():
            print(f"  {name}: wall {w_ms:.3f} ms (synced median of 5), device {fmt(d_ms)} ms "
                  f"in {fmt_count(n_k)} device launches")
        row = {"tok_s": b.tokens_generated / secs, "seconds": secs, "steps": steps,
               "chunks": chunks, "ttft_ms": statistics.median(r.ttft for r in b.completed) * 1e3,
               "prefix": st, "n_equal": n_equal, "margin": margin.min().item(), "costs": costs,
               "whole_tok_s": wb.tokens_generated / wsecs, "whole_ttft_ms": w_ttft}
        print(f"  {row['tok_s']:.1f} tok/s ({steps} steps in {secs:.3f} s), median TTFT "
              f"{row['ttft_ms']:.1f} ms")
        if mode == "det":
            # a traced chunked serve: the fused step's dispatch/device split
            tr = Tracer()
            path = Path(__file__).resolve().parent / "build" / "lm_chunked_trace.json"
            _, tb, _, tsecs = serve_streams(
                ServeEngine(lm_cfg, packed, tracer=tr), chunk_prompts, c_new, c_slots,
                prefill_chunk=c_len, prefix_cache=PrefixCache(max_entries=LM_CHUNK["prefix_cache"]))
            info = validate_trace(tr.save(str(path)))
            if info["root"] != "stream_serve" or info["coverage"] < 0.95:
                raise AssertionError(f"chunked trace: {info}")
            print(f"== traced chunked serve {LM_ARCH} det (fenced; {path.name}): "
                  f"{info['spans']} spans, coverage {info['coverage'] * 100:.1f}%, "
                  f"{tb.tokens_generated / tsecs:.1f} tok/s")
            row["split"] = span_split(tr, ("decode_prefill", "prefill_chunk", "decode_step",
                                           "prefix_splice"))
        lm6f[mode] = row
        del engine, state, lg

    # temperature sampling (det): the words on the card against the CPU twin's,
    # and the sampled tokens against the same sampling with the plain kernels
    print(f"== {LM_ARCH} det, temperature {LM_TEMPERATURE} at key {LM_TEMPERATURE_KEY}: the "
          f"first {c_slots} prompts, {c_new} tokens")
    engine = ServeEngine(lm_cfg, lm_packed["det"])
    prompts4 = torch.from_numpy(np.stack(chunk_prompts[:c_slots])).to(dev)
    tkey = prng.key(LM_TEMPERATURE_KEY)
    first = prng.split(tkey)[1]
    shape = (c_slots, vocab)
    u_dev = prng.uniform(first, shape, dev, minval=prng.TINY32, maxval=1.0)
    u_cpu = prng.uniform(first, shape, minval=prng.TINY32, maxval=1.0)
    if not torch.equal(u_dev.cpu().view(torch.int32), u_cpu.view(torch.int32)):
        raise AssertionError("uniform words under categorical differ from the CPU's")
    g_err = (prng.gumbel(first, shape, dev).cpu() - prng.gumbel(first, shape)).abs().max().item()
    print(f"  the first draw's {c_slots}x{vocab} uniform words on the card == the CPU twin's; "
          f"gumbel max |card - CPU| {g_err:.3g}")

    def sampled(max_new):
        """(tokens, top-2 margins of logits / T + gumbel, tolerance), each
        (B, max_new), along generate's tempered path and key chain."""
        key_, toks, margins, tols = tkey, [], [], []
        with torch.inference_mode():
            lg_, cache = T.prefill(lm_cfg, engine.params, prompts4,
                                   max_len=prompts4.shape[1] + max_new)
            for i in range(max_new):
                key_, sub = prng.split(key_)
                x = tempered(lg_, LM_TEMPERATURE)
                y = x + prng.gumbel(sub, tuple(x.shape), dev)
                tok_ = torch.argmax(y, dim=-1).to(torch.int32)
                toks.append(tok_)
                margins.append(top2_margin(y))
                tols.append(LM_6F_LOGIT_TOL * x.abs().amax(dim=-1))
                if i < max_new - 1:
                    lg_, cache = T.decode_step(lm_cfg, engine.params, cache, tok_[:, None])
        return torch.stack(toks, 1), torch.stack(margins, 1), torch.stack(tols, 1)

    reset_counts()
    gen = engine.generate(prompts4, c_new, temperature=LM_TEMPERATURE, key=tkey)
    expect_counts(f"{LM_ARCH} det temperature", ("det temperature", "det"),
                  {"binary_matmul": n_proj * c_new})
    k_tok, _, _ = sampled(c_new)
    if not torch.equal(gen.tokens, k_tok):
        raise AssertionError("generate(temperature) differs from its own sampling path")
    with plain_kernels():
        p_tok, p_margin, p_tol = sampled(c_new)
    for b_ in range(c_slots):
        a, c = gen.tokens[b_].tolist(), p_tok[b_].tolist()
        if a == c:
            continue
        i = first_diff(a, c)
        print(f"  request {b_}: tempered tokens equal the plain kernels' up to step {i}, "
              f"margin {p_margin[b_, i].item():.4g} (tolerance {p_tol[b_, i].item():.4g})")
        if p_margin[b_, i] >= p_tol[b_, i]:
            raise AssertionError(f"tempered request {b_} diverges above the tolerance")
    t_equal = sum(gen.tokens[b_].tolist() == p_tok[b_].tolist() for b_ in range(c_slots))
    print(f"  {t_equal}/{c_slots} tempered streams equal the plain kernels' (smallest "
          f"top-2 margin of logits / T + gumbel {p_margin.min().item():.4g})")
    lm6f["temperature"] = {"equal": t_equal, "margin": p_margin.min().item(), "g_err": g_err}
    del engine, lm_packed

    # the K-replica ensemble (stoch)
    ek, e_new, e_slots = LM_ENSEMBLE["k"], LM_ENSEMBLE["max_new"], LM_ENSEMBLE["slots"]
    print(f"== {LM_ARCH} full width, {LM_6F_LAYERS} of 30 layers, stoch ensemble: "
          f"{LM_ENSEMBLE}")
    plan_s = compile_plan(masters, DEFAULT_POLICY, "stoch")
    erng = np.random.default_rng(1)
    e_prompts = [erng.integers(0, vocab, LM_ENSEMBLE["prompt_len"])
                 for _ in range(LM_ENSEMBLE["requests"])]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rs = sample_replicas(masters, plan_s, prng.key(1), ek)
    torch.cuda.synchronize()
    e_pack_s = time.perf_counter() - t0
    engine = ServeEngine(lm_cfg, None, ensemble=rs)
    streams, b, steps, secs = serve_streams(engine, e_prompts, e_new, e_slots)
    print(f"  {ek} x {n_proj} K1 at pack; {LM_ENSEMBLE['requests']} prefills + {steps - 1} "
          f"decode steps x {ek} replicas x {n_proj} projections")
    expect_counts(f"{LM_ARCH} ensemble", ("stoch ensemble", "stoch"),
                  {"binarize_pack": n_proj * ek,
                   "binary_matmul": n_proj * ek * (LM_ENSEMBLE["requests"] + steps - 1)})
    agr = [a for r in b.completed for a in r.agreement]
    var = [v for r in b.completed for v in r.variance]
    if not (all(0.0 <= a <= 1.0 for a in agr) and min(var) >= 0.0):
        raise AssertionError("ensemble agreement outside [0, 1] or a negative variance")
    for r in b.completed:
        one = engine.generate(r.prompt[None], r.max_new)
        if one.tokens[0].tolist() != r.generated:
            raise AssertionError(f"ensemble request {r.uid}'s stream differs from its "
                                 f"one-shot generate")
    print(f"  all {len(b.completed)} streams equal the ensemble's one-shot generate; vote "
          f"agreement mean {statistics.fmean(agr):.3f} (min {min(agr):.3f}), variance mean "
          f"{statistics.fmean(var):.4g}")
    # K = 1 is the stochastic single-sample engine (rs.base is plan.pack at
    # the same key), tokens and logprobs bit for bit
    e_prompts4 = torch.from_numpy(np.stack(e_prompts[:e_slots])).to(dev)
    single = ServeEngine(lm_cfg, rs.base).generate(e_prompts4, e_new)
    one_rs = sample_replicas(masters, plan_s, prng.key(1), 1)
    k1 = ServeEngine(lm_cfg, None, ensemble=one_rs).generate(e_prompts4, e_new)
    if not (torch.equal(single.tokens, k1.tokens) and torch.equal(single.logprobs, k1.logprobs)):
        raise AssertionError("the K = 1 ensemble differs from the stoch-packed engine")
    print(f"  K = 1: tokens and logprobs equal the stoch-packed engine's bit for bit")
    del one_rs, single, k1
    state = engine.init_decode(e_slots, LM_ENSEMBLE["prompt_len"], e_new)
    for slot in range(e_slots):
        state = engine.prefill_into(state, slot, e_prompts[slot])
    tok = torch.argmax(state.logits, dim=-1)
    e_step = step_costs(lambda: engine.decode_step(state, tok), reps=5)
    lm6f["ensemble"] = {"bytes": rs.tree_nbytes(), "pack_s": e_pack_s,
                        "tok_s": b.tokens_generated / secs, "steps": steps, "seconds": secs,
                        "step": e_step, "agreement": statistics.fmean(agr)}
    print(f"  {ek} replicas {rs.tree_nbytes() / 1e6:.1f} MB (shared leaves once); pack "
          f"{e_pack_s:.3f} s; {lm6f['ensemble']['tok_s']:.1f} tok/s ({steps} steps in "
          f"{secs:.3f} s); decode step wall {e_step[0]:.3f} ms, device {fmt(e_step[1])} ms "
          f"in {fmt_count(e_step[2])} device launches")
    del engine, state, rs, masters
    torch.cuda.empty_cache()

    phase_start["6k"] = time.perf_counter()
    # 6k. StarCoder2-3B at full width and depth on a (2, 2) ("data", "model")
    # mesh whose four positions share the card, placed from 6e's packed det
    # and xnor trees; then a chunked det serve with the prefix cache at
    # LM_6F_LAYERS layers, cut from 6e's det tree
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.layers import apply_linear
    from repro_torch.obs.collectives import predict_call_collectives

    lm_cfg = cb.get_config(LM_ARCH)
    n_proj = 4 * lm_cfg.n_layers
    mesh = SH.Mesh(*LM_MESH, device="cuda")
    groups, n_model = mesh.shape[0], mesh.model_size
    sizes = mesh.axis_sizes()
    m_new, m_slots = LM_SERVE["max_new"], LM_SERVE["slots"]
    proj_kernels = {"det": ("binary_matmul",), "xnor": ("sign_pack", "xnor_matmul")}
    mesh6k = {}
    print(f"== mesh: {mesh} ({mesh.size} positions on one card; single controller: one "
          f"process launches every position's kernels and the collectives between them)")

    def served_logits(engine, prompts, max_new, forced=None):
        """((B, max_new, V) f32 logits, (B, max_new) tokens) of greedy serving
        on B slots through the engine's entry points (prefill_into each slot,
        then decode_step), decoding ``forced`` tokens where given."""
        state = engine.init_decode(len(prompts), len(prompts[0]), max_new)
        for slot, p_ in enumerate(prompts):
            state = engine.prefill_into(state, slot, p_)
        out, toks = [], []
        for i in range(max_new):
            out.append(state.logits.to(torch.float32))
            toks.append(torch.argmax(state.logits, dim=-1) if forced is None else forced[:, i])
            if i < max_new - 1:
                state = engine.decode_step(state, toks[-1])
        return torch.stack(out, 1), torch.stack(toks, 1)

    def near_ties(tag, got, want, margin_of, tol_scale):
        """Holds each stream of ``got`` against ``want`` (uid -> tokens): a
        stream may part only at a step whose top-2 logit margin on the
        single-device path is under ``tol_scale`` of the largest logit;
        returns (streams equal, near ties)."""
        n_eq = ties = 0
        for uid, w_ in want.items():
            if got[uid] == w_:
                n_eq += 1
                continue
            i = first_diff(got[uid], w_)
            lg_ = margin_of(uid)[i]
            tol_, marg = tol_scale * lg_.abs().max().item(), top2_margin(lg_).item()
            print(f"  {tag} request {uid}: equal up to step {i}, where the single-device "
                  f"top-2 margin is {marg:.4g} (tolerance {tol_:.4g})")
            if marg >= tol_:
                raise AssertionError(f"{tag}: request {uid} parts from the single-device "
                                     f"stream with a top-2 margin above the tolerance")
            ties += 1
        return n_eq, ties

    for mode in ("det", "xnor"):
        keep = lm_keep.pop(mode)
        print(f"== serve {LM_ARCH} full width ({lm_cfg.n_layers} layers) --packed --binarize "
              f"{mode} on the mesh, placed from 6e's tree: {LM_SERVE}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = ServeEngine(lm_cfg, keep["params"], mesh=mesh, plan=keep["plan"])
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        single = ServeEngine(lm_cfg, keep["params"])
        per_pos = SH.position_nbytes(engine.params)
        print(f"  placed in {place_s:.3f} s: {', '.join(f'{b_ / 1e6:.1f}' for b_ in per_pos.flat)}"
              f" MB a position (row-major), {sum(per_pos.flat) / 1e6:.1f} MB in all")

        # every projection at its mesh shards against the single-device call, bit
        # for bit: K2's column sums and K4's popcounts do not depend on N or M
        view = SH.group_view(engine.params, 0)
        n_checked = 0
        for blk, name in (("attn", "w_qkv"), ("attn", "w_o"), ("mlp", "wi"), ("mlp", "wo")):
            whole_leaf = keep["params"]["layers"][blk][name]
            for layer in range(lm_cfg.n_layers):
                x = torch.randn(m_slots // groups, 1, whole_leaf.k, generator=g,
                                device=dev).to(torch.bfloat16)
                a_ = apply_linear(view["layers"][blk][name][layer], x)
                b_ = apply_linear(whole_leaf[layer], x)
                if not torch.equal(a_, b_):
                    raise AssertionError(f"{LM_ARCH} {mode} mesh: {blk}/{name} layer {layer} "
                                         f"differs from the single-device projection")
                n_checked += 1
        what = ("K2 column shards" if mode == "det"
                else "K3 + K4 column shards and int32 row partials")
        print(f"  all {n_checked} projections ({what}) equal the single-device call bit for "
              f"bit on a group's 2 rows")

        t_parts = {"place and projection checks": time.perf_counter() - t0}
        reset_counts()
        SH.reset_collective_counts()
        t0 = time.perf_counter()
        streams, b, steps, secs = serve_streams(engine, keep["prompts"], m_new, m_slots)
        t_parts["serve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        calls = LM_SERVE["requests"] * n_model + (steps - 1) * n_model * groups
        print(f"  {LM_SERVE['requests']} prefills x {n_model} positions + {steps - 1} decode "
              f"steps x {mesh.size} positions, x {n_proj} projections")
        expect_counts(f"{LM_ARCH} {mode} mesh", (f"{mode} mesh", mode),
                      {name: n_proj * calls for name in proj_kernels[mode]})
        p1 = predict_call_collectives(keep["plan"], sizes, groups=1)
        p2 = predict_call_collectives(keep["plan"], sizes, groups=groups)
        want_c = {k_: LM_SERVE["requests"] * p1[k_] + (steps - 1) * p2[k_] for k_ in p1}
        got_c = SH.collective_counts()
        print(f"  collectives over the serve {got_c} (the plan's prediction {want_c})")
        if got_c != want_c:
            raise AssertionError(f"{LM_ARCH} {mode} mesh: collectives {got_c} != {want_c}")

        # the streams against 6e's single-device ones, near ties counted
        prompts_t = {uid: torch.from_numpy(p_[None]).to(dev)
                     for uid, p_ in enumerate(keep["prompts"])}
        n_eq, ties = near_ties(f"{LM_ARCH} {mode} mesh", streams, keep["streams"],
                               lambda uid: lm_greedy(single, prompts_t[uid], m_new)[0],
                               LM_LOGIT_TOL)
        print(f"  {n_eq}/{len(streams)} mesh streams equal 6e's single-device streams, "
              f"{ties} parting at a near tie")

        # the logits of the first 4 requests, both engines decoding 6e's tokens
        s_lg, s_tok = served_logits(single, keep["prompts"][:m_slots], m_new)
        m_lg, _ = served_logits(engine, keep["prompts"][:m_slots], m_new, forced=s_tok)
        err = (m_lg - s_lg).abs().amax(dim=-1)
        tol = LM_LOGIT_TOL * s_lg.abs().amax(dim=-1)
        n_bitwise = int((m_lg == s_lg).all(dim=-1).sum())
        print(f"  logits of the first {m_slots} requests x {m_new} steps vs single-device: "
              f"max_abs_err {err.max().item():.4g} (tolerance at least "
              f"{tol.min().item():.4g}); {n_bitwise}/{err.numel()} steps bit for bit")
        if (err > tol).any():
            raise AssertionError(f"{LM_ARCH} {mode} mesh: logits past the tolerance")
        t_parts["streams and logits checks"] = time.perf_counter() - t0
        t0 = time.perf_counter()

        # a decode step: wall, device ms, launches, collectives
        state = engine.init_decode(m_slots, LM_SERVE["prompt_len"], m_new)
        for slot in range(m_slots):
            state = engine.prefill_into(state, slot, keep["prompts"][slot])
        tok = torch.argmax(state.logits, dim=-1)
        step_wall = []
        for _ in range(m_new - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = engine.decode_step(state, tok)
            torch.cuda.synchronize()
            step_wall.append(time.perf_counter() - t0)
        step_ms = statistics.median(step_wall) * 1e3
        step_state = engine.init_decode(m_slots, LM_SERVE["prompt_len"], m_new)
        SH.reset_collective_counts()
        engine.decode_step(step_state, tok)
        step_c = SH.collective_counts()
        if step_c != p2:
            raise AssertionError(f"{LM_ARCH} {mode} mesh: a decode step's collectives "
                                 f"{step_c} != the plan's prediction {p2}")
        # one profile for both numbers: a mesh step records ~5,500 launches a rep
        events = profile_events(lambda: engine.decode_step(step_state, tok), reps=3)
        step_dev = events and sum(t for t, _ in events.values()) / 3 / 1e3
        step_n = events and sum(c for _, c in events.values()) / 3
        peak = torch.cuda.max_memory_allocated() - live
        t_parts["step timing"] = time.perf_counter() - t0
        print("  seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t_parts.items()))
        mesh6k[mode] = {"tok_s": b.tokens_generated / secs, "seconds": secs, "steps": steps,
                        "ttft_ms": statistics.median(r.ttft for r in b.completed) * 1e3,
                        "step_ms": step_ms, "step_device_ms": step_dev,
                        "step_launches": step_n, "collectives": step_c,
                        "bytes_per_position": [int(v) for v in per_pos.flat],
                        "peak_gb": peak / 1e9, "place_s": place_s, "n_equal": n_eq,
                        "near_ties": ties, "logit_err": err.max().item(),
                        "steps_bitwise": n_bitwise, "proj_launches": n_proj * n_model * groups}
        print(f"  {mesh6k[mode]['tok_s']:.1f} tok/s ({steps} steps in {secs:.3f} s), median "
              f"TTFT {mesh6k[mode]['ttft_ms']:.1f} ms; decode step {step_ms:.3f} ms median "
              f"(synced), device {fmt(step_dev)} ms in {fmt_count(step_n)} device launches "
              f"({n_proj * n_model * groups} of them the projections' "
              f"{'K2' if mode == 'det' else 'K3 + K4 pairs'}), collectives a step {step_c}; "
              f"peak allocated {peak / 1e9:.2f} GB above the {live / 1e9:.2f} GB held")
        if mode == "det":
            det_tree = keep["params"]
        del engine, single, state, step_state, keep, view

    # chunked det with the prefix cache on the mesh, 6e's det tree cut to
    # LM_6F_LAYERS layers, against whole-prompt admission on the same mesh
    cfg10 = dataclasses.replace(lm_cfg, n_layers=LM_6F_LAYERS)
    cut = dict(det_tree, layers=tree_map(lambda a: a[:LM_6F_LAYERS], det_tree["layers"]))
    n_proj10 = 4 * LM_6F_LAYERS
    print(f"== serve {LM_ARCH} det on the mesh, {LM_6F_LAYERS} of 30 layers cut from 6e's "
          f"tree, chunked prefill and the prefix cache: {LM_CHUNK}, request {repeat} "
          f"repeating request {LM_REPEAT_OF}'s prompt, against whole-prompt admission on "
          f"the mesh")
    engine = ServeEngine(cfg10, cut, mesh=mesh)
    whole10, wb, _, wsecs = serve_streams(engine, chunk_prompts, c_new, c_slots)
    pc, reg = PrefixCache(max_entries=LM_CHUNK["prefix_cache"]), MetricsRegistry()
    reset_counts()
    streams10, b, steps, secs = serve_streams(engine, chunk_prompts, c_new, c_slots,
                                              prefill_chunk=c_len, prefix_cache=pc,
                                              metrics=reg)
    chunks = int(reg["serve_prefill_chunks_total"].value)
    calls = n_model * (groups * (steps - 1) + chunks)
    print(f"  {steps - 1} decode steps x {mesh.size} positions + {chunks} prefill chunks x "
          f"{n_model} positions, x {n_proj10} projections")
    expect_counts(f"{LM_ARCH} det mesh chunked", ("det mesh chunked", "det"),
                  {"binary_matmul": n_proj10 * calls})
    st = pc.stats()
    print(f"  prefix cache: {st}")
    if st["hits"] < 1 or streams10[repeat] != streams10[LM_REPEAT_OF]:
        raise AssertionError(f"{LM_ARCH} det mesh chunked: no prefix hit, or request "
                             f"{repeat}'s full-prompt hit differs from request "
                             f"{LM_REPEAT_OF}'s stream")
    single10 = ServeEngine(cfg10, cut)
    lg10 = lm_greedy(single10, torch.from_numpy(np.stack(chunk_prompts)).to(dev), c_new)
    n_eq10, ties10 = near_ties(f"{LM_ARCH} det mesh chunked", streams10, whole10,
                               lambda uid: lg10[uid], LM_6F_LOGIT_TOL)
    mesh6k["chunked"] = {"tok_s": b.tokens_generated / secs, "whole_tok_s":
                         wb.tokens_generated / wsecs, "steps": steps, "chunks": chunks,
                         "prefix": st, "n_equal": n_eq10, "near_ties": ties10,
                         "n": len(chunk_prompts)}
    print(f"  {n_eq10}/{len(chunk_prompts)} chunked mesh streams equal the whole-prompt mesh "
          f"streams, {ties10} parting at a near tie; {mesh6k['chunked']['tok_s']:.1f} tok/s "
          f"chunked, {mesh6k['chunked']['whole_tok_s']:.1f} whole-prompt")
    del engine, single10, cut, det_tree, lg10
    torch.cuda.empty_cache()

    phase_start["6g"] = time.perf_counter()
    # 6g. the MoE family: the expert-batched K2 at Moonlight's expert shapes,
    # then Moonlight-16B-A3B at full width (MOE_LAYERS of its 48 layers)
    # served in det and stoch
    from repro_torch.models import moe as moe_mod

    print("== expert-batched K2 vs plain at Moonlight's expert shapes (E = 64 experts, M = 8 "
          "rows: the decode capacity), a ragged shape and K past 2048 (several word rows a "
          "chain, M in two row chunks), f32 and bf16, scaled and not, all rows live and "
          "routed (rows = per-expert counts: all empty, one expert full, a decode step's 4 "
          "tokens x top-6, past M): within tolerance, each expert's live rows bit for bit a "
          "2-D K2 call on its slices and the rows past its count +0 [* scale], two calls "
          "bit-identical, one launch a call")
    cpu_g = torch.Generator().manual_seed(0)
    for e_, m, k, n in MOE_K2 + [(3, 5, 100, 70), (2, 9, 16500, 36)]:
        x32 = torch.randn(e_, m, k, generator=g, device=dev)
        wp = torch.stack([binarize_pack(torch.randn(k, n, generator=g, device=dev),
                                        stochastic=False) for _ in range(e_)])
        scale = torch.rand(e_, n, generator=g, device=dev) + 0.5
        top = torch.stack([torch.randperm(e_, generator=cpu_g)[:min(6, e_)] for _ in range(4)])
        one = torch.zeros(e_, dtype=torch.int64)
        one[e_ // 2] = m
        routings = {None: None, "all empty": torch.zeros(e_, dtype=torch.int64),
                    "one full": one,
                    "decode 4 x top-6": torch.bincount(top.reshape(-1), minlength=e_),
                    "past M": torch.randint(m + 1, 3 * m + 1, (e_,), generator=cpu_g)}
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            x = x32.to(dtype)
            for s in (None, scale):
                loop = torch.stack([binary_matmul(x[i], wp[i], None if s is None else s[i])
                                    for i in range(e_)])
                for route, counts in routings.items():
                    rows = None if counts is None else counts.to(dev)
                    n_before = binary_matmul_batched.launches
                    got = binary_matmul_batched(x, wp, s, rows)
                    if binary_matmul_batched.launches - n_before != 1:
                        raise AssertionError("batched K2: not one launch a call")
                    want = binary_matmul_batched_plain(x, wp, s, rows)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    tag = (f"{e_}x{m}x{k}x{n} {str(dtype)[6:]} "
                           f"{'scaled' if s is not None else 'unscaled'} "
                           f"{'all rows' if route is None else route}")
                    print(f"  {tag}: max_abs_err {err:.3e} (|want| max "
                          f"{want.abs().max().item():.3e})")
                    torch.testing.assert_close(got, want, **tol, msg=f"batched K2 {tag}")
                    live = [m] * e_ if counts is None else counts.clamp(max=m).tolist()
                    for i, c in enumerate(live):
                        if not torch.equal(got[i, :c], loop[i, :c]):
                            raise AssertionError(f"batched K2 {tag}: expert {i}'s live rows "
                                                 f"differ from the 2-D K2 loop")
                        if (got[i, c:] != 0).any() or torch.signbit(got[i, c:]).any():
                            raise AssertionError(f"batched K2 {tag}: expert {i}'s rows past "
                                                 f"its count are not +0")
                    if not torch.equal(binary_matmul_batched(x, wp, s, rows), got):
                        raise AssertionError(f"batched K2 {tag}: two calls differ")
                    if e_ == 64 and dtype == torch.bfloat16 and s is not None:
                        errs["k2_moe"] = max(errs.get("k2_moe", 0.0), err)
        del x32, wp, scale
    print("  every case's live rows equal to the 2-D loop, the rest +0, bit-identical over "
          "two calls")
    for k, n in MOE_ATTN_KN:
        x = torch.randn(4, k, generator=g, device=dev).to(torch.bfloat16)
        wp = binarize_pack(torch.randn(k, n, generator=g, device=dev), stochastic=False)
        scale = torch.rand(n, generator=g, device=dev) + 0.5
        got, want = binary_matmul(x, wp, scale), binary_matmul_plain(x, wp, scale)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        print(f"  K2 at {MOE_ARCH}'s attention 4x{k}x{n} bf16 scaled: max_abs_err {err:.3e}")
        torch.testing.assert_close(got, want, **F32_TOL, msg=f"K2 {MOE_ARCH} 4x{k}x{n}")
        errs["k2_moe_attn"] = max(errs.get("k2_moe_attn", 0.0), err)

    moe_cfg = dataclasses.replace(cb.get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    n_exp_proj = 3 * MOE_LAYERS                   # expert projections a model call
    n_attn_proj = 2 * MOE_LAYERS                  # attention projections a model call
    k1_moe = MOE_LAYERS * (2 + 3 * moe_cfg.n_experts)


    @contextlib.contextmanager
    def record_moe(into: list):
        """Records (tokens, dropped fraction) of every MoE layer the model runs
        (a host read a layer: for measuring, never inside a timed run)."""
        orig = moe_mod.moe_ffn

        def rec(cfg, params, x):
            y, aux = orig(cfg, params, x)
            into.append((x.shape[0] * x.shape[1], float(aux["dropped_frac"])))
            return y, aux

        moe_mod.moe_ffn = rec
        try:
            yield
        finally:
            moe_mod.moe_ffn = orig


    @contextlib.contextmanager
    def record_rows(into: list):
        """Records the rows (per-expert counts) every expert-batched K2 call
        gets, as a copy."""
        orig = kops_mod._binary_matmul_batched

        def rec(x, w_packed, scale=None, rows=None):
            into.append(rows.clone())
            return orig(x, w_packed, scale, rows)

        kops_mod._binary_matmul_batched = rec
        try:
            yield
        finally:
            kops_mod._binary_matmul_batched = orig


    def flipped(probs, own, other):
        """(tokens whose k experts in ``other`` differ from their ``own``, the
        largest router-logit gap at such a token: log p of its own k-th expert
        less log p of an expert ``other`` took in its place, from ``probs``)."""
        own_s, other_s = own.sort(-1).values, other.sort(-1).values
        rows = (own_s != other_s).any(-1)
        if not rows.any():
            return 0, 0.0
        lp = torch.log(probs[rows])
        kth = lp.gather(1, own[rows]).amin(-1)
        taken = lp.gather(1, other[rows])
        outside = ~(other[rows][:, :, None] == own[rows][:, None, :]).any(-1)
        return int(rows.sum()), (kth[:, None] - taken).masked_fill(~outside, 0.0).max().item()


    @contextlib.contextmanager
    def moe_routing(record=None, replay=None, flips=None):
        """Every MoE layer call's routing: appended to ``record`` as (probs,
        experts); or, with ``replay`` (a record of the same calls), each call
        takes the recorded experts in place of its own top k (weights
        renormalised from its own probabilities) and appends ``flipped`` of
        its own choice against the replayed one to ``flips``."""
        orig = moe_mod.route
        calls = iter(replay or ())

        def hooked(cfg, router, xt):
            probs, w, e = orig(cfg, router, xt)
            if record is not None:
                record.append((probs, e))
            if replay is not None:
                e_r = next(calls)[1]
                flips.append(flipped(probs, e, e_r))
                w, e = probs.gather(1, e_r), e_r
                w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
            return probs, w, e

        moe_mod.route = hooked
        try:
            yield
        finally:
            moe_mod.route = orig


    def moe_greedy(cfg_, params, prompts, max_new, forced=None):
        """(B, max_new, V) f32: each step's logits of greedy generation, or of
        decoding the tokens ``forced`` (B, max_new) in place of the argmax."""
        out = []
        with torch.inference_mode():
            lg, cache = T.prefill(cfg_, params, prompts, max_len=prompts.shape[1] + max_new)
            for i in range(max_new):
                out.append(lg.to(torch.float32))
                if i < max_new - 1:
                    tok = (torch.argmax(lg, dim=-1) if forced is None else forced[:, i])
                    lg, cache = T.decode_step(cfg_, params, cache, tok.to(torch.int32)[:, None])
        return torch.stack(out, 1)


    moe_rows = {}
    for mode in MOE_MODES:
        print(f"== serve {MOE_ARCH} full width, {MOE_LAYERS} of its 48 layers (d_model "
              f"{moe_cfg.d_model}, {moe_cfg.n_experts} experts of d_ff {moe_cfg.d_ff}, top-"
              f"{moe_cfg.experts_per_token}, vocab {moe_cfg.vocab_size}, {moe_cfg.dtype}) --packed "
              f"--binarize {mode}: {LM_SERVE}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        reset_counts()
        res = serve_lm(arch=MOE_ARCH, n_layers=MOE_LAYERS, packed=True, binarize=mode,
                       device="cuda", **LM_SERVE)
        calls = LM_SERVE["requests"] + res.steps - 1      # prefills + decode steps
        print(f"  {LM_SERVE['requests']} prefills + {res.steps - 1} decode steps x ({n_attn_proj} "
              f"K2 + {n_exp_proj} expert-batched K2), {k1_moe} K1 at pack time")
        got = launch_counts()
        want = {name: 0 for name in counters}
        want.update(binarize_pack=k1_moe, binary_matmul=n_attn_proj * calls,
                    binary_matmul_batched=n_exp_proj * calls)
        print(f"  launches {got}")
        if got != want:
            raise AssertionError(f"{MOE_ARCH} {mode}: expected launches {want}")
        for name, count in got.items():
            launches[name][(MOE_ARCH, mode)] = count
        run_mode[(MOE_ARCH, mode)] = mode
        peak = torch.cuda.max_memory_allocated() - live
        engine = res.engine
        done = sorted(res.batcher.completed, key=lambda r: r.uid)
        if len(done) != LM_SERVE["requests"] or res.tokens != 16 * LM_SERVE["max_new"]:
            raise AssertionError(f"{MOE_ARCH} {mode}: served {len(done)} requests, "
                                 f"{res.tokens} tokens")

        # the served words against a plain pack of the same masters at key(seed + 1)
        masters = T.init_lm(moe_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        plan = compile_plan(masters, DEFAULT_POLICY, mode)
        with plain_kernels():
            plain = plan.pack(masters, key=prng.key(1))
        n_slices = 0
        for (path, a), (_, b) in zip(tree_leaves_with_path(engine.params),
                                     tree_leaves_with_path(plain)):
            if hasattr(a, "packed"):
                if type(a) is not type(b) or not torch.equal(a.packed, b.packed):
                    raise AssertionError(f"{MOE_ARCH} {mode}: served {path} differs from the "
                                         f"plain pack")
                n_slices += a.packed[..., 0, 0].numel()
        stoch_note = ""
        if mode == "stoch":
            # the threefry twin on the card against the CPU: two expert slices
            row = plan["layers/moe/w_down"]
            e_ = moe_cfg.n_experts
            keys = prng.split(prng.fold_in(prng.key(1), row.index), MOE_LAYERS * e_)
            served = engine.params["layers"]["moe"]["w_down"].packed
            for layer, expert in ((0, 0), (MOE_LAYERS - 1, e_ - 1)):
                cpu = kops_mod.binarize_and_pack(
                    masters["layers"]["moe"]["w_down"][layer, expert].cpu(),
                    keys[layer * e_ + expert], stochastic=True)
                if not torch.equal(served[layer, expert].cpu(), cpu):
                    raise AssertionError(f"{MOE_ARCH} stoch: w_down layer {layer} expert "
                                         f"{expert} words differ from the CPU's")
            stoch_note = (f"; w_down (layer 0, expert 0) and (layer {MOE_LAYERS - 1}, expert "
                          f"{e_ - 1}) equal a CPU pack at their split keys")
        del masters, plain
        torch.cuda.empty_cache()
        print(f"  {n_slices} served (K, N) slices (K1) == plain pack{stoch_note}")

        # greedy logits of the first 4 requests against the plain kernels. The
        # plain run decodes the kernel run's tokens on the kernel run's routing:
        # a token whose router scores two experts within rounding of each other
        # may route to either, and another expert in a top 6 moves the logits
        # further than the kernels' rounding does; such flips are counted and
        # held to MOE_ROUTE_TIE, and each step's argmax may part only at a near
        # tie of the plain logits
        prompts = torch.from_numpy(np.stack([r.prompt for r in done[:4]])).to(dev)
        routes, flips = [], []
        with moe_routing(record=routes):
            k_lg = moe_greedy(moe_cfg, engine.params, prompts, LM_SERVE["max_new"])
        k_tok = k_lg.argmax(-1)
        with plain_kernels(), moe_routing(replay=routes, flips=flips):
            p_lg = moe_greedy(moe_cfg, engine.params, prompts, LM_SERVE["max_new"],
                              forced=k_tok)
        n_flip = sum(n for n, _ in flips)
        gap = max(gp for _, gp in flips)
        n_routed = sum(int(e.shape[0]) for _, e in routes)
        print(f"  routing: {n_flip} of {n_routed} token routings (tokens x layers) of the plain "
              f"kernels differ from the kernels' (the plain run takes the kernels'); largest "
              f"router-logit gap at a flip {gap:.4g} (near-tie bound {MOE_ROUTE_TIE})")
        if gap >= MOE_ROUTE_TIE:
            raise AssertionError(f"{MOE_ARCH} {mode}: a routing flip at a gap of {gap}")
        del routes
        tol = LM_LOGIT_TOL * p_lg.abs().amax(dim=-1)           # (4, steps)
        err = (k_lg - p_lg).abs().amax(dim=-1)
        print(f"  logits vs the plain kernels, largest over the {LM_SERVE['max_new']} steps: "
              f"max_abs_err per request {[round(e, 5) for e in err.amax(-1).tolist()]} "
              f"(tolerance {[round(t, 5) for t in tol.amin(-1).tolist()]} at the least)")
        if (err > tol).any():
            raise AssertionError(f"{MOE_ARCH} {mode}: logits differ from the plain kernels")
        margin = top2_margin(p_lg)
        parted = (k_tok != p_lg.argmax(-1)) & (margin >= tol)
        if parted.any():
            raise AssertionError(f"{MOE_ARCH} {mode}: a greedy token differs from the plain "
                                 f"kernels' at a top-2 margin above the tolerance")
        print(f"  greedy tokens equal the plain kernels' at {int((k_tok == p_lg.argmax(-1)).sum())} "
              f"of {k_tok.numel()} steps, the rest at a near tie (smallest top-2 margin "
              f"{margin.min().item():.4g})")
        err0 = err.amax(-1)

        # every stream equals the one-shot generate of its request
        for r in done:
            one = engine.generate(r.prompt[None], r.max_new).tokens[0].tolist()
            if one != r.generated:
                raise AssertionError(f"{MOE_ARCH} {mode}: request {r.uid}'s stream differs "
                                     f"from its one-shot generate")
        print(f"  all {len(done)} streams equal the one-shot generate of their request")

        # the dropped fraction at the decode capacity (4 slots) and at the
        # prefill capacity (one 32-token prompt)
        state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])
        drops_prefill, drops_decode = [], []
        with record_moe(drops_prefill):
            for slot in range(4):
                state = engine.prefill_into(state, slot, done[slot].prompt)
        tok = torch.argmax(state.logits, dim=-1)
        decode_rows = []
        with record_moe(drops_decode), record_rows(decode_rows):
            state = engine.decode_step(state, tok)
        if mode == "det":
            # the served decode routing, one count vector a layer (its three
            # projections share it), for phase 7's timing
            moe_decode_rows = decode_rows[::3]
            cap4 = moe_mod.capacity(moe_cfg, 4)
            print(f"  decode step routing: {len(moe_decode_rows)} layers, live experts a "
                  f"layer {[int((r > 0).sum()) for r in moe_decode_rows]} (of "
                  f"{moe_cfg.n_experts}), live rows a layer "
                  f"{[int(r.clamp(max=cap4).sum()) for r in moe_decode_rows]}")
        cap_p = moe_mod.capacity(moe_cfg, drops_prefill[0][0])
        cap_d = moe_mod.capacity(moe_cfg, drops_decode[0][0])
        dp = statistics.mean(d for _, d in drops_prefill)
        dd = statistics.mean(d for _, d in drops_decode)
        print(f"  dropped fraction: prefill ({drops_prefill[0][0]} tokens, capacity {cap_p}) "
              f"{dp:.5g} mean over {len(drops_prefill)} layer calls (max "
              f"{max(d for _, d in drops_prefill):.5g}); decode ({drops_decode[0][0]} tokens, "
              f"capacity {cap_d}) {dd:.5g} (the reference's 1 - mean(keep), with its rounding)")

        # decode step: wall (synced), device time and launches (profiler)
        step_wall = []
        for _ in range(LM_SERVE["max_new"] - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = engine.decode_step(state, tok)
            torch.cuda.synchronize()
            step_wall.append(time.perf_counter() - t0)
        step_ms = statistics.median(step_wall) * 1e3
        step_state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])

        def one_step():
            engine.decode_step(step_state, tok)

        step_kern = profiled(one_step, reps=5)
        step_dev = step_kern and sum(step_kern.values())
        step_n = kernels_per_rep(one_step, reps=5)
        top = sorted((step_kern or {}).items(), key=lambda kv: -kv[1])[:4]
        step_k2b = step_kern and sum(v for name, v in step_kern.items()
                                     if "binary_matmul_batched_kernel" in name)
        moe_rows[mode] = {
            "pack_s": res.pack_seconds, "dense_mb": res.dense_bytes / 1e6,
            "served_mb": res.packed_bytes / 1e6, "tok_s": res.tok_per_s,
            "ttft_ms": res.median_ttft * 1e3, "latency_ms": res.median_latency * 1e3,
            "step_ms": step_ms, "step_device_ms": step_dev, "step_launches": step_n,
            "step_k2b_ms": step_k2b, "peak_gb": peak / 1e9, "seconds": res.seconds,
            "steps": res.steps,
            "max_abs_err": err0.max().item(), "drop_prefill": dp, "drop_decode": dd,
            "flips": (n_flip, n_routed, gap)}
        print(f"  pack {res.pack_seconds:.3f} s; {res.dense_bytes / 1e6:.1f} MB bf16 dense -> "
              f"{res.packed_bytes / 1e6:.1f} MB served; {res.tok_per_s:.1f} tok/s, median TTFT "
              f"{res.median_ttft * 1e3:.1f} ms, median latency {res.median_latency * 1e3:.1f} ms; "
              f"decode step {step_ms:.3f} ms median (synced), device {fmt(step_dev)} ms in "
              f"{fmt_count(step_n)} device launches (torch.profiler, 5 steps), of which "
              f"expert-batched K2 {fmt(step_k2b)} ms; peak allocated "
              f"{peak / 1e9:.2f} GB above the {live / 1e9:.2f} GB earlier phases hold; top: "
              + "; ".join(f"{k[:50]} {v:.4f}" for k, v in top))

        if mode == "det":
            # chunked admission with the prefix cache, from the same engine:
            # streams against its whole-prompt streams. A chunk of 8 tokens
            # drops no assignment (8 x top-6 over 64 experts of capacity 8);
            # a whole 32-token prompt may (capacity 8 for 192 assignments), so
            # a request whose whole-prompt prefill dropped one may part.
            c_ = MOE_CHUNK
            rng = np.random.default_rng(0)
            shared = rng.integers(0, moe_cfg.vocab_size, c_["shared_prefix"])
            cprompts = []
            for _ in range(c_["requests"]):
                p_ = rng.integers(0, moe_cfg.vocab_size, c_["prompt_len"])
                p_[:len(shared)] = shared
                cprompts.append(p_)
            whole, _, _, _ = serve_streams(engine, cprompts, c_["max_new"], c_["slots"])
            no_prefix, _, _, _ = serve_streams(engine, cprompts, c_["max_new"], c_["slots"],
                                               prefill_chunk=c_["prefill_chunk"])
            pc = PrefixCache(max_entries=c_["prefix_cache"])
            reg = MetricsRegistry()
            reset_counts()
            streams, cb_, csteps, csecs = serve_streams(
                engine, cprompts, c_["max_new"], c_["slots"], prefill_chunk=c_["prefill_chunk"],
                prefix_cache=pc, metrics=reg)
            chunks = int(reg["serve_prefill_chunks_total"].value)
            got = launch_counts()
            ccalls = csteps - 1 + chunks
            want = {name: 0 for name in counters}
            want.update(binary_matmul=n_attn_proj * ccalls, binary_matmul_batched=n_exp_proj * ccalls)
            print(f"  chunked det ({c_}): {csteps - 1} decode steps + {chunks} chunks; launches "
                  f"{got}; prefix cache {pc.stats()}")
            if got != want:
                raise AssertionError(f"{MOE_ARCH} det chunked: expected launches {want}")
            for name, count in got.items():
                launches[name][(MOE_ARCH, "det chunked")] = count
            run_mode[(MOE_ARCH, "det chunked")] = "det"
            if pc.stats()["hits"] < 1:
                raise AssertionError(f"{MOE_ARCH} det chunked: no prefix hit")
            # a prefix hit splices the rows its chunks would compute: the streams
            # equal the same chunked admission without the cache, bit for bit
            if streams != no_prefix:
                raise AssertionError(f"{MOE_ARCH} det chunked: the prefix cache changed a stream")
            print(f"  all {len(cprompts)} streams equal the chunked serve's without the prefix "
                  f"cache")
            lg = moe_greedy(moe_cfg, engine.params, torch.from_numpy(np.stack(cprompts)).to(dev),
                            c_["max_new"])
            tol = LM_LOGIT_TOL * lg.abs().amax(dim=-1)
            margin = top2_margin(lg)

            def path_routes(prompt, forced, chunk):
                """Routing records of one request's greedy path on one slot:
                its prompt prefilled whole (chunk 0) or by chunks, then the
                ``forced`` tokens decoded; each prefill layer's records joined
                along the tokens."""
                rec = []
                st_ = engine.init_decode(1, c_["prompt_len"], c_["max_new"])
                with moe_routing(record=rec):
                    if chunk:
                        for off in range(0, len(prompt), chunk):
                            st_ = engine.prefill_chunk_into(st_, 0, prompt[off:off + chunk], off)
                    else:
                        st_ = engine.prefill_into(st_, 0, prompt)
                    for t_ in forced:
                        st_ = engine.decode_step(st_, torch.tensor([t_], device=dev))
                n_pre = moe_cfg.n_layers * (len(prompt) // chunk if chunk else 1)
                pre = [(torch.cat([rec[c * moe_cfg.n_layers + l_][0] for c in
                                   range(n_pre // moe_cfg.n_layers)]),
                        torch.cat([rec[c * moe_cfg.n_layers + l_][1] for c in
                                   range(n_pre // moe_cfg.n_layers)]))
                       for l_ in range(moe_cfg.n_layers)]
                return pre + rec[n_pre:]

            n_equal = n_dropped = n_flipped = 0
            for uid, p_ in enumerate(cprompts):
                drops = []
                with record_moe(drops):
                    T.prefill(moe_cfg, engine.params, torch.from_numpy(p_[None]).to(dev))
                dropped = any(d > 0 for _, d in drops)
                n_dropped += dropped
                if streams[uid] == whole[uid]:
                    n_equal += 1
                    continue
                i = first_diff(streams[uid], whole[uid])
                note = (f"  request {uid}: chunked stream equals the whole-prompt one up to step "
                        f"{i} (top-2 margin {margin[uid, i].item():.4g}, tolerance "
                        f"{tol[uid, i].item():.4g})")
                if dropped:       # the whole prompt ran a different FFN: no tie to look for
                    print(f"{note}; its whole-prompt prefill dropped assignments")
                    continue
                rw = path_routes(p_, whole[uid][:i], 0)
                rc = path_routes(p_, whole[uid][:i], c_["prefill_chunk"])
                fl = [flipped(pw, ew, ec) for (pw, ew), (_, ec) in zip(rw, rc)]
                n_fl, gap_fl = sum(n for n, _ in fl), max(gp for _, gp in fl)
                n_flipped += n_fl > 0
                print(f"{note}; no drop; {n_fl} token routings differ between the chunked and "
                      f"whole paths up to there (largest router-logit gap {gap_fl:.4g})")
                if gap_fl >= MOE_ROUTE_TIE:
                    raise AssertionError(f"{MOE_ARCH} det: request {uid}: a routing flip at a "
                                         f"gap of {gap_fl}")
                if not n_fl and margin[uid, i] >= tol[uid, i]:
                    raise AssertionError(f"{MOE_ARCH} det: request {uid}'s chunked stream "
                                         f"diverges with no drop, no routing flip and a margin "
                                         f"above the tolerance")
            moe_rows["chunked"] = {"tok_s": cb_.tokens_generated / csecs, "steps": csteps,
                                   "chunks": chunks, "n_equal": n_equal, "n_req": len(cprompts),
                                   "n_dropped": n_dropped, "n_flipped": n_flipped,
                                   "prefix": pc.stats(),
                                   "ttft_ms": statistics.median(r.ttft for r in cb_.completed) * 1e3}
            print(f"  {n_equal}/{len(cprompts)} chunked streams equal the whole-prompt streams; "
                  f"{n_dropped} whole-prompt prefills dropped assignments, {n_flipped} differing "
                  f"streams met a routing flip; "
                  f"{moe_rows['chunked']['tok_s']:.1f} tok/s, median TTFT "
                  f"{moe_rows['chunked']['ttft_ms']:.1f} ms")
        del res, engine, state, step_state, k_lg, p_lg
        torch.cuda.empty_cache()

    phase_start["6h"] = time.perf_counter()
    # 6h. the SSM family: mamba2-130m at its full CONFIG width (all 24 layers)
    # served in det, stoch and xnor; a chunked det serve with the prefix
    # cache; a 200-token prefill (two SSD chunks, padded) against the plain
    # kernels
    ssm_cfg = cb.get_config(SSM_ARCH)
    n_ssm_proj = 2 * ssm_cfg.n_layers              # in_proj and out_proj a model call
    ssm_kern_names = ("binary_matmul", "sign_pack", "xnor_")
    ssm_rows = {}

    def ssm_want(mode, calls):
        return {name: n_ssm_proj * calls for name in
                (("sign_pack", "xnor_matmul") if mode == "xnor" else ("binary_matmul",))}

    def logits_against_plain(tag, mode, k_lg, p_lg):
        """The kernel run's logits against the plain kernels' on the same
        card: within LM_LOGIT_TOL of the largest |logit| (xnor bit for
        bit). Returns the largest |difference|."""
        tol = LM_LOGIT_TOL * p_lg.abs().amax(dim=-1)
        err = (k_lg - p_lg).abs().amax(dim=-1)
        if (err > tol).any() or (mode == "xnor" and not torch.equal(k_lg, p_lg)):
            raise AssertionError(f"{tag}: logits differ from the plain kernels (max_abs_err "
                                 f"{err.max().item():.4g}, tolerance {tol.min().item():.4g})")
        return err.max().item()

    for mode in LM_MODES:
        print(f"== serve {SSM_ARCH} full width ({ssm_cfg.n_layers} layers, d_model "
              f"{ssm_cfg.d_model}, d_inner {ssm_cfg.d_inner}, state {ssm_cfg.ssm_state}, "
              f"{ssm_cfg.ssm_heads} heads of {ssm_cfg.ssm_head_dim}, vocab {ssm_cfg.vocab_size}, "
              f"{ssm_cfg.dtype}) --packed --binarize {mode}: {LM_SERVE}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        live = torch.cuda.memory_allocated()
        reset_counts()
        res = serve_lm(arch=SSM_ARCH, packed=True, binarize=mode, device="cuda", **LM_SERVE)
        peak = torch.cuda.max_memory_allocated() - live
        calls = LM_SERVE["requests"] + res.steps - 1      # prefills + decode steps
        print(f"  {LM_SERVE['requests']} prefills + {res.steps - 1} decode steps x "
              f"{n_ssm_proj} projections, {n_ssm_proj} K1 at pack time")
        got = launch_counts()
        want = {name: 0 for name in counters}
        want.update(binarize_pack=n_ssm_proj, **ssm_want(mode, calls))
        print(f"  launches {got}")
        if got != want:
            raise AssertionError(f"{SSM_ARCH} {mode}: expected launches {want}")
        for name, count in got.items():
            launches[name][(SSM_ARCH, mode)] = count
        run_mode[(SSM_ARCH, mode)] = mode
        engine = res.engine
        done = sorted(res.batcher.completed, key=lambda r: r.uid)
        if len(done) != LM_SERVE["requests"] or res.tokens != 16 * LM_SERVE["max_new"]:
            raise AssertionError(f"{SSM_ARCH} {mode}: served {len(done)} requests, "
                                 f"{res.tokens} tokens")

        # the served words against a plain pack of the same masters at key(seed + 1)
        masters = T.init_lm(ssm_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        with plain_kernels():
            plain = compile_plan(masters, DEFAULT_POLICY, mode).pack(masters, key=prng.key(1))
        n_checked = 0
        for (path, a), (_, b) in zip(tree_leaves_with_path(engine.params),
                                     tree_leaves_with_path(plain)):
            if hasattr(a, "packed"):
                if type(a) is not type(b) or not torch.equal(a.packed, b.packed):
                    raise AssertionError(f"{SSM_ARCH} {mode}: served {path} differs from the "
                                         f"plain pack")
                n_checked += a.packed.shape[0]
        del masters, plain
        print(f"  {n_checked} served per-layer leaves (K1) == plain pack")

        # greedy logits against the plain kernels, first 4 requests; then a
        # 200-token prefill: two SSD chunks of 128, the second padded
        prompts = torch.from_numpy(np.stack([r.prompt for r in done[:4]])).to(dev)
        k_lg = lm_greedy(engine, prompts, LM_SERVE["max_new"])
        with plain_kernels():
            p_lg = lm_greedy(engine, prompts, LM_SERVE["max_new"])
        err_first = logits_against_plain(f"{SSM_ARCH} {mode}", mode, k_lg[:, :1], p_lg[:, :1])
        if mode == "xnor" and not torch.equal(k_lg, p_lg):
            raise AssertionError(f"{SSM_ARCH} xnor: greedy logits differ from the plain kernels")
        margin = top2_margin(p_lg)
        tol = LM_LOGIT_TOL * p_lg.abs().amax(dim=-1)
        same = k_lg.argmax(-1) == p_lg.argmax(-1)
        for b in range(prompts.shape[0]):
            bad = (~same[b]).nonzero()
            if len(bad):
                i = bad[0].item()
                print(f"  request {b}: tokens equal the plain kernels' up to step {i}, where "
                      f"the plain run's top-2 margin is {margin[b, i].item():.4g}")
                if margin[b, i] >= tol[b, i]:
                    raise AssertionError(f"{SSM_ARCH} {mode}: request {b} diverges from the "
                                         f"plain kernels with a top-2 margin above tolerance")
        long_prompt = torch.from_numpy(np.random.default_rng(7).integers(
            0, ssm_cfg.vocab_size, (2, SSM_LONG_PROMPT)).astype(np.int32)).to(dev)
        before = launch_counts()
        with torch.inference_mode():
            k_long, k_cache = T.prefill(ssm_cfg, engine.params, long_prompt)
            after = launch_counts()
            with plain_kernels():
                p_long, p_cache = T.prefill(ssm_cfg, engine.params, long_prompt)
        n_long = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        if n_long != ssm_want(mode, 1):
            raise AssertionError(f"{SSM_ARCH} {mode}: a {SSM_LONG_PROMPT}-token prefill "
                                 f"launched {n_long}")
        err_long = logits_against_plain(f"{SSM_ARCH} {mode} {SSM_LONG_PROMPT}-token prefill",
                                        mode, k_long.float(), p_long.float())
        # the final states: bit for bit in xnor (integer popcounts, then the
        # same ops on the same card); in det and stoch they carry K2's f32
        # sum order through 24 bf16 layers, and are reported
        st_err = ((k_cache["ssm"] - p_cache["ssm"]).abs().max()
                  / p_cache["ssm"].abs().max()).item()
        if mode == "xnor" and not (torch.equal(k_cache["ssm"], p_cache["ssm"])
                                   and torch.equal(k_cache["conv"], p_cache["conv"])):
            raise AssertionError(f"{SSM_ARCH} xnor: the {SSM_LONG_PROMPT}-token prefill's "
                                 f"state differs from the plain kernels' ({st_err:.4g})")
        print(f"  logits vs the plain kernels: first step max_abs_err {err_first:.4g}, "
              f"{int(same.sum())}/{same.numel()} greedy tokens equal (smallest top-2 margin "
              f"{margin.min().item():.4g}); a {SSM_LONG_PROMPT}-token prefill ({n_long}): "
              f"logits {err_long:.4g}, final state {st_err:.3g} of its largest |value|")
        del k_lg, p_lg, k_cache, p_cache

        # every stream equals the one-shot generate of its request
        for r in done:
            one = engine.generate(r.prompt[None], r.max_new).tokens[0].tolist()
            if one != r.generated:
                raise AssertionError(f"{SSM_ARCH} {mode}: request {r.uid}'s stream differs "
                                     f"from its one-shot generate")
        print(f"  all {len(done)} streams equal the one-shot generate of their request")

        # decode step: wall, device time, launches; the kernels' share of it
        state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])
        for slot in range(4):
            state = engine.prefill_into(state, slot, done[slot].prompt)
        tok = torch.argmax(state.logits, dim=-1)
        step_ms = synced_ms(lambda: engine.decode_step(state, tok), LM_SERVE["max_new"] - 1)
        step_kern = profiled(lambda: engine.decode_step(state, tok), reps=5)
        step_dev = step_kern and sum(step_kern.values())
        step_n = kernels_per_rep(lambda: engine.decode_step(state, tok), reps=5)
        kern_dev = step_kern and sum(v for k_, v in step_kern.items()
                                     if any(s in k_ for s in ssm_kern_names))
        top = sorted((step_kern or {}).items(), key=lambda kv: -kv[1])[:4]
        ssm_rows[mode] = {
            "pack_s": res.pack_seconds, "dense_mb": res.dense_bytes / 1e6,
            "served_mb": res.packed_bytes / 1e6, "tok_s": res.tok_per_s,
            "ttft_ms": res.median_ttft * 1e3, "latency_ms": res.median_latency * 1e3,
            "step_ms": step_ms, "step_device_ms": step_dev, "step_launches": step_n,
            "step_kernel_ms": kern_dev, "peak_gb": peak / 1e9, "seconds": res.seconds,
            "steps": res.steps, "max_abs_err": err_first, "long_err": err_long,
            "long_state_err": st_err}
        share = (f"{100 * kern_dev / step_dev:.1f}%" if step_dev else "not measured")
        print(f"  pack {res.pack_seconds:.3f} s; {res.dense_bytes / 1e6:.1f} MB bf16 dense -> "
              f"{res.packed_bytes / 1e6:.1f} MB served; {res.tok_per_s:.1f} tok/s, median TTFT "
              f"{res.median_ttft * 1e3:.1f} ms, median latency {res.median_latency * 1e3:.1f} ms; "
              f"decode step {step_ms:.3f} ms median (synced), device {fmt(step_dev)} ms in "
              f"{fmt_count(step_n)} device launches, K2/K3/K4 {fmt(kern_dev)} ms of it "
              f"({share}; the rest the SSD's plain ops, the norms and the head); peak allocated "
              f"{peak / 1e9:.2f} GB; top: " + "; ".join(f"{k_[:50]} {v:.4f}" for k_, v in top))
        del res, engine, state

    # chunked prefill with the prefix cache (det) against whole-prompt admission
    print(f"== serve {SSM_ARCH} full width --packed --binarize det, chunked prefill and the "
          f"prefix cache: {SSM_CHUNK}")
    masters = T.init_lm(ssm_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(ssm_cfg, compile_plan(masters, DEFAULT_POLICY, "det").pack(
        masters, key=prng.key(1)))
    del masters
    rng = np.random.default_rng(1)
    shared = rng.integers(0, ssm_cfg.vocab_size, SSM_CHUNK["shared_prefix"])
    sprompts = [np.concatenate([shared, rng.integers(0, ssm_cfg.vocab_size,
                                                     SSM_CHUNK["prompt_len"] - len(shared))])
                for _ in range(SSM_CHUNK["requests"])]
    s_new, s_slots = SSM_CHUNK["max_new"], SSM_CHUNK["slots"]
    whole, _, _, _ = serve_streams(engine, sprompts, s_new, s_slots)
    pc, reg = PrefixCache(max_entries=SSM_CHUNK["prefix_cache"]), MetricsRegistry()
    reset_counts()
    streams, sb, ssteps, ssecs = serve_streams(engine, sprompts, s_new, s_slots,
                                               prefill_chunk=SSM_CHUNK["prefill_chunk"],
                                               prefix_cache=pc, metrics=reg)
    chunks = int(reg["serve_prefill_chunks_total"].value)
    got = launch_counts()
    want = {name: 0 for name in counters}
    want.update(ssm_want("det", ssteps - 1 + chunks))
    print(f"  {ssteps - 1} decode steps + {chunks} prefill chunks x {n_ssm_proj} projections; "
          f"launches {got}; prefix cache {pc.stats()}")
    if got != want:
        raise AssertionError(f"{SSM_ARCH} det chunked: expected launches {want}")
    for name, count in got.items():
        launches[name][(SSM_ARCH, "det chunked")] = count
    run_mode[(SSM_ARCH, "det chunked")] = "det"
    if pc.hits < 1:
        raise AssertionError(f"{SSM_ARCH} det chunked: no prefix hit")
    lg = lm_greedy(engine, torch.from_numpy(np.stack(sprompts)).to(dev), s_new)
    margin, tol = top2_margin(lg), LM_LOGIT_TOL * lg.abs().amax(dim=-1)
    n_equal = 0
    for uid in range(len(sprompts)):
        if streams[uid] == whole[uid]:
            n_equal += 1
            continue
        i = first_diff(streams[uid], whole[uid])
        print(f"  request {uid}: chunked stream equals the whole-prompt one up to step {i}, "
              f"where the top-2 margin is {margin[uid, i].item():.4g}")
        if margin[uid, i] >= tol[uid, i]:
            raise AssertionError(f"{SSM_ARCH} det: request {uid}'s chunked stream diverges "
                                 f"with a top-2 margin above the tolerance")
    ssm_rows["chunked"] = {"tok_s": sb.tokens_generated / ssecs, "steps": ssteps,
                           "chunks": chunks, "prefix": pc.stats(), "n_equal": n_equal,
                           "n_req": len(sprompts),
                           "ttft_ms": statistics.median(r.ttft for r in sb.completed) * 1e3}
    print(f"  {n_equal}/{len(sprompts)} chunked streams equal the whole-prompt streams "
          f"(smallest top-2 margin on the whole-prompt path {margin.min().item():.4g}); "
          f"{ssm_rows['chunked']['tok_s']:.1f} tok/s, median TTFT "
          f"{ssm_rows['chunked']['ttft_ms']:.1f} ms")
    del engine, lg
    torch.cuda.empty_cache()

    phase_start["6i"] = time.perf_counter()
    # 6i. the hybrid: K2 at jamba-1.5-large's shapes; the draw-and-pack route
    # against plan.pack(init_lm(...)) at SMOKE width on the card; jamba at full
    # width with all 72 layers (det); one period in det and stoch against the
    # plain kernels; a chunked det serve of one period with the prefix cache
    import math

    hyb_cfg = cb.get_config(HYB_ARCH)
    hyb_per = hyb_cfg.attn_period
    n_moe_per = sum(hyb_cfg.moe_layer(j) for j in range(hyb_per))
    hyb_k1 = 2 + 2 * (hyb_per - 1) + 3 * (hyb_per - n_moe_per) + 3 * n_moe_per * hyb_cfg.n_experts
    hyb_k2 = sum(c for _, c in HYB_KN)                  # 2-D K2 a period and model call
    hyb_k2b = 3 * n_moe_per                             # expert-batched K2 likewise
    hyb_rows = {}

    def hyb_want(n_per, calls, packs=True):
        want = {name: 0 for name in counters}
        want.update(binary_matmul=hyb_k2 * n_per * calls,
                    binary_matmul_batched=hyb_k2b * n_per * calls)
        if packs:
            want["binarize_pack"] = hyb_k1 * n_per
        return want

    def hyb_counted(tag, run, mode, want):
        got = launch_counts()
        print(f"  launches {got}")
        if got != want:
            raise AssertionError(f"{HYB_ARCH} {tag}: expected launches {want}")
        for name, count in got.items():
            launches[name][(HYB_ARCH, run)] = count
        run_mode[(HYB_ARCH, run)] = mode

    def same_tree(tag, got, want):
        """Every leaf of two serving trees equal, words, scales and tensors."""
        n = 0
        for (path, a), (_, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
            if type(a) is not type(b):
                raise AssertionError(f"{tag}: {path} is a {type(a).__name__}, want "
                                     f"{type(b).__name__}")
            if hasattr(a, "packed"):
                n += math.prod(a.packed.shape[:-2])
                if not (torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale)):
                    raise AssertionError(f"{tag}: {path}'s words or scales differ")
            elif not torch.equal(a, b):
                raise AssertionError(f"{tag}: {path} differs")
        return n

    def step_profile(engine, state, tok):
        """(wall ms synced median, device ms, device launches, 2-D K2 ms,
        expert-batched K2 ms) of one decode step."""
        step_ms = synced_ms(lambda: engine.decode_step(state, tok), LM_SERVE["max_new"] - 2)
        kern = profiled(lambda: engine.decode_step(state, tok), reps=3)
        n_ = kernels_per_rep(lambda: engine.decode_step(state, tok), reps=3)
        if not kern:
            return step_ms, None, n_, None, None
        return (step_ms, sum(kern.values()), n_,
                sum(v for k_, v in kern.items() if "binary_matmul_kernel" in k_),
                sum(v for k_, v in kern.items() if "binary_matmul_batched_kernel" in k_))

    def share(part, whole):
        return "not measured" if not whole or part is None else f"{100 * part / whole:.1f}%"

    print(f"== K2 vs plain at {HYB_ARCH}'s projection shapes (bf16, M = 4 and 32, scaled; "
          f"K up to 24576, N up to 33280) and the expert-batched K2 at its expert shapes (16 "
          f"experts x 8 rows; all rows, and routed: all empty, one full, a decode step's 4 "
          f"tokens x top-2, past M): within tolerance, two calls bit-identical, each expert's "
          f"live rows bit for bit the 2-D K2 on its slices and +0 past them")
    for (k, n), _ in HYB_KN:
        wp = binarize_pack(torch.randn(k, n, generator=g, device=dev), stochastic=False)
        scale = torch.rand(n, generator=g, device=dev) + 0.5
        for m in (4, 32):
            x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
            got, want = binary_matmul(x, wp, scale), binary_matmul_plain(x, wp, scale)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            print(f"  K2 {m}x{k}x{n} bf16 scaled: max_abs_err {err:.3e} (|want| max "
                  f"{want.abs().max().item():.3e})")
            torch.testing.assert_close(got, want, **F32_TOL, msg=f"K2 {HYB_ARCH} {m}x{k}x{n}")
            if not torch.equal(binary_matmul(x, wp, scale), got):
                raise AssertionError(f"K2 {m}x{k}x{n}: two calls differ")
            errs["k2_hyb"] = max(errs.get("k2_hyb", 0.0), err)
        del wp
    cpu_g = torch.Generator().manual_seed(1)
    for e_, m, k, n in HYB_K2:
        x = torch.randn(e_, m, k, generator=g, device=dev).to(torch.bfloat16)
        wp = torch.stack([binarize_pack(torch.randn(k, n, generator=g, device=dev),
                                        stochastic=False) for _ in range(e_)])
        scale = torch.rand(e_, n, generator=g, device=dev) + 0.5
        loop = torch.stack([binary_matmul(x[i], wp[i], scale[i]) for i in range(e_)])
        top = torch.stack([torch.randperm(e_, generator=cpu_g)[:2] for _ in range(4)])
        one = torch.zeros(e_, dtype=torch.int64)
        one[e_ // 2] = m
        routings = {"all rows": None, "all empty": torch.zeros(e_, dtype=torch.int64),
                    "one full": one,
                    "decode 4 x top-2": torch.bincount(top.reshape(-1), minlength=e_),
                    "past M": torch.randint(m + 1, 3 * m + 1, (e_,), generator=cpu_g)}
        for route, counts in routings.items():
            rows = None if counts is None else counts.to(dev)
            n_before = binary_matmul_batched.launches
            got = binary_matmul_batched(x, wp, scale, rows)
            if binary_matmul_batched.launches - n_before != 1:
                raise AssertionError("batched K2: not one launch a call")
            want = binary_matmul_batched_plain(x, wp, scale, rows)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tag = f"{e_}x{m}x{k}x{n} bf16 scaled {route}"
            print(f"  expert-batched K2 {tag}: max_abs_err {err:.3e}")
            torch.testing.assert_close(got, want, **F32_TOL, msg=f"batched K2 {tag}")
            live = [m] * e_ if counts is None else counts.clamp(max=m).tolist()
            for i, c in enumerate(live):
                if not torch.equal(got[i, :c], loop[i, :c]):
                    raise AssertionError(f"batched K2 {tag}: expert {i}'s live rows differ "
                                         f"from the 2-D K2 loop")
                if (got[i, c:] != 0).any() or torch.signbit(got[i, c:]).any():
                    raise AssertionError(f"batched K2 {tag}: expert {i}'s rows past its "
                                         f"count are not +0")
            if not torch.equal(binary_matmul_batched(x, wp, scale, rows), got):
                raise AssertionError(f"batched K2 {tag}: two calls differ")
            errs["k2_hyb_moe"] = max(errs.get("k2_hyb_moe", 0.0), err)
        del x, wp, scale, loop, want, got
    torch.cuda.empty_cache()

    smoke_cfg = cb.get_config(HYB_ARCH, smoke=True)
    for mode in MOE_MODES:
        masters = T.init_lm(smoke_cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        plan = compile_plan(T.lm_shapes(smoke_cfg), DEFAULT_POLICY, mode)
        if plan.to_json() != compile_plan(masters, DEFAULT_POLICY, mode).to_json():
            raise AssertionError(f"{HYB_ARCH} SMOKE {mode}: the plan from the masters' shapes "
                                 f"differs from the plan from the masters")
        n_ = same_tree(f"{HYB_ARCH} SMOKE {mode} draw-and-pack",
                       plan.pack_drawn(T.lm_draws(smoke_cfg),
                                       torch.Generator(device=dev).manual_seed(0),
                                       key=prng.key(1), device=dev),
                       plan.pack(masters, key=prng.key(1)))
        print(f"  {HYB_ARCH} SMOKE ({smoke_cfg.n_layers} layers, 2 periods) {mode}: the plan "
              f"from the masters' shapes equals the plan from the masters, and the "
              f"draw-and-pack route equals plan.pack(init_lm(...)) on the card, {n_} (K, N) "
              f"matrices and every other leaf bit for bit")
    del masters

    # all 72 layers at full width (det)
    n_per = hyb_cfg.n_layers // hyb_per
    words_gb = sum(math.prod(d.shape[:-2]) * -(-d.shape[-2] // 32) * d.shape[-1] * 4
                   for d in T.lm_draws(hyb_cfg) if d.fan_in is not None) / 1e9
    print(f"== serve {HYB_ARCH} full width, all {hyb_cfg.n_layers} layers ({n_per} periods "
          f"of {hyb_per}: d_model {hyb_cfg.d_model}, d_ff {hyb_cfg.d_ff}, {hyb_cfg.n_experts} "
          f"experts top-{hyb_cfg.experts_per_token}, d_inner {hyb_cfg.d_inner}, state "
          f"{hyb_cfg.ssm_state}, vocab {hyb_cfg.vocab_size}, {hyb_cfg.dtype}) --packed "
          f"--binarize det, each (K, N) master drawn and packed at once: {LM_SERVE}; "
          f"{hyb_cfg.param_count() / 1e9:.1f} B parameters, {words_gb:.2f} GB of words")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    reset_counts()
    res = serve_lm(arch=HYB_ARCH, packed=True, binarize="det", device="cuda", **LM_SERVE)
    peak_serve = torch.cuda.max_memory_allocated()
    calls = LM_SERVE["requests"] + res.steps - 1
    print(f"  {LM_SERVE['requests']} prefills + {res.steps - 1} decode steps x {n_per} periods "
          f"x ({hyb_k2} K2 + {hyb_k2b} expert-batched K2), {hyb_k1 * n_per} K1 at pack time")
    hyb_counted("det", "det", "det", hyb_want(n_per, calls))
    engine = res.engine
    done = sorted(res.batcher.completed, key=lambda r: r.uid)
    if len(done) != LM_SERVE["requests"] or res.tokens != 16 * LM_SERVE["max_new"]:
        raise AssertionError(f"{HYB_ARCH} det: served {len(done)} requests, {res.tokens} tokens")
    leaves = dict(tree_leaves_with_path(engine.params))
    served_words = sum(v.nbytes() for v in leaves.values() if hasattr(v, "packed")) / 1e9
    dense_f32 = sum(v.numel() * v.element_size() for v in leaves.values()
                    if isinstance(v, torch.Tensor)) / 1e9
    # each at batch 1, as the serve prefills it: a MoE layer's capacity
    # follows the tokens of the call (8 rows an expert for one 32-token
    # prompt, 24 for four), so a batch-4 prefill may drop other assignments
    for r in done[:4]:
        if engine.generate(r.prompt[None], r.max_new).tokens[0].tolist() != r.generated:
            raise AssertionError(f"{HYB_ARCH} det: request {r.uid}'s stream differs from its "
                                 f"one-shot generate")
    print(f"  the first 4 streams equal the one-shot generate of their request")
    state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])
    for slot in range(4):
        state = engine.prefill_into(state, slot, done[slot].prompt)
    tok = torch.argmax(state.logits, dim=-1)
    decode_rows = []
    with record_rows(decode_rows):
        state = engine.decode_step(state, tok)
    # the served decode routing, one count vector a MoE layer (its three
    # projections share it), for phase 7's timing
    hyb_decode_rows = decode_rows[::3]
    cap4 = moe_mod.capacity(hyb_cfg, 4)
    print(f"  decode step routing: {len(hyb_decode_rows)} MoE layers, live experts a layer "
          f"{[int((r > 0).sum()) for r in hyb_decode_rows]} (of {hyb_cfg.n_experts}), live rows "
          f"{sum(int(r.clamp(max=cap4).sum()) for r in hyb_decode_rows)} in all")
    step_ms, step_dev, step_n, k2_ms, k2b_ms = step_profile(engine, state, tok)
    peak = torch.cuda.max_memory_allocated()
    hyb_rows["full"] = {
        "pack_s": res.pack_seconds, "dense_gb": res.dense_bytes / 1e9,
        "served_gb": res.packed_bytes / 1e9, "words_gb": served_words, "f32_gb": dense_f32,
        "tok_s": res.tok_per_s, "ttft_ms": res.median_ttft * 1e3,
        "latency_ms": res.median_latency * 1e3, "step_ms": step_ms, "step_device_ms": step_dev,
        "step_launches": step_n, "k2_ms": k2_ms, "k2b_ms": k2b_ms,
        "peak_serve_gb": peak_serve / 1e9, "peak_gb": peak / 1e9, "live_gb": live / 1e9,
        "seconds": res.seconds, "steps": res.steps}
    print(f"  draw + pack {res.pack_seconds:.3f} s; {res.dense_bytes / 1e9:.2f} GB bf16 dense -> "
          f"{res.packed_bytes / 1e9:.2f} GB served ({res.dense_bytes / res.packed_bytes:.2f}x; "
          f"{served_words:.2f} GB of words and scales, {dense_f32:.2f} GB of f32 embedding, head, "
          f"routers, conv and norms on the card); {res.tok_per_s:.1f} tok/s, median TTFT "
          f"{res.median_ttft * 1e3:.1f} ms, median latency {res.median_latency * 1e3:.1f} ms; "
          f"decode step {step_ms:.3f} ms median (synced), device {fmt(step_dev)} ms in "
          f"{fmt_count(step_n)} device launches, 2-D K2 {fmt(k2_ms)} ms "
          f"({share(k2_ms, step_dev)}), expert-batched K2 {fmt(k2b_ms)} ms "
          f"({share(k2b_ms, step_dev)}); peak allocated (torch.cuda.max_memory_allocated) "
          f"{peak_serve / 1e9:.2f} GB through the serve, {peak / 1e9:.2f} GB with the batch-4 "
          f"generate and the step timing ({live / 1e9:.2f} GB held by earlier phases)")
    del res, engine, state, leaves
    torch.cuda.empty_cache()

    # one period (8 layers) in det and stoch, against the plain kernels; the
    # det engine also serves the chunked admission
    per_cfg = dataclasses.replace(hyb_cfg, n_layers=hyb_per)
    n_moe_calls = n_moe_per                            # MoE layers a model call, one period

    def hyb_chunked(engine):
        """Chunked admission with the prefix cache (det, one period) against
        whole-prompt admission, on ``engine``: a chunk of 8 tokens never
        overflows an expert (16 assignments over 16 experts of capacity 8); a
        whole 32-token prompt may (64 assignments), so a request whose
        whole-prompt prefill dropped one may part; otherwise a stream may
        part only at a routing near tie or a top-2 logit near tie."""
        c_ = HYB_CHUNK
        print(f"== serve {HYB_ARCH} one period --packed --binarize det, chunked prefill and the "
              f"prefix cache: {c_}")
        rng = np.random.default_rng(1)
        shared = rng.integers(0, hyb_cfg.vocab_size, c_["shared_prefix"])
        hprompts = [np.concatenate([shared, rng.integers(0, hyb_cfg.vocab_size,
                                                         c_["prompt_len"] - len(shared))])
                    for _ in range(c_["requests"])]
        whole, _, _, _ = serve_streams(engine, hprompts, c_["max_new"], c_["slots"])
        no_prefix, _, _, _ = serve_streams(engine, hprompts, c_["max_new"], c_["slots"],
                                           prefill_chunk=c_["prefill_chunk"])
        pc, reg = PrefixCache(max_entries=c_["prefix_cache"]), MetricsRegistry()
        reset_counts()
        streams, hb, hsteps, hsecs = serve_streams(engine, hprompts, c_["max_new"], c_["slots"],
                                                   prefill_chunk=c_["prefill_chunk"],
                                                   prefix_cache=pc, metrics=reg)
        chunks = int(reg["serve_prefill_chunks_total"].value)
        print(f"  {hsteps - 1} decode steps + {chunks} prefill chunks; prefix cache {pc.stats()}")
        hyb_counted("det chunked", "det chunked", "det", hyb_want(1, hsteps - 1 + chunks,
                                                                  packs=False))
        if pc.hits < 1:
            raise AssertionError(f"{HYB_ARCH} det chunked: no prefix hit")
        if streams != no_prefix:
            raise AssertionError(f"{HYB_ARCH} det chunked: the prefix cache changed a stream")
        print(f"  all {len(hprompts)} streams equal the chunked serve's without the prefix cache")
        lg = moe_greedy(per_cfg, engine.params, torch.from_numpy(np.stack(hprompts)).to(dev),
                        c_["max_new"])
        tol, margin = LM_LOGIT_TOL * lg.abs().amax(dim=-1), top2_margin(lg)

        def hyb_routes(prompt, forced, chunk):
            """Routing records of one request's greedy path on one slot: its
            prompt prefilled whole (chunk 0) or by chunks, then the ``forced``
            tokens decoded; each prefill MoE call's records joined along the
            tokens."""
            rec = []
            st_ = engine.init_decode(1, c_["prompt_len"], c_["max_new"])
            with moe_routing(record=rec):
                if chunk:
                    for off in range(0, len(prompt), chunk):
                        st_ = engine.prefill_chunk_into(st_, 0, prompt[off:off + chunk], off)
                else:
                    st_ = engine.prefill_into(st_, 0, prompt)
                for t_ in forced:
                    st_ = engine.decode_step(st_, torch.tensor([t_], device=dev))
            n_chunks = len(prompt) // chunk if chunk else 1
            pre = [(torch.cat([rec[c * n_moe_calls + l_][0] for c in range(n_chunks)]),
                    torch.cat([rec[c * n_moe_calls + l_][1] for c in range(n_chunks)]))
                   for l_ in range(n_moe_calls)]
            return pre + rec[n_chunks * n_moe_calls:]

        n_equal = n_dropped = n_flipped = 0
        for uid, p_ in enumerate(hprompts):
            drops = []
            with record_moe(drops), torch.inference_mode():
                T.prefill(per_cfg, engine.params, torch.from_numpy(p_[None]).to(dev))
            dropped = any(d > 0 for _, d in drops)
            n_dropped += dropped
            if streams[uid] == whole[uid]:
                n_equal += 1
                continue
            i = first_diff(streams[uid], whole[uid])
            note = (f"  request {uid}: chunked stream equals the whole-prompt one up to step {i} "
                    f"(top-2 margin {margin[uid, i].item():.4g}, tolerance "
                    f"{tol[uid, i].item():.4g})")
            if dropped:
                print(f"{note}; its whole-prompt prefill dropped assignments")
                continue
            fl = [flipped(pw, ew, ec) for (pw, ew), (_, ec) in
                  zip(hyb_routes(p_, whole[uid][:i], 0),
                      hyb_routes(p_, whole[uid][:i], c_["prefill_chunk"]))]
            n_fl, gap_fl = sum(n for n, _ in fl), max(gp for _, gp in fl)
            n_flipped += n_fl > 0
            print(f"{note}; no drop; {n_fl} token routings differ between the chunked and whole "
                  f"paths up to there (largest router-logit gap {gap_fl:.4g})")
            if gap_fl >= MOE_ROUTE_TIE:
                raise AssertionError(f"{HYB_ARCH} det: request {uid}: a routing flip at a gap of "
                                     f"{gap_fl}")
            if not n_fl and margin[uid, i] >= tol[uid, i]:
                raise AssertionError(f"{HYB_ARCH} det: request {uid}'s chunked stream diverges "
                                     f"with no drop, no routing flip and a margin above the "
                                     f"tolerance")
        hyb_rows["chunked"] = {"tok_s": hb.tokens_generated / hsecs, "steps": hsteps,
                               "chunks": chunks, "prefix": pc.stats(), "n_equal": n_equal,
                               "n_req": len(hprompts), "n_dropped": n_dropped,
                               "n_flipped": n_flipped,
                               "ttft_ms": statistics.median(r.ttft for r in hb.completed) * 1e3}
        print(f"  {n_equal}/{len(hprompts)} chunked streams equal the whole-prompt streams; "
              f"{n_dropped} whole-prompt prefills dropped assignments, {n_flipped} differing "
              f"streams met a routing flip; {hyb_rows['chunked']['tok_s']:.1f} tok/s, median TTFT "
              f"{hyb_rows['chunked']['ttft_ms']:.1f} ms")

    for mode in MOE_MODES:
        print(f"== serve {HYB_ARCH} full width, one period ({hyb_per} layers) --packed "
              f"--binarize {mode}: {LM_SERVE}")
        torch.cuda.empty_cache()
        reset_counts()
        res = serve_lm(arch=HYB_ARCH, n_layers=hyb_per, packed=True, binarize=mode,
                       device="cuda", **LM_SERVE)
        calls = LM_SERVE["requests"] + res.steps - 1
        hyb_counted(f"{mode} period", f"{mode} period", mode, hyb_want(1, calls))
        engine = res.engine
        done = sorted(res.batcher.completed, key=lambda r: r.uid)
        if len(done) != LM_SERVE["requests"] or res.tokens != 16 * LM_SERVE["max_new"]:
            raise AssertionError(f"{HYB_ARCH} {mode}: served {len(done)} requests")
        torch.cuda.empty_cache()        # the plain expert products unpack 13 GB of f32
        if mode == "det":
            with plain_kernels():
                plain = res.plan.pack_drawn(T.lm_draws(per_cfg),
                                            torch.Generator(device=dev).manual_seed(0),
                                            key=prng.key(1), device=dev)
            n_ = same_tree(f"{HYB_ARCH} det period", engine.params, plain)
            del plain
            note = f"{n_} served (K, N) matrices (K1) == a plain pack of the same draws"
        else:
            # the threefry twin on the card against the CPU: the last expert
            # matrix of w_down (the last of its 64 split keys), replayed from the
            # draw order (a CPU pack of its 201 M weights takes ~10 s)
            row = res.plan["layers/moe/w_down"]
            lead = math.prod(row.shape[:-2])
            keys = prng.split(prng.fold_in(prng.key(1), row.index), lead)
            picked, gen_ = {}, torch.Generator(device=dev).manual_seed(0)
            for d in T.lm_draws(per_cfg):
                if d.whole is not None:
                    d.whole(gen_, dev)
                    continue
                for i, w in enumerate(d.matrices(gen_, dev)):
                    if d.path == row.path and i == lead - 1:
                        picked[i] = w.cpu()
            served = engine.params["layers"]["moe"]["w_down"].packed
            served = served.reshape(lead, *served.shape[-2:])
            for i, w in picked.items():
                if not torch.equal(served[i].cpu(),
                                   kops_mod.binarize_and_pack(w, keys[i], stochastic=True)):
                    raise AssertionError(f"{HYB_ARCH} stoch: w_down matrix {i}'s words differ "
                                         f"from a CPU pack at its split key")
            note = (f"w_down matrix {lead - 1} of {lead} (replayed from the draw order) equals "
                    f"a CPU pack at its split key")
        print(f"  {note}")

        prompts = torch.from_numpy(np.stack([r.prompt for r in done[:4]])).to(dev)
        routes, flips = [], []
        with moe_routing(record=routes):
            k_lg = moe_greedy(per_cfg, engine.params, prompts, LM_SERVE["max_new"])
        k_tok = k_lg.argmax(-1)
        with plain_kernels(), moe_routing(replay=routes, flips=flips):
            p_lg = moe_greedy(per_cfg, engine.params, prompts, LM_SERVE["max_new"], forced=k_tok)
        n_flip = sum(n for n, _ in flips)
        gap = max(gp for _, gp in flips)
        n_routed = sum(int(e.shape[0]) for _, e in routes)
        print(f"  routing: {n_flip} of {n_routed} token routings (tokens x MoE layers) of the "
              f"plain kernels differ from the kernels' (the plain run takes the kernels'); "
              f"largest router-logit gap at a flip {gap:.4g} (near-tie bound {MOE_ROUTE_TIE})")
        if gap >= MOE_ROUTE_TIE:
            raise AssertionError(f"{HYB_ARCH} {mode}: a routing flip at a gap of {gap}")
        del routes
        tol = LM_LOGIT_TOL * p_lg.abs().amax(dim=-1)
        err = (k_lg - p_lg).abs().amax(dim=-1)
        print(f"  logits vs the plain kernels, largest over the {LM_SERVE['max_new']} steps: "
              f"max_abs_err per request {[round(e, 5) for e in err.amax(-1).tolist()]} "
              f"(tolerance {[round(t, 5) for t in tol.amin(-1).tolist()]} at the least)")
        if (err > tol).any():
            raise AssertionError(f"{HYB_ARCH} {mode}: logits differ from the plain kernels")
        margin = top2_margin(p_lg)
        if ((k_tok != p_lg.argmax(-1)) & (margin >= tol)).any():
            raise AssertionError(f"{HYB_ARCH} {mode}: a greedy token differs from the plain "
                                 f"kernels' at a top-2 margin above the tolerance")
        print(f"  greedy tokens equal the plain kernels' at "
              f"{int((k_tok == p_lg.argmax(-1)).sum())} of {k_tok.numel()} steps, the rest at a "
              f"near tie (smallest top-2 margin {margin.min().item():.4g})")
        for r in done:
            if engine.generate(r.prompt[None], r.max_new).tokens[0].tolist() != r.generated:
                raise AssertionError(f"{HYB_ARCH} {mode}: request {r.uid}'s stream differs "
                                     f"from its one-shot generate")
        print(f"  all {len(done)} streams equal the one-shot generate of their request")
        state = engine.init_decode(4, LM_SERVE["prompt_len"], LM_SERVE["max_new"])
        drops = []
        with record_moe(drops):
            for slot in range(4):
                state = engine.prefill_into(state, slot, done[slot].prompt)
        tok = torch.argmax(state.logits, dim=-1)
        step_ms, step_dev, step_n, k2_ms, k2b_ms = step_profile(engine, state, tok)
        hyb_rows[mode] = {
            "pack_s": res.pack_seconds, "served_gb": res.packed_bytes / 1e9,
            "tok_s": res.tok_per_s, "ttft_ms": res.median_ttft * 1e3, "step_ms": step_ms,
            "step_device_ms": step_dev, "step_launches": step_n, "k2_ms": k2_ms,
            "k2b_ms": k2b_ms, "max_abs_err": err.max().item(),
            "flips": (n_flip, n_routed, gap),
            "drop_prefill": statistics.mean(d for _, d in drops)}
        print(f"  draw + pack {res.pack_seconds:.3f} s; {res.dense_bytes / 1e9:.2f} GB bf16 "
              f"dense -> {res.packed_bytes / 1e9:.2f} GB served; {res.tok_per_s:.1f} tok/s, median "
              f"TTFT {res.median_ttft * 1e3:.1f} ms; dropped fraction at a 32-token prefill "
              f"{hyb_rows[mode]['drop_prefill']:.5g} (mean over {len(drops)} MoE layer calls); "
              f"decode step {step_ms:.3f} ms (synced), device {fmt(step_dev)} ms in "
              f"{fmt_count(step_n)} launches, 2-D K2 {fmt(k2_ms)} ms ({share(k2_ms, step_dev)}), "
              f"expert-batched K2 {fmt(k2b_ms)} ms ({share(k2b_ms, step_dev)})")
        del res, state, k_lg, p_lg
        if mode == "det":
            hyb_chunked(engine)
        del engine
        torch.cuda.empty_cache()


    phase_start["6j"] = time.perf_counter()
    # 6j. Alg.-1 training of the decoder LMs: StarCoder2-3B and musicgen-large at
    # full width, a 2-layer cut against the CPU, mamba2-130m through the CLI with
    # a crash, Moonlight and jamba at SMOKE width against the CPU

    def zero_counts():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    train_rows = LmTraining(smi, launch_counts, zero_counts).run()

    phase_start["7"] = time.perf_counter()
    # 7. timing at the path shapes
    print("== timing (kernel_ms: CUDA events around 200 back-to-back wrapper calls, K1 "
          "cold with L2 flushed before each call, as at pack time; device_ms: the "
          "kernel's own device time from torch.profiler)")
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)

    def time_cold(fn, iters=20) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(iters):
            flush_buf.zero_()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def time_warm(fn, iters=200) -> float:
        for _ in range(10):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    def total(counts: dict, keys) -> int:
        return sum(v for key, v in counts.items() if key in keys)

    kernels = []
    k, n = 2048, 2048
    w = torch.randn(k, n, generator=g, device=dev) * 0.7
    bits = rand_words((k, n))
    # the stochastic pack route as plan.pack runs it: the twin's words over
    # the reference's draw shape, then K1's operand mode
    pack_key = prng.fold_in(prng.key(1), 3)
    route_ms = time_cold(lambda: kops_mod.binarize_and_pack(w, pack_key, stochastic=True))
    print(f"  stochastic pack route {k}x{n} f32 (twin words + K1 operand mode), cold: "
          f"{route_ms:.4f} ms")
    k1_serves = {"det": [r for r, m in run_mode.items() if m != "stoch"],
                 "stoch": [r for r, m in run_mode.items() if m == "stoch"]}
    for mode in ("det", "stoch"):
        st = mode == "stoch"
        b_ = bits if st else None
        ms = time_cold(lambda: binarize_pack(w, b_, stochastic=st))
        plain_ms = time_cold(lambda: binarize_pack_plain(w, b_, stochastic=st))
        dev_ms = device_ms(lambda: (flush_buf.zero_(), binarize_pack(w, b_, stochastic=st)),
                           "binarize_pack_kernel")
        nbytes = k * n * 4 * (2 if st else 1) + (k // 32) * n * 4
        bms, by = bound(nbytes, 0, PEAK_F32_FLOP_PER_S)
        print(f"  K1 {mode} {k}x{n} f32: kernel_ms {ms:.4f}, device_ms {fmt(dev_ms)}, "
              f"plain_ms {plain_ms:.4f}, library_ms none, bound_ms {bms:.4f} ({by}, {nbytes} B)")
        kernels.append({
            "name": f"binarize_pack ({mode})", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/binarize_pack.cu",
            "replaces": ("src/repro/kernels/stoch_binarize.py:118" if st
                         else "src/repro/kernels/stoch_binarize.py:98"),
            "launches": total(launches["binarize_pack"], k1_serves[mode]),
            "max_abs_err": errs[f"k1_{mode}"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "device_ms": dev_ms,
            **({"pack_route_ms": route_ms} if st else {})})

    # the on-chip variant (no path runs it), beside the operand route it
    # would replace: the twin's words, then K1 on them
    seed = 2024
    ms = time_cold(lambda: binarize_pack(w, stochastic=True, seed=seed, on_chip_prng=True))
    plain_ms = time_cold(lambda: binarize_pack_plain(w, None, stochastic=True, seed=seed,
                                                     on_chip_prng=True))
    dev_ms = device_ms(lambda: (flush_buf.zero_(), binarize_pack(
        w, stochastic=True, seed=seed, on_chip_prng=True)), "binarize_pack_onchip_kernel")
    nbytes = k * n * 4 + (k // 32) * n * 4
    int_ops = (k // 4) * n * PHILOX_INT32_OPS        # one Philox call per 4 weights
    bms, by = bound(nbytes, int_ops, PEAK_INT32_OPS_PER_S)
    print(f"  K1 stoch on-chip Philox {k}x{n} f32: kernel_ms {ms:.4f}, device_ms "
          f"{fmt(dev_ms)}, plain_ms {plain_ms:.4f}, library_ms none, operand route "
          f"(twin words + K1) {route_ms:.4f}, bound_ms {bms:.4f} ({by}; bytes "
          f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f} ms for {nbytes} B, Philox integer ops "
          f"{int_ops / PEAK_INT32_OPS_PER_S * 1e3:.4f} ms for {int_ops})")
    kernels.append({
        "name": "binarize_pack (stoch, on-chip Philox; on no path)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/binarize_pack.cu",
        "replaces": "src/repro/kernels/stoch_binarize.py:107",
        "launches": total(launches["binarize_pack_on_chip"], run_mode),
        "max_abs_err": errs["k1_onchip"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "device_ms": dev_ms, "operand_route_ms": route_ms})

    # K2 at the serving shapes (mnist_fc's two hidden layers, VGG fc/1) and M=256
    runs_of = {arch: [r for r in run_mode if r[0] == arch]
               for arch in ("mnist_fc", "vgg16_cifar10")}
    k2_serves = {2048: runs_of["mnist_fc"], 512: runs_of["vgg16_cifar10"]}
    for m, k, n in [(4, 2048, 2048), (4, 512, 512), (256, 2048, 2048)]:
        wk = torch.randn(k, n, generator=g, device=dev)
        wp = binarize_pack(wk, stochastic=False)
        scale = wk.abs().mean(dim=0)
        w_pm1 = unpack_bits(wp)                      # the library call's operand
        x32 = torch.randn(m, k, generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            ms = time_warm(lambda: binary_matmul(x, wp, scale))
            dev_ms = device_ms(lambda: binary_matmul(x, wp, scale), "binary_matmul_kernel")
            plain_ms = time_warm(lambda: binary_matmul_plain(x, wp, scale))
            wl = w_pm1.to(dtype)
            lib_ms = time_warm(lambda: (x @ wl).float() * scale)
            esize = 4 if dtype == torch.float32 else 2
            nbytes = m * k * esize + (k // 32) * n * 4 + n * 4 + m * n * 4
            peak = PEAK_F32_FLOP_PER_S if dtype == torch.float32 else PEAK_BF16_FLOP_PER_S
            bms, by = bound(nbytes, 2.0 * m * k * n, peak)
            print(f"  K2 scaled {m}x{k}x{n} {str(dtype)[6:]}: kernel_ms {ms:.4f}, "
                  f"device_ms {fmt(dev_ms)}, plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} (torch.matmul on "
                  f"unpacked +-1 times scale), bound_ms {bms:.5f} ({by})")
            if m == 4 and dtype == torch.float32:   # the serving path's shapes
                kernels.append({
                    "name": ("binary_matmul (scaled, f32, M=4)" if k == 2048   # the name earlier runs used
                             else f"binary_matmul (scaled, f32, {m}x{k}x{n})"), "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/binary_matmul.cu",
                    "replaces": "src/repro/kernels/binary_matmul.py:125",
                    "launches": total(launches["binary_matmul"], k2_serves[k]),
                    "max_abs_err": errs[f"k2_{k}"],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms, "device_ms": dev_ms})

    def entry(name, source, replaces, count, err, rows):
        """One kernels-line entry; ``rows`` holds (ms, plain, bound_ms,
        t_bytes_ms, t_ops_ms, library_ms, device_ms) per shape, summed over
        the shapes one batch runs."""
        t_bytes = sum(r[3] for r in rows)
        t_ops = sum(r[4] for r in rows)
        libs = [r[5] for r in rows]
        devs = [r[6] for r in rows]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count, "max_abs_err": err,
                "ms": sum(r[0] for r in rows), "plain_ms": sum(r[1] for r in rows),
                "bound_ms": sum(r[2] for r in rows),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None if None in libs else sum(libs),
                "device_ms": None if None in devs else sum(devs)}

    def k3_row(m, kk, dtype=torch.float32):
        x = torch.randn(m, kk, generator=g, device=dev).to(dtype)
        ms = time_warm(lambda: sign_pack(x))
        dev_ms = device_ms(lambda: sign_pack(x), "sign_pack_kernel")
        plain_ms = time_warm(lambda: sign_pack_plain(x))
        nbytes = m * kk * x.element_size() + m * ((kk + 31) // 32) * 4
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"  K3 {m}x{kk} {str(dtype)[6:]}: kernel_ms {ms:.4f}, device_ms {fmt(dev_ms)}, plain_ms "
              f"{plain_ms:.4f}, library_ms none, bound_ms {t_b:.5f} (bytes, {nbytes} B)")
        return (ms, plain_ms, t_b, t_b, 0.0, None, dev_ms)

    def k3_fused_row(m, kk):
        """K3 with the producer prologue, beside the unfused route a site
        takes with it off (bn_sign, then plain K3): the route's device time
        and device kernel launches."""
        case = k3_cases.bn_inputs(m, kk, m + kk, dev)
        ms = time_warm(lambda: bn_sign_pack(*case))
        dev_ms = device_ms(lambda: bn_sign_pack(*case), "sign_pack_kernel")
        plain_ms = time_warm(lambda: bn_sign_pack_plain(*case))

        def chain():
            return sign_pack(bn_sign(*case))

        if not torch.equal(chain(), bn_sign_pack(*case)):
            raise AssertionError(f"K3 fused {m}x{kk}: differs from the unfused route")
        chain_ms = time_warm(chain)
        chain_kern = profiled(chain, reps=20)
        chain_dev = chain_kern and sum(chain_kern.values())
        chain_n = kernels_per_rep(chain)
        nbytes = (m * kk + 5 * kk) * 4 + m * ((kk + 31) // 32) * 4
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"  K3 fused (bias + eval BN + sign) {m}x{kk} f32: kernel_ms {ms:.4f}, device_ms "
              f"{fmt(dev_ms)}, plain_ms {plain_ms:.4f}, library_ms none, bound_ms {t_b:.7f} "
              f"(bytes, {nbytes} B); unfused route (bn_sign + K3): wall {chain_ms:.4f} ms, device "
              f"{fmt(chain_dev)} ms in {fmt_count(chain_n)} device kernel launches")
        return (ms, plain_ms, t_b, t_b, 0.0, None, dev_ms), {
            "chain_ms": chain_ms, "chain_device_ms": chain_dev, "chain_launches": chain_n}

    def bn_sign_row(m, kk, eager=False):
        """bn_sign at one site's (M, K); with ``eager``, also the eager ops the
        site ran before it (bias add, batch norm, sign; no flush): their
        device time and device kernel launches."""
        case = k3_cases.bn_inputs(m, kk, m + kk + 1, dev)
        ms = time_warm(lambda: bn_sign(*case))
        dev_ms = device_ms(lambda: bn_sign(*case), "bn_sign_kernel")
        plain_ms = time_warm(lambda: bn_sign_plain(*case))
        nbytes = (2 * m * kk + 5 * kk) * 4
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        extra = ""
        if eager:
            h, bias, scale, shift, mean, var = case

            def chain():
                return deterministic_binarize(batch_norm(h + bias, scale, shift, mean, var))

            eager_kern = profiled(chain, reps=20)
            extra = (f"; the eager ops it replaced: device "
                     f"{fmt(eager_kern and sum(eager_kern.values()))} ms in "
                     f"{fmt_count(kernels_per_rep(chain))} device kernel launches")
        print(f"  bn_sign {m}x{kk} f32: kernel_ms {ms:.4f}, device_ms {fmt(dev_ms)}, plain_ms "
              f"{plain_ms:.4f} (the flushed chain in torch ops), library_ms none, bound_ms "
              f"{t_b:.7f} (bytes, {nbytes} B){extra}")
        return (ms, plain_ms, t_b, t_b, 0.0, None, dev_ms)

    def k4_row(m, wds, n, kk, scaled, conv=None):
        """``conv``: the NHWC input of a 3x3 SAME conv whose patches the rows
        of ``a`` are; K4 then runs as the conv path calls it, with the border
        correction and the scale in its flush."""
        a, w4 = words((m, wds)), words((wds, n))
        s = torch.rand(n, generator=g, device=dev) + 0.5 if scaled else None
        border = None
        if conv is not None:
            _, h, w_, c = conv
            oh, ow, ((ph0, _), (pw0, _)) = conv_geometry(h, w_, (3, 3), (1, 1), "SAME")
            tap_sums = torch.randint(-c, c + 1, (9, n), generator=g, device=dev,
                                     dtype=torch.int32)
            border = ConvBorder(tap_sums, h, w_, oh, ow, (3, 3), (1, 1), (ph0, pw0))
        ms = time_warm(lambda: xnor_matmul(a, w4, s, k_total=kk, border=border))
        dev_ms = device_ms(lambda: xnor_matmul(a, w4, s, k_total=kk, border=border), "xnor_")
        plain_ms = time_warm(lambda: xnor_matmul_plain(a, w4, s, k_total=kk, border=border),
                             iters=20)
        a_pm1 = unpack_activations(a)                    # the library call's operands
        w_pm1_ = unpack_bits(w4)
        if s is None:
            lib_ms = time_warm(lambda: a_pm1 @ w_pm1_)
        else:
            lib_ms = time_warm(lambda: (a_pm1 @ w_pm1_) * s)
        nbytes = ((m * wds + wds * n + m * n) * 4 + (n * 4 if scaled else 0)
                  + (9 * n * 4 if border is not None else 0))
        bms, by = bound(nbytes, m * n * wds, PEAK_POPC_WORDS_PER_S)
        what = (f"{'conv, fused border + ' if border is not None else ''}"
                f"{'scaled' if scaled else 'int'}")
        print(f"  K4 {m}x{wds}w x{n} k={kk} {what}: kernel_ms "
              f"{ms:.4f}, device_ms {fmt(dev_ms)}, plain_ms {plain_ms:.4f}, library_ms "
              f"{lib_ms:.4f} (f32 torch.matmul on unpacked +-1), bound_ms {bms:.5f} ({by})")
        return (ms, plain_ms, bms, nbytes / PEAK_BYTES_PER_S * 1e3,
                m * n * wds / PEAK_POPC_WORDS_PER_S * 1e3, lib_ms, dev_ms)

    def k5_row(shape):
        x = torch.randn(shape, generator=g, device=dev)
        ms = time_warm(lambda: patch_pack(x, ksize=(3, 3)))
        dev_ms = device_ms(lambda: patch_pack(x, ksize=(3, 3)), "patch_pack_kernel")
        plain_ms = time_warm(lambda: patch_pack_plain(x, ksize=(3, 3)), iters=50)
        b, h, w_, c = shape
        nbytes = b * h * w_ * c * 4 + b * h * w_ * 9 * ((c + 31) // 32) * 4
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        print(f"  K5 {shape} 3x3 SAME f32: kernel_ms {ms:.4f}, device_ms {fmt(dev_ms)}, "
              f"plain_ms {plain_ms:.4f}, library_ms none, bound_ms {t_b:.5f} "
              f"(bytes, {nbytes} B)")
        return (ms, plain_ms, t_b, t_b, 0.0, None, dev_ms)

    k3_src, k3_rep = "src/repro_torch/kernels/csrc/sign_pack.cu", "src/repro/xnor/kernel.py:164"
    k4_src, k4_rep = "src/repro_torch/kernels/csrc/xnor_matmul.cu", "src/repro/xnor/kernel.py:125"
    mnist_x, vgg_x = runs_of["mnist_fc"], runs_of["vgg16_cifar10"]
    for (arch_mode, kk, what) in [(mnist_x, 2048, "mnist_fc xnor layers/0-1 and 1-2, 4x2048 "
                                   "f32, per site"),
                                  (vgg_x, 512, "vgg16 xnor fc/0-1, 4x512 f32")]:
        row, chain = k3_fused_row(4, kk)
        kernels.append({**entry(f"sign_pack, prologue fused: bias + eval batch norm + Eq.-1 "
                                f"sign ({what})", k3_src, k3_rep,
                                total(launches["sign_pack_fused"], arch_mode),
                                errs["k3_fused"],
                                [row]), **chain})
    bn_note = ("no pl.pallas_call: the reference's bias add, batch_norm and binarize, "
               "separate XLA ops")
    kernels.append({**entry("bn_sign: bias + eval batch norm + Eq.-1 sign, flushed, unpacked "
                            "(mnist_fc xnor layers/2-3, 4x2048 f32)", k3_src,
                            "src/repro/models/mnist_fc.py:60",
                            total(launches["bn_sign"], mnist_x), errs["bn_sign"],
                            [bn_sign_row(*MNIST_BN_SIGN[0], eager=True)]),
                    "replaces_note": bn_note})
    vgg_bn = [bn_sign_row(m, kk, eager=(i == 0)) for i, (m, kk) in enumerate(VGG_BN_SIGN)]
    print("  bn_sign device_ms at VGG's 12 sites (conv 1-11, fc/1): "
          + ", ".join(fmt(r[6]) for r in vgg_bn)
          + (f"; sum {sum(r[6] for r in vgg_bn):.4f}" if None not in [r[6] for r in vgg_bn]
             else ""))
    kernels.append({**entry("bn_sign (vgg16 xnor, the 12 sites of one batch, summed)", k3_src,
                            "src/repro/models/vgg.py:97", total(launches["bn_sign"], vgg_x),
                            errs["bn_sign"], vgg_bn),
                    "replaces_note": bn_note, "device_ms_per_shape": [r[6] for r in vgg_bn]})
    for (arch_mode, kk) in [(mnist_x, 2048), (vgg_x, 512)]:
        kernels.append(entry(f"sign_pack, no prologue (xnor_matmul on a float input; on no "
                             f"path), 4x{kk} f32", k3_src, k3_rep,
                             total(launches["sign_pack"], arch_mode)
                             - total(launches["sign_pack_fused"], arch_mode),
                             errs["k3"], [k3_row(4, kk)]))
    kernels.append(entry("xnor_matmul (mnist_fc xnor, 4x64w x2048 scaled, per layer)",
                         k4_src, k4_rep, total(launches["xnor_matmul"], mnist_x), errs["k4"],
                         [k4_row(4, 64, 2048, 2048, True)]))
    vgg_k4 = [k4_row(b * h * w_, 9 * c // 32, n, 9 * c, True, conv=(b, h, w_, c))
              for (b, h, w_, c), n in VGG_XNOR_CONVS] + [k4_row(4, 16, 512, 512, True)]
    print("  K4 device_ms at VGG's 12 shapes (conv/2-12 fused, fc/1): "
          + ", ".join(fmt(r[6]) for r in vgg_k4)
          + (f"; sum {sum(r[6] for r in vgg_k4):.4f}" if None not in [r[6] for r in vgg_k4]
             else ""))
    kernels.append({**entry("xnor_matmul (vgg16 xnor, the 12 shapes of one batch, summed)",
                            k4_src, k4_rep, total(launches["xnor_matmul"], vgg_x), errs["k4"],
                            vgg_k4),
                    "device_ms_per_shape": [r[6] for r in vgg_k4]})
    vgg_k5 = [k5_row(shape) for shape, _ in VGG_XNOR_CONVS]
    print("  K5 device_ms at VGG's 11 conv inputs: " + ", ".join(fmt(r[6]) for r in vgg_k5)
          + (f"; sum {sum(r[6] for r in vgg_k5):.4f}" if None not in [r[6] for r in vgg_k5]
             else ""))
    kernels.append({**entry("patch_pack (vgg16 xnor, the 11 conv inputs of one batch, summed)",
                            "src/repro_torch/kernels/csrc/patch_pack.cu",
                            "src/repro/xnor/conv/kernel.py:76",
                            total(launches["patch_pack"], vgg_x),
                            errs["k5"], vgg_k5),
                    "device_ms_per_shape": [r[6] for r in vgg_k5]})

    # the LM decode shapes: the 4 projections of one StarCoder2-3B layer at 4 slots
    def k2_lm_row(m, k, n):
        x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
        wk = torch.randn(k, n, generator=g, device=dev)
        wp = binarize_pack(wk, stochastic=False)
        scale = wk.abs().mean(dim=0)
        wl = unpack_bits(wp).to(torch.bfloat16)          # the library call's operand
        ms = time_warm(lambda: binary_matmul(x, wp, scale))
        dev_ms = device_ms(lambda: binary_matmul(x, wp, scale), "binary_matmul_kernel")
        plain_ms = time_warm(lambda: binary_matmul_plain(x, wp, scale), iters=50)
        lib_ms = time_warm(lambda: (x @ wl).float() * scale)
        nbytes = m * k * 2 + (k // 32) * n * 4 + n * 4 + m * n * 4
        t_b, t_o = nbytes / PEAK_BYTES_PER_S * 1e3, 2.0 * m * k * n / PEAK_BF16_FLOP_PER_S * 1e3
        print(f"  K2 scaled {m}x{k}x{n} bf16: kernel_ms {ms:.4f}, device_ms {fmt(dev_ms)}, "
              f"plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} (bf16 torch.matmul on "
              f"unpacked +-1 times scale), bound_ms {max(t_b, t_o):.5f} "
              f"({'bytes' if t_b >= t_o else 'operations'})")
        return (ms, plain_ms, max(t_b, t_o), t_b, t_o, lib_ms, dev_ms)

    print(f"== {LM_ARCH} decode shapes (M = 4 slots; a layer runs qkv, w_o, wi, wo)")
    lm_k2_runs = [(LM_ARCH, r) for r in ("det", "stoch", "det chunked", "det temperature",
                                          "stoch ensemble")]
    lm_x = [(LM_ARCH, "xnor"), (LM_ARCH, "xnor chunked")]
    lm_k2 = [k2_lm_row(4, k, n) for k, n in LM_KN]
    kernels.append({**entry(f"binary_matmul ({LM_ARCH} det/stoch decode, bf16 M=4, scaled: "
                            f"the 4 projections of a layer, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul"], lm_k2_runs), errs["k2_lm"], lm_k2),
                    "device_ms_per_shape": [r[6] for r in lm_k2]})
    k3_lm = {kk: k3_row(4, kk, torch.bfloat16) for kk in sorted({k for k, _ in LM_KN})}
    lm_k3 = [k3_lm[k] for k, _ in LM_KN]
    kernels.append({**entry(f"sign_pack, no prologue ({LM_ARCH} xnor decode, bf16 M=4: the 4 "
                            f"projection inputs of a layer, summed)", k3_src, k3_rep,
                            total(launches["sign_pack"], lm_x), errs["k3"], lm_k3),
                    "device_ms_per_shape": [r[6] for r in lm_k3]})
    lm_k4 = [k4_row(4, k // 32, n, k, True) for k, n in LM_KN]
    kernels.append({**entry(f"xnor_matmul ({LM_ARCH} xnor decode, M=4, scaled: the 4 "
                            f"projections of a layer, summed)", k4_src, k4_rep,
                            total(launches["xnor_matmul"], lm_x), errs["k4"], lm_k4),
                    "device_ms_per_shape": [r[6] for r in lm_k4]})

    print(f"== {LM_ARCH} on the (2, 2) mesh, decode shapes a position runs (M = 2: a data "
          f"group's slots; det: N/2 of each projection; xnor: w_qkv and wi on N/2, w_o and "
          f"wo on K/2, K4's int32 partial unscaled)")
    mesh_k2 = [k2_lm_row(2, k, n) for k, n in LM_MESH_K2]
    kernels.append({**entry(f"binary_matmul ({LM_ARCH} det on a (2, 2) mesh, decode: a "
                            f"position's N shard at a group's M=2, bf16, scaled: the 4 "
                            f"projections of a layer, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul"],
                                  [(LM_ARCH, "det mesh"), (LM_ARCH, "det mesh chunked")]),
                            errs["k2_mesh"], mesh_k2),
                    "device_ms_per_shape": [r[6] for r in mesh_k2]})
    mesh_x = [(LM_ARCH, "xnor mesh")]
    mesh_k3 = [k3_row(2, k, torch.bfloat16) for k, _, _ in LM_MESH_K4]
    kernels.append({**entry(f"sign_pack, no prologue ({LM_ARCH} xnor on a (2, 2) mesh, "
                            f"decode: a position's input range at M=2, bf16: the 4 "
                            f"projections of a layer, summed)", k3_src, k3_rep,
                            total(launches["sign_pack"], mesh_x), errs["k3"], mesh_k3),
                    "device_ms_per_shape": [r[6] for r in mesh_k3]})
    mesh_k4 = [k4_row(2, k // 32, n, k, scaled) for k, n, scaled in LM_MESH_K4]
    kernels.append({**entry(f"xnor_matmul ({LM_ARCH} xnor on a (2, 2) mesh, decode: a "
                            f"position's shard at M=2, w_qkv and wi scaled on N/2, w_o and wo "
                            f"int32 on K/2: the 4 projections of a layer, summed)",
                            k4_src, k4_rep, total(launches["xnor_matmul"], mesh_x),
                            errs["k4"], mesh_k4),
                    "device_ms_per_shape": [r[6] for r in mesh_k4]})

    def k2_moe_row(e_, m, k, n, routings=None):
        """The expert-batched K2 at (E, M, K, N), bf16, scaled: all rows live,
        or cycling through ``routings`` (per-expert counts, one a call) with
        x zero past each count as the dispatch buffer holds it, so that
        torch.bmm on the whole (E, M, K) computes the same function. The
        bound counts what the inputs need: the live experts' words and
        scales, the live rows of x and the whole output, averaged over the
        routings; beside it the all-expert bound."""
        x = torch.randn(e_, m, k, generator=g, device=dev).to(torch.bfloat16)
        wk = torch.randn(e_, k, n, generator=g, device=dev)
        wp = torch.stack([binarize_pack(w_, stochastic=False) for w_ in wk])
        scale = wk.abs().mean(dim=1)
        del wk
        wl = torch.stack([unpack_bits(w_) for w_ in wp]).to(torch.bfloat16)  # library operand
        if routings is None:
            calls = [(x, None)]
        else:
            rows_ = [r.to(dev) for r in routings]
            calls = [(x * (torch.arange(m, device=dev) < r[:, None])[:, :, None], r)
                     for r in rows_]
        cyc = itertools.cycle(calls)

        def kern():
            xi, r = next(cyc)
            return binary_matmul_batched(xi, wp, scale, r)

        def plain():
            xi, r = next(cyc)
            return binary_matmul_batched_plain(xi, wp, scale, r)

        ms = time_warm(kern)
        dev_ms = device_ms(kern, "binary_matmul_batched_kernel", reps=max(20, 2 * len(calls)))
        plain_ms = time_warm(plain, iters=20)
        lib_ms = time_warm(lambda: torch.bmm(x, wl).float() * scale[:, None, :])
        live_e = [e_ if r is None else int((r > 0).sum()) for _, r in calls]
        live_m = [e_ * m if r is None else int(r.clamp(max=m).sum()) for _, r in calls]
        words = (k + 31) // 32 * n * 4
        nbytes = statistics.fmean(le * (words + n * 4) + lm * k * 2 + e_ * m * n * 4
                                  for le, lm in zip(live_e, live_m))
        all_b = e_ * (m * k * 2 + words + n * 4 + m * n * 4)
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        t_o = 2.0 * statistics.fmean(live_m) * k * n / PEAK_BF16_FLOP_PER_S * 1e3
        t_all = max(all_b / PEAK_BYTES_PER_S, 2.0 * e_ * m * k * n / PEAK_BF16_FLOP_PER_S) * 1e3
        what = ("all rows live" if routings is None else
                f"the served decode routing over {len(calls)} layers, live experts "
                f"{min(live_e)}-{max(live_e)} (mean {statistics.fmean(live_e):.2f}), live rows "
                f"{min(live_m)}-{max(live_m)}")
        print(f"  expert-batched K2 scaled {e_}x{m}x{k}x{n} bf16, {what}: kernel_ms {ms:.4f}, "
              f"device_ms {fmt(dev_ms)}, plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} "
              f"(torch.bmm on unpacked +-1 times scale, all {e_}x{m} rows), bound_ms "
              f"{max(t_b, t_o):.5f} ({'bytes' if t_b >= t_o else 'operations'}, {nbytes:.0f} B; "
              f"all experts {t_all:.5f}, {all_b} B)")
        return (ms, plain_ms, max(t_b, t_o), t_b, t_o, lib_ms, dev_ms, t_all,
                statistics.fmean(live_e))

    print(f"== {MOE_ARCH} decode shapes (4 slots: the experts' capacity 8; a layer runs w_qkv "
          f"and w_o on K2, w_gate, w_up and w_down on the expert-batched K2), each expert "
          f"shape all rows live and at the decode routing a served det step produced")
    moe_runs = [(MOE_ARCH, r) for r in ("det", "stoch", "det chunked")]
    moe_shapes = [MOE_K2[0], MOE_K2[0], MOE_K2[1]]
    moe_k2_all = [k2_moe_row(*sh) for sh in moe_shapes]
    moe_k2 = [k2_moe_row(*sh, routings=moe_decode_rows) for sh in moe_shapes]
    kernels.append({**entry(f"binary_matmul_batched ({MOE_ARCH} det/stoch decode at the "
                            f"served routing, bf16, 64 experts x 8 rows, scaled: w_gate, "
                            f"w_up, w_down of a layer, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul_batched"], moe_runs),
                            errs["k2_moe"], moe_k2),
                    "replaces_note": "vmapped over the experts at src/repro/models/moe.py:29-32",
                    "device_ms_per_shape": [r[6] for r in moe_k2],
                    "live_experts_mean": moe_k2[0][8],
                    "bound_ms_all_experts": sum(r[7] for r in moe_k2),
                    "all_rows_live": {
                        key: v for key, v in entry("", "", "", 0, 0.0, moe_k2_all).items()
                        if key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}})
    moe_attn = [k2_lm_row(4, k, n) for k, n in MOE_ATTN_KN]
    kernels.append({**entry(f"binary_matmul ({MOE_ARCH} det/stoch decode, bf16 M=4, scaled: "
                            f"w_qkv and w_o of a layer, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul"], moe_runs), errs["k2_moe_attn"],
                            moe_attn),
                    "device_ms_per_shape": [r[6] for r in moe_attn]})

    print(f"== {SSM_ARCH} shapes: K1 at pack time (cold), and the decode projections (M = 4 "
          f"slots; a layer runs in_proj and out_proj)")
    ssm_runs = [r for r in run_mode if r[0] == SSM_ARCH]
    ssm_k1 = {}
    for mode in ("det", "stoch"):
        st = mode == "stoch"
        rows_ = []
        for k_, n_ in SSM_KN:
            w_ = torch.randn(k_, n_, generator=g, device=dev) * 0.7
            b_ = rand_words((k_, n_)) if st else None
            ms = time_cold(lambda: binarize_pack(w_, b_, stochastic=st))
            plain_ms = time_cold(lambda: binarize_pack_plain(w_, b_, stochastic=st))
            dev_ms = device_ms(lambda: (flush_buf.zero_(), binarize_pack(w_, b_, stochastic=st)),
                               "binarize_pack_kernel")
            nbytes = k_ * n_ * 4 * (2 if st else 1) + (k_ + 31) // 32 * n_ * 4
            t_b = nbytes / PEAK_BYTES_PER_S * 1e3
            print(f"  K1 {mode} {k_}x{n_} f32: kernel_ms {ms:.4f}, device_ms {fmt(dev_ms)}, "
                  f"plain_ms {plain_ms:.4f}, library_ms none, bound_ms {t_b:.5f} (bytes, "
                  f"{nbytes} B)")
            rows_.append((ms, plain_ms, t_b, t_b, 0.0, None, dev_ms))
        ssm_k1[mode] = rows_
        kernels.append({**entry(f"binarize_pack ({mode}, {SSM_ARCH}: in_proj and out_proj of "
                                f"a layer, summed)",
                                "src/repro_torch/kernels/csrc/binarize_pack.cu",
                                ("src/repro/kernels/stoch_binarize.py:118" if st
                                 else "src/repro/kernels/stoch_binarize.py:98"),
                                total(launches["binarize_pack"],
                                      [r for r in ssm_runs if (run_mode[r] == "stoch") == st]),
                                errs[f"k1_{mode}"], rows_),
                        "device_ms_per_shape": [r[6] for r in rows_]})
    ssm_k2 = [k2_lm_row(4, k_, n_) for k_, n_ in SSM_KN]
    kernels.append({**entry(f"binary_matmul ({SSM_ARCH} det/stoch decode, bf16 M=4, scaled: "
                            f"in_proj and out_proj of a layer, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul"], ssm_runs), errs["k2_ssm"], ssm_k2),
                    "device_ms_per_shape": [r[6] for r in ssm_k2]})
    ssm_k3 = [k3_row(4, k_, torch.bfloat16) for k_, _ in SSM_KN]
    kernels.append({**entry(f"sign_pack, no prologue ({SSM_ARCH} xnor decode, bf16 M=4: the "
                            f"inputs of in_proj and out_proj, summed)", k3_src, k3_rep,
                            total(launches["sign_pack"], ssm_runs), errs["k3"], ssm_k3),
                    "device_ms_per_shape": [r[6] for r in ssm_k3]})
    ssm_k4 = [k4_row(4, k_ // 32, n_, k_, True) for k_, n_ in SSM_KN]
    kernels.append({**entry(f"xnor_matmul ({SSM_ARCH} xnor decode, M=4, scaled: in_proj and "
                            f"out_proj of a layer, summed)", k4_src, k4_rep,
                            total(launches["xnor_matmul"], ssm_runs), errs["k4"], ssm_k4),
                    "device_ms_per_shape": [r[6] for r in ssm_k4]})

    print(f"== {HYB_ARCH} decode shapes (M = 4 slots; a period runs 28 2-D K2: w_qkv, w_o, "
          f"7 mixers' in_proj and out_proj, 4 dense GLUs' w_gate, w_up and w_down; and 12 "
          f"expert-batched K2: 4 MoE layers' w_gate, w_up and w_down), each expert shape all "
          f"rows live and at the decode routing the served 72-layer det step produced")
    hyb_runs = [r for r in run_mode if r[0] == HYB_ARCH]
    hyb_2d_rows = [k2_lm_row(4, k_, n_) for (k_, n_), _ in HYB_KN]
    hyb_2d = [r for r, (_, c) in zip(hyb_2d_rows, HYB_KN) for _ in range(c)]
    kernels.append({**entry(f"binary_matmul ({HYB_ARCH} det/stoch decode, bf16 M=4, scaled: "
                            f"the 28 2-D projections of a period, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul"], hyb_runs), errs["k2_hyb"], hyb_2d),
                    "device_ms_per_shape": [r[6] for r in hyb_2d_rows],
                    "shapes": [f"{k_}x{n_} x{c}" for (k_, n_), c in HYB_KN]})
    hyb_b_all, hyb_b_routed = {}, {}
    for sh in dict.fromkeys(HYB_K2):
        hyb_b_all[sh] = k2_moe_row(*sh)
        torch.cuda.empty_cache()
        hyb_b_routed[sh] = k2_moe_row(*sh, routings=hyb_decode_rows)
        torch.cuda.empty_cache()
    hyb_shapes = [HYB_K2[0], HYB_K2[0], HYB_K2[1]]     # w_gate, w_up, w_down
    hyb_b = [hyb_b_routed[sh] for sh in hyb_shapes]
    kernels.append({**entry(f"binary_matmul_batched ({HYB_ARCH} det/stoch decode at the "
                            f"served routing, bf16, 16 experts x 8 rows, scaled: w_gate, w_up, "
                            f"w_down of a MoE layer, summed)",
                            "src/repro_torch/kernels/csrc/binary_matmul.cu",
                            "src/repro/kernels/binary_matmul.py:125",
                            total(launches["binary_matmul_batched"], hyb_runs),
                            errs["k2_hyb_moe"], hyb_b),
                    "replaces_note": "vmapped over the experts at src/repro/models/moe.py:29-32",
                    "device_ms_per_shape": [r[6] for r in hyb_b],
                    "live_experts_mean": hyb_b[0][8],
                    "bound_ms_all_experts": sum(r[7] for r in hyb_b),
                    "all_rows_live": {
                        key: v for key, v in entry(
                            "", "", "", 0, 0.0, [hyb_b_all[sh] for sh in hyb_shapes]).items()
                        if key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}})

    print("== xnor conv layers as a whole (K5, then K4 with the border correction and "
          "epilogue in its flush) against F.conv2d on +-1 f32, TF32 off; device kernels "
          "a layer launches, counted by torch.profiler")
    F = torch.nn.functional
    layer_ms = lib_ms = 0.0
    per_layer = []
    for shape, n_out in VGG_XNOR_CONVS:
        c = shape[-1]
        xw = torch.randn(3, 3, c, n_out, generator=g, device=dev)
        leaf = XnorConv(pack_conv_kernel(xw), xw.abs().mean(dim=(0, 1, 2)), (3, 3), c)
        x = torch.randn(shape, generator=g, device=dev)
        ms = time_warm(lambda: apply_conv2d(leaf, x))
        xs = torch.where(x > 0, 1.0, -1.0).permute(0, 3, 1, 2).contiguous()
        ws = torch.where(xw > 0, 1.0, -1.0).permute(3, 2, 0, 1).contiguous()
        lms = time_warm(lambda: F.conv2d(xs, ws, padding=1))
        layer_dev = profiled(lambda: apply_conv2d(leaf, x), reps=20)
        n_kernels = kernels_per_rep(lambda: apply_conv2d(leaf, x))
        lib_dev = profiled(lambda: F.conv2d(xs, ws, padding=1), reps=20)
        layer_ms, lib_ms = layer_ms + ms, lib_ms + lms
        per_layer.append(n_kernels)
        print(f"  {shape} -> {n_out}: xnor layer_ms {ms:.4f} (device "
              f"{fmt(layer_dev and sum(layer_dev.values()))}, "
              f"{'not measured' if n_kernels is None else f'{n_kernels:g}'} device kernels "
              f"a layer), F.conv2d library_ms {lms:.4f} (device "
              f"{fmt(lib_dev and sum(lib_dev.values()))})")
    print(f"  the 11 layers of one batch: xnor {layer_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms; "
          f"device kernels per xnor conv layer: {per_layer}")

    print("== training summary (steps/s over the steps after the first, device ms per "
          "step; no bound claimed)")
    for key_, r in train_ms.items():
        if key_ == "tf32":
            continue
        print(f"  {key_[0]} {key_[1]}: {r['steps_per_s']:.2f} steps/s, wall ms "
              f"{[round(w, 3) for w in r['wall_ms']]}, device ms {[fmt(d) for d in r['device_ms']]}, "
              f"device launches {[fmt_count(n) for n in r['launches']]}, binarized weights "
              f"differing from the CPU's {r['flips']}")

    print("== serving summary (ms/batch median, img/s)")
    for (arch, mode), r in serve_ms.items():
        busy = r.get("busy")
        dev = f", device busy {busy:.4f} ms ({100 * busy / r['ms']:.1f}%)" if busy else ""
        launches = "" if r["launches"] is None else f", {r['launches']:g} device launches"
        if "chain_launches" in r:
            launches += f" (K3's prologue route off: {fmt_count(r['chain_launches'])})"
        print(f"  {arch} {mode}: {r['ms']:.4f} ms/batch, {r['ips']:.1f} img/s{dev}{launches}")

    print(f"== {LM_ARCH} serving summary (full width, {LM_SERVE})")
    for mode in LM_MODES:
        r = lm_rows[mode]
        print(f"  {mode}: pack {r['pack_s']:.3f} s, {r['dense_mb']:.1f} -> {r['served_mb']:.1f} "
              f"MB, {r['tok_s']:.1f} tok/s ({r['steps']} steps in {r['seconds']:.3f} s), median "
              f"TTFT {r['ttft_ms']:.1f} ms, median latency {r['latency_ms']:.1f} ms, decode "
              f"step {r['step_ms']:.3f} ms (device {fmt(r['step_device_ms'])} ms, "
              f"{fmt_count(r['step_launches'])} launches), peak {r['peak_gb']:.2f} GB, logits "
              f"vs plain kernels {r['max_abs_err']:.4g}")
    tr = lm_rows["trace"]
    print(f"  traced det: coverage {tr['coverage'] * 100:.1f}%, {tr['tok_s']:.1f} tok/s; "
          + "; ".join(f"{k} dispatch {d:.3f} + device {v:.3f} ms ({n} calls)"
                      for k, (n, d, v) in tr["split"].items()))
    for mode in ("det", "xnor"):
        r = lm6f[mode]
        print(f"  chunked {mode} ({LM_6F_LAYERS} layers): {r['tok_s']:.1f} tok/s ({r['steps']} steps, {r['chunks']} "
              f"chunks in {r['seconds']:.3f} s), median TTFT {r['ttft_ms']:.1f} ms (whole-prompt "
              f"admission {r['whole_tok_s']:.1f} tok/s, {r['whole_ttft_ms']:.1f} ms), prefix "
              f"{r['prefix']['hits']} hits / {r['prefix']['misses']} misses, "
              f"{r['prefix']['tokens_skipped']} tokens skipped; {r['n_equal']}/{n_req} streams "
              f"equal the whole-prompt ones; "
              + "; ".join(f"{k} {w:.3f} ms wall, {fmt(d)} device, {fmt_count(n)} launches"
                          for k, (w, d, n) in r["costs"].items()))
    print("  traced chunked det: " + "; ".join(
        f"{k} dispatch {d:.3f} + device {v:.3f} ms ({n} calls)"
        for k, (n, d, v) in lm6f["det"]["split"].items()))
    t_, e_ = lm6f["temperature"], lm6f["ensemble"]
    print(f"  temperature: {t_['equal']}/4 streams equal the plain kernels', smallest margin "
          f"{t_['margin']:.4g}, gumbel card vs CPU {t_['g_err']:.3g}")
    print(f"  ensemble K={LM_ENSEMBLE['k']}: {e_['bytes'] / 1e6:.1f} MB, pack "
          f"{e_['pack_s']:.3f} s, {e_['tok_s']:.1f} tok/s, decode step {e_['step'][0]:.3f} ms "
          f"wall, {fmt(e_['step'][1])} device, {fmt_count(e_['step'][2])} launches, mean "
          f"agreement {e_['agreement']:.3f}")
    print(f"== {LM_ARCH} on the (2, 2) ('data', 'model') mesh, one card (full width, "
          f"{LM_SERVE}) [{smi}]")
    for mode in ("det", "xnor"):
        r = mesh6k[mode]
        print(f"  {mode}: placed in {r['place_s']:.3f} s, "
              f"{', '.join(f'{v / 1e6:.1f}' for v in r['bytes_per_position'])} MB a position; "
              f"{r['tok_s']:.1f} tok/s ({r['steps']} steps in {r['seconds']:.3f} s), median "
              f"TTFT {r['ttft_ms']:.1f} ms, decode step {r['step_ms']:.3f} ms (device "
              f"{fmt(r['step_device_ms'])} ms, {fmt_count(r['step_launches'])} launches, "
              f"{r['proj_launches']} of them the projections'), collectives a step "
              f"{r['collectives']}, peak {r['peak_gb']:.2f} GB; {r['n_equal']}/16 streams equal "
              f"6e's, {r['near_ties']} near ties; logits vs single-device {r['logit_err']:.4g} "
              f"({r['steps_bitwise']}/{m_slots * m_new} steps bit for bit)")
    r = mesh6k["chunked"]
    print(f"  chunked det ({LM_6F_LAYERS} layers): {r['tok_s']:.1f} tok/s ({r['steps']} steps, "
          f"{r['chunks']} chunks; whole-prompt {r['whole_tok_s']:.1f} tok/s), prefix "
          f"{r['prefix']['hits']} hits, {r['n_equal']}/{r['n']} streams equal the whole-prompt "
          f"mesh streams, {r['near_ties']} near ties")
    print(f"== {MOE_ARCH} serving summary (full width, {MOE_LAYERS} of 48 layers, {LM_SERVE})")
    for mode in MOE_MODES:
        r = moe_rows[mode]
        print(f"  {mode}: pack {r['pack_s']:.3f} s, {r['dense_mb']:.1f} -> {r['served_mb']:.1f} "
              f"MB, {r['tok_s']:.1f} tok/s ({r['steps']} steps in {r['seconds']:.3f} s), median "
              f"TTFT {r['ttft_ms']:.1f} ms, median latency {r['latency_ms']:.1f} ms, decode "
              f"step {r['step_ms']:.3f} ms (device {fmt(r['step_device_ms'])} ms, expert-"
              f"batched K2 {fmt(r['step_k2b_ms'])} ms of it, "
              f"{fmt_count(r['step_launches'])} launches), peak {r['peak_gb']:.2f} GB, logits "
              f"vs plain kernels {r['max_abs_err']:.4g}, dropped fraction prefill "
              f"{r['drop_prefill']:.5g} / decode {r['drop_decode']:.3g}, routing flips "
              f"{r['flips'][0]}/{r['flips'][1]} (largest gap {r['flips'][2]:.4g})")
    r = moe_rows["chunked"]
    print(f"  chunked det: {r['tok_s']:.1f} tok/s ({r['steps']} steps, {r['chunks']} chunks), "
          f"median TTFT {r['ttft_ms']:.1f} ms, prefix {r['prefix']['hits']} hits / "
          f"{r['prefix']['misses']} misses; {r['n_equal']}/{r['n_req']} streams equal the "
          f"whole-prompt ones, {r['n_dropped']} whole-prompt prefills dropped assignments")
    print(f"== {SSM_ARCH} serving summary (full width, all {ssm_cfg.n_layers} layers, "
          f"{LM_SERVE})")
    for mode in LM_MODES:
        r = ssm_rows[mode]
        print(f"  {mode}: pack {r['pack_s']:.3f} s, {r['dense_mb']:.1f} -> {r['served_mb']:.1f} "
              f"MB, {r['tok_s']:.1f} tok/s ({r['steps']} steps in {r['seconds']:.3f} s), median "
              f"TTFT {r['ttft_ms']:.1f} ms, median latency {r['latency_ms']:.1f} ms, decode "
              f"step {r['step_ms']:.3f} ms (device {fmt(r['step_device_ms'])} ms, K2/K3/K4 "
              f"{fmt(r['step_kernel_ms'])} ms of it, {fmt_count(r['step_launches'])} launches), "
              f"peak {r['peak_gb']:.2f} GB, logits vs plain kernels {r['max_abs_err']:.4g} "
              f"({SSM_LONG_PROMPT}-token prefill {r['long_err']:.4g}, its final state "
              f"{r['long_state_err']:.3g} of the largest |value|)")
    r = ssm_rows["chunked"]
    print(f"  chunked det: {r['tok_s']:.1f} tok/s ({r['steps']} steps, {r['chunks']} chunks), "
          f"median TTFT {r['ttft_ms']:.1f} ms, prefix {r['prefix']['hits']} hits / "
          f"{r['prefix']['misses']} misses; {r['n_equal']}/{r['n_req']} streams equal the "
          f"whole-prompt ones")
    r = hyb_rows["full"]
    print(f"== {HYB_ARCH} serving summary (full width, {LM_SERVE})")
    print(f"  all {hyb_cfg.n_layers} layers, det: draw + pack {r['pack_s']:.3f} s, "
          f"{r['dense_gb']:.2f} "
          f"-> {r['served_gb']:.2f} GB ({r['words_gb']:.2f} GB of words and scales, "
          f"{r['f32_gb']:.2f} GB of f32 leaves), {r['tok_s']:.2f} tok/s ({r['steps']} steps in "
          f"{r['seconds']:.3f} s), median TTFT {r['ttft_ms']:.1f} ms, median latency "
          f"{r['latency_ms']:.1f} ms, decode step {r['step_ms']:.3f} ms (device "
          f"{fmt(r['step_device_ms'])} ms, 2-D K2 {fmt(r['k2_ms'])} ms, expert-batched K2 "
          f"{fmt(r['k2b_ms'])} ms, {fmt_count(r['step_launches'])} launches), peak allocated "
          f"{r['peak_serve_gb']:.2f} GB (serve), {r['peak_gb']:.2f} GB (with the checks)")
    for mode in MOE_MODES:
        r = hyb_rows[mode]
        print(f"  one period, {mode}: draw + pack {r['pack_s']:.3f} s, {r['served_gb']:.2f} GB, "
              f"{r['tok_s']:.1f} tok/s, median TTFT {r['ttft_ms']:.1f} ms, decode step "
              f"{r['step_ms']:.3f} ms (device {fmt(r['step_device_ms'])} ms, 2-D K2 "
              f"{fmt(r['k2_ms'])} ms, expert-batched K2 {fmt(r['k2b_ms'])} ms, "
              f"{fmt_count(r['step_launches'])} launches), logits vs plain kernels "
              f"{r['max_abs_err']:.4g}, routing flips {r['flips'][0]}/{r['flips'][1]} (largest "
              f"gap {r['flips'][2]:.4g}), dropped fraction at prefill {r['drop_prefill']:.5g}")
    r = hyb_rows["chunked"]
    print(f"  one period, chunked det: {r['tok_s']:.1f} tok/s ({r['steps']} steps, {r['chunks']} "
          f"chunks), median TTFT {r['ttft_ms']:.1f} ms, prefix {r['prefix']['hits']} hits / "
          f"{r['prefix']['misses']} misses; {r['n_equal']}/{r['n_req']} streams equal the "
          f"whole-prompt ones, {r['n_dropped']} whole-prompt prefills dropped assignments")
    print(f"== LM training summary (Alg. 1, SGD momentum, batch {TRAIN_LM['batch']} x "
          f"{TRAIN_LM['seq']} tokens, grads clipped to norm {TRAIN_LM_GRAD_CLIP:g}) [{smi}]")
    for tag, what in (("lm", f"{TRAIN_LM_ARCH}, all layers"),
                      ("frontend", f"{TRAIN_FRONTEND_ARCH}, {TRAIN_FRONTEND_LAYERS} layers")):
        r = train_rows[tag]
        print(f"  {what} ({r['params_b']:.3f} B parameters): peak allocated "
              f"{r['peak_gb']:.2f} GB (reckoned {r['reckoned_gb']:.1f}); " + "; ".join(
                  f"{s['mode']} wall {s['wall_ms']:.1f} ms"
                  + (f" (profiled: device {fmt(s['device_ms'])} ms, "
                     f"{fmt_count(s['launches'])} launches)" if s["profiled"] else "")
                  + f" loss {s['loss']:.4f}" for s in r["steps"]))
    r = train_rows["lm"]
    print(f"  {TRAIN_LM_ARCH} stoch: the twin's uniforms {r['twin_ms']:.1f} ms a step; the "
          f"CLI's unclipped step: largest |grad| {r['diverge']['grad']:.3g}, largest |master| "
          f"after it {r['diverge']['master']:.3g}; {TRAIN_FRONTEND_ARCH}'s at all 48 layers: "
          f"{train_rows['frontend']['full']['nonfinite_leaves']} grad leaves not finite")
    for (dtype, mode), r in train_rows["cut"].items():
        print(f"  {TRAIN_LM_ARCH} {TRAIN_LM_CPU_LAYERS} layers {dtype} {mode}, step 1 relative "
              f"l2, the head's worst leaf / the rest's: " + ", ".join(
                  f"{k} {r['head'][k]:.3g} / {r['rest'][k]:.3g}" for k in r["head"])
              + f"; losses (card, CPU) {[(round(a, 6), round(b, 6)) for a, b in r['losses']]}; "
              f"binarized weights differing {r['flips']}; CPU {r['cpu_s']:.1f} s")
    print(f"  mamba2_130m CLI: recoveries {train_rows['cli']['recoveries']}, final masters "
          f"equal to the clean run's bit for bit")
    for arch, r in train_rows["smoke"].items():
        print(f"  {arch} SMOKE det vs CPU: loss {r['loss']:.6f} / {r['loss_cpu']:.6f}, lb_loss "
              f"{r['lb']:.6f} / {r['lb_cpu']:.6f}, momentum {r['mu']:.3g}, masters "
              f"{r['params']:.3g}")
    marks = sorted(phase_start.items(), key=lambda kv: kv[1]) + [("end", time.perf_counter())]
    print("== seconds a phase: " + ", ".join(
        f"{name} {t1 - t0:.1f}" for (name, t0), (_, t1) in zip(marks, marks[1:]))
        + f"; {time.perf_counter() - t_start:.1f} in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
