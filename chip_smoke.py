#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc, plain
C interface, one nvcc per source, all started together) and holds every
kernel against its plain PyTorch version on the card. Then it drives the
port's main paths:

  * the policy simulator: the hybrid keep-alive policy replayed over a
    1M-app, 14-day trace through ``repro_torch.core.experiment.run(
    engine="kernel")`` (one launch of the sweep-scan kernel, no step
    launch), checked against the float64 engine and the scalar oracle,
    the scan kernel held to the step kernel iterated (``scan_parity``, in
    every form), and the 34-config policy sweep, whose 32 hybrid configs
    share one histogram group and take the scan's ``factored`` form (one
    launch a chunk; ``factored_parity`` holds that form to the factored
    plain scan and to the register form over one histogram per config);
  * serving: full-width RecurrentGemma-2B (``use_kernels=True``, bf16) in
    two endpoints behind a ``WarmPool`` driven by the hybrid policy, with a
    short periodic request stream of ``generate([2, 4096], max_new=16)``
    calls (cold, warm, and a reload after the keep-alive ran out); every
    prefill must launch the attention kernel 8 times and the RG-LRU scan
    18 times, and the kernel path's logits must agree with the plain
    branches (``use_kernels=False``) in bf16 and be no less accurate
    against them in f32;
  * serving Mamba-2-2.7B the same way (phase ``serve_mamba2``): every
    prefill must launch the SSD scan kernel 64 times, once per layer;
  * serving Qwen2-7B the same way (phase ``serve_qwen2``), through a KV
    cache: every request must launch the attention kernel 28 times (the
    prefill) and the decode kernel 420 times (15 decode steps of 28
    layers, counted through the graph's replays), and the logits of four
    decode steps are held to the plain branches too;
  * in every serving phase, ``generate`` decodes through the engine's
    executable cache: a CUDA graph of one decode step per (app,
    ``max_len``, batch), captured at the first request after each load
    (its seconds reported as ``capture_s``) and replayed for every later
    step. Phase ``decode_graph``, run inside each serving phase on its
    weights: the graph's tokens and logits over 15 greedy steps equal the
    eager ``model.decode_step``'s from the same prefill bit for bit, with
    the same launches a step by kernel and form, the two timed in turn;
  * serving OLMoE-1B-7B (phase ``serve_olmoe``, the MoE family: 64
    experts, top 8, at the ``depth_scaled`` draw, whose routing does not
    collapse) the same way: 16 attention and 240 decode launches a
    request, the decode kernel at group 1; beside the gates, each layer's
    routing agreement between the kernel and plain paths, the choices
    dropped by capacity, and the prefill with the gather dispatch beside
    the einsum one;
  * serving SeamlessM4T-medium (phase ``serve_seamless``, the
    encoder-decoder, head dim 64) the same way: the encoder fed the
    frontend stub's zero frames, 12 attention and 180 decode launches a
    request;
  * the paper's default hybrid, ARIMA on, over ``azure_like(100_000,
    days=7, seed=0)`` (phase ``arima_point``): the histogram pass, then
    the forecast post-pass of the apps the scan flags as consulting the
    forecaster (one step-kernel launch per event column in the rescan,
    one batched fit of every forecaster window); the kernel scan's flags
    held to the plain scan's and to the host's selection, the first 200
    apps that selection adds over the old final-state one to the scalar
    oracle; the replay held to the use_arima=False run on the other apps,
    to the scalar oracle with its forecasters on the card on sampled
    apps, the
    fit bit-identical whole, in chunks of 7 and row by row, and within
    the fit's bounds of the CPU fit; and the SPES predictor over the
    scale trace (phase ``spes_point``), equal to ``SpesPolicy`` on 1,000
    sampled apps;
  * the fleet simulation (§5.3, phase ``fleet_point``) through
    ``run(trace, spec, cluster=ClusterSpec(...))``: the 1M-app
    ``azure_like`` fleet on 1,024 workers (phase B through the sweep-step
    kernel once per event column of each chunk, no plain-step call), the
    reference benchmark's eviction regime (100k apps, 64 workers, 8
    images a worker) equal to its run with phase B on the CPU, the
    paper's default ``HybridSpec()`` on the 1M-app fleet, and the
    vectorized engine equal to the per-event oracle (policies on the
    card) on small fleets, one of them consulting the forecaster;
  * the fleet's policy-update tick over the scale trace (phase
    ``policy_update_parity``): one tick per event column through the CUDA
    kernel, every output equal to the plain version's at every tick and,
    on 1,000 sampled apps, to the scalar ``AppHistogram``; and one more
    tick at 1,000 bins on a seeded small fleet with rows past
    ``MAX_SCALED_COUNT``, equal to the plain version;
  * the serving launcher (phase ``launch_serve``):
    ``repro_torch.launch.serve.main`` on the card at the reference's
    example (40 apps, 120 minutes) and at 2,000 apps x 240 minutes under
    both policies, each run's printed lines equal to the per-event
    oracle's (``--engine scalar``);
  * training (phase ``train_smollm``): full-width SmolLM-135M (30 layers,
    bf16 compute, fp32 AdamW masters, remat, ``use_kernels=False``) for 20
    steps of 8 x 4,096 tokens through the training launcher
    (``launch.train.run``), gated on the loss falling by 0.3 nats, the first
    step in bf16 against f32, a restart after a fault at step 10 that
    reproduces steps 11-20 bit for bit, and a kernel refusing autograd;
    no kernel of the port launches there, as in the reference.
  * the multi-device layers (phase ``mesh_train``): a one-rank NCCL
    process group and a (1, 1) ``("data", "model")`` ``DeviceMesh``;
    full-width SmolLM-135M, 5 ZeRO steps of 8 x 4,096 tokens (masters
    and moments as DTensors in ``opt_specs`` placements,
    ``grad_shardings``) with cast_bf16 off and on, each bit-equal to the
    unsharded steps in losses and masters; then ``save``,
    ``resharded_restore`` onto a fresh mesh and
    ``verify_roundtrip(atol=0)``. Phase ``dryrun`` runs on the host (a
    worker process started after ``mesh_train`` and waited for before the
    kernels are timed, ``CUDA_VISIBLE_DEVICES=""``):
    ``repro_torch.launch.dryrun`` on the fake process group, Qwen2-7B
    train_4k and decode_32k on 16 x 16 and decode_32k on 2 x 16 x 16, per
    device bytes against the card's 80 GB. Phase ``dist_ranks`` asks gloo
    whether it takes CUDA tensors for every collective of the distributed
    decode and the pipeline, with two ranks on the card; it does not for
    send/recv, so the phase's line says it was left out and why.

Before the build, phase ``lint`` runs the port's invariant linter
(``repro_torch.analysis``, standard library only) over ``src/repro_torch``
in-process; a finding fails the run there. After the last phase, phase
``tf32`` checks that no phase switched TF32 on: both ``allow_tf32``
switches off and the float32 matmul precision ``"highest"``.

Then it times each kernel at its path's shapes beside its bound, its plain
version and, where one exists, the one PyTorch call computing the same
function (the decode kernel with ``kv_len`` on the device, as the serving
graphs launch it, beside the host-int form; the fleet tick per call and
back to back, the RG-LRU scan by
CUDA-graph replay and with its host work, the sweep scan's factored form
at the sweep point beside its register form). Each phase prints one JSON
line; any mismatch raises. The last lines are the kernel table, the
card's name and power limit (``nvidia-smi``), and ``{"ok": true,
"device": ...}``.

Exits non-zero without a result where there is no CUDA device or no
``src/repro_torch`` beside this file. Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
BF16_TENSOR_OPS_PER_S = 989e12   # H100 SXM dense bf16 tensor cores
F32_CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM rate of plain scalar instructions outside the tensor cores: the
# data sheet's 67e12 float32 rate counts a fused multiply-add as two
# operations, and the step's multiplies, compares and adds (mostly int32)
# issue at one per lane per clock, half of that
SCALAR_OPS_PER_S = 33.5e12
SCALE_APPS = 1_000_000
SWEEP_APPS = 100_000
# The paper's default hybrid (240 one-minute bins, ARIMA on) over its §3
# fleet mix at the scenario library's default size: azure_like(100_000,
# days=7, seed=0). Gate 2 replays sampled OOB-heavy apps through the scalar
# oracle with at most ARIMA_SCALAR_FITS forecaster fits; gates 3 and 4
# refit ARIMA_FIT_SAMPLE of the forecaster windows (whole, in chunks of
# ARIMA_FIT_CHUNK, and ARIMA_ROW_BY_ROW of them one at a time; on the CPU).
ARIMA_APPS, ARIMA_DAYS = 100_000, 7.0
ARIMA_SCALAR_FITS = 40
# The post-pass selection: the apps at which the scalar policy consults the
# forecaster at some event (the scan's ``consulted`` flag). The selection
# before that repair took the apps OOB-heavy in the scan's final state,
# 12,621 apps here (on an NVIDIA H100 80GB HBM3 and on the CPU alike: the
# count follows from the trace). The scalar oracle (forecasters on
# the CPU, where a lone window fits faster than on the card) replays the
# first ARIMA_ADDED_CHECK apps the new selection adds.
ARIMA_OLD_SELECTION = 12_621
ARIMA_ADDED_CHECK = 200
ARIMA_FIT_SAMPLE, ARIMA_FIT_CHUNK, ARIMA_ROW_BY_ROW = 4096, 7, 8
# The fit's bounds against the reference, as tests/test_torch_forecast_
# conformance.py states them: at most 1% of the (window, order) pairs
# beyond |dAIC| 3e-4 or relative |dpred| 1e-3; the selected order equal
# where the two best valid AICs are >= 0.01 apart, at most 4% of the
# selected forecasts beyond 1e-4. Gate 4 holds the card's fit to the
# port's CPU fit with them.
FIT_BOUNDS = dict(share=0.01, aic=3e-4, pred=1e-3, selected_share=0.04,
                  selected_pred=1e-4, selection_delta=0.01)
SPES_SAMPLE = 1000
# The fleet simulation (§5.3, phase fleet_point). (a) The README's fleet:
# azure_like(1_000_000, days=0.5, seed=17, max_events=6) on 1,024 workers,
# infinite HBM budget (the reference's CPU record, BENCH_cluster_sim.json
# "fleet": 2,547,247 events). (b) The reference benchmark's eviction regime
# (benchmarks/cluster_sim.py:29,132-135): 100k apps of the same scenario,
# 64 workers, a budget of 8 x the largest image; the reference's record
# counts 44,084 evictions there. (c) HybridSpec() (ARIMA on) on (a).
FLEET = dict(n_apps=1_000_000, days=0.5, seed=17, max_events=6)
FLEET_WORKERS = 1024
EVICT_FLEET = dict(n_apps=100_000, days=0.5, seed=17, max_events=6)
EVICT_WORKERS, EVICT_IMAGES = 64, 8
REF_EVICTIONS = 44_084
# Gate 1 against the port's per-event oracle: the reference benchmark's
# smoke size (2,000 apps, 16 workers; an infinite budget and 2 images), and
# a fleet where apps consult the forecaster (at 0.5 days none can: five
# idle times past the 240-minute range do not fit in 720 minutes), the
# oracle's forecasters fitting on the card.
GATE_FLEET = dict(n_apps=2_000, days=0.5, seed=17, max_events=6)
GATE_WORKERS, GATE_IMAGES = 16, 2
FORECAST_FLEET = dict(n_apps=60, days=3.0, seed=5, max_events=16)
FORECAST_WORKERS = 4
CLUSTER_COUNTERS = ("cold_starts", "warm_starts", "prewarms", "unloads",
                    "evictions", "budget_overflows", "bytes_moved")
# The float32 "reference" engine (phase reference_engine): gate (a) holds
# the card to the CPU on the scale trace's first REFERENCE_SLICE apps; gate
# (b) lets fewer than REFERENCE_MAX_COLD_SHARE of the apps differ from the
# float64 kernel engine in their cold count (float32 rebased time moved 4 of
# 1M in PR 12; many would mean a broken engine).
REFERENCE_SLICE = 20_000
REFERENCE_MAX_COLD_SHARE = 1e-3
# The example twins (phase examples) at the reference scripts' defaults;
# the quickstart's and the explorer's CPU runs (minutes of plain scans) run
# in worker processes from the start, and the phase waits for them at most
# CPU_EXAMPLES_TIMEOUT seconds. The training twin crashes at step 120 of
# 200 (checkpoints every 50 steps: it resumes from step 100).
# The scale-out phase times each devices setting this many times, in
# turns, at each point (the scale point's replay is host-bound and spreads).
SCALEOUT_REPEATS = {"scale_point": 5, "fleet": 2}
CPU_EXAMPLES = ("quickstart", "policy_explorer")
CPU_EXAMPLES_TIMEOUT = 600
EXAMPLE_CRASH_AT = 120

# The serving path: RecurrentGemma-2B's attention (B=2 prompts of 4,096
# tokens, 10 q heads, 1 KV head, head dim 256, window 2,048) and RG-LRU
# width (2,560).
SERVE_BATCH, SERVE_SEQ, SERVE_NEW = 2, 4096, 16
ATTN_SHAPE = dict(B=SERVE_BATCH, S=SERVE_SEQ, Hq=10, Hkv=1, D=256, W=2048)
# Qwen2-7B's prefill attention: 28 q heads over 4 KV heads of 128, causal,
# k and v the first SERVE_SEQ rows of the SERVE_SEQ + SERVE_NEW-row cache
QWEN2_ATTN_SHAPE = dict(B=SERVE_BATCH, S=SERVE_SEQ, Hq=28, Hkv=4, D=128, W=0)
# OLMoE-1B-7B's (16 heads of 128, MHA) and SeamlessM4T-medium's decoder
# prefill attention (16 heads of 64), causal, k and v cache views as Qwen2's
OLMOE_ATTN_SHAPE = dict(B=SERVE_BATCH, S=SERVE_SEQ, Hq=16, Hkv=16, D=128, W=0)
SEAMLESS_ATTN_SHAPE = dict(B=SERVE_BATCH, S=SERVE_SEQ, Hq=16, Hkv=16, D=64,
                           W=0)
# bf16 attention kernel vs its plain version, (atol as a share of the
# largest |want|, rtol). Both compute the softmax in f32 and round the
# output to bf16 once (2^-8 of its magnitude at most: rtol 8e-3); the kernel
# also rounds P to bf16 before P v, 2^-9 of each weight, which in a row with
# few keys moves the output by up to 2^-9 of the largest |v|, about 2e-3 of
# the largest |want| here (the first full run measured 1.1e-3 of it, 0.0039
# at a row with two keys): atol 3e-3 of the largest |want|. The reference's
# 2e-2 (atol and rtol) is more than the typical output at the serving
# shapes (median |out| about 0.03): a kernel that left out one 64-key tile
# passed it. attention_parity computes, at both path shapes, what leaving
# out one tile does and fails unless this bound catches it.
ATTN_BF16_TOL = (3e-3, 8e-3)
ATTN_DROPPED_TILE = 64
# The forms every launch of the serving paths must take, and the
# instantiations they run, which must build with no register spills.
SERVE_FORMS = {"flash_attention": "hopper", "decode_attention": "tensor_cores",
               "rglru_scan": "vec4"}
NO_SPILL_KERNELS = {
    "flash_attention": ("flash_attention_hopper_kernel<256>",
                        "flash_attention_hopper_kernel<128>",
                        "flash_attention_hopper_kernel<64>"),
    "decode_attention": ("decode_attention_mma_kernel<128,1,3>",
                         "decode_attention_mma_kernel<64,1,3>"),
    "policy_update": ("policy_update_kernel<4>", "policy_update_kernel<1>"),
    "rglru_scan": ("rglru_scan_kernel<4>", "rglru_scan_kernel<1>"),
    "hybrid_sweep_step": tuple(
        f"hybrid_sweep_scan_factored_kernel<{bpl},{cpl}>"
        for bpl in (2, 8) for cpl in (1, 2))}
RGLRU_SHAPE = (SERVE_BATCH, SERVE_SEQ, 2560)
# rglru_parity's shapes: the path's, L=384 (which the TPU kernel gets
# wrong), a ragged L at a width that is not a multiple of the kernel's 32
# channels a block, and a width that is not a multiple of 4 (the scalar
# form)
RGLRU_PARITY_SHAPES = (RGLRU_SHAPE, (2, 384, 2560), (3, 1000, 200),
                       (1, 777, 130))
RGLRU_TOL = (2e-5, 2e-4)
ATTN_PER_PREFILL, RGLRU_PER_PREFILL = 8, 18
# (minute, endpoint): both cold first, both warm 30 minutes on, and the
# first again after its 240-minute standard keep-alive ran out (a reload).
# Kernel path vs plain branches (use_kernels=False) on the same prompt and
# weights, bf16 through 26 layers: the attention and the scan round their
# f32 results to bf16 where the plain versions do too, but a value near a
# rounding edge can land one ulp apart and the difference carries on; the
# last-token logits must agree within 5% of their largest magnitude.
SERVE_LOGITS_REL_TOL = 5e-2
# (minute, endpoint index) of both serving phases
SERVE_STREAM = ((0.0, 0), (1.0, 1), (30.0, 0), (31.0, 1), (400.0, 0))

# The Mamba-2 serving path: mamba2-2.7b's SSD scan over the same prompts
# (80 heads of 64, state 128, chunk 256), one launch per layer.
SSD_SHAPE = dict(b=SERVE_BATCH, l=SERVE_SEQ, h=80, p=64, n=128, chunk=256)
SSD_PER_PREFILL = 64
# SSD kernel vs its plain version on the card, elementwise
#   |got - want| <= atol * max(1, max |want|) + rtol * |want|.
# f32: the reference's kernel tolerances (tests/test_kernels.py: atol 5e-5,
# rtol 5e-4), whose cases have outputs of order 1. At the path's shape y
# reaches ~300 and each output sums ~33k f32 products, in another order in
# each form, so atol scales with the largest |want|: held unscaled, the
# first full run failed there (7,293 of 41.9M elements, up to 1.24e-3 at
# |y| <= 295), where the float64 per-token recurrence, an oracle that
# shares no code with either form, now tells kernel and plain version
# apart. bf16 x, B and C: the kernel rounds y to bf16 (at most 2^-8 of
# |y|, half a unit in the last place) where the plain version keeps f32,
# so rtol 8e-3; before that rounding the tensor cores' two-half split of
# the f32 operands loses about 2^-17 a term, far inside atol 1e-3 (of the
# largest |want|). The final state is f32 and is held to the f32
# tolerance.
SSD_F32_TOL = (5e-5, 5e-4)
SSD_BF16_Y_TOL = (1e-3, 8e-3)
# Mamba-2 kernel path vs plain branches through 64 bf16 layers: as for the
# hybrid model, rounding flips carry through the layers; the last-token
# logits must agree within 5% of their largest magnitude.
SERVE_MAMBA2_LOGITS_REL_TOL = 5e-2
# The dense serving path: qwen2-7b (28 layers, 28 q heads over 4 KV heads
# of 128) over the same prompts, through a KV cache of SERVE_SEQ +
# SERVE_NEW positions: per request one prefill (28 launches of the
# attention kernel) and SERVE_NEW - 1 decode steps (28 launches of the
# decode kernel each). Its decode kernel at that shape, as each decode
# step's 28 layers call it (kv_len 4,097 to 4,111; timed at the full
# 4,112).
QWEN2_LAYERS = 28
DECODE_SHAPE = dict(B=SERVE_BATCH, Hq=28, Hkv=4, D=128,
                    Skv=SERVE_SEQ + SERVE_NEW)
QWEN2_ATTN_PER_REQUEST = QWEN2_LAYERS
QWEN2_DECODE_PER_REQUEST = QWEN2_LAYERS * (SERVE_NEW - 1)
SERVE_QWEN2_DECODE_STEPS = 4
# Decode kernel vs its plain version, (atol, rtol): f32 the reference's
# kernel tolerance (tests/test_kernels.py), 2e-5 (IEEE f32 on both sides,
# the sums in another order). Both versions compute in f32 and round the
# output to bf16 once, so a bf16 result may differ by one bf16 rounding
# step, at most 2^-7 of its magnitude: rtol 8e-3, and atol 1e-3 of the
# largest |want| for outputs near 0. At the serving shape a typical |out|
# is about 0.02 and leaving out one 128-key split moves it by about 5e-3,
# far past this bound (the reference's 2e-2 would let that through).
DECODE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
# split lengths at which times_decode also times the decode kernel
DECODE_SPLIT_KEYS_TIMED = (128, 256, 384, 512)
# Qwen2-7B kernel path vs plain branches through 28 bf16 layers: as for the
# other two models, the last-token logits within 5% of their largest
# magnitude; the same gate holds the logits of the decode steps.
SERVE_QWEN2_LOGITS_REL_TOL = 5e-2
# The MoE serving path: olmoe-1b-7b (16 layers, 16 heads of 128, 64
# experts of 1,024, top 8) over the same prompts: per request 16 attention
# launches (the prefill) and 15 x 16 decode launches at group 1; its decode
# kernel shape as each step calls it (timed at the full 4,112). The
# encoder-decoder: seamless-m4t-medium (12 encoder and 12 decoder layers,
# 16 heads of 64); only the decoder's causal self-attention takes the
# kernels (the encoder's is not causal, the cross-attention reads a
# memory: both the plain _sdpa, as in the reference). The same gates as
# Qwen2-7B's, four decode steps included.
OLMOE_LAYERS, SEAMLESS_DEC_LAYERS = 16, 12
OLMOE_ATTN_PER_REQUEST = OLMOE_LAYERS
OLMOE_DECODE_PER_REQUEST = OLMOE_LAYERS * (SERVE_NEW - 1)
SEAMLESS_ATTN_PER_REQUEST = SEAMLESS_DEC_LAYERS
SEAMLESS_DECODE_PER_REQUEST = SEAMLESS_DEC_LAYERS * (SERVE_NEW - 1)
OLMOE_DECODE_SHAPE = dict(B=SERVE_BATCH, Hq=16, Hkv=16, D=128,
                          Skv=SERVE_SEQ + SERVE_NEW)
SEAMLESS_DECODE_SHAPE = dict(B=SERVE_BATCH, Hq=16, Hkv=16, D=64,
                             Skv=SERVE_SEQ + SERVE_NEW)
# The MoE family's bf16 gate is the other families': the kernel path's
# logits against the plain branches', each run on its own routing. A
# router is discrete, so a last-bit difference in an attention output can
# swap two near-equal gates and move tokens across the capacity edge; the
# phase prints, per layer, the prefill's routing agreement and dropped
# choices and the decode steps' flipped choices beside the gate. OLMoE is
# served at the "depth_scaled" draw (models.moe.depth_scale_): at the
# reference's draw a 4,096-token prompt's hidden states collapse onto each
# other, routing with them, and the plain bf16 branches themselves lie
# 7-11% from the f32 ones, so no kernel short of bit-exact could be told
# right from wrong at 5%.
SERVE_MOE_LOGITS_REL_TOL = 5e-2
SERVE_ENCDEC_LOGITS_REL_TOL = 5e-2
# The fleet's policy-update tick: one tick per event column of the scale
# trace (1M apps, <= 64 columns), idle times in the paper's 240 one-minute
# bins.
POLICY_BINS = 240
POLICY_SAMPLE = 1000
# policy_update_parity's extra tick past one 256-bin tile of the kernel, on
# a seeded small fleet whose first rows sit at and past MAX_SCALED_COUNT
# (where cum * PCT_SCALE wraps around, int32 as in the reference)
POLICY_WIDE = dict(n=4099, n_bins=1000)
# Both serving phases also run the plain branches in f32 on f32 copies of
# the same weights. The kernel path's bf16 logits must lie no further from
# them than 1.5x as far as the plain branches' bf16 logits do: the kernels
# compute in f32 and round where the plain versions round, so they may
# move the bf16 result along another path of rounding flips but must not
# make it less accurate.
SERVE_F32_DIST_FACTOR = 1.5

# Training (phase train_smollm): SmolLM-135M at full width and depth, the
# train_4k shape at seq 4,096 with batch 8 instead of 256 (32,768 tokens a
# step: one card does not hold 1M tokens a step); 20 steps, a fault after
# step 10 with a checkpoint every 10 steps for the restart gate.
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 4096, 20
TRAIN_FAULT = TRAIN_CKPT_EVERY = 10
TRAIN_LR = 1e-2          # the launcher's --lr; warmup at OptConfig's 100
TRAIN_MIN_DROP = 0.3     # nats, the reference's test_train_step_reduces_loss
# the bf16 step against the same step in f32: the loss within 2%, the
# gradients' global norm within 5%
TRAIN_F32_LOSS_RTOL, TRAIN_F32_GNORM_RTOL = 0.02, 0.05
# launch_serve: the reference's example and a larger fleet, both policies
SERVE_CLI_RUNS = ((40, 120), (2000, 240))
SERVE_CLI_POLICIES = ("hybrid", "fixed")
# mesh_train: full-width SmolLM-135M, the ZeRO step on a one-rank (1, 1)
# mesh against the unsharded step, cast_bf16 off and on, at train_smollm's
# step of 8 x 4,096 tokens
MESH_TRAIN_STEPS = 5
# dryrun (on the host): (mesh, arch, shape) cells on the fake process group
DRYRUN_CELLS = ((False, "qwen2-7b", "train_4k"),
                (False, "qwen2-7b", "decode_32k"),
                (True, "qwen2-7b", "decode_32k"))
DRYRUN_TIMEOUT = 600
# dist_ranks: the collectives of the distributed decode and the pipeline,
# tried on CUDA tensors with two gloo ranks on the one card
GLOO_CUDA_COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "send_recv")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# Kernel parity on random state
# ---------------------------------------------------------------------------


def random_step_inputs(rng, S, n, n_bins, device):
    """A valid random sweep-step state (nondecreasing cum rows, Welford sums
    consistent with the counts) and S random configs, as tensors; the time
    layer in float64."""
    import torch
    from repro_torch.core import policy_math

    counts = rng.integers(0, 3, (S, n, n_bins))
    counts[rng.uniform(size=(S, n)) < 0.2] = 0            # empty histograms
    cum = np.cumsum(counts, axis=-1).astype(np.int32)
    cv_sum = counts.sum(-1).astype(np.float32)
    cv_sum_sq = (counts.astype(np.int64) ** 2).sum(-1).astype(np.float32)
    oob = rng.integers(0, 30, (S, n)).astype(np.int32)

    bins = rng.choice([0.5, 1.0, 2.0], S)
    rows_i, rows_f = [], []
    for s in range(S):
        h, t = [(0.0, 100.0), (5.0, 99.0), (10.0, 95.0), (1.0, 99.9)][
            rng.integers(4)]
        rng_min = float(bins[s] * n_bins)
        c = policy_math.HybridStepConfig.from_host(
            n_bins=n_bins, head_pct=h, tail_pct=t,
            margin=float(rng.choice([0.0, 0.1, 0.2])),
            bin_minutes=float(bins[s]), range_minutes=rng_min,
            cv_threshold=float(rng.choice([0.5, 1.0, 2.0, 4.0])),
            min_samples=int(rng.choice([1, 5, 10])),
            oob_threshold=float(rng.choice([0.25, 0.5, 0.75])),
            standard_keep=rng_min)
        rows_i.append([c.n_bins, c.head_numer, c.tail_numer, c.min_samples])
        rows_f.append([c.margin_lo, c.margin_hi, c.bin_f32, c.range_f32,
                       c.cv_threshold, c.oob_threshold, c.standard_keep])

    prev = rng.uniform(0.0, 5000.0, (S, n))
    prev[rng.uniform(size=(S, n)) < 0.1] = -np.inf         # first events
    # one clock per app: the trace column is shared by the configs
    prev[:] = prev[0]
    gap = np.where(rng.uniform(size=n) < 0.7,
                   rng.uniform(0.0, 1.2 * bins.max() * n_bins, n),
                   rng.integers(0, n_bins, n).astype(np.float64))  # bin edges
    t_now = prev[0] + gap
    t_now[~np.isfinite(prev[0])] = rng.uniform(0.0, 5000.0)
    t_now[rng.uniform(size=n) < 0.25] = np.inf             # no event
    prewarm = np.where(rng.uniform(size=(S, n)) < 0.5, 0.0,
                       rng.uniform(0.0, 60.0, (S, n)))
    unload = prewarm + rng.uniform(0.0, 300.0, (S, n))
    cold = rng.integers(0, 64, (S, n)).astype(np.int32)
    waste = rng.uniform(0.0, 1e4, (S, n))

    as_t = lambda a, dt: torch.tensor(a, dtype=dt, device=device)
    tdt, i32 = torch.float64, torch.int32
    return [as_t(t_now, tdt), as_t(prev, tdt), as_t(cum, i32),
            as_t(oob, i32), as_t(cv_sum, tdt), as_t(cv_sum_sq, tdt),
            as_t(prewarm, tdt), as_t(unload, tdt), as_t(cold, i32),
            as_t(waste, tdt), as_t(np.asarray(rows_i, np.int32), i32),
            as_t(np.asarray(rows_f, np.float32), torch.float32)]


def kernel_parity(rng, device):
    """One kernel step vs the plain version on the same state: every output
    must be torch.equal. Returns the largest absolute difference seen."""
    import torch
    from repro_torch.kernels import histogram as H

    worst = 0.0
    for S, n, n_bins in ((4, 100_003, 240), (32, 4_099, 60)):
        args = random_step_inputs(rng, S, n, n_bins, device)
        plain_args = list(args)
        plain_args[2] = args[2].clone()
        got = H.fused_hybrid_sweep_step(*args)
        want = H.fused_hybrid_sweep_step_plain(*plain_args)
        torch.cuda.synchronize()
        names = ("prev_t", "cum", "oob", "cv_sum", "cv_sum_sq", "prewarm",
                 "unload_at", "cold", "waste")
        for name, g, w in zip(names, got, want):
            if not torch.equal(g, w):
                diff = (g.double() - w.double()).abs()
                raise AssertionError(
                    f"kernel != plain on {name} at S={S} n={n} "
                    f"n_bins={n_bins}: {int((diff > 0).sum())} elements "
                    f"differ, max {float(diff.max())}")
            worst = max(worst, float((g.double() - w.double()).abs().max()))
        emit("kernel_parity", S=S, n=n, n_bins=n_bins, outputs=len(names),
             torch_equal=True)
    return worst


def event_stream_parity(device):
    """The S=1 kernel driven event by event (5 identical apps) against the
    scalar AppHistogram / HybridHistogramPolicy path after every event."""
    import torch
    from repro_torch.core.histogram import AppHistogram, HistogramConfig
    from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
    from repro_torch.kernels import ops

    cfg = HistogramConfig()
    hyb = HybridConfig(histogram=cfg, use_arima=False)
    rng = np.random.default_rng(11)
    its = [max(round(v * 64.0) / 64.0, 0.0) for v in np.concatenate(
        [rng.uniform(0.5, 40.0, 30), [10.0, 30.0] * 10,
         rng.uniform(250.0, 500.0, 8), rng.integers(0, 240, 12)])]
    lanes, n_bins, f64 = 5, cfg.n_bins, torch.float64
    z = lambda dt: torch.zeros(lanes, dtype=dt, device=device)
    state = (torch.full((lanes,), -np.inf, dtype=f64, device=device),
             torch.zeros((lanes, n_bins), dtype=torch.int32, device=device),
             z(torch.int32), z(f64), z(f64), z(f64),
             torch.full((lanes,), hyb.standard_keep_alive, dtype=f64,
                        device=device),
             z(torch.int32), z(f64))
    policy, hist = HybridHistogramPolicy(hyb), AppHistogram(cfg)
    t = 0.0
    for k, it in enumerate(its):
        t += it
        state = ops.fused_hybrid_step(
            torch.full((lanes,), t, dtype=f64, device=device), *state,
            head_pct=cfg.head_percentile, tail_pct=cfg.tail_percentile,
            margin=cfg.margin, bin_minutes=cfg.bin_minutes,
            range_minutes=cfg.range_minutes, cv_threshold=hyb.cv_threshold,
            min_samples=hyb.min_samples,
            oob_threshold=hyb.oob_fraction_threshold,
            standard_keep=hyb.standard_keep_alive)
        w = policy.on_invocation("a", None if k == 0 else float(it))
        if k > 0:
            hist.record(float(it))
        cum = state[1].cpu().numpy()
        pre, ub = state[5].cpu().numpy(), state[6].cpu().numpy()
        counts = np.diff(np.concatenate([[0], cum[0].astype(np.int64)]))
        ok = (np.array_equal(counts, hist.counts)
              and int(state[2][0]) == hist.oob
              and float(pre[0]) == w.prewarm
              and float(ub[0]) - float(pre[0]) == w.keep_alive
              and (cum == cum[:1]).all() and (pre == pre[0]).all())
        if not ok:
            raise AssertionError(f"S=1 kernel stream != scalar path at "
                                 f"event {k} (it={it})")
    emit("event_stream_parity", events=len(its), n_bins=n_bins, equal=True)


def attention_inputs(B, S, Hq, Hkv, D, dtype, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, S, h, D, generator=g, device=device).to(dtype)
            for h in (Hq, Hkv, Hkv)]


def rglru_inputs(B, L, D, device, seed):
    """Decays in (0, 0.98) as the model's sigmoid gates give, and a normal
    gated input; both float32 as the model hands them over."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    b_in = torch.randn(B, L, D, generator=g, device=device)
    a = 0.98 * torch.sigmoid(torch.randn(B, L, D, generator=g,
                                         device=device))
    return b_in, a


def attention_tol(dtype, want):
    """(atol, rtol) for the attention kernel against its plain output
    ``want``: f32 2e-5 (IEEE f32 on both sides, the sums in another order),
    bf16 ATTN_BF16_TOL with atol scaled by the largest |want|."""
    if dtype == "float32":
        return 2e-5, 2e-5
    frac, rtol = ATTN_BF16_TOL
    return frac * float(want.abs().max()), rtol


def plain_without_keys(q, k, v, window, lo, hi):
    """The plain attention with keys [lo, hi) masked as well: what a kernel
    that left out one key tile would give."""
    import math
    import torch
    from repro_torch.kernels import flash_attention as FA
    B, S, Hq, D = q.shape
    group = Hq // k.shape[2]
    kf = k.repeat_interleave(group, dim=2).float()
    vf = v.repeat_interleave(group, dim=2).float()
    i = torch.arange(S, device=q.device)
    mask = FA._band(i[:, None], i[None, None, :], True, window)
    mask &= ~((i >= lo) & (i < hi))
    return FA._softmax_attend(q.float() / math.sqrt(D), kf, vf,
                              mask).to(q.dtype)


def attention_parity(device):
    """The attention kernel against its plain version: the serving paths'
    shapes in bf16 (RecurrentGemma: D 256, window 2,048; Qwen2: D 128,
    causal, k and v the first rows of a longer cache; OLMoE: D 128 and
    SeamlessM4T: D 64, both MHA and causal) at ATTN_BF16_TOL,
    with the largest and median |out| and what leaving out one 64-key tile
    would do (the gate must catch that); f32 cases within 2e-5; S=640,
    which the TPU kernel gets wrong; and the form each case took. Returns
    the largest absolute difference seen."""
    import torch
    from repro_torch.kernels import flash_attention as FA

    shape = lambda a: (a["B"], a["S"], a["Hq"], a["Hkv"], a["D"])
    bf16, f32 = torch.bfloat16, torch.float32
    rg, qw = ATTN_SHAPE, QWEN2_ATTN_SHAPE
    ol, sm = OLMOE_ATTN_SHAPE, SEAMLESS_ATTN_SHAPE
    # (shape, dtype, window, extra cache rows of k and v, drop-tile check)
    cases = [(shape(rg), bf16, rg["W"], 0, True),
             (shape(qw), bf16, qw["W"], SERVE_NEW, True),
             (shape(ol), bf16, ol["W"], SERVE_NEW, True),
             (shape(sm), bf16, sm["W"], SERVE_NEW, True),
             ((2, 1024, 8, 2, 128), f32, 0, 0, False),
             ((2, 1024, 8, 2, 128), f32, 256, 0, False),
             ((1, 640, 10, 1, 256), f32, 128, 0, False),
             ((2, 640, 10, 1, 256), bf16, 2048, 0, False),
             ((2, 640, 28, 4, 128), bf16, 0, SERVE_NEW, False),
             ((1, 200, 2, 2, 40), bf16, 0, 0, False)]
    worst = 0.0
    for n, (shp, dtype, window, extra, drop) in enumerate(cases):
        B, S, Hq, Hkv, D = shp
        q, kk, v = attention_inputs(B, S + extra, Hq, Hkv, D, dtype, device,
                                    seed=10 + n)
        q, kk, v = q[:, :S].contiguous(), kk[:, :S], v[:, :S]
        form = FA._form(q, kk, v)
        got = FA.flash_attention(q, kk, v, window=window)
        want = FA.flash_attention_plain(q, kk, v, window=window)
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        dname = str(dtype).replace("torch.", "")
        atol, rtol = attention_tol(dname, want)
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        fields = {}
        if drop:
            lo = S // 2
            dropped = plain_without_keys(q, kk, v, window, lo,
                                         lo + ATTN_DROPPED_TILE).float()
            moved = (dropped - want).abs()
            caught = not torch.allclose(dropped, want, atol=atol, rtol=rtol)
            if not caught:
                raise AssertionError(f"the bf16 attention gate at {shp} "
                                     f"would pass a kernel that left out "
                                     f"keys [{lo}, {lo + ATTN_DROPPED_TILE})")
            fields = dict(dropped_tile=[lo, lo + ATTN_DROPPED_TILE],
                          dropped_tile_max_abs_diff=float(moved.max()),
                          dropped_tile_rows_max_abs_diff_median=float(
                              moved.amax(dim=(0, 2, 3))[lo:].median()),
                          dropped_tile_caught=caught)
        emit("attention_parity", shape=list(shp), dtype=dname, window=window,
             kv_cache_rows=S + extra, form=form, atol=atol, rtol=rtol,
             max_abs_err=err, max_abs_out=float(want.abs().max()),
             median_abs_out=float(want.abs().median()), **fields)
    return worst


def rglru_one_chunk_short(b_in, a, want_h):
    """What a scan whose carry into the last chunk of R.CHUNK steps left out
    the chunk before it would give: the plain version restarted there from
    the state two chunks back (zero where there is none)."""
    import torch
    from repro_torch.kernels import rglru_scan as R
    L, Q = a.shape[1], R.CHUNK
    k = (L - 1) // Q
    start = want_h[:, k * Q - Q - 1] if k > 1 else torch.zeros_like(
        want_h[:, 0])
    tail, _ = R.rglru_scan_plain(b_in[:, k * Q:], a[:, k * Q:], start)
    return torch.cat([want_h[:, :k * Q], tail], dim=1)


def rglru_parity(device):
    """The scan kernel against its plain version (the doubling scan) within
    RGLRU_TOL at RGLRU_PARITY_SHAPES, h_last equal to h[:, -1], the form
    each case took, and at every shape longer than a chunk a carry one
    chunk short, which the tolerance must reject. Returns the largest
    absolute difference seen."""
    import torch
    from repro_torch.kernels import rglru_scan as R

    atol, rtol = RGLRU_TOL
    worst = 0.0
    for k, shape in enumerate(RGLRU_PARITY_SHAPES):
        b_in, a = rglru_inputs(*shape, device, seed=20 + k)
        forms = dict(R.LAUNCHES_BY_FORM)
        h, h_last = R.rglru_scan(b_in, a)
        want_h, want_last = R.rglru_scan_plain(b_in, a)
        torch.cuda.synchronize()
        form = [f for f, c in R.LAUNCHES_BY_FORM.items() if c != forms[f]]
        torch.testing.assert_close(h, want_h, atol=atol, rtol=rtol)
        torch.testing.assert_close(h_last, want_last, atol=atol, rtol=rtol)
        if not torch.equal(h_last, h[:, -1]):
            raise AssertionError("rglru_scan: h_last != h[:, -1]")
        err = float((h - want_h).abs().max())
        share = float(((h - want_h).abs() / (atol + rtol * want_h.abs()))
                      .max())
        worst = max(worst, err)
        fields = {}
        if shape[1] > R.CHUNK:
            short = rglru_one_chunk_short(b_in, a, want_h)
            if torch.allclose(short, want_h, atol=atol, rtol=rtol):
                raise AssertionError(f"the RG-LRU bound at {shape} would "
                                     f"not catch a carry one chunk short")
            fields = dict(short_carry_max_change=float(
                (short - want_h).abs().max()), short_carry_caught=True)
        emit("rglru_parity", shape=list(shape), form=form, atol=atol,
             rtol=rtol, max_abs_err=err, worst_share_of_tolerance=share,
             **fields)
    return worst


def ssd_close(got, want, tol, what: str) -> float:
    """Raise unless |got - want| <= atol * max(1, max |want|) + rtol * |want|
    elementwise (tol = (atol, rtol)); returns the largest |got - want|."""
    import torch
    got, want = got.double(), want.double()
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=tol[0] * scale, rtol=tol[1],
                               msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def ssd_within(got, want, tol) -> bool:
    """Whether |got - want| <= atol * max(1, max |want|) + rtol * |want|
    holds elementwise (ssd_close's bound, without raising)."""
    got, want = got.double(), want.double()
    atol = tol[0] * max(1.0, float(want.abs().max()))
    return bool(((got - want).abs() <= atol + tol[1] * want.abs()).all())


def ssd_recurrence_f64(x, dt, A, B, C, S0):
    """y_t = C_t . S_t with S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T, token
    by token in float64 on the card: an oracle that shares no code with
    either chunked form."""
    import torch
    x, dt, A, B, C = (t.double() for t in (x, dt, A, B, C))
    b, l, h, p = x.shape
    S = (torch.zeros((b, h, B.shape[-1], p), dtype=torch.float64,
                     device=x.device) if S0 is None else S0.double())
    y = torch.empty((b, l, h, p), dtype=torch.float64, device=x.device)
    for t in range(l):
        S = S * torch.exp(dt[:, t] * A)[..., None, None] + \
            B[:, t, None, :, None] * (dt[:, t, :, None] * x[:, t])[:, :, None]
        y[:, t] = torch.einsum("bn,bhnp->bhp", C[:, t], S)
    return y, S


def ssd_parity(device):
    """The SSD kernel against its plain version: the serving path's shape
    (x, B and C strided views, as the model hands them over) in bf16 and
    f32, and lengths that are not a multiple of the chunk (384 and 640 at
    chunk 256, where the TPU kernel leaves NaN, and 1), with and without an
    initial state; the f32 cases also against the float64 recurrence.
    Tolerances: SSD_F32_TOL, SSD_BF16_Y_TOL; each bf16 case longer than a
    chunk also checks that the bound catches a carry one chunk short.
    Returns the largest absolute difference of y from the plain version
    seen."""
    import torch
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.timing import ssd_inputs

    s = SSD_SHAPE
    path = (s["b"], s["l"], s["h"], s["p"], s["n"])
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(path, bf16, False, True), (path, f32, False, True),
             (path, bf16, True, False),
             ((1, 384, 8, 64, 128), f32, True, False),
             ((2, 384, 8, 64, 128), bf16, False, False),
             ((1, 640, 8, 64, 128), f32, False, False),
             ((2, 640, 8, 64, 128), bf16, True, False),
             ((2, 1, 80, 64, 128), f32, True, False),
             ((2, 1, 80, 64, 128), bf16, False, True)]
    if SS._lib().ssd_scan_bf16_max_state() != SS.MAX_BF16_STATE:
        raise AssertionError("ssd_scan.MAX_BF16_STATE disagrees with the "
                             "kernel's shared-memory limit")
    worst = 0.0
    for k, (shape, dtype, with_state, model_like) in enumerate(cases):
        b, l, h, p, n = shape
        x, dt, A, B, C = ssd_inputs(*shape, dtype, device, 40 + k,
                                    model_like)
        S0 = None
        if with_state:
            g = torch.Generator(device=device).manual_seed(60 + k)
            S0 = torch.randn(b, h, n, p, generator=g, device=device)
        y, fin = SS.ssd_scan(x, dt, A, B, C, chunk=s["chunk"],
                             initial_state=S0)
        want_y, want_fin = SS.ssd_scan_plain(x, dt, A, B, C, s["chunk"], S0)
        torch.cuda.synchronize()
        if y.dtype != dtype or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"ssd_scan: y {y.dtype} not finite or not "
                                 f"in {dtype} at {shape}")
        y_tol = SSD_F32_TOL if dtype == f32 else SSD_BF16_Y_TOL
        err = ssd_close(y, want_y, y_tol, f"y at {shape} {dtype}")
        state_err = ssd_close(fin, want_fin, SSD_F32_TOL,
                              f"final state at {shape} {dtype}")
        oracle = {}
        if dtype == f32:
            o_y, o_fin = ssd_recurrence_f64(x, dt, A, B, C, S0)
            oracle = dict(
                kernel_vs_f64=ssd_close(y, o_y, y_tol, "kernel vs f64"),
                plain_vs_f64=ssd_close(want_y, o_y, y_tol, "plain vs f64"),
                kernel_state_vs_f64=ssd_close(fin, o_fin, SSD_F32_TOL,
                                              "kernel state vs f64"))
        Q = s["chunk"]
        if dtype == bf16 and l > Q:
            # a carry one chunk short: the plain version with chunk k - 1
            # left out of the state entering chunk k (k the last chunk)
            k = (l - 1) // Q
            xz = x.clone()
            xz[:, (k - 1) * Q:k * Q] = 0
            y_drop, _ = SS.ssd_scan_plain(xz, dt, A, B, C, Q, S0)
            y_drop[:, :k * Q] = want_y[:, :k * Q]
            if ssd_within(y_drop, want_y, y_tol):
                raise AssertionError(f"the bf16 bound at {shape} would not "
                                     f"catch a carry one chunk short")
            oracle["dropped_chunk_max_change"] = float(
                (y_drop - want_y).abs().max())
            oracle["dropped_chunk_caught"] = True
        worst = max(worst, err)
        emit("ssd_parity", shape=list(shape), chunk=s["chunk"],
             dtype=str(dtype), initial_state=with_state,
             model_like=model_like, y_tol=list(y_tol), max_abs_err=err,
             max_abs_y=float(want_y.abs().max()),
             median_abs_y=float(want_y.abs().median()),
             state_max_abs_err=state_err,
             max_abs_state=float(want_fin.abs().max()), **oracle)
    return worst


def decode_inputs(B, Skv, Hq, Hkv, D, dtype, device, seed):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(B, s, h, D, generator=g, device=device).to(dtype)
            for s, h in ((1, Hq), (Skv, Hkv), (Skv, Hkv))]


def decode_tol(dtype, want):
    """(atol, rtol) for the decode kernel against its plain output
    ``want``: DECODE_TOL, bf16's atol scaled by the largest |want|."""
    atol, rtol = DECODE_TOL[dtype]
    if dtype == "bfloat16":
        atol *= float(want.abs().max())
    return atol, rtol


def decode_parity(device):
    """The decode kernel against its plain version: the reference's cases
    (B 2, Hq 4, Hkv 2, D 64), the serving paths' shapes (Qwen2-7B,
    OLMoE-1B-7B and SeamlessM4T-medium) at kv_len 4,097, 4,112 and 1, and
    a ragged cache (Skv 640, kv_len 600, which the TPU
    kernel gets wrong); f32 and bf16 at DECODE_TOL, each case's largest and
    median |out| printed beside its error; in every case the launch with
    kv_len on the device (the serve engine's form) equal to the host-int
    launch bit for bit. Returns the largest absolute difference seen."""
    import torch
    from repro_torch.kernels import decode_attention as DA

    cases = [((2, Skv, 4, 2, 64), n) for Skv, n in
             ((256, 256), (512, 300), (512, 1), (1024, 777))]
    for d in (DECODE_SHAPE, OLMOE_DECODE_SHAPE, SEAMLESS_DECODE_SHAPE):
        serving = (d["B"], d["Skv"], d["Hq"], d["Hkv"], d["D"])
        cases += [(serving, n) for n in (4097, 4112, 1)]
    cases += [((1, 640, 8, 2, 64), 600)]
    worst = 0.0
    for k, (shape, kv_len) in enumerate(cases):
        for dtype in ("float32", "bfloat16"):
            q, kc, vc = decode_inputs(*shape, getattr(torch, dtype), device,
                                      seed=70 + k)
            got = DA.decode_attention(q, kc, vc, kv_len)
            on_device = DA.decode_attention(
                q, kc, vc, torch.full((), kv_len, dtype=torch.int64,
                                      device=device))
            want = DA.decode_attention_plain(q, kc, vc, kv_len)
            torch.cuda.synchronize()
            if not torch.equal(on_device, got):
                raise AssertionError(
                    f"decode kernel with kv_len {kv_len} on the device "
                    f"differs from the host-int launch at {shape}, {dtype}")
            got, want = got.float(), want.float()
            atol, rtol = decode_tol(dtype, want)
            torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            emit("decode_parity", shape=list(shape), kv_len=kv_len,
                 dtype=dtype, atol=atol, rtol=rtol, max_abs_err=err,
                 max_abs_out=float(want.abs().max()),
                 median_abs_out=float(want.abs().median()))
    return worst


def policy_columns(trace, device):
    """Per event column of ``trace``: the tick's (bins, active) int32 [n],
    the idle time since the app's previous event binned by the port's
    ``classify_idle_time`` into POLICY_BINS one-minute bins (``n_bins`` =
    out of bounds); an app is active where it has an event in the column
    and one before it."""
    import torch
    from repro_torch.core import policy_math

    times, counts = trace.to_padded()
    width = int(counts.max())
    cols = torch.from_numpy(np.ascontiguousarray(
        times[:, :width].T.astype(np.float64))).to(device)
    prev = torch.full_like(cols[0], -np.inf)
    out = []
    for t in cols:
        rec = torch.isfinite(t) & torch.isfinite(prev)
        it = torch.where(rec, t - prev, 0.0)
        safe, in_b, oob_hit = policy_math.classify_idle_time(
            it, rec, 1.0, POLICY_BINS)
        bins = torch.where(oob_hit, POLICY_BINS, torch.where(in_b, safe, -1))
        out.append((bins.to(torch.int32), rec.to(torch.int32)))
        prev = torch.where(torch.isfinite(t), t, prev)
    return out, times, counts


def fresh_policy_state(n, device):
    import torch
    z = lambda dt: torch.zeros(n, dtype=dt, device=device)
    return (torch.zeros((n, POLICY_BINS), dtype=torch.int32, device=device),
            z(torch.int32), z(torch.int32), z(torch.float32),
            z(torch.float32))


def wide_policy_state(n, n_bins, device, seed):
    """A seeded fleet of ``n`` apps x ``n_bins`` for one tick: random counts
    (0-4 a bin, a fifth of the rows empty), totals and Welford sums that
    agree with them, this tick's bins in [-3, n_bins + 8) and half the rows
    active; then its first three rows at the int32 edge of the scaled
    compares, active on a bin in range: 300,000 samples in the last bin
    (cum * PCT_SCALE wraps negative there), MAX_SCALED_COUNT samples (one
    more this tick), and 2 x MAX_SCALED_COUNT spread over the row (the
    scaled sums wrap part way along it). Tensors in the tick's argument
    order."""
    import torch
    from repro_torch.core import policy_math
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 5, (n, n_bins)).astype(np.int32)
    counts[rng.uniform(size=n) < 0.2] = 0
    bins = rng.integers(-3, n_bins + 8, n).astype(np.int32)
    active = rng.integers(0, 2, n).astype(np.int32)
    edge = policy_math.MAX_SCALED_COUNT
    counts[:3] = 0
    counts[0, -1] = 300_000
    counts[1, 0], counts[1, -1] = edge // 2, edge - edge // 2
    counts[2] = 2 * edge // n_bins
    counts[2, -1] += 2 * edge - int(counts[2].sum())
    bins[:3], active[:3] = (n_bins - 1, 0, n_bins // 2), 1
    total = counts.sum(1, dtype=np.int64)
    arrays = (counts, rng.integers(0, 3, n).astype(np.int32),
              total.astype(np.int32), total.astype(np.float32),
              (counts.astype(np.int64) ** 2).sum(1).astype(np.float32),
              bins, active)
    return [torch.from_numpy(x).to(device) for x in arrays]


def policy_update_parity(trace, device):
    """The fleet's policy-update tick over the scale trace, one tick per
    event column, through ``kernels.ops.policy_update`` (the CUDA kernel;
    its launch count is set to 0 just before the run and read just after).
    Beside it the plain version runs on its own copy of the state: all
    eight outputs must be torch.equal at every tick. At the end the
    histogram, the gate and both windows of POLICY_SAMPLE sampled apps must
    equal the scalar AppHistogram's fed the same idle times. Returns the
    launches, the largest absolute difference seen (0.0) and the tick
    columns."""
    import torch
    from repro_torch.core import policy_math
    from repro_torch.core.histogram import AppHistogram, HistogramConfig
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    columns, times, counts = policy_columns(trace, device)
    prep_s = time.perf_counter() - t0
    n = counts.shape[0]
    state, plain_state = fresh_policy_state(n, device), \
        fresh_policy_state(n, device)
    names = ("counts", "oob", "total", "cv_sum", "cv_sum_sq", "prewarm",
             "keep_alive", "use_hist")
    H.POLICY_UPDATE_LAUNCHES = 0          # count the main path's launches
    active_rows, worst = 0, 0.0
    for c, (bins, active) in enumerate(columns):
        got = ops.policy_update(*state, bins, active)
        want = H.policy_update_plain(*plain_state, bins, active)
        for name, g, w in zip(names, got, want):
            worst = max(worst, float((g.double() - w.double()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(
                    f"policy_update kernel != plain on {name} at tick {c}: "
                    f"{int((g != w).sum())} elements differ")
        state, plain_state = got[:5], want[:5]
        active_rows += int(active.sum())
    launches = H.POLICY_UPDATE_LAUNCHES
    if launches != len(columns):
        raise AssertionError(f"{launches} policy_update launches for "
                             f"{len(columns)} ticks")

    cfg = HistogramConfig(range_minutes=float(POLICY_BINS))
    rng = np.random.default_rng(6)
    sample = np.sort(rng.choice(n, POLICY_SAMPLE, replace=False))
    host = [x.cpu().numpy() for x in got]
    n_hist = 0
    for a in sample:
        h = AppHistogram(cfg)
        ts = times[a, :counts[a]].astype(np.float64)
        for it in np.diff(ts):
            h.record(float(it))
        gate = policy_math.use_histogram_gate(
            h.total, h.oob, h._cv_sum, h._cv_sum_sq, POLICY_BINS, 5, 2.0,
            0.5)
        pw, ka = h.windows() if gate else (0.0, cfg.range_minutes)
        n_hist += gate
        ok = (np.array_equal(host[0][a], h.counts) and host[1][a] == h.oob
              and host[2][a] == h.total and host[7][a] == int(gate)
              and host[5][a] == np.float32(pw)
              and host[6][a] == np.float32(ka))
        if not ok:
            raise AssertionError(f"policy_update != AppHistogram at app {a}")

    # one more tick past the kernel's 256-bin tile, with rows at the int32
    # edge (a comparison launch: not counted)
    wn, wb = POLICY_WIDE["n"], POLICY_WIDE["n_bins"]
    with uncounted(H):
        got = H.policy_update(*wide_policy_state(wn, wb, device, seed=7),
                              range_minutes=float(wb))
        want = H.policy_update_plain(*wide_policy_state(wn, wb, device,
                                                        seed=7),
                                     range_minutes=float(wb))
        torch.cuda.synchronize()
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"policy_update kernel != plain on {name} at {wb} bins: "
                f"{int((g != w).sum())} elements differ")
    if int(got[2][1]) != policy_math.MAX_SCALED_COUNT + 1:
        raise AssertionError("the wide tick's edge row is not past "
                             "MAX_SCALED_COUNT")
    emit("policy_update_parity", n_apps=n, n_bins=POLICY_BINS,
         ticks=len(columns), active_app_ticks=active_rows,
         column_prep_seconds=prep_s, outputs=len(names), torch_equal=True,
         launches=launches, sampled_apps=len(sample),
         sampled_using_histogram=int(n_hist),
         equal_to_app_histogram=True,
         wide_tick=dict(n_apps=wn, n_bins=wb, form=H._policy_form(
             wb, got[0].data_ptr()), rows_past_max_scaled_count=3,
             torch_equal=True))
    return launches, worst, columns


# ---------------------------------------------------------------------------
# Serving: full-width models behind the warm pool
# ---------------------------------------------------------------------------


def serve(device, phase, arch, prefix, kernels, logits_rel_tol,
          decode_steps=0, init="reference"):
    """Two full-width endpoints of ``arch`` (seeds 0 and 1, drawn as
    ``init`` says, ``use_kernels``, bf16) behind a
    WarmPool(HybridSpec(use_arima=False)), driven by SERVE_STREAM; the pool's residency decisions are mirrored onto the
    engine after every pool call. ``kernels`` maps each kernel module of
    the path to the launches one request must make; the counts are set to
    0 just before the stream and read just after. The kernel path's
    last-token prefill logits are held to the plain branches' in bf16
    (``logits_rel_tol``) and, on f32 copies of the same weights, in f32
    (SERVE_F32_DIST_FACTOR); with ``decode_steps``, so are the logits of
    that many teacher-forced decode steps from the kernel path's prefill
    state (each path on its own copy of it). Before the f32 check the
    endpoint not under check is unloaded (the stream is over). Every
    launch of a kernel module with forms must take the form SERVE_FORMS
    names. The encoder-decoder's requests get the engine's frontend stub
    (zero frames); its checks and profile get seeded frames
    (``frontend.audio_frames``), so that the cross-attention reads a
    memory that is not zero. For the MoE family the phase also prints each
    layer's routing agreement between the kernel and plain paths, the
    choices dropped by capacity, and the prefill seconds of the gather
    dispatch beside the einsum one. ``generate`` decodes by replaying the
    executable cache's graph; the launches counted through the replays
    must be each request's, the requests after each load report their
    ``capture_s``, and :func:`decode_graph` (phase ``decode_graph``) holds
    the graph to eager decode bit for bit after the stream; its gates join
    the logits gates. Returns the stream's launches by
    kernel name, its launches by form, the number of requests and the
    gates that failed (the phase line lists them too; the caller
    fails the run once the later phases have run)."""
    import contextlib
    import torch
    from repro_torch.configs import get
    from repro_torch.core.experiment import HybridSpec
    from repro_torch.models import build, frontend
    from repro_torch.serving import (ModelEndpoint, Registry, ServeEngine,
                                     WarmPool)

    cfg = get(arch).with_(use_kernels=True)
    reg = Registry()
    for i in range(2):
        reg.register(ModelEndpoint(f"{prefix}-{i}", cfg, seed=i, init=init))
    engine = ServeEngine(reg, device=device)
    pool = WarmPool(reg, HybridSpec(use_arima=False))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_SEQ))).to(device)
    loads = []                            # (app, seconds, first)

    def mirror():
        for ep in reg:
            st = pool.state.get(ep.app_id)
            resident = st is not None and st.loaded
            if resident and not engine.is_loaded(ep.app_id):
                first = ep.app_id not in engine._weights
                loads.append((ep.app_id, engine.load(ep.app_id), first))
            elif not resident and engine.is_loaded(ep.app_id):
                engine.unload(ep.app_id)

    def counts():
        return {name: mod.LAUNCHES for name, (mod, _) in kernels.items()}

    torch.cuda.reset_peak_memory_stats()
    for mod, _ in kernels.values():
        mod.LAUNCHES = 0                  # count the serving path's launches
        for form in getattr(mod, "LAUNCHES_BY_FORM", {}):
            mod.LAUNCHES_BY_FORM[form] = 0
    want = {name: n for name, (_, n) in kernels.items()}
    requests = []
    for minute, i in SERVE_STREAM:
        app, now = f"{prefix}-{i}", minute * 60.0
        n_loads = len(loads)
        pool.tick(now)                    # expiries and pre-warms first
        mirror()
        cold, _ = pool.on_request(app, now)
        mirror()
        load_s = sum(s for a, s, _ in loads[n_loads:] if a == app)
        before = counts()
        out, gen_s = engine.generate(app, tokens, max_new=SERVE_NEW,
                                     max_len=SERVE_SEQ + SERVE_NEW)
        made = {k: v - before[k] for k, v in counts().items()}
        if made != want:
            raise AssertionError(f"a prefill launched {made}, not {want}")
        if tuple(out.shape) != (SERVE_BATCH, SERVE_NEW) or \
                not bool(((out >= 0) & (out < cfg.vocab)).all()):
            raise AssertionError(f"bad tokens {tuple(out.shape)}")
        pool.on_request_end(app, now)
        mirror()
        requests.append(dict(minute=minute, app=app, cold=cold,
                             load_s=load_s, generate_s=gen_s,
                             latency_s=load_s + gen_s, **engine.last_times,
                             launches=made))
        emit(f"{phase}_request", **requests[-1])
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0:
        raise AssertionError(f"the serving path launched {launches}")
    by_form = {name: dict(mod.LAUNCHES_BY_FORM)
               for name, (mod, _) in kernels.items()
               if hasattr(mod, "LAUNCHES_BY_FORM")}
    for name, forms in by_form.items():
        if forms.get(SERVE_FORMS[name]) != launches[name]:
            raise AssertionError(f"{name}: {forms} by form, not all "
                                 f"{launches[name]} in the "
                                 f"{SERVE_FORMS[name]} form")
    st = pool.stats
    if len(loads) != st.cold_starts + st.prewarms:
        raise AssertionError(f"{len(loads)} engine loads for "
                             f"{st.cold_starts} cold starts and "
                             f"{st.prewarms} pre-warms")
    colds = [q for q in requests if q["cold"]]
    warms = [q for q in requests if not q["cold"]]
    if not colds or not warms:
        raise AssertionError("the stream needs a cold and a warm request")
    captures = [q["capture_s"] for q in requests if q["capture_s"] > 0]
    if not captures:
        raise AssertionError("no request of the stream captured its decode "
                             "step")
    graph = decode_graph(engine, f"{prefix}-{SERVE_STREAM[-1][1]}", cfg,
                         tokens, phase)

    # the same prompt through the plain branches, on the same weights
    app = f"{prefix}-{SERVE_STREAM[-1][1]}"
    params = engine._loaded[app]
    max_len = SERVE_SEQ + SERVE_NEW
    kmodel, pmodel = build(cfg), build(cfg.with_(use_kernels=False))
    frames = None
    if cfg.family == "encdec":
        frames = frontend.audio_frames(
            cfg, SERVE_BATCH, torch.Generator(device).manual_seed(3),
            device=device)
    moe_family = cfg.family == "moe"
    rng = np.random.default_rng(1)
    dec_tokens = [torch.from_numpy(rng.integers(0, cfg.vocab, SERVE_BATCH)
                                   ).to(device) for _ in range(decode_steps)]

    def decode_logits(model, weights, state):
        """Logits of ``decode_steps`` teacher-forced steps from ``state``
        (a copy of the kernel path's prefill cache)."""
        out = []
        for tok in dec_tokens:
            lg, state = model.decode_step(weights, tok, state)
            out.append(lg.float())
        return torch.stack(out) if out else None

    def copied(state, dtype=None):
        out = {"k": [t.to(dtype or t.dtype, copy=True) for t in state["k"]],
               "v": [t.to(dtype or t.dtype, copy=True) for t in state["v"]],
               "pos": state["pos"]}
        if "enc" in state:                # the encoder-decoder's memory
            out["enc"] = state["enc"].to(dtype or state["enc"].dtype,
                                         copy=True)
        return out

    routes = lambda: recorded_routes() if moe_family \
        else contextlib.nullcontext()
    with torch.inference_mode():
        with routes() as k_routes:
            got, state = kmodel.prefill(params, tokens, max_len,
                                        embeds=frames)
        with routes() as p_routes:
            plain, _ = pmodel.prefill(params, tokens, max_len,
                                      embeds=frames)
        if decode_steps:
            torch.cuda.synchronize()
            t_dec = time.perf_counter()
            with routes() as k_dec_routes:
                dec_got = decode_logits(kmodel, params, copied(state))
            torch.cuda.synchronize()
            teacher_forced_ms = 1e3 * (time.perf_counter() - t_dec) \
                / decode_steps
            with routes() as p_dec_routes:
                dec_plain = decode_logits(pmodel, params, copied(state))
    # every gate is evaluated and the phase line printed before the
    # failures go back to the caller, so that a failing run still reports
    # what it measured
    failures = list(graph.pop("failures"))
    got, plain = got.float(), plain.float()
    diff = float((got - plain).abs().max())
    scale = float(plain.abs().max())
    if not (torch.isfinite(got).all() and diff <= logits_rel_tol * scale):
        failures.append(f"kernel-path logits differ from the plain "
                        f"branches by {diff} (largest logit {scale})")
    same_argmax = float((got.argmax(-1) == plain.argmax(-1)).float().mean())
    moe_fields = moe_report(cfg, params, tokens, max_len, k_routes, p_routes,
                            got) if moe_family else {}
    decode_fields = {}
    if decode_steps:
        dec_diff = float((dec_got - dec_plain).abs().max())
        dec_scale = float(dec_plain.abs().max())
        if not (torch.isfinite(dec_got).all()
                and dec_diff <= logits_rel_tol * dec_scale):
            failures.append(f"kernel-path decode logits differ from the "
                            f"plain branches' by {dec_diff} (largest logit "
                            f"{dec_scale})")
        decode_fields = dict(
            decode_steps_checked=decode_steps,
            eager_teacher_forced_decode_ms_per_step=teacher_forced_ms,
            decode_logits_max_abs_diff_vs_plain=dec_diff,
            decode_logits_max_abs=dec_scale,
            decode_logits_max_abs_diff_by_step=[
                float((a - b).abs().max()) for a, b in zip(dec_got,
                                                           dec_plain)],
            decode_argmax_agreement_vs_plain=float(
                (dec_got.argmax(-1) == dec_plain.argmax(-1)).float().mean()))
        if moe_family:
            decode_fields.update(decode_routing_flips(
                cfg, k_dec_routes, p_dec_routes, decode_steps))
    # the plain branches in f32, on f32 copies of the same weights; the
    # other endpoint is unloaded first (the stream is over)
    for ep in reg:
        if ep.app_id != app:
            engine.unload(ep.app_id)
    torch.cuda.empty_cache()
    # drawn again as the engine's first load draws them: its host store
    # holds them in bf16
    ep = reg.get(app)
    params32 = engine._model(cfg).init(ep.seed, device=device,
                                       scheme=ep.init)
    model32 = build(cfg.with_(use_kernels=False, dtype="float32"))
    with torch.inference_mode():
        ref32, _ = model32.prefill(params32, tokens, max_len,
                                   embeds=frames)
        if decode_steps:
            with routes() as f_dec_routes:
                dec32 = decode_logits(model32, params32,
                                      copied(state, torch.float32))
    del params32, state
    ref32 = ref32.float()
    vs_f32 = {"kernel_bf16": float((got - ref32).abs().max()),
              "plain_bf16": float((plain - ref32).abs().max())}
    if decode_steps:
        vs_f32.update(
            decode_kernel_bf16=float((dec_got - dec32).abs().max()),
            decode_plain_bf16=float((dec_plain - dec32).abs().max()))
        if moe_family:
            # routings of the decode steps that differ from the f32 run's
            for name, rts in (("kernel", k_dec_routes),
                              ("plain", p_dec_routes)):
                decode_fields[f"decode_routing_flips_{name}_vs_f32"] = sum(
                    int((a[0] != b[0]).sum())
                    for a, b in zip(rts.calls, f_dec_routes.calls))
    for which in ["", "decode_"] if decode_steps else [""]:
        k_d, p_d = vs_f32[which + "kernel_bf16"], vs_f32[which + "plain_bf16"]
        if not k_d <= SERVE_F32_DIST_FACTOR * p_d:
            failures.append(
                f"kernel-path {which}logits lie {k_d} from the f32 plain "
                f"branches', more than {SERVE_F32_DIST_FACTOR} x the plain "
                f"bf16 branches' {p_d}")

    warm_prefill = [q["prefill_s"] for q in warms]
    warm_decode = [q["decode_s"] for q in warms]
    profile = serve_profile(kmodel, params, tokens, max_len, embeds=frames)
    emit(phase, arch=cfg.arch_id, n_params=build(cfg).n_params(),
         init=init, dtype=cfg.dtype, batch=SERVE_BATCH, prompt=SERVE_SEQ,
         max_new=SERVE_NEW, requests=len(requests),
         cold=len(colds), warm=len(warms),
         pool_cold_starts=st.cold_starts, pool_warm_starts=st.warm_starts,
         pool_prewarms=st.prewarms, engine_loads=len(loads),
         first_load_s=[s for _, s, first in loads if first],
         reload_s=[s for _, s, first in loads if not first],
         cold_latency_s=[q["latency_s"] for q in colds],
         warm_latency_s=[q["latency_s"] for q in warms],
         prefill_tokens_per_s=[SERVE_BATCH * SERVE_SEQ / s
                               for s in warm_prefill],
         decode_ms_per_step=[1e3 * s / (SERVE_NEW - 1) for s in warm_decode],
         decode_timed_by="graph replays of the executable cache's entry "
                         "(warm requests)",
         capture_s=captures,
         eager_decode_ms_per_step=graph["eager_ms_per_step"],
         graph_decode_ms_per_step=graph["graph_ms_per_step"],
         peak_device_bytes=peak, launches=launches,
         launches_by_form=by_form, logits_max_abs_diff_vs_plain=diff,
         logits_max_abs=scale,
         logits_rel_tol=logits_rel_tol,
         argmax_agreement_vs_plain=same_argmax, **decode_fields,
         **moe_fields,
         logits_max_abs_diff_vs_plain_f32=vs_f32,
         f32_dist_factor=SERVE_F32_DIST_FACTOR, profile=profile,
         gates_failed=failures)
    return launches, by_form, len(requests), [f"{phase}: {f}"
                                              for f in failures]


def decode_graph(engine, app, cfg, tokens, phase):
    """Phase ``decode_graph`` of a serving phase, on its last request's
    app and prompt at full width: from one prefill each, SERVE_NEW - 1
    greedy steps of the eager ``model.decode_step`` and of the executable
    cache's entry (``ServeEngine._executables``: its graph, captured by
    the stream), timed in turn in this process. Gates (in the returned
    ``failures``): the graph's tokens and every step's logits equal the
    eager ones bit for bit, and the graph's launches by kernel and form
    per step equal the eager step's. Also: the entry's capture seconds,
    the ms a step of each, the device ms a step of the graph
    (torch.profiler over its replays), the ms of copying a prefill's
    state into the entry's (what each request's prefill does) and the
    state's bytes. The launches here are not the serving path's: the
    counters are put back after."""
    import torch
    from repro_torch.serving.engine import _COUNTED, _copy_into, _tree

    mods = _COUNTED                       # the model kernels' modules
    model, params = engine._model(cfg), engine._loaded[app]
    max_len = SERVE_SEQ + SERVE_NEW
    steps = SERVE_NEW - 1
    entry = engine._executables(app, max_len, SERVE_BATCH)
    embeds = engine._frontend(cfg, tokens)

    def counts():
        return {m.__name__.rsplit(".", 1)[-1]: dict(
            getattr(m, "LAUNCHES_BY_FORM", {}), all=m.LAUNCHES)
            for m in mods}

    def per_step(after, before):
        return {k: {f: (n - before[k][f]) / steps for f, n in v.items()
                    if n != before[k][f]}
                for k, v in after.items() if v["all"] != before[k]["all"]}

    with contextlib.ExitStack() as stack:
        for m in mods:
            stack.enter_context(uncounted(m))
        with torch.inference_mode():
            logits, state = model.prefill(params, tokens, max_len,
                                          embeds=embeds)
            tok = torch.argmax(logits, dim=-1)[:, 0]
            eager_tok, eager_lg = [tok], []
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            for _ in range(steps):
                lg, state = model.decode_step(params, tok, state)
                tok = torch.argmax(lg, dim=-1)
                eager_tok.append(tok)
                eager_lg.append(lg)
            torch.cuda.synchronize()
            eager_s, eager_launches = time.perf_counter() - t0, \
                per_step(counts(), c0)
            graph_tok = [entry.prefill(tokens, embeds)]
            graph_lg = []
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            for _ in range(steps):
                graph_tok.append(entry.decode())
                graph_lg.append(entry.logits.clone())
            torch.cuda.synchronize()
            graph_s, graph_launches = time.perf_counter() - t0, \
                per_step(counts(), c0)
            # the copy each request's prefill makes into the entry's state
            # (of a fresh prefill: the profiled replays start at its pos)
            del state
            _, state = model.prefill(params, tokens, max_len, embeds=embeds)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            _tree(_copy_into, entry.state, state)
            b.record()
            b.synchronize()
            copy_ms = a.elapsed_time(b)
            nbytes = []
            _tree(lambda t: nbytes.append(t.numel() * t.element_size()),
                  entry.state)
            state_bytes = sum(nbytes)
            del state
            prof = 4                      # < SERVE_NEW: inside the cache
            dev = device_ms(lambda: [entry.decode() for _ in range(prof)])
    failures = []
    same_tokens = torch.equal(torch.stack(eager_tok, 1),
                              torch.stack(graph_tok, 1))
    same_logits = [torch.equal(x, y) for x, y in zip(eager_lg, graph_lg)]
    if not (same_tokens and all(same_logits)):
        failures.append(f"decode_graph: the graph's tokens (equal: "
                        f"{same_tokens}) or logits (equal by step: "
                        f"{same_logits}) differ from eager decode")
    if graph_launches != eager_launches:
        failures.append(f"decode_graph: {graph_launches} launches a graph "
                        f"step, {eager_launches} an eager one")
    graph_ms = 1e3 * graph_s / steps
    dev_step = None if dev is None else {k: v / prof for k, v in dev.items()}
    out = dict(serve_phase=phase, arch=cfg.arch_id, family=cfg.family,
               steps=steps, tokens_equal=same_tokens,
               logits_equal_by_step=same_logits,
               capture_s=entry.capture_s,
               eager_ms_per_step=1e3 * eager_s / steps,
               graph_ms_per_step=graph_ms,
               eager_launches_per_step=eager_launches,
               graph_launches_per_step=graph_launches,
               graph_device_ms_per_step=dev_step,
               state_copy_ms=copy_ms, state_bytes=state_bytes,
               gates_failed=failures)
    emit("decode_graph", **out)
    out["failures"] = failures
    return out


class recorded_routes:
    """Within the block, each call of ``repro_torch.models.moe._route``
    (one a layer) leaves its ``(topi, keep, positions)`` in ``calls``."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.calls = moe, moe._route, []

        def route(*args, **kw):
            out = self.orig(*args, **kw)
            self.calls.append((out[0], out[3], out[2]))
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.orig


def decode_routing_flips(cfg, k_routes, p_routes, steps):
    """Routing of the teacher-forced decode steps, kernel path against
    plain branches: per step and layer, the (token, choice) routings whose
    expert differs, and those whose kept/dropped verdict differs (a
    decode step routes its 2 tokens in a group of its own, capacity 1)."""
    L = cfg.n_layers
    if len(k_routes.calls) != steps * L or len(p_routes.calls) != steps * L:
        raise AssertionError(f"recorded {len(k_routes.calls)} and "
                             f"{len(p_routes.calls)} decode routings for "
                             f"{steps} steps of {L} layers")
    pairs = list(zip(k_routes.calls, p_routes.calls))
    flips = [[int((k[0] != p[0]).sum()) for k, p in pairs[i * L:(i + 1) * L]]
             for i in range(steps)]
    keep = [[int((k[1] != p[1]).sum()) for k, p in pairs[i * L:(i + 1) * L]]
            for i in range(steps)]
    return dict(decode_routing_choices_per_layer=int(
                    k_routes.calls[0][0].numel()),
                decode_routing_flips_by_step_and_layer=flips,
                decode_routing_keep_changes_by_step_and_layer=keep)


def moe_report(cfg, params, tokens, max_len, k_routes, p_routes, got):
    """What the MoE prefill's routing did: per layer, the share of (token,
    choice) routings equal between the kernel path (``k_routes``) and the
    plain branches (``p_routes``), and the choices and tokens the kernel
    path dropped by capacity; then the kernel path's prefill seconds with
    the gather dispatch beside the einsum one on the same weights (in
    turns: gather, einsum, einsum, gather), and how far the gather's
    last-token logits lie from ``got``, the einsum's."""
    import torch
    from repro_torch.models import build

    layers = len(k_routes.calls)
    if layers != cfg.n_layers or len(p_routes.calls) != layers:
        raise AssertionError(f"recorded {layers} and "
                             f"{len(p_routes.calls)} routings for "
                             f"{cfg.n_layers} layers")
    agree = [float((k[0] == p[0]).float().mean())
             for k, p in zip(k_routes.calls, p_routes.calls)]
    dropped = [int((~k[1]).sum()) for k in k_routes.calls]
    dropped_tokens = [int((~k[1]).any(-1).sum()) for k in k_routes.calls]
    models = {impl: build(cfg.with_(moe_impl=impl))
              for impl in ("einsum", "gather")}
    seconds = {"einsum": [], "gather": []}
    with torch.inference_mode():
        for impl in ("gather", "einsum", "einsum", "gather"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = models[impl].prefill(params, tokens, max_len)
            torch.cuda.synchronize()
            seconds[impl].append(time.perf_counter() - t0)
            if impl == "gather":
                gather_logits = logits.float()
    return dict(
        routing_choices_per_layer=int(k_routes.calls[0][0].numel()),
        routing_agreement_per_layer=agree,
        routing_dropped_choices_per_layer=dropped,
        routing_tokens_with_a_dropped_choice_per_layer=dropped_tokens,
        prefill_seconds_by_moe_impl=seconds,
        gather_logits_max_abs_diff_vs_einsum=float(
            (gather_logits - got).abs().max()))


def _kernel_class(name: str) -> str:
    if "decode_attention" in name:
        return "decode_kernel"
    if any(f in name for f in ("ssd_cb", "ssd_state", "ssd_carry",
                               "ssd_out")):
        return "ssd_kernel"
    if "flash_attention" in name:
        return "attention_kernel"
    if "rglru_scan" in name:
        return "scan_kernel"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "nvjet")):
        return "matmul"
    return "other"


def device_ms(run, counts=None, names=None):
    """Device ms by kernel class of ``run()`` (torch.profiler), or None
    where the profiler records no device events; with a dict ``counts``,
    the kernel launches by class go there too, and with a dict ``names``
    the device ms by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_class = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        k = _kernel_class(e.key)
        by_class[k] = by_class.get(k, 0.0) + us / 1e3
        if counts is not None:
            counts[k] = counts.get(k, 0) + e.count
        if names is not None:
            names[e.key] = names.get(e.key, 0.0) + us / 1e3
    return by_class or None


def serve_profile(model, params, tokens, max_len, *, embeds=None):
    """Device time by kernel class (torch.profiler) of one prefill and of
    four decode steps; null where the profiler records no device
    events."""
    import torch

    steps = 4
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens, max_len, embeds=embeds)
        tok = logits.argmax(-1)[:, 0]
        torch.cuda.synchronize()
        pre = device_ms(lambda: model.prefill(params, tokens, max_len,
                                              embeds=embeds))
        state = {"cache": cache, "tok": tok}

        def decode():
            for _ in range(steps):
                lg, state["cache"] = model.decode_step(params, state["tok"],
                                                       state["cache"])
                state["tok"] = lg.argmax(-1)
        dec = device_ms(decode)
    out = {"prefill_device_ms": pre, "decode_step_device_ms": None}
    if dec:
        out["decode_step_device_ms"] = {k: v / steps for k, v in dec.items()}
    return out


# ---------------------------------------------------------------------------
# The main path at full size
# ---------------------------------------------------------------------------


def app_steps(counts: np.ndarray) -> int:
    """Apps x scan columns summed over the event-count buckets."""
    from repro_torch.core.simulator import _buckets
    times = np.zeros((len(counts), 1), np.float32)
    return int(sum(len(sel) * int(counts[sel].max())
                   for sel, _ in _buckets(times, counts)))


def assert_rows_equal(a, b, what: str) -> None:
    """Every output equal, waste included: every engine keeps float64
    time."""
    for field in ("cold", "invocations", "final_prewarm",
                  "final_keep_alive", "wasted_minutes"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            bad = int((getattr(a, field) != getattr(b, field)).sum())
            raise AssertionError(f"{what}: {field} differs in {bad} apps")


def scale_point(device):
    import torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.policy import HybridConfig, HybridHistogramPolicy
    from repro_torch.core.simulator import simulate_scalar
    from repro_torch.core.workload_spec import WorkloadSpec
    from repro_torch.kernels import histogram as H

    t0 = time.perf_counter()
    trace = WorkloadSpec.uniform(SCALE_APPS, days=14.0, seed=1,
                                 max_events=64, min_events=1).materialize()
    gen_s = time.perf_counter() - t0
    times, counts = trace.to_padded()
    spec = HybridSpec(use_arima=False)
    opts = EngineOptions(app_chunk=SCALE_APPS, device=device)

    from repro_torch.core.simulator import _chunked_buckets
    # one scan launch per (chunk, band): one band (240 bins), and a chunk
    # per event-count bucket of the trace
    chunks = sum(1 for _ in _chunked_buckets(times, counts, SCALE_APPS))
    form = H.scan_form(spec.to_config().histogram.n_bins)[0]
    torch.cuda.reset_peak_memory_stats()
    H.LAUNCHES = H.SCAN_LAUNCHES = 0     # count the main path's launches
    for k in H.SCAN_LAUNCHES_BY_FORM:
        H.SCAN_LAUNCHES_BY_FORM[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(trace, spec, engine="kernel", options=opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_form = H.SCAN_LAUNCHES, dict(H.SCAN_LAUNCHES_BY_FORM)
    step_launches = H.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != chunks or by_form[form] != chunks or step_launches:
        raise AssertionError(
            f"the kernel engine made {launches} scan launches {by_form} and "
            f"{step_launches} step launches; expected {chunks} {form} scan "
            f"launches (one per chunk) and no step launch")

    t0 = time.perf_counter()
    fused = run(trace, spec, engine="fused", options=opts)
    fused_s = time.perf_counter() - t0
    assert_rows_equal(got, fused, "kernel vs fused (1M apps)")

    rng = np.random.default_rng(5)
    sample = np.sort(rng.choice(SCALE_APPS, 1000, replace=False))
    oracle = simulate_scalar(trace, HybridHistogramPolicy(
        HybridConfig(use_arima=False)), app_indices=sample)
    for field in ("cold", "final_prewarm", "final_keep_alive"):
        if not np.array_equal(getattr(got, field)[sample],
                              getattr(oracle, field)[sample]):
            raise AssertionError(f"kernel vs scalar oracle: {field}")
    # host share: the engine's per-chunk preparation of the one chunk
    # (bucket slice, contiguous copy, pinned staging buffer)
    t0 = time.perf_counter()
    for _, sub in _chunked_buckets(times, counts, SCALE_APPS):
        torch.from_numpy(np.ascontiguousarray(sub)).pin_memory()
    prep_s = time.perf_counter() - t0
    steps = app_steps(counts)
    emit("scale_point", n_apps=SCALE_APPS, days=14.0, width=times.shape[1],
         app_steps=steps, invocations=int(counts.sum()),
         trace_gen_seconds=gen_s, seconds=seconds, host_prep_seconds=prep_s,
         app_steps_per_s=steps / seconds, scan_launches=launches,
         scan_launches_by_form=by_form, step_launches=step_launches,
         peak_device_bytes=peak, fused_seconds=fused_s,
         cold_p75_pct=got.cold_pct_percentile(75),
         always_cold_fraction=got.always_cold_fraction,
         equal_to_fused=True, equal_to_scalar_on_sample=len(sample))
    return trace, launches, by_form, dict(seconds=seconds, app_steps=steps)


def sweep_grid(E, range_minutes=60.0):
    """The 32 hybrid configs of the reference's sweep benchmark (one
    histogram group, 60 bins at its range: 8 window variants x 4 gates),
    as specs of the experiment module ``E``."""
    return [E.HybridSpec(range_minutes=range_minutes, head_percentile=h,
                         tail_percentile=t, cv_threshold=cv, margin=m,
                         use_arima=False)
            for m in (0.10, 0.20) for cv in (0.5, 1.0, 2.0, 4.0)
            for (h, t) in ((0.0, 100.0), (5.0, 99.0), (10.0, 95.0),
                           (15.0, 90.0))]


def policy_sweep(device):
    """The 34-config sweep (the grid, a fixed keep-alive and no-unload)
    through the kernel engine: every row equal to the fused engine's and
    four to single runs; the grid's band must take the factored form.
    Returns the trace, its scan launches by form and the chunk."""
    from repro_torch.core import experiment as E
    from repro_torch.core import simulator as sim
    from repro_torch.core.workload_spec import WorkloadSpec
    from repro_torch.kernels import histogram as H

    trace = WorkloadSpec.uniform(SWEEP_APPS, days=14.0, seed=3,
                                 max_events=64, min_events=1).materialize()
    grid = sweep_grid(E)
    specs = grid + [E.FixedSpec(10.0), E.NoUnloadSpec()]
    opts = E.EngineOptions(device=device)
    reset_counts(H)                      # count the sweep's launches
    t0 = time.perf_counter()
    res = E.sweep(trace, specs, engine="kernel", options=opts)
    seconds = time.perf_counter() - t0
    launches, by_form = H.SCAN_LAUNCHES, dict(H.SCAN_LAUNCHES_BY_FORM)
    times, counts = trace.to_padded()
    cfgs = [sp.to_config() for sp in grid]
    blk = sim._sweep_block_host(cfgs)
    n_bins = cfgs[0].histogram.n_bins
    chunk = sim._auto_chunk([(blk, n_bins)])
    chunks = sum(1 for _ in sim._chunked_buckets(times, counts, chunk))
    if by_form != {"registers": 0, "columns": 0, "factored": chunks} \
            or launches != chunks or H.LAUNCHES:
        raise AssertionError(
            f"sweep: {launches} scan launches {by_form}, {H.LAUNCHES} step "
            f"launches; expected {chunks} factored (one per chunk)")
    fused = E.sweep(trace, specs, engine="fused", options=opts)
    for s in range(len(specs)):
        assert_rows_equal(res.row(s), fused.row(s), f"sweep row {s} vs fused")
    singles = (0, 13, 31, 32)
    for s in singles:
        one = E.run(trace, specs[s], engine="kernel", options=opts)
        assert_rows_equal(res.row(s), one, f"sweep row {s} vs run()")
    S, G = len(cfgs), len(blk.g_n_bins)
    # the unfactored scan's chunk and state, as the port carried it before
    # (a histogram per config, its chunk divided by the config count)
    old_chunk = max(sim.DEFAULT_APP_CHUNK // S, sim._MIN_AUTO_CHUNK)
    emit("sweep", n_apps=SWEEP_APPS, configs=len(specs), seconds=seconds,
         rows_equal_to_fused=len(specs), rows_equal_to_single_run=len(singles),
         scan_launches=launches, launches_by_form=by_form, groups=G,
         window_variants=len(blk.w_group), gate_variants=len(blk.t_group),
         searches=len(set(zip(blk.w_head_numer[:, 0].tolist(),
                              blk.w_tail_numer[:, 0].tolist()))),
         chunk=chunk, chunks=chunks,
         state_bytes_per_app=sim._state_bytes_per_app(S, G, n_bins),
         state_bytes_per_chunk=chunk * sim._state_bytes_per_app(
             S, G, n_bins),
         unfactored_chunk=old_chunk,
         unfactored_state_bytes_per_app=sim._state_bytes_per_app(
             S, S, n_bins),
         unfactored_state_bytes_per_chunk=old_chunk * sim._state_bytes_per_app(
             S, S, n_bins))
    return trace, launches, by_form


# ---------------------------------------------------------------------------
# The paper's default policy (ARIMA on) and the SPES predictor
# ---------------------------------------------------------------------------


def reset_counts(*mods) -> None:
    """Every launch count of the kernel modules to 0."""
    for mod in mods:
        for k, v in vars(mod).items():
            if "LAUNCHES" in k and isinstance(v, int):
                setattr(mod, k, 0)
            elif "LAUNCHES" in k and isinstance(v, dict):
                for key in v:
                    v[key] = 0


def post_pass_selections(times, counts, hybrid):
    """The apps the engines hand to the forecast post-pass — those at which
    the scalar policy consults the forecaster after some event (enough
    samples, OOB-heavy) — and the selection before that repair — those
    OOB-heavy after their last event — both computed on the host from the
    trace alone, as a check of the engine's own flags."""
    from repro_torch.core import policy_math
    h = hybrid.histogram
    col = np.arange(times.shape[1] - 1)[None, :]
    gap = col < (counts[:, None] - 1)
    with np.errstate(invalid="ignore"):
        it = np.where(gap, times[:, 1:].astype(np.float64)
                      - times[:, :-1].astype(np.float64), 0.0)
    _, in_b, oob = policy_math.classify_idle_time(it, gap, h.bin_minutes,
                                                  h.n_bins)
    total = np.cumsum(in_b, 1, dtype=np.int32)
    oob = np.cumsum(oob, 1, dtype=np.int32)
    heavy = policy_math.oob_heavy(total, oob, hybrid.oob_fraction_threshold)
    consulted = (heavy & (total + oob >= hybrid.min_samples) & gap).any(1)
    return consulted, heavy[:, -1]


def scan_flags(times, counts, hybrid, device):
    """The scan's ``consulted`` flags of every app, from the kernel scan
    and from the plain scan on the card, chunk by chunk as the engine
    scans (uncounted); every output of the two must be equal. Returns the
    kernel's flags [n] and the seconds of the kernel scans."""
    import torch
    from repro_torch.core.simulator import (DEFAULT_APP_CHUNK,
                                            _chunk_stream, _chunked_buckets,
                                            _hybrid_sweep_scan,
                                            _sweep_block_host,
                                            _sweep_identities)
    from repro_torch.interop import sweep_block_from_numpy
    from repro_torch.kernels import histogram as H
    dev = torch.device(device)
    host = _sweep_block_host([hybrid])
    ids = _sweep_identities(host)
    n_bins = hybrid.histogram.n_bins
    plan = H.factored_scan_plan(host, ids, n_bins, dev)
    blk = sweep_block_from_numpy(host, device=dev)
    flags = np.zeros(len(counts), bool)
    kernel_s = 0.0
    with uncounted(H):
        for sel, cols in _chunk_stream(_chunked_buckets(
                times, counts, DEFAULT_APP_CHUNK), dev):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = _hybrid_sweep_scan(cols, blk, plan, n_bins, ids, True)
            torch.cuda.synchronize()
            kernel_s += time.perf_counter() - t0
            want = _hybrid_sweep_scan(cols, blk, plan, n_bins, ids, False)
            for name, g, w in zip(("cold", "waste", "consulted", "last_t",
                                   "prewarm", "unload_at"), got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"arima_point: the kernel scan's "
                                         f"{name} != the plain scan's")
            flags[sel] = got[2][0].cpu().numpy()
    return flags, kernel_s


def fit_bounds(want, got):
    """``got``'s fit against ``want``'s under FIT_BOUNDS: the counts and
    shares, and whether every bound holds."""
    b = FIT_BOUNDS
    both = want.valid & got.valid
    with np.errstate(invalid="ignore"):
        d_aic = np.abs(want.aic - got.aic)[both]
    rel = lambda x, y: np.abs(x - y) / np.maximum(np.abs(x), 1e-6)
    d_pred = rel(want.pred, got.pred)[both]
    has = want.valid.any(1)
    aic_w = np.where(want.valid, want.aic, np.inf)[has]
    sel_w = aic_w.argmin(1)
    sel_g = np.where(got.valid, got.aic, np.inf)[has].argmin(1)
    two = np.sort(aic_w, 1)[:, :2]
    rows = np.arange(len(sel_w))
    d_sel = rel(want.pred[has][rows, sel_w], got.pred[has][rows, sel_w])
    out = dict(
        pairs=int(both.sum()),
        valid_equal=bool(np.array_equal(want.valid, got.valid)),
        aic_equal=int((d_aic == 0).sum()), pred_equal=int(
            (want.pred[both] == got.pred[both]).sum()),
        aic_beyond=int((d_aic > b["aic"]).sum()),
        pred_beyond=int((d_pred > b["pred"]).sum()),
        selected_beyond=int((d_sel > b["selected_pred"]).sum()),
        orders_changed=int(((sel_w != sel_g)
                            & (two[:, 1] - two[:, 0]
                               >= b["selection_delta"])).sum()),
        max_abs_aic=float(d_aic.max()) if d_aic.size else 0.0,
        max_rel_pred=float(d_pred.max()) if d_pred.size else 0.0)
    n = max(out["pairs"], 1)
    out["ok"] = (out["valid_equal"]
                 and out["aic_beyond"] <= b["share"] * n
                 and out["pred_beyond"] <= b["share"] * n
                 and out["orders_changed"] == 0
                 and out["selected_beyond"]
                 <= b["selected_share"] * max(len(sel_w), 1))
    return out


def fits_equal(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True)
               for f in ("aic", "pred", "valid"))


def arima_point(device):
    """run(azure_like(100k, 7 days), HybridSpec()) on the card, engine
    "kernel": the histogram pass (one scan launch a chunk), then the
    forecast post-pass of the apps the scan flags (the step kernel once
    per event column in the rescan, one batched fit of every forecaster
    window). The selection's gates: the kernel scan's flags equal the
    plain scan's and the host's (``post_pass_selections``), the old
    final-state selection has ARIMA_OLD_SELECTION apps, and the first
    ARIMA_ADDED_CHECK apps the new one adds equal ``simulate_scalar``.
    Gates: (1) apps not flagged equal the use_arima=False run;
    (2) simulate_scalar with the forecasters on the card equals the
    replay on sampled flagged apps; (3) the card's fit of sampled windows
    is bit-identical whole, in chunks of 7 and row by row; (4) it is
    within the fit's bounds of the port's CPU fit. Then the post-pass
    again stage by stage, for its times. Returns the step launches of the
    main run."""
    import torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.simulator import (DEFAULT_APP_CHUNK,
                                            _chunked_buckets,
                                            simulate_scalar)
    from repro_torch.core.workload_spec import azure_like
    from repro_torch.forecast import arima_batched as A
    from repro_torch.forecast import replay as R
    from repro_torch.kernels import histogram as H

    t0 = time.perf_counter()
    trace = azure_like(ARIMA_APPS, days=ARIMA_DAYS, seed=0).materialize()
    gen_s = time.perf_counter() - t0
    times, counts = trace.to_padded()
    spec = HybridSpec()
    hyb = spec.to_config()
    opts = EngineOptions(device=device)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = run(trace, HybridSpec(use_arima=False), engine="kernel",
               options=opts)
    torch.cuda.synchronize()
    hist_s = time.perf_counter() - t0

    reset_counts(H)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(trace, spec, engine="kernel", options=opts)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    step_launches, scan_launches = H.LAUNCHES, H.SCAN_LAUNCHES

    flagged, old_selection = post_pass_selections(times, counts, hyb)
    # the kernel scan's flags: equal to the plain scan's, and to the host's
    # selection from the trace alone
    kernel_flags, flags_scan_s = scan_flags(times, counts, hyb, device)
    if not np.array_equal(kernel_flags, flagged):
        raise AssertionError(f"arima_point: the scan flags "
                             f"{int(kernel_flags.sum())} apps, the host's "
                             f"selection {int(flagged.sum())}")
    if int(old_selection.sum()) != ARIMA_OLD_SELECTION:
        raise AssertionError(f"arima_point: the final-state selection has "
                             f"{int(old_selection.sum())} apps, not "
                             f"{ARIMA_OLD_SELECTION}")
    aidx = np.nonzero(flagged)[0]
    sub_t, sub_c = times[aidx], counts[aidx].astype(np.int64)
    columns = sum(sub.shape[1] for _, sub in
                  _chunked_buckets(sub_t, sub_c, DEFAULT_APP_CHUNK))
    if step_launches != columns or step_launches == 0:
        raise AssertionError(f"the rescan made {step_launches} step "
                             f"launches; expected one per column of the "
                             f"flagged apps' chunks, {columns}")
    # gate 1: the post-pass touches the flagged apps only
    rest = ~flagged
    for field in ("cold", "invocations", "final_prewarm",
                  "final_keep_alive", "wasted_minutes"):
        if not np.array_equal(getattr(got, field)[rest],
                              getattr(base, field)[rest]):
            raise AssertionError(f"arima_point: an app not flagged differs "
                                 f"from the use_arima=False run in {field}")

    # the post-pass again, stage by stage (uncounted), for its times; the
    # stages must give the main run's rows
    dev = torch.device(device)
    with uncounted(H):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        la, ua, branch = R._scan_window_sequences(sub_t, sub_c, hyb, None,
                                                  dev, True)
        rescan_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows, events, stacked, lens = R._call_windows(sub_t, sub_c, hyb,
                                                      branch)
        stack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fit = A.fit_arima_grid(stacked, lens, device=dev)
        fit_s = time.perf_counter() - t0
        chunks = A.fit_chunks(lens, None, "cuda")
        t0 = time.perf_counter()
        last_keep = R._replay_cadence(rows, events, fit, sub_c, hyb, la, ua)
        cadence_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = R._verdict(sub_t, sub_c, float(trace.duration_minutes), hyb,
                         la, ua, last_keep, True)
        verdict_s = time.perf_counter() - t0
    for field, v in out.items():
        if not np.array_equal(v, getattr(got, field)[aidx]):
            raise AssertionError(f"arima_point: the stages' {field} differs "
                                 f"from the main run's")
    forecast_apps = int((~np.isnan(last_keep)).sum())

    # the apps the new selection adds: on the first ARIMA_ADDED_CHECK of
    # them, the scalar oracle's cold counts are the main run's (the old
    # selection left them at the use_arima=False run's)
    added = np.nonzero(flagged & ~old_selection)[0][:ARIMA_ADDED_CHECK]
    t0 = time.perf_counter()
    added_oracle = simulate_scalar(trace, spec.build(device="cpu"),
                                   app_indices=added)
    added_s = time.perf_counter() - t0
    if not np.array_equal(got.cold[added], added_oracle.cold[added]):
        raise AssertionError("arima_point: the kernel engine's cold counts "
                             "!= the scalar oracle's on the added apps")
    added_moved = int((base.cold[added] != got.cold[added]).sum())

    # gate 2: the scalar oracle with its forecasters on the card, on
    # sampled flagged apps whose replay needs a few dozen fits in all
    rng = np.random.default_rng(7)
    n_fits = np.zeros(len(aidx), np.int64)
    for r, ks in zip(rows, events):
        n_fits[r] = len(ks)
    sample, fits_needed = [], 0
    for i in rng.permutation(len(aidx)):
        if 1 <= n_fits[i] <= 3 and fits_needed + n_fits[i] \
                <= ARIMA_SCALAR_FITS:
            sample.append(i)
            fits_needed += int(n_fits[i])
    sample += [int(i) for i in rng.permutation(np.nonzero(n_fits == 0)[0])
               [:10]]
    apps = np.sort(aidx[sample])
    t0 = time.perf_counter()
    oracle = simulate_scalar(trace, spec.build(device=dev),
                             app_indices=apps)
    scalar_s = time.perf_counter() - t0
    for field in ("cold", "invocations", "final_prewarm",
                  "final_keep_alive", "wasted_minutes"):
        if not np.array_equal(getattr(got, field)[apps],
                              getattr(oracle, field)[apps]):
            raise AssertionError(f"arima_point: scalar oracle on the card "
                                 f"!= replay in {field}")

    # gates 3 and 4: the card's fit of sampled windows, however chunked,
    # and against the port's CPU fit
    pick = np.sort(rng.choice(len(lens), min(ARIMA_FIT_SAMPLE, len(lens)),
                              replace=False))
    s_rows, s_lens = stacked[pick], lens[pick]
    t0 = time.perf_counter()
    whole = A.fit_arima_grid(s_rows, s_lens, device=dev)
    whole_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = A.fit_arima_grid(s_rows, s_lens, device=dev,
                             chunk_rows=ARIMA_FIT_CHUNK)
    small_s = time.perf_counter() - t0
    if not fits_equal(whole, small):
        raise AssertionError("arima_point: the card's fit in chunks of "
                             f"{ARIMA_FIT_CHUNK} != whole")
    # the fit's device time and launches (torch.profiler), and the card's
    # idle share against the unprofiled wall seconds of the same fit
    fit_launches = {}
    fit_dev = device_ms(lambda: A.fit_arima_grid(s_rows, s_lens, device=dev),
                        fit_launches)
    fit_dev_ms = sum(fit_dev.values()) if fit_dev else None
    for i in rng.choice(len(pick), ARIMA_ROW_BY_ROW, replace=False):
        one = A.fit_arima_grid(s_rows[i:i + 1], s_lens[i:i + 1], device=dev)
        if not all(np.array_equal(getattr(one, f)[0], getattr(whole, f)[i],
                                  equal_nan=True)
                   for f in ("aic", "pred", "valid")):
            raise AssertionError(f"arima_point: window {i} fitted alone != "
                                 f"in the batch")
    t0 = time.perf_counter()
    cpu = A.fit_arima_grid(s_rows, s_lens, device="cpu")
    cpu_s = time.perf_counter() - t0
    vs_cpu = fit_bounds(cpu, whole)
    if not vs_cpu["ok"]:
        raise AssertionError(f"arima_point: the card's fit is not within "
                             f"the bounds of the CPU fit: {vs_cpu}")

    spans = np.asarray([A._pow2(x) for x in lens])
    emit("arima_point", n_apps=ARIMA_APPS, days=ARIMA_DAYS, seed=0,
         n_bins=hyb.histogram.n_bins, invocations=int(counts.sum()),
         trace_gen_seconds=gen_s, post_passed_apps=int(len(aidx)),
         post_passed_apps_old_selection=int(old_selection.sum()),
         selection_added=int((flagged & ~old_selection).sum()),
         selection_dropped=int((old_selection & ~flagged).sum()),
         flags_kernel_equal_plain=True,
         flags_kernel_scan_seconds=flags_scan_s,
         added_checked_apps=int(len(added)),
         added_checked_cold_moved=added_moved,
         added_checked_oracle_seconds=added_s,
         forecast_apps=int(len(rows)), final_forecast_apps=forecast_apps,
         forecaster_windows=int(len(lens)),
         windows_by_span={int(k): int((spans == k).sum())
                          for k in np.unique(spans)},
         rescan_step_launches=step_launches, scan_launches=scan_launches,
         seconds=total_s, seconds_without_arima=hist_s,
         post_pass_seconds=total_s - hist_s,
         stage_seconds=dict(rescan=rescan_s, window_stacking=stack_s,
                            fit=fit_s, cadence=cadence_s, verdict=verdict_s),
         fit_chunks=len(chunks),
         windows_per_chunk=[int(len(c)) for c in chunks],
         fit_windows_per_s=len(lens) / fit_s,
         cold_p75_pct=got.cold_pct_percentile(75),
         cold_p75_pct_without_arima=base.cold_pct_percentile(75),
         wasted_minutes=got.total_wasted,
         wasted_minutes_without_arima=base.total_wasted,
         gate1_apps_not_flagged_equal=int(rest.sum()),
         gate2_scalar_apps=int(len(apps)), gate2_scalar_fits=fits_needed,
         gate2_scalar_seconds=scalar_s,
         gate3_windows=int(len(pick)), gate3_whole_seconds=whole_s,
         gate3_fit_device_ms=fit_dev_ms,
         gate3_fit_kernel_launches=sum(fit_launches.values()),
         gate3_fit_idle_share=(None if fit_dev_ms is None
                               else 1.0 - fit_dev_ms / 1e3 / whole_s),
         gate3_chunked_seconds=small_s, gate3_row_by_row=ARIMA_ROW_BY_ROW,
         gate4_cpu_seconds=cpu_s, gate4_card_vs_cpu=vs_cpu)
    return step_launches


def spes_point(trace, device):
    """run(scale trace, SpesSpec()) on the card: 1M apps x 14 days in one
    float64 pass of plain PyTorch steps; equal bit for bit, waste
    included, to simulate_scalar(SpesPolicy) on 1,000 sampled apps."""
    import torch
    from repro_torch.core.experiment import EngineOptions, SpesSpec, run
    from repro_torch.core.policy import SpesPolicy
    from repro_torch.core.simulator import simulate_scalar

    spec = SpesSpec()
    opts = EngineOptions(app_chunk=SCALE_APPS, device=device)
    run(trace, spec, engine="kernel", options=opts)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(trace, spec, engine="kernel", options=opts)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sample = np.sort(np.random.default_rng(9).choice(
        trace.n_apps, SPES_SAMPLE, replace=False))
    oracle = simulate_scalar(trace, SpesPolicy(spec.to_config()),
                             app_indices=sample)
    for field in ("cold", "invocations", "final_prewarm",
                  "final_keep_alive", "wasted_minutes"):
        if not np.array_equal(getattr(got, field)[sample],
                              getattr(oracle, field)[sample]):
            raise AssertionError(f"spes_point: {field} != SpesPolicy")
    emit("spes_point", n_apps=trace.n_apps, days=14.0, seconds=seconds,
         app_steps=app_steps(trace.to_padded()[1]),
         cold_p75_pct=got.cold_pct_percentile(75),
         wasted_minutes=got.total_wasted,
         equal_to_scalar_on_sample=SPES_SAMPLE)
    return seconds


# ---------------------------------------------------------------------------
# The fleet simulation (§5.3)
# ---------------------------------------------------------------------------


def assert_cluster_equal(got, want, what: str) -> None:
    """The cluster engines' contract: cold % per app, latencies and every
    per-worker counter equal; wasted GB-minutes and resident byte-seconds
    within rtol 1e-9 (float64 accumulation order)."""
    bad = int((got.cold_pct_per_app != want.cold_pct_per_app).sum())
    if bad:
        raise AssertionError(f"{what}: cold % differs in {bad} apps")
    if not np.array_equal(got.latencies_s, want.latencies_s):
        raise AssertionError(f"{what}: latencies differ")
    close = lambda a, b: abs(a - b) <= 1e-9 * abs(b)
    if not close(got.wasted_gb_minutes, want.wasted_gb_minutes):
        raise AssertionError(f"{what}: wasted GB-minutes "
                             f"{got.wasted_gb_minutes} != "
                             f"{want.wasted_gb_minutes}")
    if len(got.stats_per_worker) != len(want.stats_per_worker):
        raise AssertionError(f"{what}: worker counts differ")
    for w, (a, b) in enumerate(zip(got.stats_per_worker,
                                   want.stats_per_worker)):
        for key in CLUSTER_COUNTERS:
            if a[key] != b[key]:
                raise AssertionError(f"{what}: worker {w} {key} {a[key]} != "
                                     f"{b[key]}")
        if not close(a["resident_byte_seconds"], b["resident_byte_seconds"]):
            raise AssertionError(f"{what}: worker {w} resident byte-seconds")
    if got.restored_mid_run != want.restored_mid_run:
        raise AssertionError(f"{what}: restored_mid_run differs")


class counting_plain_steps:
    """Count the calls of the sweep step's plain version (the CPU path)
    while inside: the fleet's phase B on the card must make none. Every
    caller reaches it through the module attribute, which this wraps."""

    def __init__(self, H):
        self.H, self.calls = H, 0

    def __enter__(self):
        self.plain = self.H.fused_hybrid_sweep_step_plain

        def counted(*args, **kwargs):
            self.calls += 1
            return self.plain(*args, **kwargs)
        self.H.fused_hybrid_sweep_step_plain = counted
        return self

    def __exit__(self, *exc):
        self.H.fused_hybrid_sweep_step_plain = self.plain


class capturing_forecast_windows:
    """Keep what the forecast post-pass stacks (stage 1 of
    ``forecast.replay``): the apps that reach it and their windows."""

    def __init__(self, R):
        self.R, self.apps, self.windows = R, 0, 0

    def __enter__(self):
        self.call_windows = self.R._call_windows

        def captured(*args, **kwargs):
            rows, events, stacked, lens = self.call_windows(*args, **kwargs)
            self.apps += len(rows)
            self.windows += len(lens)
            return rows, events, stacked, lens
        self.R._call_windows = captured
        return self

    def __exit__(self, *exc):
        self.R._call_windows = self.call_windows


def fleet_point(device):
    """The §5.3 fleet simulation on the card through ``run(trace, spec,
    cluster=ClusterSpec(...))``: (a) the 1M-app fleet, phase B through the
    sweep-step kernel once per event column of each chunk; (b) the
    eviction regime; (c) HybridSpec() on (a). Gates: (1) the vectorized
    engine equals the port's per-event oracle (policies on the card) at
    the smoke size and on a fleet that consults the forecaster; (2) (b) on
    the card equals (b) with phase B on the CPU; (3) (a) makes one step
    launch per event column of each chunk and no plain-step call. Returns
    the step launches of (a)."""
    import torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.simulator import DEFAULT_APP_CHUNK, _chunked_buckets
    from repro_torch.core.workload_spec import azure_like
    from repro_torch.forecast import replay as R
    from repro_torch.kernels import histogram as H
    from repro_torch.serving import AppTable, ClusterSpec
    from repro_torch.serving import cluster_vector as CV

    opts = EngineOptions(device=device)
    no_arima = HybridSpec(use_arima=False)
    inf = float("inf")

    def timed_run(table, spec, cluster, options=opts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(table, spec, cluster=cluster, options=options)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(CV.PHASE_SECONDS)

    # (a) the README's fleet
    t0 = time.perf_counter()
    table = AppTable.from_spec(azure_like(**FLEET))
    table_s = time.perf_counter() - t0
    n_events = table.n_events
    counts = table.counts.astype(np.int64)
    columns = sum(sub.shape[1] for _, sub in
                  _chunked_buckets(table.times, counts, DEFAULT_APP_CHUNK))
    cluster = ClusterSpec(n_workers=FLEET_WORKERS, hbm_budget_bytes=inf)
    run(AppTable.from_spec(azure_like(**GATE_FLEET)), no_arima,
        cluster=cluster, options=opts)              # warm-up, uncounted
    reset_counts(H)
    with counting_plain_steps(H) as plain:
        fleet, fleet_s, phases = timed_run(table, no_arima, cluster)
    launches = H.LAUNCHES
    # gate 3
    if plain.calls or launches < columns:
        raise AssertionError(f"fleet_point: {launches} step launches (one "
                             f"per column of each chunk: {columns}) and "
                             f"{plain.calls} plain-step calls (0)")
    with uncounted(H):
        prof = {}
        dev = device_ms(lambda: run(table, no_arima, cluster=cluster,
                                    options=opts), prof)
    dev_ms = sum(dev.values()) if dev else None

    # (c) the paper's default policy on (a)
    with uncounted(H), capturing_forecast_windows(R) as fc:
        arima, arima_s, arima_phases = timed_run(table, HybridSpec(),
                                                 cluster)
    del table

    # (b) the eviction regime, and gate 2: phase B on the CPU
    t0 = time.perf_counter()
    etable = AppTable.from_spec(azure_like(**EVICT_FLEET))
    etable_s = time.perf_counter() - t0
    ecluster = ClusterSpec(n_workers=EVICT_WORKERS, hbm_budget_bytes=float(
        etable.weight_bytes.max()) * EVICT_IMAGES)
    with uncounted(H):
        evict, evict_s, evict_phases = timed_run(etable, no_arima, ecluster)
        evict_cpu, evict_cpu_s, _ = timed_run(
            etable, no_arima, ecluster, EngineOptions(device="cpu"))
    assert_cluster_equal(evict, evict_cpu, "fleet_point (b): card vs CPU")

    # gate 1: the vectorized engine against the port's oracle on the card
    gate = []
    gtable = AppTable.from_spec(azure_like(**GATE_FLEET))
    ftable = AppTable.from_spec(azure_like(**FORECAST_FLEET))
    big = float(gtable.weight_bytes.max())
    cases = [(gtable, spec, ClusterSpec(n_workers=GATE_WORKERS,
                                        hbm_budget_bytes=budget))
             for budget in (inf, big * GATE_IMAGES)
             for spec in (no_arima, HybridSpec())]
    cases.append((ftable, HybridSpec(),
                  ClusterSpec(n_workers=FORECAST_WORKERS,
                              hbm_budget_bytes=inf)))
    with uncounted(H):
        for tab, spec, cl in cases:
            what = (f"fleet_point gate 1: {tab.n_apps} apps, "
                    f"{spec.name}, use_arima={spec.use_arima}, "
                    f"budget {cl.hbm_budget_bytes:g}")
            with capturing_forecast_windows(R) as gfc:
                vec, vec_s, _ = timed_run(tab, spec, cl)
            t0 = time.perf_counter()
            sca = run(tab, spec, cluster=cl, engine="scalar", options=opts)
            sca_s = time.perf_counter() - t0
            assert_cluster_equal(vec, sca, what)
            gate.append(dict(apps=tab.n_apps, events=tab.n_events,
                             use_arima=spec.use_arima,
                             budget=cl.hbm_budget_bytes,
                             evictions=vec.evictions,
                             prewarms=sum(s["prewarms"]
                                          for s in vec.stats_per_worker),
                             forecast_apps=gfc.apps,
                             forecast_windows=gfc.windows,
                             vector_seconds=vec_s, oracle_seconds=sca_s))
    if not gate[-1]["forecast_windows"]:
        raise AssertionError("fleet_point gate 1: the forecast fleet "
                             "reached no forecaster")

    emit("fleet_point",
         fleet=dict(FLEET, workers=FLEET_WORKERS, events=n_events,
                    table_seconds=table_s, seconds=fleet_s,
                    events_per_s=n_events / fleet_s, phase_seconds=phases,
                    step_launches=launches, columns=columns,
                    plain_step_calls=plain.calls,
                    device_ms=dev, device_launches=prof,
                    idle_share=(None if dev_ms is None
                                else 1.0 - dev_ms / 1e3 / fleet_s),
                    cold_p75_pct=fleet.cold_pct_p75,
                    wasted_gb_minutes=fleet.wasted_gb_minutes,
                    prewarms=sum(s["prewarms"]
                                 for s in fleet.stats_per_worker)),
         fleet_arima=dict(seconds=arima_s, events_per_s=n_events / arima_s,
                          phase_seconds=arima_phases,
                          forecast_apps=fc.apps,
                          forecast_windows=fc.windows,
                          cold_p75_pct=arima.cold_pct_p75,
                          wasted_gb_minutes=arima.wasted_gb_minutes,
                          equal_to_without_arima=bool(
                              np.array_equal(arima.cold_pct_per_app,
                                             fleet.cold_pct_per_app))),
         eviction=dict(EVICT_FLEET, workers=EVICT_WORKERS,
                       budget_images=EVICT_IMAGES,
                       budget_bytes=ecluster.hbm_budget_bytes,
                       events=etable.n_events, table_seconds=etable_s,
                       seconds=evict_s,
                       events_per_s=etable.n_events / evict_s,
                       phase_seconds=evict_phases,
                       evictions=evict.evictions,
                       budget_overflows=evict.budget_overflows,
                       reference_evictions=REF_EVICTIONS,
                       reproduces_reference_evictions=(
                           evict.evictions == REF_EVICTIONS),
                       cpu_phase_b_seconds=evict_cpu_s),
         gate1=gate, gate2_card_equals_cpu=True,
         gate3_launches_at_least_columns=True)
    return launches


# ---------------------------------------------------------------------------
# The float32 "reference" engine, the app-axis scale-out, the examples
# ---------------------------------------------------------------------------


def rows_differing(a, b) -> dict:
    """Apps whose cold count, final windows or waste differ between two
    runs; waste also beyond the float32 engines' tolerance (rtol 1e-5,
    atol 1e-3: tests/test_engine_conformance.py)."""
    windows = (a.final_prewarm != b.final_prewarm) \
        | (a.final_keep_alive != b.final_keep_alive)
    beyond = ~np.isclose(a.wasted_minutes, b.wasted_minutes, rtol=1e-5,
                         atol=1e-3)
    return dict(cold=int((a.cold != b.cold).sum()),
                windows=int(windows.sum()),
                waste=int((a.wasted_minutes != b.wasted_minutes).sum()),
                waste_beyond_f32_tolerance=int(beyond.sum()))


def reference_engine(trace, device):
    """``run(scale trace, HybridSpec(use_arima=False), engine="reference")``
    on the card: the reference's pre-sweep float32 engine (per-bucket
    rebasing, a full cumsum per step) in plain PyTorch, no kernel. Gates:
    (a) on a 20,000-app slice the card equals the same engine on the CPU
    bit for bit; (b) fewer than 0.1% of the apps differ from the ``kernel``
    engine (float64 time) in their cold count. Returns the failed gates."""
    import torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.interop import trace_from_numpy
    from repro_torch.kernels import histogram as H

    spec = HybridSpec(use_arima=False)
    opts = EngineOptions(app_chunk=SCALE_APPS, device=device)

    def timed(engine, tr=trace, options=opts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(tr, spec, engine=engine, options=options)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    with uncounted(H):
        kernel, kernel_s = timed("kernel")
    torch.cuda.reset_peak_memory_stats()
    ref, ref_s = timed("reference")
    peak = torch.cuda.max_memory_allocated()
    diff = rows_differing(ref, kernel)

    times, counts = trace.to_padded()
    sl = trace_from_numpy(np.ascontiguousarray(times[:REFERENCE_SLICE]),
                          counts[:REFERENCE_SLICE].copy(),
                          duration_minutes=trace.duration_minutes)
    card, card_s = timed("reference", sl)
    t0 = time.perf_counter()
    cpu = run(sl, spec, engine="reference", options=EngineOptions(
        device="cpu"))
    cpu_s = time.perf_counter() - t0
    slice_diff = rows_differing(card, cpu)
    failed = []
    if any(slice_diff.values()):
        failed.append(f"reference_engine (a): the card differs from the CPU "
                      f"on the {REFERENCE_SLICE}-app slice: {slice_diff}")
    if diff["cold"] >= REFERENCE_MAX_COLD_SHARE * SCALE_APPS:
        failed.append(f"reference_engine (b): {diff['cold']} apps differ "
                      f"from the kernel engine in their cold count")
    emit("reference_engine", n_apps=SCALE_APPS, days=14.0,
         seconds=ref_s, kernel_seconds=kernel_s, peak_device_bytes=peak,
         differ_from_kernel=diff, pr12_float32_step_differed=dict(
             cold=4, windows=22, waste_beyond_f32_tolerance=67),
         gate_a=dict(apps=REFERENCE_SLICE, card_seconds=card_s,
                     cpu_seconds=cpu_s, differing=slice_diff),
         gate_b_cold_share=diff["cold"] / SCALE_APPS,
         gates_failed=failed)
    return failed


def scaleout(trace, device):
    """``devices=1`` and ``devices="auto"`` against ``devices=None`` on the
    card: the scale point (``kernel`` engine) and fleet (a). Gate: every
    output equal bit for bit. Counts the scan and step launches of each
    run (one scan launch per chunk, band and shard; one step launch per
    event column of each chunk and shard), and checks that asking for more
    cards than the machine has raises ``RuntimeError``. Returns (scan
    launches, step launches, failed gates)."""
    import torch
    from repro_torch.core.experiment import EngineOptions, HybridSpec, run
    from repro_torch.core.simulator import DEFAULT_APP_CHUNK, _chunked_buckets
    from repro_torch.core.workload_spec import azure_like
    from repro_torch.kernels import histogram as H
    from repro_torch.serving import AppTable, ClusterSpec

    spec = HybridSpec(use_arima=False)
    times, counts = trace.to_padded()
    chunks = sum(1 for _ in _chunked_buckets(times, counts, SCALE_APPS))
    t0 = time.perf_counter()
    table = AppTable.from_spec(azure_like(**FLEET))
    table_s = time.perf_counter() - t0
    columns = sum(sub.shape[1] for _, sub in _chunked_buckets(
        table.times, table.counts.astype(np.int64), DEFAULT_APP_CHUNK))
    cluster = ClusterSpec(n_workers=FLEET_WORKERS, hbm_budget_bytes=float(
        "inf"))
    n_cards = torch.cuda.device_count()
    failed, points = [], {}
    scan_launches = step_launches = 0
    for point in ("scale_point", "fleet"):
        rows = {}
        # interleaved repeats (host-bound replays spread between runs);
        # the first repeat's launches are the path's, the rest timing
        for rep in range(SCALEOUT_REPEATS[point]):
            for devices in (None, 1, "auto"):
                shards = {None: 1, 1: 1, "auto": n_cards}[devices]
                opts = EngineOptions(
                    app_chunk=SCALE_APPS if point == "scale_point" else None,
                    device=device, devices=devices)
                reset_counts(H)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if point == "scale_point":
                    res = run(trace, spec, engine="kernel", options=opts)
                else:
                    res = run(table, spec, cluster=cluster, options=opts)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                if rep:
                    rows[str(devices)]["seconds"].append(sec)
                    continue
                scan, step = H.SCAN_LAUNCHES, H.LAUNCHES
                want = (chunks * shards, 0) if point == "scale_point" \
                    else (0, columns * shards)
                if devices is not None:
                    scan_launches += scan
                    step_launches += step
                rows[str(devices)] = dict(seconds=[sec], scan_launches=scan,
                                          step_launches=step, shards=shards,
                                          expected_launches=want)
                # phase B steps each column of each chunk and shard at
                # least once; the scale point scans each chunk and shard
                # once
                ok = (scan, step) == want if point == "scale_point" \
                    else scan == 0 and step >= want[1]
                if not ok:
                    failed.append(f"scaleout {point} devices={devices}: "
                                  f"{scan} scan and {step} step launches, "
                                  f"expected {want}")
                if devices is None:
                    base = res
                    continue
                try:
                    if point == "scale_point":
                        assert_rows_equal(res, base, f"scaleout {point} "
                                          f"devices={devices}")
                    else:
                        assert_cluster_equal(res, base, f"scaleout {point} "
                                             f"devices={devices}")
                except AssertionError as e:
                    failed.append(str(e))
        for row in rows.values():
            row["median_seconds"] = float(np.median(row["seconds"]))
        rows["overhead_devices_1"] = rows["1"]["median_seconds"] \
            / rows["None"]["median_seconds"] - 1.0
        points[point] = rows
    too_many = n_cards + 1
    try:
        run(trace, spec, engine="kernel", options=EngineOptions(
            device=device, devices=too_many))
        failed.append(f"scaleout: devices={too_many} on {n_cards} card(s) "
                      f"did not raise")
        raised = None
    except RuntimeError as e:
        raised = str(e)
    emit("scaleout", cards=n_cards, chunks=chunks, fleet_config=dict(
        FLEET, workers=FLEET_WORKERS, columns=columns,
        table_seconds=table_s), **points,
         too_many_devices=dict(devices=too_many, raised=raised),
         scan_launches=scan_launches, step_launches=step_launches,
         gates_failed=failed)
    return scan_launches, step_launches, failed


def example_numbers(name: str, device):
    """The quickstart's or the policy explorer's printed numbers at their
    defaults on ``device``, as JSON round-trips them (each ``PolicyPoint``
    as its fields in order; repr round-trips floats)."""
    import dataclasses
    from repro_torch.examples import policy_explorer, quickstart
    row = lambda p: list(dataclasses.astuple(p))
    if name == "quickstart":
        n_apps, n_inv, points = quickstart.headline(device=device)
        res = dict(headline=[n_apps, n_inv, [row(p) for p in points]],
                   regimes=quickstart.regimes(device=device))
    else:
        res = [[title, [row(p) for p in pts]]
               for title, pts in policy_explorer.explore(device=device)]
    return json.loads(json.dumps(res))


def cpu_example(name: str, out: str) -> None:
    """:func:`example_numbers` on the CPU (``fused``), written to ``out``:
    what ``examples`` holds the card's run to. Runs in a worker process,
    one intra-op thread."""
    import torch
    torch.set_num_threads(1)
    res = example_numbers(name, "cpu")
    with open(out, "w") as f:
        json.dump(res, f)


def start_cpu_examples():
    """Start the CPU runs of the quickstart and policy explorer twins in
    worker processes (minutes of plain-PyTorch scans on one core each) so
    that they overlap the card's phases. Returns {name: (process, path)}."""
    out_dir = os.path.join(ROOT, "src", "repro_torch", "kernels", "build",
                           "examples")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            f"chip_smoke.cpu_example(sys.argv[1], sys.argv[2])")
    jobs = {}
    for name in CPU_EXAMPLES:
        path = os.path.join(out_dir, f"{name}_cpu.json")
        if os.path.exists(path):
            os.remove(path)
        jobs[name] = (subprocess.Popen([sys.executable, "-c", code, name,
                                        path], env=env, cwd=ROOT), path)
    return jobs


def stop_cpu_examples(jobs) -> None:
    for proc, _ in jobs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def examples(device, jobs):
    """The five example twins at the reference scripts' defaults on the
    card. Gates: the quickstart's and the explorer's policy numbers equal
    the same functions on the CPU (``fused``, the worker processes of
    :func:`start_cpu_examples`); the serving twin's cold, pre-warm and
    GB-minute lines equal its CPU run's; the training twin's final loss
    after a crash at step 120 equals the uninterrupted run's bit for bit;
    the exported files equal the CPU run's byte for byte. Returns (scan
    launches, step launches, failed gates)."""
    import filecmp
    import shutil
    import torch
    from repro_torch.examples import (export_dataset, quickstart,
                                      serve_serverless, train_smollm)
    from repro_torch.core.metrics import PolicyPoint, pareto_frontier
    from repro_torch.kernels import histogram as H

    t_phase = time.perf_counter()
    failed, out = [], {}
    reset_counts(H)
    timed = {}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        timed[key] = time.perf_counter() - t0
        return res

    card = {name: clock(name, lambda: example_numbers(name, device))
            for name in CPU_EXAMPLES}
    scan_launches, step_launches = H.SCAN_LAUNCHES, H.LAUNCHES
    wait_s = time.perf_counter()
    cpu = {}
    for name, (proc, path) in jobs.items():
        rc = proc.wait(timeout=CPU_EXAMPLES_TIMEOUT)
        if rc != 0:
            failed.append(f"examples: the CPU {name} worker exited {rc}")
            continue
        with open(path) as f:
            cpu[name] = json.load(f)
    wait_s = time.perf_counter() - wait_s
    equal = {name: cpu.get(name) == card[name] for name in CPU_EXAMPLES}
    failed += [f"examples: {name}'s policy numbers differ between the card "
               f"and the CPU" for name, same in equal.items() if not same]
    n_apps, n_inv, points = card["quickstart"]["headline"]
    points = [PolicyPoint(*p) for p in points]
    out["quickstart"] = dict(
        lines=quickstart.headline_lines(n_apps, n_inv, points)
        + quickstart.regime_lines(card["quickstart"]["regimes"]),
        equal_to_cpu=equal["quickstart"])
    out["policy_explorer"] = dict(
        frontiers={t: [p.name for p in pareto_frontier(
            [PolicyPoint(*v) for v in pts])]
            for t, pts in card["policy_explorer"]},
        equal_to_cpu=equal["policy_explorer"])

    registry, trace = serve_serverless.build()
    serve = {}
    for spec in (serve_serverless.HybridSpec(use_arima=False,
                                             label="hybrid"),
                 serve_serverless.FixedSpec(10.0)):
        got = clock(f"serve_{spec.name}", lambda: serve_serverless.drive(
            spec, trace, registry, device=device))
        want = serve_serverless.drive(spec, trace, registry, device="cpu")
        lines = serve_serverless.drive_lines(spec.name, *got)
        if lines[0] != serve_serverless.drive_lines(spec.name, *want)[0]:
            failed.append(f"examples: serve_serverless [{spec.name}] "
                          f"differs from the CPU run: {lines[0]}")
        serve[spec.name] = dict(lines=lines, stats=got[0])
    out["serve_serverless"] = dict(
        lines=[l for s in serve.values() for l in s["lines"]]
        + [serve_serverless.saving_line(serve["hybrid"]["stats"],
                                        serve["fixed-10m"]["stats"])])

    ck = os.path.join(ROOT, "src", "repro_torch", "kernels", "build",
                      "examples_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    try:
        clean = clock("train_smollm", lambda: train_smollm.run(
            crash_at=None, checkpoint_dir=os.path.join(ck, "clean"),
            device=device, log=lambda _: None))
        crashed = clock("train_smollm_crash", lambda: train_smollm.run(
            crash_at=EXAMPLE_CRASH_AT, checkpoint_dir=os.path.join(
                ck, "crash"), device=device, log=lambda _: None))
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if crashed["final_loss"] != clean["final_loss"] \
            or crashed["attempts"] != 2:
        failed.append(f"examples: train_smollm with a crash at step "
                      f"{EXAMPLE_CRASH_AT} ends at loss "
                      f"{crashed['final_loss']!r} against "
                      f"{clean['final_loss']!r} uninterrupted")
    out["train_smollm"] = dict(
        first_loss=clean["first_loss"], final_loss=clean["final_loss"],
        crashed_final_loss=crashed["final_loss"],
        resumed_from=crashed["resumed_from"], attempts=crashed["attempts"])

    base = os.path.join(ROOT, "src", "repro_torch", "kernels", "build",
                        "examples_export")
    card_dir, cpu_dir = os.path.join(base, "card"), os.path.join(base, "cpu")
    shutil.rmtree(base, ignore_errors=True)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            clock("export_dataset", lambda: export_dataset.main(
                ["--out", card_dir, "--device", str(device)]))
        _, cpu_paths = export_dataset.export_trace(out=cpu_dir)
        files = [os.path.relpath(p, cpu_dir) for p in cpu_paths]
        same = all(filecmp.cmp(os.path.join(card_dir, f), p, shallow=False)
                   for f, p in zip(files, cpu_paths))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    if not same:
        failed.append("examples: export_dataset's files differ from the CPU "
                      "run's")
    out["export_dataset"] = dict(lines=printed.getvalue().splitlines(),
                                 files=files, byte_identical_to_cpu=same)
    emit("examples", seconds=time.perf_counter() - t_phase,
         cpu_wait_seconds=wait_s, seconds_by_twin=timed,
         scan_launches=scan_launches, step_launches=step_launches,
         **out, gates_failed=failed)
    return scan_launches, step_launches, failed


# ---------------------------------------------------------------------------
# Times
# ---------------------------------------------------------------------------


def sweep_columns(trace, device):
    """The scale trace's event columns as the engine scans them: float64
    [width, n] on the card."""
    import torch
    times, counts = trace.to_padded()
    return torch.from_numpy(np.ascontiguousarray(
        times[:, :int(counts.max())].T.astype(np.float64))).to(device)


def default_cfg_blocks(device):
    """The paper's default hybrid config as the (int32, float32) knob
    blocks the sweep kernels read, and its bin count."""
    import torch
    from repro_torch.core.policy import HybridConfig
    from repro_torch.core.simulator import _build_cfg_blocks
    ci, cf = (torch.from_numpy(x).to(device)
              for x in _build_cfg_blocks([HybridConfig(use_arima=False)]))
    return ci, cf, int(ci[0, 0])


def fresh_sweep_state(S, n, n_bins, cf, device):
    """The simulator's initial carry of a chunk (float64 time)."""
    import torch
    tdt = torch.float64
    z = lambda dt: torch.zeros((S, n), dtype=dt, device=device)
    return (torch.full((S, n), -np.inf, dtype=tdt, device=device),
            torch.zeros((S, n, n_bins), dtype=torch.int32, device=device),
            z(torch.int32), z(tdt), z(tdt), z(tdt),
            cf[:, 6:7].to(tdt).repeat(1, n), z(torch.int32), z(tdt))


SWEEP_NAMES = ("prev_t", "cum", "oob", "cv_sum", "cv_sum_sq", "prewarm",
               "unload_at", "cold", "waste")


def assert_sweep_equal(got, want, what: str) -> float:
    """All nine outputs torch.equal; returns the largest difference (0)."""
    import torch
    worst = 0.0
    for name, g, w in zip(SWEEP_NAMES, got, want):
        if not torch.equal(g, w):
            diff = (g.double() - w.double()).abs()
            raise AssertionError(f"{what}: {name} differs in "
                                 f"{int((diff > 0).sum())} elements, max "
                                 f"{float(diff.max())}")
        worst = max(worst, float((g.double() - w.double()).abs().max()))
    return worst


def scan_parity(cols, device):
    """The scan kernel against the step kernel iterated over the same event
    columns from the same state, torch.equal on all nine outputs: at the
    scale point (the trace's columns, S=1, 240 bins, the register form, 8
    bins a lane) and, on small random streams from a random mid-trace
    state (S=3), at each other form and layout: 60 bins (registers, 2 a
    lane), and 300 and 2,400 bins (columns, the step a column). Launches
    here do not count."""
    import torch
    from repro_torch.kernels import histogram as H

    ci, cf, n_bins = default_cfg_blocks(device)
    n = cols.shape[1]
    cases = []
    with uncounted(H):
        scan = H.fused_hybrid_sweep_scan(
            cols, *fresh_sweep_state(1, n, n_bins, cf, device), ci, cf)
        step = fresh_sweep_state(1, n, n_bins, cf, device)
        for t_now in cols:
            step = H.fused_hybrid_sweep_step(t_now, *step, ci, cf)
        torch.cuda.synchronize()
        worst = assert_sweep_equal(scan, step, "scan vs step (scale point)")
        cases.append(dict(S=1, n=n, n_bins=n_bins, width=cols.shape[0],
                          form=H.scan_form(n_bins)[0]))
        rng = np.random.default_rng(17)
        for S, n, nb in ((3, 20_000, 60), (3, 20_000, 300),
                         (3, 5_000, 2400)):
            form = H.scan_form(nb)[0]
            args = random_step_inputs(rng, S, n, nb, device)
            ci_s, cf_s = args[10], args[11]
            prev = args[1][0]
            gaps = torch.from_numpy(rng.uniform(
                0.0, 1.5 * nb, (16, n))).to(device)
            cols_s = torch.where(torch.isfinite(prev), prev, 0.0) + \
                torch.cumsum(gaps, 0)
            cols_s[torch.from_numpy(rng.uniform(size=(16, n)) < 0.25)
                   .to(device)] = np.inf
            step = [x.clone() for x in args[1:10]]
            for t_now in cols_s:
                step = H.fused_hybrid_sweep_step(t_now, *step, ci_s, cf_s)
            before = H.SCAN_LAUNCHES_BY_FORM[form]
            scan = H.fused_hybrid_sweep_scan(
                cols_s, *[x.clone() for x in args[1:10]], ci_s, cf_s)
            torch.cuda.synchronize()
            if H.SCAN_LAUNCHES_BY_FORM[form] != before + 1:
                raise AssertionError(f"n_bins={nb} did not take the {form} "
                                     f"form")
            worst = max(worst, assert_sweep_equal(
                scan, step, f"scan vs step ({form}, n_bins={nb})"))
            cases.append(dict(S=S, n=n, n_bins=nb, width=16, form=form))
    emit("scan_parity", cases=cases, outputs=len(SWEEP_NAMES),
         torch_equal=True)
    return worst


def random_factored_state(rng, blk, n, n_bins, device):
    """A mid-trace state of a sweep block: nondecreasing group rows with
    their Welford sums, OOB counts from none to heavy, a shared clock with
    apps not yet started, per-config bounds and counters; with event
    columns [16, n] from it (in-bounds, out-of-bounds and bin-edge gaps,
    25% without an event)."""
    import torch
    G, S = len(blk.g_n_bins), len(blk.c_window)
    counts = rng.integers(0, 3, (G, n, n_bins))
    counts[rng.uniform(size=(G, n)) < 0.2] = 0
    prev = rng.uniform(0.0, 500.0, n)
    prev[rng.uniform(size=n) < 0.2] = -np.inf
    load = np.where(rng.uniform(size=(S, n)) < 0.5, 0.0, rng.uniform(
        0.0, 30.0, (S, n)).astype(np.float32)).astype(np.float64)
    put = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(
        device)
    state = [put(prev, np.float64), put(np.cumsum(counts, -1), np.int32),
             put(rng.integers(0, 40, (G, n)), np.int32),
             put(counts.sum(-1), np.float64),
             put((counts ** 2).sum(-1), np.float64), put(load, np.float64),
             put(load + rng.uniform(0.0, 90.0, (S, n)).astype(np.float32),
                 np.float64),
             put(rng.integers(0, 9, (S, n)), np.int32),
             put(rng.uniform(0.0, 1e3, (S, n)), np.float64)]
    gaps = np.where(rng.uniform(size=(16, n)) < 0.6,
                    rng.integers(0, 2 * n_bins * 64, (16, n)) / 64.0,
                    rng.uniform(0.0, 3.0 * n_bins, (16, n)))
    cols = np.where(np.isfinite(prev), prev, 0.0) + np.cumsum(gaps, 0)
    cols[rng.uniform(size=(16, n)) < 0.25] = np.inf
    return state, put(cols, np.float64)


FACTORED_NAMES = ("prev_t", "gcum", "goob", "gcv_sum", "gcv_sum_sq",
                  "load_c", "unload_c", "cold", "waste", "consulted")


def factored_parity(device):
    """The factored scan kernel against the factored plain scan (on the
    card) and against the unfactored scan kernel over one histogram per
    config (registers form, the group state read through each config's
    group), torch.equal on all ten outputs, from a random mid-trace state:
    the sweep's 32-config grid at 60 bins (2 bins a lane, 1 config a lane),
    the same grid at 240 bins (8 bins a lane), a band of two groups (range
    60 at 1-minute bins with range 120 at 2-minute bins), a 70-config group
    (split in two, 2 configs a lane) and a ragged app count. Launches here
    do not count."""
    import torch
    from repro_torch.core import experiment as E
    from repro_torch.core import simulator as sim
    from repro_torch.interop import sweep_block_from_numpy
    from repro_torch.kernels import histogram as H

    def two_groups(E):
        return [E.HybridSpec(range_minutes=r, bin_minutes=b,
                             cv_threshold=cv, head_percentile=h,
                             tail_percentile=t, min_samples=ms,
                             use_arima=False)
                for (r, b) in ((60.0, 1.0), (120.0, 2.0))
                for cv in (1.0, 2.0) for (h, t) in ((0.0, 100.0),
                                                   (5.0, 99.0))
                for ms in (2, 5)]

    def wide(E):
        return [E.HybridSpec(range_minutes=60.0, cv_threshold=float(cv),
                             margin=m, use_arima=False)
                for cv in np.linspace(0.25, 3.0, 35) for m in (0.1, 0.2)]

    cases = (("grid32", sweep_grid, 20_000, (2, 1, False)),
             ("grid32_240", lambda E: sweep_grid(E, 240.0), 20_000,
              (8, 1, False)),
             ("two_groups", two_groups, 20_000, (2, 1, False)),
             ("wide70", wide, 5_000, (2, 2, True)),
             ("ragged", sweep_grid, 777, (2, 1, False)))
    rng = np.random.default_rng(23)
    out = []
    with uncounted(H):
        for name, make, n, (bpl, cpl, split) in cases:
            cfgs = [sp.to_config() for sp in make(E)]
            n_bins = cfgs[0].histogram.n_bins
            host = sim._sweep_block_host(cfgs)
            ids = sim._sweep_identities(host)
            plan = H.factored_scan_plan(host, ids, n_bins, device)
            blk = sweep_block_from_numpy(host, device=device)
            got_form = (plan.form, plan.bins_per_lane, plan.configs_per_lane,
                        plan.layout.k_group is not None)
            if got_form != ("factored", bpl, cpl, split):
                raise AssertionError(f"factored_parity {name}: plan "
                                     f"{got_form}")
            state, cols = random_factored_state(rng, blk, n, n_bins, device)
            n = cols.shape[1]
            before = H.SCAN_LAUNCHES_BY_FORM["factored"]
            got = H.fused_hybrid_sweep_scan_factored(
                cols, *[x.clone() for x in state], blk=blk, ids=ids,
                plan=plan)
            torch.cuda.synchronize()
            if H.SCAN_LAUNCHES_BY_FORM["factored"] != before + 1:
                raise AssertionError(f"factored_parity {name}: no factored "
                                     f"launch")
            want = H.fused_hybrid_sweep_scan_factored_plain(
                cols, *[x.clone() for x in state], blk=blk, ids=ids)
            for field, g, w in zip(FACTORED_NAMES, got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"factored_parity {name}: {field} "
                                         f"!= the factored plain scan's")
            # the unfactored kernel, a histogram per config
            c_group = blk.w_group.long()[blk.c_window.long()]
            S = len(cfgs)
            ci, cf = (torch.from_numpy(x).to(device)
                      for x in sim._build_cfg_blocks(cfgs))
            bm = torch.tensor([c.histogram.bin_minutes for c in cfgs],
                              dtype=torch.float64, device=device)
            per_cfg = [state[0].expand(S, n).contiguous()] + \
                [x[c_group].contiguous() for x in state[1:5]] + \
                [x.clone() for x in state[5:9]]
            form = H.scan_form(n_bins)[0]
            before = H.SCAN_LAUNCHES_BY_FORM[form]
            flat = H.fused_hybrid_sweep_scan(cols, *per_cfg, ci, cf,
                                             bin_minutes=bm)
            torch.cuda.synchronize()
            if H.SCAN_LAUNCHES_BY_FORM[form] != before + 1:
                raise AssertionError(f"factored_parity {name}: no {form} "
                                     f"launch")
            for k, field in enumerate(FACTORED_NAMES):
                g = got[k]
                if field == "prev_t":
                    g = g.expand(S, n)
                elif k in (1, 2, 3, 4):
                    g = g[c_group]
                if not torch.equal(g, flat[k]):
                    raise AssertionError(f"factored_parity {name}: {field} "
                                         f"!= the {form} scan's per config")
            out.append(dict(case=name, configs=S, groups=len(blk.g_n_bins),
                            n=n, n_bins=n_bins, bins_per_lane=bpl,
                            configs_per_lane=cpl, split=split,
                            kernel_groups=len(plan.layout.grp_i32),
                            searches=len(plan.layout.search_i32),
                            consulted=int(got[9].sum()),
                            cold=int(got[7].sum())))
    emit("factored_parity", cases=out, outputs=len(FACTORED_NAMES),
         torch_equal=True)


def sweep_work(cols, bin_minutes, n_bins):
    """From the data: the (app, column) pairs with an event, and the bins
    their suffix adds write (idle times in bounds), over the columns."""
    import torch
    active = written = 0.0
    prev = torch.full((cols.shape[1],), -np.inf, dtype=torch.float64,
                      device=cols.device)
    for t_now in cols.double():
        valid = torch.isfinite(t_now)
        rec = valid & torch.isfinite(prev)
        q = torch.floor((t_now - prev) / bin_minutes)
        inb = rec & (q < n_bins)
        written += float(torch.where(inb, n_bins - q.clamp(0, n_bins - 1),
                                     0.0).sum())
        active += int(valid.sum())
        prev = torch.where(valid, t_now, prev)
    return active, written


def time_scan_factored(trace, device):
    """For ``times_scan``: the factored scan kernel's ms per replay of the
    sweep trace (the 32-config grid's band, every app and column in one
    launch from the initial carry; CUDA events, mean of 5), the factored
    plain scan's, the unfactored register-form kernel over one histogram
    per config (the same work as the port carried it before; beside it,
    not a yardstick), and the bound from the data: the columns read once,
    the group and per-config state read and written once, against the
    least operations (per app and column with an event: each distinct
    percentile search a binary search, about 15 operations per group for
    its bin, counts and Welford sums, 8 per window variant for its float32
    window, 9 per gate variant for the CV and the gate, 13 per config for
    its verdict, waste and selection; one add per suffix bin written)."""
    import torch
    from repro_torch.core import experiment as E
    from repro_torch.core import simulator as sim
    from repro_torch.interop import sweep_block_from_numpy
    from repro_torch.kernels import histogram as H

    cfgs = [sp.to_config() for sp in sweep_grid(E)]
    n_bins = cfgs[0].histogram.n_bins
    host = sim._sweep_block_host(cfgs)
    ids = sim._sweep_identities(host)
    plan = H.factored_scan_plan(host, ids, n_bins, device)
    blk = sweep_block_from_numpy(host, device=device)
    cols = sweep_columns(trace, device)
    width, n = cols.shape
    S, G = len(cfgs), len(blk.g_n_bins)
    W, T = len(blk.w_group), len(blk.t_group)
    c_group = blk.w_group.long()[blk.c_window.long()]
    ci, cf = (torch.from_numpy(x).to(device)
              for x in sim._build_cfg_blocks(cfgs))
    bm = torch.tensor([c.histogram.bin_minutes for c in cfgs],
                      dtype=torch.float64, device=device)

    def timed(call, fresh, reps):
        ms = []
        for _ in range(reps):
            state = fresh()
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            call(state)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return sum(ms) / len(ms)

    fresh = lambda: sim._initial_sweep_carry(blk, n, n_bins, torch.float64)
    kernel = lambda st: H.fused_hybrid_sweep_scan_factored(
        cols, *st, blk=blk, ids=ids, plan=plan)
    plain = lambda st: H.fused_hybrid_sweep_scan_factored_plain(
        cols, *st, blk=blk, ids=ids)

    def fresh_flat():
        st = fresh()
        return [st[0].expand(S, n).contiguous()] + \
            [x[c_group].contiguous() for x in st[1:5]] + list(st[5:9])
    flat = lambda st: H.fused_hybrid_sweep_scan(cols, *st, ci, cf,
                                                bin_minutes=bm)
    with uncounted(H):
        timed(kernel, fresh, 1)                          # warm-up
        kernel_ms = timed(kernel, fresh, 5)
        timed(flat, fresh_flat, 1)
        registers_ms = timed(flat, fresh_flat, 5)
        for g, w in zip(kernel(fresh()), plain(fresh())):
            if not torch.equal(g, w):
                raise AssertionError("times_scan_factored: the timed kernel "
                                     "replay != the plain replay")
    plain_ms = timed(plain, fresh, 1)

    active, written = sweep_work(cols, float(cfgs[0].histogram.bin_minutes),
                                 n_bins)
    searches = int(plan.layout.search_i32.shape[0])
    ops = (searches * 2 * (math.ceil(math.log2(n_bins)) + 1) + 15 * G
           + 8 * W + 9 * T + 13 * S) * active + written
    nbytes = (8 * width * n + 2 * 8 * n
              + 2 * G * n * (4 * n_bins + 4 + 8 + 8)
              + 2 * S * n * (8 + 8 + 4 + 8) + S * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    return dict(configs=S, groups=G, window_variants=W, gate_variants=T,
                searches=searches, n=n,
                n_bins=n_bins, columns=width,
                bins_per_lane=plan.bins_per_lane,
                configs_per_lane=plan.configs_per_lane,
                kernel_ms=kernel_ms, plain_ms=plain_ms,
                registers_ms=registers_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, bytes_bound_ms=bytes_ms,
                operations=ops, ops_bound_ms=ops_ms,
                active_app_columns=active)


def time_kernel(cols, device):
    """Step kernel and plain-version ms per launch over the event columns
    ``cols`` [width, n] float64 (CUDA events), and the bound those columns
    give; also the operations summed over the columns, which bound the
    scan of the same work."""
    import torch
    from repro_torch.kernels import histogram as H

    tdt = cols.dtype
    ci, cf, n_bins = default_cfg_blocks(device)
    S, n = 1, cols.shape[1]
    fresh = lambda: fresh_sweep_state(S, n, n_bins, cf, device)

    def replay(step):
        step(cols[0], *fresh(), ci, cf)                  # warm-up
        torch.cuda.synchronize()
        state, total_ms = fresh(), 0.0
        for t_now in cols:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            state = step(t_now, *state, ci, cf)
            b.record()
            b.synchronize()
            total_ms += a.elapsed_time(b)
        return total_ms / cols.shape[0], state

    with uncounted(H):
        kernel_ms, k_state = replay(H.fused_hybrid_sweep_step)
    plain_ms, p_state = replay(H.fused_hybrid_sweep_step_plain)
    for g, w in zip(k_state, p_state):
        if not torch.equal(g, w):
            raise AssertionError("timed kernel replay != plain replay")

    # Least bytes each launch must move: the event column, the 8 [S, n]
    # states read and written (6 in the time dtype, 2 int32), the config
    # blocks, the cum rows of apps with an event read, and the suffix of
    # each recorded bin written. Least operations: per row with an event,
    # the two percentile searches (cum never decreases and
    # MAX_SCALED_COUNT keeps cum * PCT_SCALE from wrapping, so each is a
    # binary search of ceil(log2 n_bins) + 1 compares), one add per suffix
    # bin written, and about 40 scalar operations (verdict, Welford update,
    # windows, gate).
    tb = cols.element_size()
    per_state = S * n * (6 * tb + 2 * 4)
    search = 2 * (math.ceil(math.log2(n_bins)) + 1)
    active, written = sweep_work(cols, float(cf[0, 2]), n_bins)
    launches = cols.shape[0]
    bytes_total = (launches * (tb * n + 2 * per_state + 44 * S)
                   + 4 * n_bins * S * active + 4 * S * written)
    ops_total = S * ((search + 40) * active + written)
    bytes_ms = bytes_total / launches / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_total / launches / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    all_rows_ms = (tb * n + 2 * per_state + 44 * S + 8 * n_bins * S * n) \
        / HBM_BYTES_PER_S * 1e3
    emit("times", shape=[S, n, n_bins],
         launches_timed=launches, kernel_ms_per_launch=kernel_ms,
         plain_ms_per_launch=plain_ms, bound_ms_per_launch=bound_ms,
         bound_by=bound_by, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
         bound_all_rows_ms=all_rows_ms, library_ms=None,
         library_note="no single PyTorch call computes this step")
    return dict(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, ops_total=ops_total, launches=launches)


def time_scan(cols, device, step, sweep_trace):
    """The scan kernel's ms per scale replay (one launch over every column,
    from the initial carry; CUDA events, mean of 5), the plain scan's, and
    the bound of the same work: the columns read once and the nine state
    tensors read once and written once (cum included) against the least
    operations of the steps, summed over the columns (``step`` is
    time_kernel's); the factored kernel over the same one-config block
    (:func:`time_scan_factored_single`); and the factored form at the
    sweep point (:func:`time_scan_factored` over ``sweep_trace``)."""
    import torch
    from repro_torch.kernels import histogram as H

    ci, cf, n_bins = default_cfg_blocks(device)
    S, (width, n) = 1, cols.shape

    def timed(scan, reps):
        ms = []
        for _ in range(reps):
            state = fresh_sweep_state(S, n, n_bins, cf, device)
            torch.cuda.synchronize()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            scan(cols, *state, ci, cf)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        return sum(ms) / len(ms)

    with uncounted(H):
        timed(H.fused_hybrid_sweep_scan, 1)              # warm-up
        kernel_ms = timed(H.fused_hybrid_sweep_scan, 5)
    plain_ms = timed(H.fused_hybrid_sweep_scan_plain, 1)
    tb = cols.element_size()
    states = S * n * (6 * tb + 2 * 4) + 4 * S * n * n_bins
    nbytes = tb * width * n + 2 * states + 44 * S
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = step["ops_total"] / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    single = time_scan_factored_single(cols, device)
    factored = time_scan_factored(sweep_trace, device)
    out = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, factored=factored)
    emit("times_scan", shape=[S, n, n_bins], columns=width,
         form=H.scan_form(n_bins)[0], kernel_ms_per_replay=kernel_ms,
         plain_ms_per_replay=plain_ms, bound_ms_per_replay=bound_ms,
         bound_by=bound_by, bytes=nbytes, bytes_bound_ms=bytes_ms,
         operations=step["ops_total"], ops_bound_ms=ops_ms,
         step_ms_per_replay=step["kernel_ms"] * width,
         step_launches_per_replay=width, library_ms=None,
         library_note="no single PyTorch call computes this scan",
         factored_single=single, factored=factored)
    return out


def time_scan_factored_single(cols, device):
    """For ``times_scan``: the factored kernel over the scale point's
    columns with the one-config block of the default policy (its plan made
    with no identity flags, so the host picks ``factored`` where the
    engine picks ``registers``), ms per replay (CUDA events, mean of 5,
    after a warm-up), beside the ``registers`` replay timed in the same
    loop; every output of the two must be equal."""
    import torch
    from repro_torch.core import policy_math as pm
    from repro_torch.core import simulator as sim
    from repro_torch.core.policy import HybridConfig
    from repro_torch.interop import sweep_block_from_numpy
    from repro_torch.kernels import histogram as H

    host = sim._sweep_block_host([HybridConfig(use_arima=False)])
    n_bins = int(host.g_n_bins[0, 0])
    width, n = cols.shape
    forced = H.factored_scan_plan(host, pm.SweepIdentities(), n_bins,
                                  device)
    ids = sim._sweep_identities(host)
    engine = H.factored_scan_plan(host, ids, n_bins, device)
    if (forced.form, engine.form) != ("factored", "registers"):
        raise AssertionError(f"times_scan factored_single: plans "
                             f"{forced.form}, {engine.form}")
    blk = sweep_block_from_numpy(host, device=device)
    fresh = lambda: sim._initial_sweep_carry(blk, n, n_bins, torch.float64,
                                             ids)
    run = lambda plan, st: H.fused_hybrid_sweep_scan_factored(
        cols, *st, blk=blk, ids=ids, plan=plan)
    ms = {"factored": [], "registers": []}
    with uncounted(H):
        outs = {form: run(plan, fresh()) for form, plan in
                (("factored", forced), ("registers", engine))}
        for field, g, w in zip(FACTORED_NAMES, outs["factored"],
                               outs["registers"]):
            if not torch.equal(g, w):
                raise AssertionError(f"times_scan factored_single: {field} "
                                     f"differs between the two forms")
        del outs
        for _ in range(5):
            for form, plan in (("factored", forced), ("registers", engine)):
                st = fresh()
                torch.cuda.synchronize()
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                run(plan, st)
                b.record()
                b.synchronize()
                ms[form].append(a.elapsed_time(b))
    return dict(configs=1, n=n, n_bins=n_bins, columns=width,
                bins_per_lane=forced.bins_per_lane,
                configs_per_lane=forced.configs_per_lane,
                kernel_ms=sum(ms["factored"]) / 5,
                registers_ms=sum(ms["registers"]) / 5,
                kernel_ms_each=ms["factored"],
                registers_ms_each=ms["registers"])


class uncounted:
    """Timing launches do not count: the launch counters of a kernel
    module (its integer LAUNCHES counts and its LAUNCHES_BY_FORM dicts)
    are put back as they were on exit."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.saved = {k: (dict(v) if isinstance(v, dict) else v)
                      for k, v in vars(self.mod).items()
                      if "LAUNCHES" in k and isinstance(v, (int, dict))}

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if isinstance(v, dict):
                getattr(self.mod, k).update(v)
            else:
                setattr(self.mod, k, v)


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_times(calls):
    """Device ms (CUDA-graph replay) of one scaled_dot_product_attention
    call per variant in ``calls`` ({name: (fn, reps)}): unpinned (the
    backend PyTorch picks, "default") and with each backend pinned in turn
    (torch.nn.attention.sdpa_kernel); a backend that refuses the call is
    recorded with its reason. Returns (times {variant: {backend: ms or
    reason}}, the fastest call (ms, variant, backend or "default"))."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.timing import graph_ms

    times, best = {}, None
    for name, (fn, reps) in calls.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            times[name] = {"default": graph_ms(fn, reps, 2)}
        if best is None or times[name]["default"] < best[0]:
            best = (times[name]["default"], name, "default")
        for be in SDPA_BACKENDS:
            try:
                with sdpa_kernel([getattr(SDPBackend, be)]), \
                        warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    ms = graph_ms(fn, reps if be != "MATH" else 1, 2)
            except RuntimeError as e:
                times[name][be] = f"refused: {str(e).splitlines()[0][:80]}"
                continue
            times[name][be] = ms
            if best is None or ms < best[0]:
                best = (ms, name, be)
    return times, best


def time_attention(device, a, seed):
    """The attention kernel at one serving path's shape ``a`` (k and v
    views of a longer cache for the dense model, as its prefill passes
    them), by CUDA-graph replay (device only) and per call with its host
    work; its plain version; and scaled_dot_product_attention computing the
    same function (timed here only; the port never calls it): the boolean
    band mask, and is_causal where there is no window, each backend pinned
    in turn; the fastest accepted call is the yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.timing import graph_ms, launch_ms

    B, S, Hq, Hkv, D, W = (a[k] for k in ("B", "S", "Hq", "Hkv", "D", "W"))
    extra = SERVE_NEW if W == 0 else 0
    q, k, v = attention_inputs(B, S + extra, Hq, Hkv, D, torch.bfloat16,
                               device, seed=seed)
    q, k, v = q[:, :S].contiguous(), k[:, :S], v[:, :S]
    form = FA._form(q, k, v)
    run = lambda: FA.flash_attention(q, k, v, window=W)
    with uncounted(FA):
        kernel_ms = graph_ms(run, 10)
        kernel_call_ms = launch_ms(run, 10)
        plain_ms = launch_ms(
            lambda: FA.flash_attention_plain(q, k, v, window=W), 3)
    i = torch.arange(S, device=device)
    band = i[None, :] <= i[:, None]
    if W:
        band &= i[None, :] > i[:, None] - W
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    calls = {"band_mask": (lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=band, enable_gqa=True), 10)}
    if not W:
        calls["is_causal"] = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    lib, best = sdpa_times(calls)
    # live (query, key) pairs per (b, h): sum over i of min(i + 1, W)
    pairs = sum(min(r + 1, W) if W else r + 1 for r in range(S))
    ops = 4.0 * B * Hq * D * pairs
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    out = dict(shape=[B, S, Hq, Hkv, D], window=W, dtype="bfloat16",
               form=form, kernel_ms=kernel_ms,
               timed_by="CUDA graph replay (device only)",
               kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
               library_ms=best[0], library_call=best[1],
               library_backend=best[2], library_ms_by_backend=lib,
               live_pairs_per_head=pairs, operations=ops, bytes=nbytes,
               bound_ms=bound_ms, bound_by=bound_by, ops_bound_ms=ops_ms,
               bytes_bound_ms=bytes_ms, share_of_bound=bound_ms / kernel_ms,
               cuda_core_ops_bound_ms=ops / F32_CUDA_CORE_OPS_PER_S * 1e3)
    emit("times_attention", **out)
    return out


def time_rglru(device, ptxas):
    """The scan kernel at the path's width over a 4,096-step prompt: device
    ms a call by CUDA-graph replay (``kernel_ms``) and ms a call with the
    wrapper's host work (``call_ms``, the measure of earlier runs), its
    plain version, the bytes the kernel moves beside the bound's, a
    PyTorch product that moves the same bytes as a yardstick, and its
    registers and spills; no single PyTorch call computes this
    recurrence."""
    import torch
    from repro_torch.kernels import rglru_scan as R
    from repro_torch.kernels.timing import graph_ms, launch_ms

    B, L, D = RGLRU_SHAPE
    b_in, a = rglru_inputs(B, L, D, device, seed=31)
    form = R._form(D, b_in.data_ptr(), a.data_ptr())
    run = lambda: R.rglru_scan(b_in, a)
    with uncounted(R):
        # three of each in turns, the median kept: on an H100 a graph
        # replay of this kernel spread by up to 10% between repeats
        graph, call = [], []
        for _ in range(3):
            graph.append(graph_ms(run, 20))
            call.append(launch_ms(run, 20))
        kernel_ms, call_ms = sorted(graph)[1], sorted(call)[1]
        plain_ms = launch_ms(lambda: R.rglru_scan_plain(b_in, a), 5)
    # a yardstick, not the same function: one PyTorch product a * b_in
    # moves the scan's bytes (reads both, writes one array like h), so its
    # rate is what the card streams for this pattern
    prod = torch.empty_like(a)
    yard_ms = graph_ms(lambda: torch.mul(a, b_in, out=prod), 20)
    # a and b_in read once, h and h_last written once; ~6 operations per
    # element are far below the bytes. The kernel reads a and b_in once and
    # writes h and h_last once, in one launch with no scratch: it moves
    # exactly these bytes.
    nbytes = 4 * (3 * B * L * D + B * D)
    moved = nbytes
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    emit("times_rglru", shape=[B, L, D], form=form, kernel_ms=kernel_ms,
         timed_by="CUDA graph replay (device only), median of 3",
         graph_ms_runs=graph, call_ms=call_ms, call_ms_runs=call,
         plain_ms=plain_ms, bytes=nbytes, bytes_moved=moved,
         bytes_moved_over_bound=moved / nbytes, bound_ms=bound_ms,
         bound_by="bytes", share_of_bound=bound_ms / kernel_ms,
         achieved_bytes_per_s=moved / (kernel_ms * 1e-3),
         yardstick_mul_ms=yard_ms,
         yardstick_bytes_per_s=3 * 4 * B * L * D / (yard_ms * 1e-3),
         library_ms=None,
         library_note="no single PyTorch call computes this recurrence",
         launches_per_request=RGLRU_PER_PREFILL,
         ptxas=ptxas["rglru_scan"])
    return kernel_ms, call_ms, plain_ms, bound_ms


def time_ssd(device):
    """The SSD kernel at the Mamba-2 serving path's shape (bf16 x, B and C
    as views into the conv output): device ms a call by CUDA-graph replay
    (``kernel_ms``), ms a call with the wrapper's host work
    (``call_ms``), device ms by kernel (``pass_device_ms``), and its plain
    version; no single PyTorch call computes this scan."""
    import torch
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.kernels.timing import (graph_ms, launch_ms, pass_ms,
                                            ssd_inputs)

    s = SSD_SHAPE
    b, l, h, p, n, Q = (s[k] for k in ("b", "l", "h", "p", "n", "chunk"))
    x, dt, A, B, C = ssd_inputs(b, l, h, p, n, torch.bfloat16, device, 50,
                                True)
    run = lambda: SS.ssd_scan(x, dt, A, B, C, chunk=Q)
    with uncounted(SS):
        call_ms = launch_ms(run, 20)
        kernel_ms = graph_ms(run, 20)
        passes = pass_ms(run)
    plain_ms = launch_ms(lambda: SS.ssd_scan_plain(x, dt, A, B, C, Q), 3)
    # Least operations: C_i . B_j for the live pairs j <= i of each chunk
    # once per batch row, the masked product with x over the same pairs and
    # C S_in and the chunk states (2 q n p each) per head. Least bytes: x, B
    # and C (bf16), dt and A read once, y (bf16) and the final state (f32)
    # written once.
    lens = [min(Q, l - c) for c in range(0, l, Q)]
    pairs = sum(q * (q + 1) // 2 for q in lens)
    ops = 2.0 * b * pairs * n + b * h * (2.0 * pairs * p + 4.0 * l * n * p)
    es = x.element_size()
    nbytes = es * (2 * b * l * h * p + 2 * b * l * n) + \
        4 * (b * l * h + h + b * h * n * p)
    ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    emit("times_ssd", shape=[b, l, h, p], n=n, chunk=Q, dtype="bfloat16",
         kernel_ms=kernel_ms, call_ms=call_ms, pass_device_ms=passes,
         plain_ms=plain_ms, operations=ops,
         bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
         ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms,
         cuda_core_ops_bound_ms=ops / F32_CUDA_CORE_OPS_PER_S * 1e3,
         library_ms=None,
         library_note="no single PyTorch call computes this scan",
         launches_per_request=SSD_PER_PREFILL)
    return kernel_ms, plain_ms, bound_ms, bound_by


def time_decode(device, d=DECODE_SHAPE,
                per_request=QWEN2_DECODE_PER_REQUEST):
    """The decode kernel at a serving shape ``d`` (bf16, the full 4,112-row
    cache: Qwen2-7B's by default) with ``kv_len`` on the device, as the
    serve engine's graph launches it, beside the host-int form it replaced
    (timed in turns: host, device, device, host), its plain version, and
    scaled_dot_product_attention with enable_gqa, with the boolean kv_len
    mask and without one (the same function at kv_len = Skv), each SDPA
    backend pinned in turn (timed here
    only; the port never calls it; the fastest accepted call is the
    yardstick). Each call reads one of eight caches in turn (135 MB, more
    than the 50 MB L2), as a decode step finds each layer's cache cold.
    Times are device time by CUDA-graph replay (the ``ms`` this script
    reports) and, for the kernel, its plain version and the unmasked
    library call, per call run back to back with the host's work (both are
    host-bound there, so that time compares the wrappers, not the
    kernels)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels.timing import graph_ms, launch_ms

    B, Hq, Hkv, D, Skv = (d[k] for k in ("B", "Hq", "Hkv", "D", "Skv"))
    kv_len = Skv
    bufs = [decode_inputs(B, Skv, Hq, Hkv, D, torch.bfloat16, device,
                          seed=80 + i) for i in range(8)]
    turn = [0]

    def cycled(fn):
        def call():
            q, k, v = bufs[turn[0] % len(bufs)]
            turn[0] += 1
            return fn(q, k, v)
        return call

    mask = (torch.arange(Skv, device=device) < kv_len)[None, None, None]
    sdpa = lambda q, k, v, **kw: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True, **kw)
    # the main path's form reads kv_len from the device (the serve engine's
    # graph); the host-int form it replaced is timed beside it, in turns
    kv_dev = torch.full((), kv_len, dtype=torch.int64, device=device)
    calls = {
        "kernel": (cycled(lambda q, k, v: DA.decode_attention(
            q, k, v, kv_dev)), 200),
        "kernel_host_kv_len": (cycled(lambda q, k, v: DA.decode_attention(
            q, k, v, kv_len)), 200),
        "plain": (cycled(lambda q, k, v: DA.decode_attention_plain(
            q, k, v, kv_dev)), 24)}
    with uncounted(DA):
        turns = {"kernel": [], "kernel_host_kv_len": []}
        for name in ("kernel_host_kv_len", "kernel", "kernel",
                     "kernel_host_kv_len"):
            turns[name].append(graph_ms(*calls[name]))
        device_ms = {k: statistics.mean(v) for k, v in turns.items()}
        device_ms["plain"] = graph_ms(*calls["plain"])
        call_ms = {k: launch_ms(fn, reps) for k, (fn, reps) in calls.items()}
        # the kernel at other split lengths (the wrapper's is SPLIT_KEYS)
        split_ms, chosen = {}, DA.SPLIT_KEYS
        try:
            for keys in DECODE_SPLIT_KEYS_TIMED:
                DA.SPLIT_KEYS = keys
                split_ms[keys] = graph_ms(calls["kernel"][0], 200)
        finally:
            DA.SPLIT_KEYS = chosen
    # the library call: the kv_len mask, and no mask (the same function
    # here, where kv_len is the whole cache), each backend pinned in turn
    lib, best = sdpa_times({
        "kv_len_mask": (cycled(lambda q, k, v: sdpa(q, k, v,
                                                     attn_mask=mask)), 100),
        "no_mask": (cycled(sdpa), 100)})
    library_call_ms = launch_ms(cycled(sdpa), 100)
    # Least bytes: K and V up to kv_len read once, q read and the output
    # written once (bf16). Least operations: q.k and p.v for every live key
    # of every q head.
    nbytes = 2 * (2 * B * kv_len * Hkv * D + 2 * B * Hq * D)
    ops = 4.0 * B * Hq * kv_len * D
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    kernel_ms, plain_ms = device_ms["kernel"], device_ms["plain"]
    out = dict(shape=[B, Skv, Hq, Hkv, D], kv_len=kv_len, dtype="bfloat16",
               form=DA._form(*bufs[0]), split_keys=chosen,
               kernel_ms=kernel_ms, kv_len_on="device",
               kernel_ms_turns=turns["kernel"],
               host_kv_len_ms=device_ms["kernel_host_kv_len"],
               host_kv_len_ms_turns=turns["kernel_host_kv_len"],
               host_kv_len_call_ms=call_ms["kernel_host_kv_len"],
               kernel_ms_by_split_keys=split_ms,
               plain_ms=plain_ms, library_ms=best[0], library_call=best[1],
               library_backend=best[2], library_ms_by_backend=lib,
               timed_by="CUDA graph replay (device only)",
               kernel_call_ms=call_ms["kernel"],
               plain_call_ms=call_ms["plain"],
               library_call_ms=library_call_ms,
               bytes=nbytes, operations=ops, bound_ms=bound_ms,
               bound_by=bound_by, bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
               share_of_bound=bound_ms / kernel_ms,
               cuda_core_ops_bound_ms=ops / F32_CUDA_CORE_OPS_PER_S * 1e3,
               launches_per_request=per_request)
    emit("times_decode", **out)
    return out


def time_policy_update(columns, device, ptxas):
    """The policy-update kernel and its plain version over the scale
    trace's ticks replayed from an empty fleet: ms a tick per call (CUDA
    events around each call, ``kernel_ms``) and device ms a tick back to
    back (one event pair around all the ticks, issued without a wait,
    ``back_to_back_ms``); the bound those ticks give; the kernel's
    registers and spills. No single PyTorch call computes this tick."""
    import torch
    from repro_torch.core import policy_math
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels.timing import launch_ms

    def replay(tick, per_call):
        tick(*fresh_policy_state(columns[0][0].shape[0], device),
             *columns[1])                                  # warm-up
        state = fresh_policy_state(columns[0][0].shape[0], device)
        torch.cuda.synchronize()
        total_ms = 0.0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for bins, active in columns:
            if per_call:
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
            out = tick(*state, bins, active)
            if per_call:
                b.record()
                b.synchronize()
                total_ms += a.elapsed_time(b)
            state = out[:5]
        end.record()
        end.synchronize()
        if not per_call:
            total_ms = start.elapsed_time(end)
        return total_ms / len(columns), out

    with uncounted(H):
        kernel_ms, got = replay(H.policy_update, True)
        back_ms, again = replay(H.policy_update, False)
        plain_ms, want = replay(H.policy_update_plain, True)
    for g, w, x in zip(got, want, again):
        if not (torch.equal(g, w) and torch.equal(x, w)):
            raise AssertionError("timed policy_update replay != plain replay")
    # a yardstick, not the same function: one PyTorch copy of the counts
    # (each byte read and written once) gives the card's streaming rate
    copy = torch.empty_like(got[0])
    copy_ms = launch_ms(lambda: copy.copy_(got[0]), 10)
    del copy

    # Least bytes a tick must move: each row's counts up to the later of
    # its two percentile bins (the whole row where a threshold is not
    # reached), the one recorded count written, and 52 bytes of vectors
    # (oob, total, cv_sum, cv_sum_sq, bins, active read; oob, total, both
    # sums, both windows and the gate written). Least operations: a scan
    # add and two scaled compares (a multiply and a compare each) per bin
    # read, and about 40 scalar operations a row.
    n = columns[0][0].shape[0]
    iota = torch.arange(POLICY_BINS, device=device, dtype=torch.int32)
    counts = torch.zeros((n, POLICY_BINS), dtype=torch.int32, device=device)
    total = torch.zeros(n, dtype=torch.int32, device=device)
    bytes_total = ops_total = 0.0
    for bins, active in columns:
        in_b = (active != 0) & (bins >= 0) & (bins < POLICY_BINS)
        counts += (iota == bins[:, None]) & in_b[:, None]
        total += in_b.to(torch.int32)
        cum = torch.cumsum(counts, dim=1, dtype=torch.int32)
        found = [policy_math.first_bin_ge_scaled(
            cum, policy_math.percentile_threshold_scaled(total, pct),
            gather=True) for pct in (5.0, 99.0)]
        read = float((torch.maximum(*found).clamp(max=POLICY_BINS - 1) + 1)
                     .sum())
        bytes_total += 4 * read + 4 * int(in_b.sum()) + 52 * n
        ops_total += 5 * read + 40 * n
    bytes_ms = bytes_total / len(columns) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_total / len(columns) / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    all_rows_ms = (4 * n * POLICY_BINS + 52 * n) / HBM_BYTES_PER_S * 1e3
    emit("times_policy_update", shape=[n, POLICY_BINS],
         form=H._policy_form(POLICY_BINS, got[0].data_ptr()),
         ticks_timed=len(columns), kernel_ms_per_tick=kernel_ms,
         back_to_back_ms_per_tick=back_ms, plain_ms_per_tick=plain_ms,
         bound_ms_per_tick=bound_ms, bound_by=bound_by,
         share_of_bound_per_call=bound_ms / kernel_ms,
         share_of_bound_back_to_back=bound_ms / back_ms,
         bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
         bound_all_rows_read_ms=all_rows_ms,
         # at 240 bins the kernel reads every row whole (one 256-bin tile)
         streamed_bytes_per_s_back_to_back=(4 * n * POLICY_BINS + 52 * n)
         / (back_ms * 1e-3),
         yardstick_copy_ms=copy_ms,
         yardstick_bytes_per_s=8 * n * POLICY_BINS / (copy_ms * 1e-3),
         library_ms=None,
         library_note="no single PyTorch call computes this tick",
         ptxas=ptxas["policy_update"])
    return kernel_ms, back_ms, plain_ms, bound_ms, bound_by


def launch_serve(device):
    """``repro_torch.launch.serve.main`` on the card (the vector engine,
    phase B through the sweep-step kernel) at each of ``SERVE_CLI_RUNS``
    under both policies. Gate: each run prints the same lines as the same
    run with ``--engine scalar`` (the per-event oracle). Returns the step
    launches of the vector runs and the failed gates."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import histogram as H
    from repro_torch.launch import serve as serve_cli

    def main(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_cli.main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"launch.serve.main({argv}) returned {rc}")
        return buf.getvalue(), time.perf_counter() - t0

    runs, failed, launches = [], [], 0
    for apps, minutes in SERVE_CLI_RUNS:
        for policy in SERVE_CLI_POLICIES:
            argv = ["--apps", str(apps), "--minutes", str(minutes),
                    "--policy", policy, "--device", str(device)]
            reset_counts(H)
            got, got_s = main(argv)
            steps = H.LAUNCHES
            launches += steps
            with uncounted(H):
                want, want_s = main(argv + ["--engine", "scalar"])
            same = got == want
            if not same:
                failed.append(f"launch_serve {apps} apps {minutes:g} min "
                              f"{policy}: the vector run printed {got!r}, "
                              f"the oracle {want!r}")
            runs.append({"apps": apps, "minutes": minutes, "policy": policy,
                         "seconds": got_s, "oracle_seconds": want_s,
                         "step_launches": steps, "equal": same,
                         "lines": got.splitlines()})
    if launches == 0:
        failed.append("launch_serve: the vector runs made no step-kernel "
                      "launch (phase B of the hybrid policy runs it)")
    emit("launch_serve", runs=runs, step_launches=launches,
         gates_failed=failed)
    return launches, failed


def _sdpa_train_ms(device, cfg, batch):
    """Device ms of the plain attention (``layers._sdpa``, f32 inside) at
    one layer's training shape: forward, and forward + backward, by CUDA
    events over 3 calls after a warm-up."""
    import torch
    from repro_torch.models import layers as L

    g = torch.Generator(device=device).manual_seed(7)
    S, hd = TRAIN_SEQ, cfg.hd
    mk = lambda h: torch.randn(batch, S, h, hd, device=device, generator=g,
                               dtype=torch.bfloat16).requires_grad_(True)
    q, k, v = mk(cfg.n_heads), mk(cfg.n_kv_heads), mk(cfg.n_kv_heads)
    dy = torch.randn(batch, S, cfg.n_heads, hd, device=device, generator=g,
                     dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            L._sdpa(q, k, v, causal=True, window=0)

    def fwd_bwd():
        out = L._sdpa(q, k, v, causal=True, window=0)
        torch.autograd.grad(out, (q, k, v), dy)

    out = {}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / 3
    return out


def train_smollm(device, kernel_mods):
    """Train full-width SmolLM-135M on the card through the launcher's path
    (``launch.train.run``: ``train_loop.train``, and ``run_with_restarts``
    under ``--fault-at-step``), bf16 compute, fp32 AdamW masters, remat,
    ``use_kernels=False`` (the reference trains so; its Pallas path has no
    backward). Gates: (a) every loss finite and the last below the first
    by ``TRAIN_MIN_DROP``; (b) the first step's loss and gradient norm in
    bf16 within 2% and 5% of the same step in f32; (c) the restarted run
    (fault after step 10, a checkpoint every 10) gives steps 11-20 the
    uninterrupted run's losses bit for bit; (d) a grad-enabled
    ``flash_attention`` on the card raises. Returns each kernel module's
    launches during training (none) and the failed gates."""
    import dataclasses
    import shutil
    import torch
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import to_device

    cfg = configs.get(TRAIN_ARCH)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--device", str(device)]
    failed, logs = [], []

    # the uninterrupted run, every kernel's count at 0 before it
    reset_counts(*kernel_mods)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = train_cli.run(argv, log=logs.append)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {f"{mod.__name__.rsplit('.', 1)[-1]}.{k}": v
                for mod in kernel_mods for k, v in vars(mod).items()
                if k.endswith("LAUNCHES") and isinstance(v, int)}
    if any(launches.values()):
        failed.append(f"train_smollm: the training path launched kernels "
                      f"{launches}; it runs use_kernels=False")
    losses = run["losses"]
    # gate (a)
    drop = losses[0] - losses[-1]
    if not all(math.isfinite(x) for x in losses) or drop < TRAIN_MIN_DROP:
        failed.append(f"train_smollm (a): losses {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}, a drop of {drop:.4f} < "
                      f"{TRAIN_MIN_DROP}")

    # gate (b): the first step in bf16 and in f32, from the same draw
    batch = to_device(data.batch_at(0, cfg, shape,
                                    batch_override=TRAIN_BATCH), device)
    ocfg = opt.OptConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    first = {}
    for name, c in (("bf16", cfg), ("f32", cfg.with_(dtype="float32"))):
        model = build(c)
        state = opt.init_state(model.init(0, device))
        step = make_train_step(model, ocfg)
        state, met = step(state, batch)
        first[name] = (float(met["loss"]), float(met["grad_norm"]))
        if name == "bf16":
            # one more step, profiled: device ms by class and kernel
            names = {}
            prof = device_ms(lambda: step(state, batch), names=names)
        del state, step
    (lb, gb), (lf, gf) = first["bf16"], first["f32"]
    if abs(lb - lf) > TRAIN_F32_LOSS_RTOL * abs(lf) or \
            abs(gb - gf) > TRAIN_F32_GNORM_RTOL * abs(gf):
        failed.append(f"train_smollm (b): step 1 bf16 loss {lb:.5f} gnorm "
                      f"{gb:.5f}, f32 {lf:.5f} {gf:.5f}")

    # gate (c): the restarted run, checkpoint save and restore timed
    ckdir = os.path.join(ROOT, "build", "train_smollm_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    timed = {"save": [], "restore": []}
    originals = {k: getattr(ckpt, k) for k in timed}

    def timing(name):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = originals[name](*a, **kw)
            torch.cuda.synchronize()
            timed[name].append(time.perf_counter() - t)
            return out
        return wrapped
    try:
        for name in timed:
            setattr(ckpt, name, timing(name))
        t0 = time.perf_counter()
        restarted = train_cli.run(argv + [
            "--checkpoint-dir", ckdir, "--checkpoint-every",
            str(TRAIN_CKPT_EVERY), "--fault-at-step", str(TRAIN_FAULT)],
            log=logs.append)
        restart_s = time.perf_counter() - t0
    finally:
        for name, fn in originals.items():
            setattr(ckpt, name, fn)
        shutil.rmtree(ckdir, ignore_errors=True)
    if restarted["attempts"] != 2 or \
            restarted["resumed_from"] != TRAIN_FAULT or \
            restarted["losses"] != losses[TRAIN_FAULT:]:
        failed.append(f"train_smollm (c): {restarted['attempts']} attempts, "
                      f"resumed from {restarted['resumed_from']}, losses "
                      f"{restarted['losses']} against "
                      f"{losses[TRAIN_FAULT:]}")

    # gate (d): a kernel asked to differentiate refuses on the card
    q = torch.zeros(1, 128, 9, 64, device=device, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.zeros(1, 128, 3, 64, device=device, dtype=torch.bfloat16)
    launched, refused = FA.LAUNCHES, None
    try:
        FA.flash_attention(q, kv, kv)
        failed.append("train_smollm (d): a grad-enabled flash_attention "
                      "call on the card did not raise")
    except RuntimeError as e:
        refused = str(e)
    if FA.LAUNCHES != launched:
        failed.append("train_smollm (d): the refused call launched")

    attn = _sdpa_train_ms(device, cfg, TRAIN_BATCH)
    steady = sorted(run["step_seconds"][1:])
    step_s = steady[len(steady) // 2]
    prof_ms = sum(prof.values()) if prof else None
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    emit("train_smollm", arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=TRAIN_STEPS, lr=TRAIN_LR, losses=losses,
         loss_drop=drop, step_seconds=run["step_seconds"],
         step_seconds_median=step_s,
         tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_s,
         run_seconds=run_s, peak_device_bytes=peak,
         first_step={"bf16": first["bf16"], "f32": first["f32"],
                     "bf16_equals_run": lb == losses[0]},
         restart={"attempts": restarted["attempts"],
                  "resumed_from": restarted["resumed_from"],
                  "losses": restarted["losses"], "seconds": restart_s,
                  "save_seconds": timed["save"],
                  "restore_seconds": timed["restore"]},
         refused=refused,
         profile_device_ms=prof, profile_top_kernels_ms=top,
         idle_share=(1.0 - prof_ms / 1e3 / step_s) if prof_ms else None,
         attention_layer_ms=attn,
         attention_ms_per_step=cfg.n_layers * (attn["fwd"]
                                               + attn["fwd_bwd"]),
         kernel_launches=launches, log=logs, gates_failed=failed)
    return launches, failed


def start_dryrun():
    """Start the dry-run's cells (``repro_torch.launch.dryrun``, on the
    fake process group, on the host: ``CUDA_VISIBLE_DEVICES=""``) in one
    worker process. It starts after the timed serve and train phases and
    is waited for before the kernels are timed, so that its host work
    overlaps no measurement. Returns (process, path of its JSONL
    results)."""
    out_dir = os.path.join(ROOT, "src", "repro_torch", "kernels", "build",
                           "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cells.jsonl")
    if os.path.exists(path):
        os.remove(path)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    calls = [["--arch", a, "--shape", s, "--out", path]
             + (["--multi-pod"] if multi else [])
             for multi, a, s in DRYRUN_CELLS]
    code = ("import sys, json; from repro_torch.launch import dryrun; "
            "sys.exit(max(dryrun.main(a) for a in json.loads(sys.argv[1])))")
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(calls)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), path


def dryrun_phase(job):
    """The dry-run's cells: Qwen2-7B train_4k and decode_32k on the 16 x 16
    mesh, decode_32k on 2 x 16 x 16; per device (rank 0 of the fake group)
    the argument and peak bytes against the card's 80 GB, FLOPs, collective
    bytes, and the host seconds. Runs on the host; the line says so. Fails
    if a cell failed."""
    proc, path = job
    try:
        out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(f"dryrun: not done in {DRYRUN_TIMEOUT} s")
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("OK", "FAIL", "SKIP"))]
    if proc.returncode != 0:
        raise AssertionError(f"dryrun: exit {proc.returncode}: {lines} "
                             f"{out[-2000:]}")
    with open(path) as f:
        cells = [json.loads(ln) for ln in f]
    if len(cells) != len(DRYRUN_CELLS):
        raise AssertionError(f"dryrun: {len(cells)} cells, want "
                             f"{len(DRYRUN_CELLS)}: {lines}")
    from repro_torch.launch.mesh import HBM_BYTES
    emit("dryrun", runs_on="host (fake process group, FakeTensorMode; no "
         "device memory)", card_hbm_bytes=HBM_BYTES, cells=[{
             "mesh": c["mesh"], "arch": c["arch"], "shape": c["shape"],
             "argument_bytes": c["argument_size"],
             "peak_bytes": c["peak_bytes"],
             "argument_share_of_hbm": c["argument_size"] / HBM_BYTES,
             "peak_share_of_hbm": c["peak_share_of_hbm"],
             "flops": c["flops"], "collective_bytes": c["collective_bytes"],
             "collectives": c["collectives"],
             "host_seconds": c["seconds"]} for c in cells], lines=lines)
    return cells


def mesh_train(device):
    """The ZeRO train step on the card: a one-rank NCCL process group, a
    (1, 1) ``("data", "model")`` ``DeviceMesh``, full-width SmolLM-135M,
    ``MESH_TRAIN_STEPS`` steps with the masters and moments as DTensors in
    ``opt_specs`` placements (``grad_shardings``), cast_bf16 off and on,
    each against the same seed's unsharded steps. Gates: losses and final
    masters bit-equal (nothing is split on one rank, so every local op is
    the unsharded op), then ``save``, ``resharded_restore`` onto a fresh
    (1, 1) mesh and ``verify_roundtrip(atol=0)`` with every leaf
    ``torch.equal``. Returns the failed gates."""
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.runtime import elastic
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import data
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_loop import to_device

    cfg = configs.get(TRAIN_ARCH)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=TRAIN_SEQ)
    batches = [to_device(data.batch_at(i, cfg, shape,
                                       batch_override=TRAIN_BATCH),
                         device) for i in range(MESH_TRAIN_STEPS)]
    ocfg = opt.OptConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS)
    model = build(cfg)
    rdzv = os.path.join(ROOT, "build", "mesh_train_rdzv")
    os.makedirs(os.path.dirname(rdzv), exist_ok=True)
    if os.path.exists(rdzv):
        os.remove(rdzv)
    ckdir = os.path.join(ROOT, "build", "mesh_train_ckpt")
    failed, runs = [], {}
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(model_parallel=1)

        def run(cast, sharded):
            state = opt.init_state(model.init(0, device))
            kw = {}
            if sharded:
                specs = shd.opt_specs(state.params, mesh, cfg)
                state = shd.distribute_state(state, mesh, specs)
                kw["grad_shardings"] = shd.named(specs, mesh)
            step = make_train_step(model, ocfg, cast_bf16=cast, **kw)
            losses, secs = [], []
            torch.cuda.reset_peak_memory_stats()
            for b in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, b)
                loss = met["loss"]
                losses.append(float(loss.full_tensor() if sharded else loss))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            return state, losses, secs, torch.cuda.max_memory_allocated()

        for cast in (False, True):
            plain, pl, ps, p_peak = run(cast, False)
            zero, zl, zs, z_peak = run(cast, True)
            diffs = {n: float((shd.full(p.detach()) - q.detach()).abs().max())
                     for (n, p), (_, q) in zip(
                         zero.params.named_parameters(),
                         plain.params.named_parameters())}
            equal = all(torch.equal(shd.full(p.detach()), q.detach())
                        for (_, p), (_, q) in zip(
                            zero.params.named_parameters(),
                            plain.params.named_parameters()))
            runs[f"cast_bf16={cast}"] = {
                "losses_zero": zl, "losses_plain": pl,
                "losses_bit_equal": zl == pl, "masters_bit_equal": equal,
                "max_master_diff": max(diffs.values()),
                "step_seconds_zero": zs, "step_seconds_plain": ps,
                "step_seconds_zero_median": statistics.median(zs[1:]),
                "step_seconds_plain_median": statistics.median(ps[1:]),
                "peak_bytes_zero": z_peak, "peak_bytes_plain": p_peak,
                "placement": str(next(zero.params.parameters()).placements)}
            if zl != pl or not equal:
                failed.append(f"mesh_train cast_bf16={cast}: ZeRO losses "
                              f"{zl} against {pl}, masters bit-equal "
                              f"{equal} (max diff {max(diffs.values())})")
            del plain
        # save from the ZeRO state of the last run, restore onto a fresh mesh
        shutil.rmtree(ckdir, ignore_errors=True)
        t0 = time.perf_counter()
        ckpt.save(ckdir, MESH_TRAIN_STEPS, zero)
        save_s = time.perf_counter() - t0
        fresh = make_host_mesh(model_parallel=1)
        template = opt.init_state(model.init(1, device))
        t0 = time.perf_counter()
        restored = elastic.resharded_restore(ckdir, MESH_TRAIN_STEPS,
                                             template, fresh, cfg)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ok = elastic.verify_roundtrip(zero, restored, atol=0.0)
        exact = all(torch.equal(shd.full(a), shd.full(b)) for a, b in zip(
            [p.detach() for p in zero.params.parameters()]
            + list(zero.m.values()) + list(zero.v.values()),
            [p.detach() for p in restored.params.parameters()]
            + list(restored.m.values()) + list(restored.v.values())))
        if not (ok and exact and restored.step == MESH_TRAIN_STEPS):
            failed.append(f"mesh_train: restore roundtrip {ok}, every leaf "
                          f"equal {exact}, step {restored.step}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
        dist.destroy_process_group()
        if os.path.exists(rdzv):
            os.remove(rdzv)
    emit("mesh_train", arch=TRAIN_ARCH, mesh="(1, 1) data x model, NCCL",
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=MESH_TRAIN_STEPS,
         runs=runs, save_seconds=save_s, restore_seconds=restore_s,
         roundtrip=ok, roundtrip_bit_equal=exact, gates_failed=failed)
    return failed


def _gloo_cuda_rank(rank, world, rdzv, out_dir):
    """One gloo rank on the card: try each collective the distributed
    decode and the pipeline issue on CUDA tensors; write what gloo said."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                            world_size=world)
    said = {}
    x = torch.ones(8, device="cuda")
    path = os.path.join(out_dir, f"rank{rank}.json")
    for name in GLOO_CUDA_COLLECTIVES:
        # written before each try: gloo may abort the process inside one
        said[name] = "started; the process ended inside it"
        with open(path, "w") as f:
            json.dump(said, f)
        try:
            if name == "all_reduce_sum":
                dist.all_reduce(x, op=dist.ReduceOp.SUM)
            elif name == "all_reduce_max":
                dist.all_reduce(x, op=dist.ReduceOp.MAX)
            else:
                buf = torch.empty_like(x)
                peer = 1 - rank
                for req in dist.batch_isend_irecv(
                        [dist.P2POp(dist.isend, x, peer),
                         dist.P2POp(dist.irecv, buf, peer)]):
                    req.wait()
            torch.cuda.synchronize()
            said[name] = "accepted"
        except Exception as e:  # noqa: BLE001 — gloo's refusal is the result
            said[name] = f"refused: {type(e).__name__}: {str(e)[:200]}"
    with open(path, "w") as f:
        json.dump(said, f)
    dist.destroy_process_group()


def dist_ranks():
    """Two gloo ranks on the one card (NCCL refuses two ranks on one GPU):
    the distributed decode and the pipeline run there only if gloo takes
    CUDA tensors for every collective they issue (all-reduce SUM and MAX;
    send/recv). Asks gloo, and leaves the phase out, with gloo's answers on
    its line, where it refuses one (the port does not stage through the
    host to make it run)."""
    import multiprocessing as mp
    out_dir = os.path.join(ROOT, "build", "gloo_cuda")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    rdzv = os.path.join(out_dir, "rdzv")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_cuda_rank, args=(r, 2, rdzv, out_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    said = {}
    for r in range(2):
        path = os.path.join(out_dir, f"rank{r}.json")
        said[f"rank{r}"] = (json.load(open(path)) if os.path.exists(path)
                            else "no answer")
    refused = sorted({k for v in said.values() if isinstance(v, dict)
                      for k, a in v.items() if a != "accepted"}
                     | ({"all"} if any(not isinstance(v, dict)
                                       for v in said.values()) else set()))
    if not refused:
        raise AssertionError("dist_ranks: gloo took CUDA tensors for every "
                             "collective; the phase's comparisons belong "
                             "here now")
    emit("dist_ranks", ran=False, left_out="gloo refuses CUDA tensors for "
         + ", ".join(refused), gloo_said=said)


def lint_phase() -> None:
    """The port's invariant linter over ``src/repro_torch``, in-process.
    Prints the files, findings, suppressed findings and seconds; raises on
    any finding (the run then ends without a result)."""
    from repro_torch.analysis import ALL_RULES, run_paths
    t0 = time.perf_counter()
    report = run_paths([os.path.join(ROOT, "src", "repro_torch")],
                       ALL_RULES)
    seconds = time.perf_counter() - t0
    counts = report["counts"]
    emit("lint", files=counts["files"], findings=counts["findings"],
         suppressed=counts["suppressed"], seconds=seconds,
         first_findings=[f.render() for f in report["findings"][:20]])
    if report["findings"] or counts["files"] < 80:
        raise AssertionError(
            f"lint: {counts['findings']} finding(s) in {counts['files']} "
            f"file(s) of src/repro_torch")


def tf32_gates() -> list:
    """The runtime side of the linter's TF32 rule: after every phase, no
    float32 product may run in TF32. Returns the failed gates."""
    import torch
    state = {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
             "float32_matmul_precision":
                 torch.get_float32_matmul_precision()}
    emit("tf32", **state)
    failed = [f"tf32: {k} is on" for k in ("matmul_allow_tf32",
                                           "cudnn_allow_tf32") if state[k]]
    if state["float32_matmul_precision"] != "highest":
        failed.append("tf32: float32 matmul precision is "
                      f"{state['float32_matmul_precision']!r}")
    return failed


def release_host_memory():
    """Hand the pinned host memory of the serving phases that ended back to
    the system: PyTorch's pinned allocator keeps freed blocks cached, and
    the two Qwen2-7B host stores need 69 GB of pinned memory of the
    machine's 101 GB on their own, the two OLMoE-1B-7B ones 55 GB."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is None:
        raise RuntimeError("this PyTorch has no torch._C._host_emptyCache: "
                           "the pinned memory of the earlier serving phases "
                           "cannot be handed back before the Qwen2-7B phase")
    empty()


def main() -> int:
    # deterministic cuBLAS products for train_smollm's bit-exact restart,
    # set before the first CUDA call creates cuBLAS's handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device only", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import histogram as H
    from repro_torch.kernels import rglru_scan as R
    from repro_torch.kernels import ssd_scan as SS
    device = torch.device("cuda")
    # the plain versions' f32 products in full f32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    lint_phase()
    built = build.build_all()
    ptxas = {stem: build.ptxas_summary(b["log"]) for stem, b in built.items()}
    emit("build", **{stem: {"seconds": b["seconds"], "kernels": ptxas[stem]}
                     for stem, b in built.items()})
    # the example twins' CPU runs, in worker processes from here on
    jobs = start_cpu_examples()
    atexit.register(stop_cpu_examples, jobs)
    for stem, names in NO_SPILL_KERNELS.items():
        for name in names:
            got = ptxas[stem].get(name)
            if got is None or got["spill_bytes"] != 0:
                raise AssertionError(f"{stem}: {name} must build with no "
                                     f"spills, ptxas says {got}")

    max_err = kernel_parity(np.random.default_rng(0), device)
    event_stream_parity(device)
    attn_err = attention_parity(device)
    rglru_err = rglru_parity(device)
    ssd_err = ssd_parity(device)
    decode_err = decode_parity(device)
    trace, launches, launches_by_form, e2e = scale_point(device)
    sweep_cols = sweep_columns(trace, device)
    max_err = max(max_err, scan_parity(sweep_cols, device))
    factored_parity(device)
    t_policy = time.perf_counter()
    policy_launches, policy_err, policy_cols = policy_update_parity(
        trace, device)
    policy_s = time.perf_counter() - t_policy
    sweep_trace, sweep_launches, sweep_by_form = policy_sweep(device)
    spes_s = spes_point(trace, device)
    t_arima = time.perf_counter()
    arima_step_launches = arima_point(device)
    arima_s = time.perf_counter() - t_arima
    t_fleet = time.perf_counter()
    fleet_step_launches = fleet_point(device)
    fleet_s = time.perf_counter() - t_fleet
    failed = []                 # the later phases' gates
    t_phase = time.perf_counter()
    failed += reference_engine(trace, device)
    reference_s = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    scaleout_scan, scaleout_step, f = scaleout(trace, device)
    scaleout_s = time.perf_counter() - t_phase
    failed += f
    t_phase = time.perf_counter()
    examples_scan, examples_step, f = examples(device, jobs)
    examples_s = time.perf_counter() - t_phase
    failed += f
    t_cli = time.perf_counter()
    cli_step_launches, f = launch_serve(device)
    launch_serve_s = time.perf_counter() - t_cli
    failed += f
    t_serve = time.perf_counter()
    serve_launches, serve_forms, n_requests, f = serve(
        device, "serve", "recurrentgemma-2b", "rg2b",
        {"flash_attention": (FA, ATTN_PER_PREFILL),
         "rglru_scan": (R, RGLRU_PER_PREFILL)}, SERVE_LOGITS_REL_TOL)
    serve_s = time.perf_counter() - t_serve
    failed += f
    t_serve = time.perf_counter()
    mamba_launches, _, n_mamba, f = serve(
        device, "serve_mamba2", "mamba2-2.7b", "m2",
        {"ssd_scan": (SS, SSD_PER_PREFILL)}, SERVE_MAMBA2_LOGITS_REL_TOL)
    serve_mamba_s = time.perf_counter() - t_serve
    failed += f
    release_host_memory()
    t_serve = time.perf_counter()
    qwen2_launches, qwen2_forms, n_qwen2, f = serve(
        device, "serve_qwen2", "qwen2-7b", "q7",
        {"flash_attention": (FA, QWEN2_ATTN_PER_REQUEST),
         "decode_attention": (DA, QWEN2_DECODE_PER_REQUEST)},
        SERVE_QWEN2_LOGITS_REL_TOL, decode_steps=SERVE_QWEN2_DECODE_STEPS)
    serve_qwen2_s = time.perf_counter() - t_serve
    failed += f
    release_host_memory()
    t_serve = time.perf_counter()
    olmoe_launches, olmoe_forms, n_olmoe, f = serve(
        device, "serve_olmoe", "olmoe-1b-7b", "ol",
        {"flash_attention": (FA, OLMOE_ATTN_PER_REQUEST),
         "decode_attention": (DA, OLMOE_DECODE_PER_REQUEST)},
        SERVE_MOE_LOGITS_REL_TOL, decode_steps=SERVE_QWEN2_DECODE_STEPS,
        init="depth_scaled")
    serve_olmoe_s = time.perf_counter() - t_serve
    failed += f
    release_host_memory()
    t_serve = time.perf_counter()
    seamless_launches, seamless_forms, n_seamless, f = serve(
        device, "serve_seamless", "seamless-m4t-medium", "sm",
        {"flash_attention": (FA, SEAMLESS_ATTN_PER_REQUEST),
         "decode_attention": (DA, SEAMLESS_DECODE_PER_REQUEST)},
        SERVE_ENCDEC_LOGITS_REL_TOL, decode_steps=SERVE_QWEN2_DECODE_STEPS)
    serve_seamless_s = time.perf_counter() - t_serve
    failed += f
    release_host_memory()
    t_train = time.perf_counter()
    train_launches, f = train_smollm(device, (H, FA, DA, R, SS))
    train_s = time.perf_counter() - t_train
    failed += f
    release_host_memory()
    # the multi-device layers: the ZeRO step on a one-rank mesh (no kernel
    # of the port launches there, as in train_smollm), the dry-run's cells
    # from the host, and whether gloo can carry two ranks on the card
    reset_counts(H, FA, DA, R, SS)
    t_phase = time.perf_counter()
    failed += mesh_train(device)
    mesh_train_s = time.perf_counter() - t_phase
    mesh_launches = {f"{m.__name__.rsplit('.', 1)[-1]}.{k}": v
                     for m in (H, FA, DA, R, SS) for k, v in vars(m).items()
                     if k.endswith("LAUNCHES") and isinstance(v, int)}
    if any(mesh_launches.values()):
        failed.append(f"mesh_train launched kernels {mesh_launches}")
    release_host_memory()
    # the dry-run's host worker, while dist_ranks asks gloo (neither timed)
    dry_job = start_dryrun()
    atexit.register(stop_cpu_examples, {"dryrun": dry_job})
    t_phase = time.perf_counter()
    dist_ranks()
    dist_ranks_s = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    dryrun_phase(dry_job)
    dryrun_wait_s = time.perf_counter() - t_phase
    # time the step and the scan on the scale trace's columns, as the main
    # path ran them
    step = time_kernel(sweep_cols, device)
    scan = time_scan(sweep_cols, device, step, sweep_trace)
    del sweep_trace
    del sweep_cols
    fa_rg = time_attention(device, ATTN_SHAPE, seed=30)
    fa_qw = time_attention(device, QWEN2_ATTN_SHAPE, seed=31)
    fa_ol = time_attention(device, OLMOE_ATTN_SHAPE, seed=32)
    fa_sm = time_attention(device, SEAMLESS_ATTN_SHAPE, seed=33)
    rg_ms, rg_call_ms, rg_plain_ms, rg_bound_ms = time_rglru(device, ptxas)
    ssd_ms, ssd_plain_ms, ssd_bound_ms, ssd_bound_by = time_ssd(device)
    da = time_decode(device)
    da_ol = time_decode(device, OLMOE_DECODE_SHAPE, OLMOE_DECODE_PER_REQUEST)
    da_sm = time_decode(device, SEAMLESS_DECODE_SHAPE,
                        SEAMLESS_DECODE_PER_REQUEST)
    pu_ms, pu_back_ms, pu_plain_ms, pu_bound_ms, pu_bound_by = \
        time_policy_update(policy_cols, device, ptxas)

    csrc = "src/repro_torch/kernels/csrc/"
    print(json.dumps({"kernels": [{
        # the main path runs the scan (one launch per chunk and band);
        # ms, plain_ms and bound_ms per scale replay (the registers form);
        # the factored form at the sweep point beside it; the step, the
        # per-column counterpart of the TPU kernel, per launch
        "name": "fused_hybrid_sweep_scan", "route": "cuda",
        "source": csrc + "hybrid_sweep_step.cu",
        "replaces": "src/repro/kernels/histogram.py:245",
        "train_launches": train_launches["histogram.SCAN_LAUNCHES"],
        "launches": launches + sweep_launches + scaleout_scan
        + examples_scan,
        "launches_by_path": {"scale_point": launches,
                             "sweep": sweep_launches,
                             "scaleout": scaleout_scan,
                             "examples": examples_scan},
        "launches_by_form": {k: launches_by_form[k] + sweep_by_form[k]
                             for k in sweep_by_form},
        "max_abs_err": max_err, "ms": scan["kernel_ms"],
        "plain_ms": scan["plain_ms"], "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"], "library_ms": None,
        "factored": {"launches": sweep_by_form["factored"],
                     **{k: scan["factored"][k] for k in (
                         "kernel_ms", "plain_ms", "registers_ms",
                         "bound_ms", "bound_by")},
                     "library_ms": None},
        # the step runs on the ARIMA post-pass's rescan and on the fleet
        # simulation's phase B, once per column of each chunk
        "step": {"name": "fused_hybrid_sweep_step",
                 "launches": arima_step_launches + fleet_step_launches
                 + scaleout_step + examples_step + cli_step_launches,
                 "launches_by_path": {"arima_point": arima_step_launches,
                                      "fleet_point": fleet_step_launches,
                                      "scaleout": scaleout_step,
                                      "examples": examples_step,
                                      "launch_serve": cli_step_launches},
                 "ms": step["kernel_ms"], "plain_ms": step["plain_ms"],
                 "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
                 "train_launches": train_launches["histogram.LAUNCHES"],
                 "launches_per_replay": step["launches"]}}, {
        "name": "flash_attention", "route": "cuda",
        "source": csrc + "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:104",
        "train_launches": train_launches["flash_attention.LAUNCHES"],
        # the serving paths' runs (RecurrentGemma's, Qwen2's, OLMoE's and
        # SeamlessM4T's prefills); ms, plain_ms, library_ms and bound_ms at
        # RecurrentGemma's shape, the others' beside them
        "launches": serve_launches["flash_attention"]
        + qwen2_launches["flash_attention"]
        + olmoe_launches["flash_attention"]
        + seamless_launches["flash_attention"],
        "launches_by_path": {"recurrentgemma": serve_forms["flash_attention"],
                             "qwen2": qwen2_forms["flash_attention"],
                             "olmoe": olmoe_forms["flash_attention"],
                             "seamless": seamless_forms["flash_attention"]},
        "max_abs_err": attn_err, "ms": fa_rg["kernel_ms"],
        "plain_ms": fa_rg["plain_ms"], "bound_ms": fa_rg["bound_ms"],
        "bound_by": fa_rg["bound_by"], "library_ms": fa_rg["library_ms"],
        "library_backend": fa_rg["library_backend"],
        **{name: {k: t[k] for k in (
            "kernel_ms", "plain_ms", "library_ms", "library_backend",
            "bound_ms", "bound_by")} for name, t in (
                ("qwen2", fa_qw), ("olmoe", fa_ol), ("seamless", fa_sm))}},
        {
        "name": "rglru_scan", "route": "cuda",
        "source": csrc + "rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:73",
        "train_launches": train_launches["rglru_scan.LAUNCHES"],
        # ms: device time a call by CUDA-graph replay; call_ms with the
        # wrapper's host work (what ms held before)
        "launches": serve_launches["rglru_scan"],
        "launches_by_form": serve_forms["rglru_scan"],
        "max_abs_err": rglru_err, "ms": rg_ms, "call_ms": rg_call_ms,
        "plain_ms": rg_plain_ms, "bound_ms": rg_bound_ms,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "ssd_scan", "route": "cuda",
        "source": csrc + "ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:84",
        "train_launches": train_launches["ssd_scan.LAUNCHES"],
        "launches": mamba_launches["ssd_scan"], "max_abs_err": ssd_err,
        "ms": ssd_ms, "plain_ms": ssd_plain_ms, "bound_ms": ssd_bound_ms,
        "bound_by": ssd_bound_by, "library_ms": None}, {
        "name": "decode_attention", "route": "cuda",
        "source": csrc + "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:96",
        "train_launches": train_launches["decode_attention.LAUNCHES"],
        # the serving paths' decode steps; ms, plain_ms, library_ms and
        # bound_ms at Qwen2's shape, OLMoE's and SeamlessM4T's beside them
        "launches": qwen2_launches["decode_attention"]
        + olmoe_launches["decode_attention"]
        + seamless_launches["decode_attention"],
        "launches_by_form": {form: sum(
            forms["decode_attention"][form] for forms in (
                qwen2_forms, olmoe_forms, seamless_forms))
            for form in qwen2_forms["decode_attention"]},
        "launches_by_path": {"qwen2": qwen2_forms["decode_attention"],
                             "olmoe": olmoe_forms["decode_attention"],
                             "seamless": seamless_forms["decode_attention"]},
        # ms with kv_len on the device (the main path's graph), the
        # host-int form it replaced beside it
        "max_abs_err": decode_err, "ms": da["kernel_ms"],
        "host_kv_len_ms": da["host_kv_len_ms"],
        "plain_ms": da["plain_ms"], "bound_ms": da["bound_ms"],
        "bound_by": da["bound_by"], "library_ms": da["library_ms"],
        "library_backend": da["library_backend"],
        **{name: {k: t[k] for k in (
            "kernel_ms", "host_kv_len_ms", "plain_ms", "library_ms",
            "library_backend", "bound_ms", "bound_by")} for name, t in (
                ("olmoe", da_ol), ("seamless", da_sm))}}, {
        "name": "policy_update", "route": "cuda",
        "source": csrc + "policy_update.cu",
        "replaces": "src/repro/kernels/histogram.py:128",
        "train_launches": train_launches["histogram.POLICY_UPDATE_LAUNCHES"],
        # ms a tick per call (events around each call); back to back
        # beside it (one event pair around the 64 ticks)
        "launches": policy_launches, "max_abs_err": policy_err,
        "ms": pu_ms, "back_to_back_ms": pu_back_ms,
        "plain_ms": pu_plain_ms, "bound_ms": pu_bound_ms,
        "bound_by": pu_bound_by, "library_ms": None}]}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start,
         scale_point_seconds=e2e["seconds"], serve_seconds=serve_s,
         serve_requests=n_requests, serve_mamba2_seconds=serve_mamba_s,
         serve_mamba2_requests=n_mamba, serve_qwen2_seconds=serve_qwen2_s,
         serve_qwen2_requests=n_qwen2, serve_olmoe_seconds=serve_olmoe_s,
         serve_olmoe_requests=n_olmoe,
         serve_seamless_seconds=serve_seamless_s,
         serve_seamless_requests=n_seamless, policy_update_seconds=policy_s,
         arima_point_phase_seconds=arima_s, spes_point_seconds=spes_s,
         fleet_point_phase_seconds=fleet_s,
         reference_engine_seconds=reference_s, scaleout_seconds=scaleout_s,
         examples_seconds=examples_s,
         launch_serve_seconds=launch_serve_s, train_smollm_seconds=train_s,
         mesh_train_seconds=mesh_train_s, dryrun_wait_seconds=dryrun_wait_s,
         dist_ranks_seconds=dist_ranks_s)
    failed += tf32_gates()
    if failed:
        # every phase ran and printed its line; a failed gate fails the run
        emit("failed", gates=failed)
        print("chip_smoke: " + "; ".join(failed), file=sys.stderr)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
