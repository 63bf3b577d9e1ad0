#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, any failure of which exits non-zero before the result line:

  1. device — require CUDA, print versions and the card's name and power
     limit, force IEEE f32 (TF32 off) in cuBLAS and cuDNN;
  2. build — compile the three CUDA kernels from ``src/repro_torch/csrc``
     (one ``nvcc`` per source and per variant of its kernels, all started
     together); no object may report spill stores;
  3. kernels against their plain versions — every distinct forward
     geometry of full-width DCGAN and V-Net, served (batch 4) and trained
     (DCGAN generator and discriminator at batch 64), of the full-width
     GP-GAN and 3D-GAN generators at batch 4, of 3D-GAN's GAN train
     step (generator and discriminator at batch 32) and of the sharded
     path (V-Net at 2 per rank, the DCGAN chain's channel shards at batch
     4, DCGAN's GAN at 32 per rank), in f32 and bf16,
     plus groups, dilation, rank 1, K=5/S=1 and scale+leaky_relu cases;
     then the forward block's code paths, each in f32 and bf16, run twice
     for the same bits: a geometry split by the planner and forced
     unsplit, scalar copies (Ci 1, 3, 6; Co 2, 3), ragged rows and
     channel tiles, groups whose Cig is not a multiple of 4, forced
     splits; and bf16 x bf16 with f32 output at reduction depths 864,
     3,456 and 4,096, unsplit and split, run twice for the same bits and
     held against float64 of the same bf16 operands (within 5e-5 of max
     |y|); and bf16 x bf16 launches that stage each box's input
     footprint once (igemm_bf16_halo_kernel), where the planner chooses
     it and forced where it keeps the gather (stride-2 phases of 1-8
     taps, ragged boxes, groups of 8 channels, dilation 2, 2-D), against
     the plain version and, with f32 output, float64, each launch's
     reported staging the planner's; then the backward: dw and both dx routes at every training
     geometry (DCGAN generator and discriminator at batch 64, V-Net at
     batch 4, 3D-GAN's at batch 32), f32 and bf16 operands, against the
     plain versions summed in float64,
     and a conv's dx over input rows no tap reads (exactly zero there),
     also with its reduction forced into slices; then the dw kernel's
     code paths, each in f32 and bf16, run twice for the same bits: every
     tile with 16-byte and scalar copies of each operand, groups, both
     store layouts, lo at B's edges, dilation 2, stride 2 reading past
     B's extent, forced splits of 1, 4 and 16 beside the planner's;
     then the int8 operands of the forward kernels: every distinct
     geometry of the quantized serving path with int8 weights beside f32
     activations and beside bf16 ones (the TF32 route) and with int8
     activations and weights (the s8 tensor-core route, K-major weights),
     and the block's code paths (16-byte and scalar copies, and the s8
     route's 16-, 4- and 1-byte A copies, forced and no splits, groups,
     dilation, scale + leaky_relu), each launch run twice for the same
     bits and held against the plain version summed in float64 (s8:
     within 1e-6, its sums exact; f32 x int8: within 5e-5); every forward
     launch's record names the kernel the C entry reports it launched,
     and its passes (f32 x f32: igemm_kernel, the CUDA cores' FMAs; bf16
     x bf16: igemm_bf16_kernel, mma.sync m16n8k16 on the bf16 tensor
     cores, or igemm_bf16_halo_kernel; f32 x int8: igemm_tf32_kernel in
     two passes; bf16 x int8: igemm_tf32_kernel in one; int8 x int8:
     igemm_s8_kernel), checked per launch and over the run, with the run's
     launches by staging (both stagings must run);
  4. serve — a ``DcnnServer`` answers 8 DCGAN seeds and 4 V-Net volumes at
     full width through the kernels (launch counts checked per batch), and
     one request of each model is held against the port's CPU run;
     serve (quantized) — the same requests again under
     ``Precision(weight_quant="int8")`` and with ``act_quant="int8"``,
     weights from ``quant.quantize_weights``, launch counts and each
     launch's operand types checked per batch, one request of each model
     held against the port's CPU run of its served batch (with int8
     activations that is a CPU run fed the card's int8 activations; a
     free CPU run is reported with its rounding-tie flips per layer),
     every output reported against the f32 one;
     train — ``Trainer`` runs 3 DCGAN steps (batch 64) and 2 V-Net steps
     (batch 4, 128x128x64), the last after a resume from a checkpoint in a
     temporary directory; losses finite, launches per step exactly those
     ``launch.steps.train_step_launches`` derives from the graphs; one
     DCGAN step's gradients (batch 4) held against the port's CPU run,
     and again against a CPU run fed the card's forward outputs, with the
     relu/leaky_relu mask flips between card and CPU counted; one DCGAN
     generator step through int8 weights (``{"w_q", "scale"}`` entries,
     the scales trained) at batch 4, its launches those of a train step,
     its gradients held against the port's CPU run; the serve phases also
     check that every result was served by ``"pallas"`` and no bucket fell
     back;
     sharded — the multi-GPU path on ``torch.distributed``, its ranks
     spawned (``torch.multiprocessing``, a ``file://`` rendezvous) after
     the build, all on device 0: one rank over NCCL serves V-Net
     data-parallel at batch 4 and runs two int8-compressed DP GAN steps of
     DCGAN at batch 64; two ranks sharing the card over gloo (collectives
     staged through the host, so no time there is NCCL's) serve V-Net at
     2 per rank (the gathered shards within 1e-4 of max |y| of the
     unsharded engine), run the full-width DCGAN generator chain on a
     2-way model axis at batch 4 (within 1e-4 of the unsharded chain, each
     collective's bytes equal to the report's ``collective_bytes``), three
     DP GAN steps of DCGAN at 32 per rank with int8 and with f32
     all-reduce (final losses within 5e-2, params equal on both ranks after
     every step; the first f32 step's losses and AdamW first moment within
     1e-4 of the mean of one process's steps on each rank's shard, and
     within 1e-3 of its step on the whole batch of 64) and one DP V-Net
     train step at 2 per rank; every DP step's bytes handed to
     ``dist.all_reduce`` counted and held to its payload (the int8 path's
     int32 sum is 4 B per element, as f32's mean); one launch per
     layer node per rank, a train step's launches per step; a rank that
     raises, exits or runs over 300 s fails the phase;
     paper benchmarks — the full-width GP-GAN and 3D-GAN generators at
     batch 4 through ``models.dcnn.generator_forward`` on the kernels (4
     launches each, output finite, of the last layer's shape, within 3e-5
     of max |y| of the same generator on the ``xla`` lowering), then two
     GAN train steps of 3D-GAN at batch 32 through ``Trainer``: launches
     per step exactly ``train_step_launches``, losses finite;
     reference methods — ``compile_network`` of both full-width graphs at
     batch 4 on each reference lowering (``oom``, ``xla``, ``iom``,
     ``iom_phase``: cuDNN and plain tensor code), the serve phase's
     weights and inputs, within 3e-5 of max |y| of the kernels' output,
     with TF32 on in cuDNN and cuBLAS (the lowerings scope it off
     themselves), and a control run with that scope removed that must
     read above 3e-5 on every method; each method's cold batch, its batch after one warm
     batch (CUDA events) and its peak memory; under w:int8 and
     w:int8+a:int8 every layer on ``xla`` against the kernels, fed the
     same input, at 1e-4;
     serve (fallback) — a ``DcnnServer`` whose V-Net bucket fails on the
     kernels (a ``FaultScript`` of dispatch errors through the retries
     and the first probe): the degraded batches are served by ``"xla"``
     with 0 kernel launches and within 1e-4 of the un-faulted outputs,
     then ``fallbacks == 1``, a failed probe, ``recoveries == 1`` and the
     recovered batch's (4, 10) launches; then a compile failure degrades
     the bucket (``InjectedCompileError`` named), a NaN row is quarantined
     and the rest re-run, and both engines failing completes every
     request with a typed ``DispatchFailedError``;
     serve (LM) — the LM serving path at full width (``LM_SERVE``, one
     model after another, each freed before the next is built):
     llama3.2-1b, qwen2-vl-2b, xlstm-350m and whisper-tiny at full
     depth, zamba2-2.7b at 12 of 54 layers (two shared-block groups;
     cut for the script's time since the train (LM) phase), dbrx-132b at
     2 of 40 layers and arctic-480b at 1 of 35: seeded weights (the new
     five drawn on the card), the port's ``Server(max_batch=8,
     max_len=128)`` answering 8 requests of 4-16 tokens (16 new tokens
     each) on the card and on the CPU (arctic's CPU: the prefill and 2
     decode calls fed the card's tokens), with
     TF32 on in cuBLAS (the LM forward scopes IEEE f32 itself): prefill
     logits within the model's f32 tolerance of max |logit| of the CPU's
     (1e-4; xlstm-350m 1e-2, whose sLSTM recurrences move its logits
     2.4e-3 on the CPU when only the summation order changes:
     ``scripts/lm_noise_floor.py``), greedy tokens equal up to a first
     divergence whose CPU top-2 margin is within 1e-2 of max |logit|
     (compared no further), each decode call's logits up to that step
     within 1e-2 of max |logit| of the CPU's (bf16 rounding ties), each
     and with an f32 decode cache the same batch's tokens equal (for
     xlstm-350m up to a tie), its
     decode logits within the f32 tolerance and each CPU decode call also
     run on the card fed the CPU's cache, within 1e-4; a MoE routing decision
     that differs between the card and the CPU must be a tie (its k-th
     and (k+1)-th router probabilities within 1e-3), and the logits and
     tokens are compared up to the call before the first; the timed
     batches' tokens equal to the first's, the reference's KV-cache
     continuation check at its rtol 5e-2 with its atol 5e-3 taken
     relative to max |logit| (the reference's own arithmetic fails the
     absolute atol at full width too:
     ``scripts/continuation_witness.py``; a MoE token routed otherwise
     at a bf16 tie, 1e-2, is not compared) and with an f32 cache within
     the model's continuation tolerance (1e-5; zamba2-2.7b 1e-4,
     xlstm-350m 1e-2, their noise floors), no hand-kernel launch;
     prefill ms, decode ms per step (host
     clock around a synchronized call), tokens/s, the decode byte bound,
     peak memory and one profiled decode step's kernels and device-busy
     ms, beside the card's name and power limit;
     train (LM) — the LM training path (``lm_train_phase``):
     llama3.2-1b at full width and depth trained 4 steps at batch 8 x 128
     through ``launch.train.main`` (checkpoints every 2 steps), then
     resumed from step 2 by the launcher's ``--resume`` and run to step
     4; the last step's loss and bf16 gradients held against the
     port's CPU run from the card's parameters and batch
     (each leaf within 5e-2 of its max |g|, the loss within 1e-2), step
     1's at f32 (the f32 control, 1e-4) and twice on the card; step 1
     leaves every parameter as it was (the cosine schedule's rate 0);
     each AdamW update applied on the CPU to the card's gradients,
     moments and parameters (every k-th element of each leaf) within 4
     ulps of the card's; the resumed parameters bit-equal to the
     uninterrupted run's when the card's two runs of step 1 are, else
     within their spread; every gradient finite; step ms (host
     clock around synchronized
     steps), tokens/s, model FLOP/s against the bf16 peak, peak memory
     and one profiled step's kernels and busy ms; then one teacher-forced
     step of xlstm-350m and whisper-tiny at full depth, qwen2-vl-2b at
     14 of 28 layers (cut for the script's time with the sharded (LM)
     phase), zamba2-2.7b at 12 of 54 and dbrx-132b at 1 of 40 (reduced
     when the host cannot hold its CPU side), each at full width and 2 x
     128 tokens (qwen2-vl-2b and dbrx-132b 1 x 128), bf16 and f32-control
     gradients against the CPU above the model's floor (``LM_TRAIN``:
     xlstm-350m's are chaotic and only reported; qwen2-vl-2b's and
     dbrx-132b's f32 controls are left out for time), the MoE term too,
     and the CPU run on the card's routing: its router probabilities
     within 1e-2 of the card's, a token routed otherwise only at a tie
     and on at most 1 in 16 tokens; no hand-kernel launch;
     sharded (LM) — the LM partitioned over a mesh (``lm_sharded_phase``):
     two gloo ranks sharing the card (every collective staged through
     the host, so no time is NCCL's), (a) llama3.2-1b at full width and
     LM_SHARDED_LAYERS layers on (1 data x 2 model), a bf16 step and an
     f32 control, (b) the same with FSDP on (2 x 1), (c) dbrx-132b at 1
     of 40 layers, its 4 token groups and 8-bit moments on (1 x 2), an
     f32 step; every case one ``make_train_step`` step on each rank,
     held against the same step unpartitioned here on the card (c's MoE
     as the plain one-process ``moe_shardmap``, routed as the ranks
     routed): the loss and each leaf's gradients on every k-th element
     (f32 1e-4 of a leaf's max |g|, bf16 at the train (LM) phase's
     measured floor, 3.2e-2), the new parameters in units of the step's
     lr (f32 within 0.35; bf16 within one Adam sign flip, on at most a
     quarter of a leaf's elements), (c)'s 8-bit moment codes at most 1
     apart and scales within 1e-4, the ranks' replicated samples equal,
     no hand-kernel launch on any rank (each wrapper's count set to 0
     just before its step and read just after); per rank the step ms,
     the collectives by axis (calls, bytes), peak GB and its parameter
     bytes against the whole model's; then llama3.2-1b served on the
     same (1 x 2) ranks, head-parallel and split-KV (``kv_seq_shard``),
     f32: a prefill of 2 x 128 tokens and 4 greedy decode steps, the
     prefill's and each step's logits and the final cache (gathered)
     within 1e-4 of max |x| of the same run unpartitioned here on the
     card, the greedy tokens equal, no hand-kernel launch;
  5. times — each kernel at every call shape the main path gave it (CUDA
     events; the serve and train runs record each wrapper's calls by
     shape) beside its plain version, one cuDNN call computing the same
     function (``convolution_backward`` with one output's mask set for
     dw and dx), and the bound, with each launch's tile, reduction
     slices and share of the bound (and, for the forwards, the wrapper's
     host time per call); the forward and dx shapes again in bf16 (the
     bf16 route); the int8 launches at every quantized call shape the
     same way, with bf16 activations too, their library time cuDNN's on
     the dequantized f32 operands and their bound at the card's rate for
     their operand types (dense TF32 for f32 x int8, bf16 for bf16 x int8,
     int8 for int8 x int8), summed per operand pair; one served
     batch of each model end to end under each policy
     (every batch served by ``"pallas"``, no bucket fallen back), and
     whole train steps;
     dry run — ``launch.dryrun``'s abstract steps (``dryrun_phase``, no
     world, ``meta`` tensors): llama3.2-1b at the train (LM) phase's
     shape on a 1 x 1 mesh, its argument bytes and FLOPs equal to one
     real step's on the card (``FlopCounterMode``), its roofline beside
     that phase's median step and peak memory; V-Net training at full
     width, the kernel wrappers' dry tally equal to
     ``train_step_launches`` and to the train phase's counted launches,
     its roofline beside the measured step; llama3.2-1b ``train_4k`` on
     the abstract 16 x 16 layout, traced ``ok``;
  6. runtime report — ``obs.measure_network`` of full-width V-Net and
     DCGAN at batch 4: every node alone (the device's time on CUDA
     events, the host's issue time beside it) against the calibrated f32
     roof (an IEEE f32 matmul probe) and the HBM copy probe, one row per
     node in order, every layer timed, no share above 1.05; the
     telemetry-instrumented callable launching the schedule's kernels
     per call, bit-equal to the bare one, one dispatch recorded per call;
     the server's registry exported as JSON and Prometheus text;
  7. tune — ``tune.tune_network`` at batch 4, the top 3 of the model
     and the heuristic measured: V-Net in f32 and under w:int8, DCGAN in
     f32; every measured candidate launched once more and held against
     its plain version (1e-4; 5e-5 for f32 x int8 against float64), each
     changed winner retimed in turns against the heuristic within the
     run's spread, the cache saved under ``build/``, reloaded with no
     heuristic fallback, a V-Net batch served on the tuned plans within
     1e-4 of the untuned one, and V-Net's graph timed on both plan sets
     in turns;
  8. paper figures — Fig. 1 (``sparsity``, all four benchmarks), Table II
     (``tiling.ENGINE_2D``/``ENGINE_3D``, and ``tiling.gpu_blocking`` of
     each network's layer 2 within the shared-memory budget), Fig. 6a
     (``tiling.network_summary``), Fig. 6c (``obs.measure_network`` of the
     four full-width generator chains at batch 4 on ``pallas`` and on
     ``xla``: every layer timed, no share of the calibrated f32 roof above
     1.05) and Fig. 7 (``comparison.modeled_comparison``, spec arithmetic,
     and ``measured_cpu_speedup`` on the card for DCGAN's and 3D-GAN's
     layer 2 at full width: ``oom``, ``iom_phase`` and the kernels within
     3e-5 of max |y| of ``oom``'s output);
  9. examples — each ``repro_torch.examples`` module's ``main`` on the
     card: ``train_dcgan --full --steps 2 --method pallas``,
     ``segment_vnet3d --steps 2 --method pallas``, ``serve_dcnn`` without
     and with ``--inject-faults`` (one fallback, one recovery), and
     ``quickstart``; each launches the hand kernels.
     Phases 6-9's launches are reported on their own: the ``"kernels"``
     line counts the main paths' alone.

``--cards N`` (N > 1) runs phases 1 and 2, then only the sharded phase's
multi-rank runs over NCCL with one rank per card (a 2 x 2 mesh for the
chain at N = 4) and the sharded (LM) phase's two ranks over NCCL on two
cards, and ends with the result line; it prints no kernels line.

The line before the last is the ``{"kernels": [...]}`` summary: each
kernel's ``ms``, ``plain_ms``, ``library_ms`` and ``bound_ms`` are sums
over exactly the launches its ``launches`` counts (each call shape's time
times the calls of that shape), each path's share of ``ms`` under
``ms_by_path`` beside ``launches_by_path`` (the sharded path's launches
are its ranks', summed; its call shapes are timed in this process); ``deconv_fwd_int8`` and
``conv_fwd_int8`` are the forward kernels' int8 launches of the quantized
serving runs.  ``by_pair`` gives the forward kernels' (and dx's) sums per
operand pair with the route each takes; a bf16 pair, which the main path
does not launch, stands in for its f32 counterpart: the same call shapes
in bf16, weighted by the f32 shapes' launches (``on_main_path`` false).
The last line is ``{"ok": true, "device": {...}}``.  ``--json PATH``
also writes every check and per-layer time to PATH.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): IEEE f32 on CUDA cores, bf16 tensor
# cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the dense int8 tensor-core rate: the bound of the int8 x int8 launches
# (the s8 route)
PEAK_INT8_OPS = 1979e12
# the dense TF32 tensor-core rate, the card's for f32 products on the
# tensor cores: the ops bound of f32 x int8 (2 x MACs, whatever passes the
# kernel runs); bf16 x int8 and bf16 x bf16 take the bf16 rate (int8
# values are exact in bf16)
PEAK_TF32 = 494.7e12
PEAK_BYTES = 3.35e12


class LmCell(NamedTuple):
    """One model of the serve (LM) phase."""
    arch: str
    layers: int | None = None      # layers served (None: all)
    # CPU forward calls compared: None, the whole batch through the
    # Server; else the prefill and the first decode calls, fed the card's
    # tokens
    cpu_calls: int | None = None
    card_draw: bool = True         # weights drawn on the card (else host)
    # the gates of its end-to-end f32 comparisons with the CPU (prefill,
    # f32-cache decode) and of its f32-cache continuation: at or above
    # the model's own f32 noise floor, how far its logits move on the CPU
    # when only the summation order changes
    # (scripts/lm_noise_floor.py: 8 vs 3 host threads)
    f32_tol: float = 1e-4
    cont_tol: float = 1e-5


# the serve (LM) phase's models, in order.  zamba2-2.7b's floor is
# 5.8e-5 (prefill) and 3.0e-5 (f32 continuation on the CPU) at its 54
# layers, its continuation gate kept at 12.  xlstm-350m's is 2.4e-3
# (prefill; 5.3e-3 by the third decode
# call, the JAX package 2.4e-3 from the port on the same parameters):
# its sLSTM recurrences amplify f32 rounding a thousandfold, so its end-
# to-end comparisons are read at the decode tolerance and its arithmetic
# is held by the teacher-forced decode check (every model's, 1e-4)
LM_SERVE = (
    LmCell("llama3.2-1b", card_draw=False),
    LmCell("qwen2-vl-2b", card_draw=False),
    LmCell("xlstm-350m", f32_tol=1e-2, cont_tol=1e-2),
    LmCell("zamba2-2.7b", layers=12, cont_tol=1e-4),
    LmCell("whisper-tiny"),
    LmCell("dbrx-132b", layers=2),
    LmCell("arctic-480b", layers=1, cpu_calls=3),
)

# the train (LM) phase: llama3.2-1b trained through launch.train at the
# launcher's batch (8 x 128), then one teacher-forced step of each other
# family (LM_TRAIN) at full width and LM_TRAIN_CELL_BATCH sequences (its
# CPU side is the phase's cost)
LM_TRAIN_ARCH = "llama3.2-1b"
LM_TRAIN_STEPS = 4
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128
LM_TRAIN_CELL_BATCH = 2
# the steps whose bf16 gradients are held against the CPU: the last, the
# first at parameters the updates have moved (one llama3.2-1b bf16
# gradient takes the 8-core host of an H100 80GB HBM3 machine 62-83 s);
# step 1's f32 control (37 s there) and repeat, and every step's update,
# are held too
LM_TRAIN_CPU_STEPS = (LM_TRAIN_STEPS,)
# card vs CPU, each leaf's max |diff| / max |g|: the train step's bf16
# gradients (its forward rounds to bf16 op by op, so each weight's
# gradient is a bf16 value and a card and a CPU product round a near-tie
# apart: the port's and the JAX package's CPU gradients lie 1.3e-2-2.5e-2
# apart at reduced sizes, tests/test_torch_lm_train_steps.py), and the
# f32 control of the same step, which rounds nothing to bf16
LM_TRAIN_BF16_TOL, LM_TRAIN_F32_TOL = 5e-2, 1e-4
LM_TRAIN_LOSS_TOL = 1e-2         # bf16 loss, card vs CPU, relative
# a MoE routing decision of the bf16 step may differ between the card and
# the CPU only at a tie: its k-th and (k+1)-th router probabilities this
# close (the serve (LM) phase's bf16 tie).  One flipped token changes its
# hidden state wholesale, and with it the untied head's gradient row of
# its label (dbrx-132b: 0.65 of the leaf's max |g| on one H100), so
# the CPU runs the card's routing (teacher-forced) and the flips are
# counted and held to the tie; the CPU's router probabilities must lie
# within the tie of the card's, and at most this share of the routed
# tokens may flip (3 of 256 read on one H100)
LM_TRAIN_ROUTE_TIE = 1e-2
LM_TRAIN_FLIP_SHARE = 1 / 16
# an AdamW update card vs CPU, in units in the last place of the largest
# of the old and new parameter and the update at each element: the
# moments agree bit for bit, the bias corrections' pow may round an ulp
# apart on the card (4 ulps of max(|p|, |p_new|) measured on one H100)
LM_TRAIN_ULPS = 4
LM_TRAIN_SAMPLE = 1 << 22        # elements of each leaf the update check reads


class LmTrainCell(NamedTuple):
    """One model of the train (LM) phase's teacher-forced steps."""
    arch: str
    layers: int | None = None      # depth trained (None: all)
    # the gates of its card-vs-CPU gradients (bf16 step, f32 control, None:
    # not run), above the model's own floor on the CPU
    # (scripts/lm_noise_floor.py --grads at 2 x 128; inf: reported only)
    bf16_tol: float = LM_TRAIN_BF16_TOL
    f32_tol: float | None = LM_TRAIN_F32_TOL
    batch: int = LM_TRAIN_CELL_BATCH
    # bytes of host memory its CPU side needs, in units of its f32
    # parameters (params, gradients, the bf16 forward's casts and saves);
    # 0: no check.  A model that does not fit runs at reduced() size
    host_need: float = 0.0


# xlstm-350m's full-width gradients are chaotic: on the 8-core host of
# an H100 machine two thread counts move a leaf's f32 gradient 35x its
# max |g| (the batch against the mean of its halves 50x; bf16 8x / 26x),
# its loss 7e-4 / 6e-3 (scripts/lm_noise_floor.py --grads, 2 x 128), so
# its gradients are reported, its loss and finiteness gated.
# zamba2-2.7b at 12 layers (two shared-block groups, the fewest that
# reuse the shared block): f32 5.4e-5, bf16 4.1e-2 / 5.1e-2 there.
# qwen2-vl-2b's and dbrx-132b's f32 controls are left out for time
# (qwen's read 4.7e-6 on one H100 and took that host 43 s), and both run
# one sequence (their bf16 CPU gradients took 60 s at 2 x 128); qwen2-vl-2b
# at 14 of 28 layers, a uniform dense stack (its CPU side took 63 s at
# 28: the script's time)
LM_TRAIN = (
    LmTrainCell("qwen2-vl-2b", layers=14, f32_tol=None, batch=1),
    LmTrainCell("xlstm-350m", bf16_tol=math.inf, f32_tol=None),
    LmTrainCell("whisper-tiny"),
    LmTrainCell("zamba2-2.7b", layers=12, bf16_tol=0.15, f32_tol=2e-4),
    LmTrainCell("dbrx-132b", layers=1, f32_tol=None, batch=1,
                host_need=3.0),
)
# the forward block's route for each (x, w) operand pair (igemm.cuh), and
# the passes of the TF32 route per activation type: what each launch's C
# entry must report it launched (launch_key); bf16 x bf16 runs
# igemm_bf16_kernel, never igemm_tf32_kernel
PAIR_ROUTE = {("float32", "float32"): "fma",
              ("bfloat16", "bfloat16"): "bf16",
              ("float32", "int8"): "tf32",
              ("bfloat16", "int8"): "tf32",
              ("int8", "int8"): "s8"}
TF32_PASSES = {"float32": 2, "bfloat16": 1}


def launch_key(xn: str, wn: str) -> tuple[str, str, str, int]:
    """The launch record an (x, w) pair's launch must leave: its type
    names, its route and passes (the wrappers' ``operand_launches`` keys,
    from what the C entry reports)."""
    route = PAIR_ROUTE[(xn, wn)]
    return xn, wn, route, TF32_PASSES[xn] if route == "tf32" else 1


# kernel vs plain version, max|diff| / max|plain|: f32 sums in another
# order (1e-4, the reference's tolerance); bf16 output may differ by one
# bf16 rounding step (2^-8 relative), so 1e-2
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the s8 route (int8 x int8) vs the float64 plain version: its s32 sums are
# exact, so only the conversion to f32 and the f32 epilogue round (a few
# 2^-24 relative)
S8_TOL = 1e-6
# f32-output launches of the TF32 route with f32 activations (f32 x int8,
# w:int8) vs the float64 plain version: the activations split hi + lo
# (within 2^-21), the int8 weights exact, each k8 step's products summed on
# the tensor cores and added to the f32 sums rounded to nearest; the
# emulation (tests/test_torch_tf32_route.py) reads under 1e-6 of max |y|
# at depth 4,096, and one pass (hi alone) above 1e-4, so 5e-5
W8_TOL = 5e-5
SERVE_TOL = 1e-4                 # card vs CPU run of the port, f32
# the reference lowerings vs the hand kernels through a full-width graph,
# f32, TF32 on in cuDNN and cuBLAS: IEEE f32 sums in another order read
# under 1e-5 of max |y|, TF32 (10-bit mantissa products) reads above this;
# the phase's control, run with the lowerings' IEEE scope removed, must
# fail it
REF_TOL = 3e-5
# int8 activations, card vs CPU run of the port: each layer's input is
# quantized per tensor, and its f32 values differ between card and CPU in
# the last bits (sums in another order), so a value within rounding of a
# .5 tie of x / scale lands one quantum (1/127 of the input's absmax)
# apart.  A flip moves every output it reaches by a share of a quantum,
# which flips more values in the next layer: through V-Net's 14 layers a
# free CPU run's int8 activations drift from the card's by whole quanta
# and its output by as much as quantization itself moves it.  So the free
# run is reported, with its flips counted per layer, and the CPU run fed
# the card's int8 activations (each layer's sums, scales and epilogue
# recomputed on the CPU) is held at SERVE_TOL

# backward kernels vs a float64 plain version on the same inputs: f32
# operands with random zero-mean data, sums of up to ~50 K products per
# slice of the dw reduction (error ~ 6e-8 x sqrt(products), ~1.4e-5), so
# 1e-4; bf16 outputs may differ by one bf16 rounding step, so 1e-2
BACKWARD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# one DCGAN train step's gradients on the card vs the port's CPU run,
# relative to each leaf's max.  f32 sums in another order through 8
# layers agree to ~1e-6, so 1e-4 (GRAD_TOL_EXACT) holds every leaf when
# the CPU run is fed the card's forward outputs, and, in a free CPU run,
# every leaf no relu mask of the generator reaches (its last deconv, the
# discriminator).  In a free run a relu mask flips where a pre-activation
# lies within rounding of 0 (the batch-4 generator has ~900 K of them),
# and one flipped element moves its share of one channel's weight
# gradient, about 1/sqrt(1024 positions) of those entries and up to
# ~1e-2 of the leaf's max; the leaves such a flip reaches (the
# projection and the relu deconvs) are held at 2e-2.  A wrong index,
# layout or lost partial sum moves a leaf by O(1)
GRAD_TOL = 2e-2
GRAD_TOL_EXACT = 1e-4
# the steps the train phase runs, the last of them after a resume (the
# batches are the configs': 64 for DCGAN, 4 for V-Net)
TRAIN_STEPS = {"dcgan": 3, "v-net": 2}

DCGAN_CHANS = (1024, 512, 256, 128, 3)
VNET_CHANS = (16, 32, 64, 128, 256)
VNET_SPATIAL = (128, 128, 64)
BATCH = 4                        # the server's max_batch
# each tuning candidate's time: the best of this many calls (one layer
# takes ~0.05-0.2 ms of wrapper host time inside its CUDA events)
TUNE_REPEATS = 5
# the port's counterparts of the JAX package's XLA-lowered methods
REF_METHODS = ("oom", "xla", "iom", "iom_phase")
# the paper's four benchmarks (core.networks.BENCHMARKS) and the two
# generators the paper-benchmark path adds to DCGAN and V-Net
PAPER_NETWORKS = ("dcgan", "gp_gan", "3d_gan", "v_net")
PAPER_GENERATORS = ("gp_gan", "3d_gan")
PAPER_TRAIN_STEPS = 2


# the wrappers' tile arguments, which their plain versions do not take
TILE_KWARGS = ("block_co", "split")

# the sharded phase: each world of ranks (spawned, all on the card's device
# 0) must end within this many seconds; a sharded output against the
# unsharded engine's, relative to max |y| (f32 sums in another order, the
# reference's tolerance); the int8-compressed DP GAN's final losses
# against the f32 all-reduce's (the reference's bound,
# tests/test_sharded_engine.py)
SHARDED_TIMEOUT = 300
SHARDED_TOL = 1e-4
DP_GAN_TOL = 5e-2
# the first f32 DP GAN step's reduced gradients against one process's step
# on the whole batch, relative to max |g| per network: f32 sums at another
# batch size, magnified by the generator's cancelling gradients (2.6e-4
# on the card at 2 x 32 against 64); a wrong reduction is off by O(1)
DP_WHOLE_BATCH_TOL = 1e-3
# the sharded path's full-width runs: V-Net served at batch 4, the DCGAN
# generator chain (networks.dcgan()) channel-sharded on a 2-way model axis
# at batch 4, DP GAN steps of DCGAN at its config's batch (64), one DP
# V-Net train step at batch 4
SHARDED_SPEC = {"device": "cuda", "one_card": True, "reduced": False,
                "vnet_spatial": (128, 128, 64),
                "vnet_chans": (16, 32, 64, 128, 256), "batch": 4,
                "gan_batch": 64, "min_channel_block": 8}

# the sharded (LM) phase: one world of 2 ranks on the card (gloo, every
# collective staged through the host; --cards: NCCL, one rank per card),
# its cases (lm_sharded_cases) each held against the same step run
# unpartitioned in the parent.  llama3.2-1b at full width and
# LM_SHARDED_LAYERS of 16 layers (time), LM_SHARDED_BATCH x LM_TRAIN_SEQ
# tokens; dbrx-132b at 1 of 40 (two ranks' blocks, gradients and moments
# on one card), one sequence
LM_SHARDED_LAYERS = 2
LM_SHARDED_BATCH = 2
LM_SHARDED_MOE_LAYERS = 1
# the AdamW step count the compared update starts from: the cosine
# schedule's rate 0.5 (step 0's is 0, which would move nothing)
LM_SHARDED_OPT_STEP = 50
# partitioned vs unpartitioned on the card, each leaf's max |diff| / max
# |g| over the sampled elements: f32 (sums split over ranks), and bf16
# at the train (LM) phase's measured floor of two bf16 runs of one step
# (card vs CPU: 2.65e-2-3.15e-2 of a leaf's max |g|); the bf16 loss as
# that phase's.
LM_SHARDED_BF16_TOL, LM_SHARDED_F32_TOL = 3.2e-2, 1e-4
# the new parameters, in units of the step's lr: from fresh moments Adam
# moves every element with |g| >> eps by lm_adam_step() (0.433 lr at step
# 51) whatever |g| is, so a skipped or wrong update puts nearly every
# element of a leaf that has a gradient that far (or twice) apart.  A
# sound run differs only where the gradient's sign or its size against
# eps is at the noise: in f32 by at most LM_SHARDED_F32_UPDATE lr (the
# card read 0.086-0.254), in bf16 by up to one sign flip (2 x 0.433 lr)
# on at most LM_SHARDED_BF16_APART of a leaf's sampled elements beyond
# LM_SHARDED_APART lr (the card read 6.1e-2-9.2e-2)
LM_SHARDED_F32_UPDATE = 0.35
LM_SHARDED_APART = 1e-3
LM_SHARDED_BF16_APART = 0.25
LM_SHARDED_SAMPLE = 1 << 20     # elements of each leaf compared (every k-th)
# the sharded (LM) phase's serve cases (lm_sharded_serve_cases): a prompt
# of LM_TRAIN_SEQ tokens a row, then LM_SHARDED_SERVE_STEPS greedy decode
# steps against a cache of LM_SHARDED_SERVE_LEN positions, f32 weights and
# cache; logits, cache and tokens against the unpartitioned forward at
# LM_SHARDED_F32_TOL of max |x|
LM_SHARDED_SERVE_STEPS = 4
LM_SHARDED_SERVE_LEN = LM_TRAIN_SEQ + 2 * LM_SHARDED_SERVE_STEPS


def lm_adam_step() -> float:
    """|m_hat / sqrt(v_hat)| of AdamW's update at step
    LM_SHARDED_OPT_STEP + 1 from zero moments, for |g| >> eps."""
    from repro_torch.optim import AdamWConfig
    opt, t = AdamWConfig(), LM_SHARDED_OPT_STEP + 1
    return ((1 - opt.b1) / (1 - opt.b1 ** t)
            / math.sqrt((1 - opt.b2) / (1 - opt.b2 ** t)))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def signature(kname, a, b, kw):
    """A wrapper call's shape key: the kernel, its operands' shapes and
    types and its other arguments (tensors by shape and type)."""
    import torch
    return (kname, tuple(a.shape), a.dtype, tuple(b.shape), b.dtype,
            tuple(sorted((k, (tuple(v.shape), v.dtype)
                          if torch.is_tensor(v) else v)
                         for k, v in kw.items())))


def record_calls(dk, ck, recorded: dict, recording: list) -> None:
    """Wrap the four kernel wrappers so that each call on the card while
    ``recording[0]`` names a path adds one to ``recorded[signature][path]``
    (int8 weights' launches are the int8 entries' own)."""
    import torch

    def recorder(mod, kname):
        real = getattr(mod, kname)

        def wrapped(a, b, **kw):
            if recording[0] and a.is_cuda:
                key = signature(kname + "_int8" * (b.dtype == torch.int8),
                                a, b, kw)
                paths = recorded.setdefault(key, {})
                paths[recording[0]] = paths.get(recording[0], 0) + 1
            return real(a, b, **kw)
        setattr(mod, kname, wrapped)

    for mod, kname in ((dk, "deconv_fwd"), (ck, "conv_fwd"),
                       (dk, "deconv_dw"), (dk, "deconv_dx")):
        recorder(mod, kname)


def lm_first_divergence(got, want, logits, tol: float):
    """The first decode step at which two runs' greedy tokens differ (None
    if they never do), after checking that at that step every differing
    row's top-2 logit margin in ``logits[step]`` ([B, V], the reference
    run's) lies within ``tol`` of its max |logit|: a rounding tie.  Rows
    and steps after it are not compared."""
    for step in range(max(len(w) for w in want)):
        rows = [i for i, (g, w) in enumerate(zip(got, want))
                if step < len(w) and g[step] != w[step]]
        if not rows:
            continue
        for i in rows:
            row = logits[step][i]
            top2 = row.topk(2).values
            margin = float(top2[0] - top2[1])
            check(margin <= tol * float(row.abs().max()),
                  f"request {i} step {step}: tokens {got[i][step]} != "
                  f"{want[i][step]} with a top-2 margin of {margin:.3g}")
        return step
    check([len(g) for g in got] == [len(w) for w in want],
          f"token counts {[len(g) for g in got]}")
    return None


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# -- the sharded phase's ranks ----------------------------------------------

def launch_counts(dk, ck) -> dict:
    """Each hand-kernel wrapper's launch count (``dk``, ``ck``: the
    deconv and conv kernel modules)."""
    return {"deconv_fwd": dk.launches, "conv_fwd": ck.launches,
            "deconv_dw": dk.dw_launches, "deconv_dx": dk.dx_launches}


def zero_launch_counts(dk, ck) -> None:
    dk.launches = ck.launches = dk.dw_launches = dk.dx_launches = 0


# kernel 1's TMA + wgmma route (csrc/deconv_wgmma.cu): launches the planner
# (tiling.plan_wgmma) gives it, (tag, x [N, D, H, W, Ci], kernel, stride,
# Co, crop_lo, out_spatial, groups, dilation): DCGAN's deconv1-3 at batch
# 64 (one tile a unit) and 1,024 (every phase of a box a unit), V-Net's
# up1-3 at batch 8, a ragged grid cropped in front, a conv's dx geometry
# (crop 1, a window past the Eq. (1) extent), two groups, and a dilation
# that leaves phases without taps
WGMMA_CASES = [
    ("dcgan.deconv1.b64", (64, 4, 1, 4, 1024), (3, 1, 3), (2, 1, 2), 512,
     (0, 0, 0), (8, 1, 8), 1, (1, 1, 1)),
    ("dcgan.deconv2.b64", (64, 8, 1, 8, 512), (3, 1, 3), (2, 1, 2), 256,
     (0, 0, 0), (16, 1, 16), 1, (1, 1, 1)),
    ("dcgan.deconv3.b64", (64, 16, 1, 16, 256), (3, 1, 3), (2, 1, 2), 128,
     (0, 0, 0), (32, 1, 32), 1, (1, 1, 1)),
    ("dcgan.deconv1.b1024", (1024, 4, 1, 4, 1024), (3, 1, 3), (2, 1, 2),
     512, (0, 0, 0), (8, 1, 8), 1, (1, 1, 1)),
    ("dcgan.deconv2.b1024", (1024, 8, 1, 8, 512), (3, 1, 3), (2, 1, 2),
     256, (0, 0, 0), (16, 1, 16), 1, (1, 1, 1)),
    ("dcgan.deconv3.b1024", (1024, 16, 1, 16, 256), (3, 1, 3), (2, 1, 2),
     128, (0, 0, 0), (32, 1, 32), 1, (1, 1, 1)),
    ("vnet.up1.b8", (8, 8, 8, 4, 256), (3, 3, 3), (2, 2, 2), 128,
     (0, 0, 0), (16, 16, 8), 1, (1, 1, 1)),
    ("vnet.up2.b8", (8, 16, 16, 8, 128), (3, 3, 3), (2, 2, 2), 64,
     (0, 0, 0), (32, 32, 16), 1, (1, 1, 1)),
    ("vnet.up3.b8", (8, 32, 32, 16, 64), (3, 3, 3), (2, 2, 2), 32,
     (0, 0, 0), (64, 64, 32), 1, (1, 1, 1)),
    ("ragged.crop1", (256, 5, 1, 7, 128), (3, 1, 3), (2, 1, 2), 48,
     (1, 0, 1), (8, 1, 12), 1, (1, 1, 1)),
    ("dx.crop1.window", (6, 9, 10, 11, 64), (3, 3, 3), (2, 2, 2), 32,
     (1, 1, 1), (19, 20, 22), 1, (1, 1, 1)),
    ("groups2", (64, 6, 1, 6, 256), (3, 1, 3), (2, 1, 2), 128, (0, 0, 0),
     (12, 1, 12), 2, (1, 1, 1)),
    ("dil2.empty_phases", (512, 6, 1, 5, 64), (3, 1, 3), (2, 1, 2), 16,
     (0, 0, 0), (15, 1, 13), 1, (2, 1, 2)),
]
WGMMA_ACTS = ("none", "relu", "leaky_relu", "tanh")


def wgmma_case(case, dev) -> dict:
    """One case of ``WGMMA_CASES`` on the card: ``deconv_fwd`` with bias,
    scale and an activation, in bf16 (gate ``TOL["bfloat16"]``) and f32
    output (``W8_TOL``) against float64 of the same bf16 operands (the
    plain version), each run twice; ``ok`` where both outputs are within
    their gates, repeat bit for bit and report the wgmma staging."""
    import torch

    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ref as dref
    tag, xs, k, s, co, crop, out, groups, dil = case
    gen = torch.Generator(device=dev).manual_seed(len(tag))
    ci = xs[-1]
    x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((math.prod(k), ci // groups, co), generator=gen,
                     device=dev)
         / math.sqrt(math.prod(k) * ci / groups / 4)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(co, generator=gen, device=dev)
    scale = 1 + 0.1 * torch.rand(co, generator=gen, device=dev)
    kw = dict(kernel=k, stride=s, dilation=dil, groups=groups, crop_lo=crop,
              out_spatial=out)
    plan = dk.planned_wgmma(x, w, **kw)
    row = {"check": tag, "plan": None if plan is None else list(plan.fields()),
           "ok": plan is not None}
    key = ("bfloat16", "bfloat16", "bf16", "wgmma")
    for i, (out_dtype, tol) in enumerate(((torch.bfloat16, TOL["bfloat16"]),
                                          (torch.float32, W8_TOL))):
        act = WGMMA_ACTS[(len(tag) + i) % len(WGMMA_ACTS)]
        ekw = dict(kw, scale=scale, bias=bias, activation=act, alpha=0.1,
                   out_dtype=out_dtype)
        before = dk.staging_launches.get(key, 0)
        got = dk.deconv_fwd(x, w, **ekw)
        again = dk.deconv_fwd(x, w, **ekw)
        torch.cuda.synchronize()
        ref = dref.deconv_fwd_plain(
            x.double(), w.double(), scale=scale.double(), bias=bias.double(),
            activation=act, alpha=0.1, out_dtype=torch.float64, **kw)
        err = float((got.double() - ref).abs().max())
        mag = float(ref.abs().max())
        res = {"activation": act, "max_abs_err": err,
               "rel_err": err / mag if mag else err, "tol": tol,
               "repeat_equal": bool(torch.equal(got, again)),
               "wgmma_launches": dk.staging_launches.get(key, 0) - before}
        row[str(out_dtype).split(".")[-1]] = res
        row["ok"] = (row["ok"] and res["rel_err"] <= tol
                     and res["repeat_equal"] and res["wgmma_launches"] == 2)
        del got, again, ref
    return row


class RankRun:
    """One rank's runs of the sharded path: each wrapper's launch count
    set to 0 just before a run and read just after, its calls recorded by
    shape (``record_calls``) while it runs, and what it measured."""

    def __init__(self, rank: int, spec: dict):
        import torch
        from repro_torch.kernels.conv import kernel as ck
        from repro_torch.kernels.deconv import kernel as dk
        self.torch, self.dk, self.ck = torch, dk, ck
        self.rank, self.spec = rank, spec
        # ranks sharing one card all run on its device 0
        self.dev = (torch.device("cuda", 0 if spec["one_card"] else rank)
                    if spec["device"] == "cuda" else torch.device("cpu"))
        self.recorded, self.recording = {}, [None]
        record_calls(dk, ck, self.recorded, self.recording)
        self.launches = {"deconv_fwd": 0, "conv_fwd": 0, "deconv_dw": 0,
                         "deconv_dx": 0}
        self.rows = []

    def counts(self) -> dict:
        return launch_counts(self.dk, self.ck)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def path(self, fn):
        """``fn()`` as a run of the sharded path: ``(its result, its
        launches per wrapper, its seconds)``."""
        zero_launch_counts(self.dk, self.ck)
        self.recording[0] = "sharded"
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        seconds = time.perf_counter() - t0
        self.recording[0] = None
        got = self.counts()
        for k, v in got.items():
            self.launches[k] += v
        return out, got, seconds


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / float(want.abs().max())


@contextlib.contextmanager
def counted_collectives(sent: list):
    """While open, every ``dist.all_reduce`` / ``dist.all_gather`` call
    appends ``(name, bytes of the tensor handed to it)`` to ``sent``: the
    payload the backend received, after any staging through the host."""
    import torch.distributed as dist
    real = {}
    for name, arg in (("all_reduce", 0), ("all_gather", 1)):
        real[name] = getattr(dist, name)

        def counted(*a, _real=real[name], _arg=arg, _name=name, **kw):
            t = a[_arg]
            sent.append((_name, t.numel() * t.element_size()))
            return _real(*a, **kw)
        setattr(dist, name, counted)
    try:
        yield sent
    finally:
        for name, f in real.items():
            setattr(dist, name, f)


def sharded_vnet_serve(run: RankRun, mesh, label: str) -> None:
    """V-Net served data-parallel: each rank's batch shard through the
    mesh-aware engine (one launch per layer node), the shards gathered and
    held against the unsharded engine's output for the whole batch."""
    torch = run.torch
    from repro_torch.core import (EngineConfig, UniformEngine,
                                  compile_network, init_network_weights,
                                  networks, shard_batch)
    from repro_torch.sharding import mesh as SM
    spec, dev = run.spec, run.dev
    graph = networks.vnet_graph(in_spatial=spec["vnet_spatial"],
                                chans=spec["vnet_chans"])
    ws = {k: v.to(dev) for k, v in init_network_weights(
        graph, torch.Generator().manual_seed(5)).items()}
    x = torch.randn((spec["batch"], *spec["vnet_spatial"], 1),
                    generator=torch.Generator().manual_seed(6)).to(dev)
    eng = UniformEngine(EngineConfig(method="pallas", device=dev,
                                     mesh=mesh))
    fn, report = compile_network(graph, eng, batch=spec["batch"])
    xs = shard_batch(x, mesh)
    with torch.inference_mode():
        y, got, cold_s = run.path(lambda: fn(ws, xs))
        t0 = time.perf_counter()
        fn(ws, xs)
        run.sync()
        warm_s = time.perf_counter() - t0
        whole = SM.all_gather(y, mesh.group("data"), dim=0)
        base, _ = compile_network(graph, UniformEngine(device=dev))
        want = base(ws, x)
    rel = _rel_err(whole, want)
    n_deconv = sum(l.op == "deconv" for l in graph.layers)
    run.rows.append({"run": f"vnet_serve{label}", "mesh": mesh.shape,
                     "per_rank_batch": report.per_device_batch,
                     "launches": got, "kernel_launches":
                     report.kernel_launches, "cold_s": cold_s,
                     "warm_s": warm_s, "rel_err_vs_unsharded": rel,
                     "tol": SHARDED_TOL})
    check(report.per_device_batch == xs.shape[0] == y.shape[0],
          f"V-Net shard {tuple(xs.shape)} -> {tuple(y.shape)}, report "
          f"{report.per_device_batch}")
    check(got == {"deconv_fwd": n_deconv,
                  "conv_fwd": len(graph.layers) - n_deconv,
                  "deconv_dw": 0, "deconv_dx": 0}
          and sum(got.values()) == report.kernel_launches,
          f"V-Net data-parallel batch launched {got}, report "
          f"{report.kernel_launches}")
    check(bool(torch.isfinite(y).all()), "V-Net shard not finite")
    check(rel <= SHARDED_TOL, f"V-Net data parallel vs unsharded: "
          f"{rel:.3g} above {SHARDED_TOL}")


def sharded_dcgan_chain(run: RankRun, mesh) -> None:
    """The DCGAN generator chain on the model axis: each rank its channel
    shard of every layer (and its batch shard, where the data axis is
    wider than 1), the psum layers all-reduced; the bytes each collective
    received counted here, against the report's."""
    torch = run.torch
    from repro_torch.core import (EngineConfig, MeshPolicy, UniformEngine,
                                  compile_network, init_network_weights,
                                  networks, shard_batch)
    spec, dev = run.spec, run.dev
    layers = networks.dcgan()
    if spec["reduced"]:
        layers = networks.scale_channels(layers, div=32)
    first = layers[0]
    ws = [w.to(dev) for w in init_network_weights(
        layers, torch.Generator().manual_seed(7))]
    x = torch.randn((spec["batch"], *first.in_spatial, first.cin),
                    generator=torch.Generator().manual_seed(8)).to(dev)
    eng = UniformEngine(EngineConfig(
        method="pallas", device=dev, mesh=mesh, policy=MeshPolicy(
            model_axis="model",
            min_channel_block=spec["min_channel_block"])))
    fn, report = compile_network(layers, eng, batch=spec["batch"])
    sent = []
    xs = shard_batch(x, mesh)
    with torch.inference_mode(), counted_collectives(sent):
        y, got, cold_s = run.path(lambda: fn(ws, xs))
    with torch.inference_mode():
        t0 = time.perf_counter()
        fn(ws, xs)
        run.sync()
        warm_s = time.perf_counter() - t0
        base, _ = compile_network(layers, UniformEngine(device=dev))
        want = shard_batch(base(ws, x), mesh)
    rel = _rel_err(y, want)
    rows = [(l.name, l.local_cin, l.local_cout, l.collective,
             l.collective_bytes) for l in report.layers]
    want_sent = [("all_reduce" if r[3] == "psum" else r[3], r[4])
                 for r in rows if r[3]]
    run.rows.append({"run": "dcgan_chain", "mesh": mesh.shape,
                     "per_rank_batch": report.per_device_batch,
                     "layers": rows, "collective_bytes":
                     report.collective_bytes, "sent": sent,
                     "launches": got, "kernel_launches":
                     report.kernel_launches, "cold_s": cold_s,
                     "warm_s": warm_s, "rel_err_vs_unsharded": rel,
                     "tol": SHARDED_TOL})
    check(any(r[3] == "psum" for r in rows), f"no layer sharded: {rows}")
    check(sent == want_sent, f"collectives received {sent}, the report "
          f"lists {want_sent}")
    check(got == {"deconv_fwd": len(layers), "conv_fwd": 0, "deconv_dw": 0,
                  "deconv_dx": 0}
          and sum(got.values()) == report.kernel_launches,
          f"DCGAN chain launched {got}, report {report.kernel_launches}")
    check(rel <= SHARDED_TOL, f"DCGAN chain on the model axis vs unsharded:"
          f" {rel:.3g} above {SHARDED_TOL}")


def _checksum(run: RankRun, params):
    """Per-leaf float64 sums: equal on every rank iff the params are."""
    torch = run.torch
    from repro_torch import tree
    return torch.stack([torch.stack([t.double().sum(), t.double().abs().sum(),
                                     (t.double() ** 2).sum()])
                        for t in tree.leaves(params)])


def sharded_dp_train(run: RankRun, mesh, arch: str, steps: int,
                     compress_runs) -> None:
    """``steps`` data-parallel train steps of ``arch`` per compression
    setting, each rank on its shard of the global batch: launches per step
    a train step's, losses finite, params moved and equal on every rank
    after every step; the int8 run's final losses against the f32 run's."""
    torch = run.torch
    import dataclasses as dc

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import UniformEngine, shard_batch
    from repro_torch.data import DcnnBatches, VolumeBatches
    from repro_torch.launch import steps as ST
    from repro_torch.models import dcnn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import dp_trainer as DP
    from repro_torch.sharding import mesh as SM
    spec, dev = run.spec, run.dev
    cfg = get_config(arch)
    if spec["reduced"]:
        cfg = cfg.reduced()
    batch = spec["gan_batch"] if arch == "dcgan" else spec["batch"]
    cfg = dc.replace(cfg, dcnn_batch=batch)
    if arch == "v-net":
        data = VolumeBatches(batch, dcnn._vnet_spatial(cfg), prefetch=False,
                             device=dev)
    else:
        last = dcnn._scaled_layers(cfg)[-1]
        data = DcnnBatches(batch, cfg.dcnn_z, (*last.out_spatial, last.cout),
                           prefetch=False, device=dev)
    batches = [shard_batch(data.make_batch(i), mesh) for i in range(steps)]
    want = ST.train_step_launches(cfg)
    engine = UniformEngine(method="pallas", device=dev)
    opt = AdamWConfig(lr=2e-3, weight_decay=0.0)
    group = mesh.group("data")
    final = {}
    for compress in compress_runs:
        p0 = ST.real_params(cfg, torch.Generator().manual_seed(0), dev)
        if arch == "v-net":
            state = adamw_init(p0, opt)
            step = ST.make_dp_vnet_train_step(cfg, opt, mesh, engine,
                                              compress)
        else:
            state = (adamw_init(p0["gen"], opt), adamw_init(p0["disc"], opt))
            step = ST.make_dp_gan_train_step(cfg, opt, mesh, engine,
                                             compress)
        carry = [p0, state, DP.init_error_state(p0, mesh.shape["data"])]
        wire = DP.grad_wire_bytes(p0, compress)
        # what the step hands dist.all_reduce: the int8 path sums int32
        # (4 B per element, as f32) plus one f32 scale per leaf; each loss
        # is one f32 mean
        n_leaves = len(tree.leaves(p0))
        want_grad_bytes = (4 * wire["param_count"]
                           + (4 * n_leaves if compress else 0))
        per_step = []
        for i, b in enumerate(batches):
            def one(b=b):
                return step(*carry, b)
            sent = []
            with counted_collectives(sent):
                (p, state, err, metrics), got, seconds = run.path(one)
            carry = [p, state, err]
            sums = _checksum(run, p)
            same = bool(torch.equal(SM.all_reduce(sums, group, "max"),
                                    SM.all_reduce(sums, group, "min")))
            metrics = {k: float(v) for k, v in metrics.items()}
            sent_bytes = sum(n for _, n in sent)
            per_step.append({"metrics": metrics, "launches": got,
                             "step_s": seconds, "params_equal": same,
                             "sent_bytes": sent_bytes})
            check(got == want, f"dp {arch} step launched {got}, a train "
                  f"step {want}")
            check(all(math.isfinite(v) for v in metrics.values()),
                  f"dp {arch} step: {metrics}")
            check(same, f"dp {arch}: params differ between ranks")
            check(sent_bytes == want_grad_bytes + 4 * len(metrics),
                  f"dp {arch} step handed the all-reduces {sent_bytes} B, "
                  f"expected {want_grad_bytes} + {4 * len(metrics)}")
            if (i == 0 and not compress and arch == "dcgan"
                    and mesh.shape["data"] > 1):
                per_step[0]["vs_one_process"] = dp_step_vs_one_process(
                    run, cfg, opt, engine, data.make_batch(0),
                    mesh.shape["data"], state, metrics)
        moved = max(float((a - b).abs().max())
                    for a, b in zip(tree.leaves(p0), tree.leaves(carry[0])))
        check(moved > 0.0, f"dp {arch}: params did not move")
        final[compress] = per_step[-1]["metrics"]
        sent_grad = per_step[-1]["sent_bytes"] - 4 * len(final[compress])
        run.rows.append({
            "run": f"dp_{arch}", "mesh": mesh.shape, "compress": compress,
            "global_batch": batch, "per_rank_batch": batch //
            mesh.shape["data"], "steps": per_step, "params_moved": moved,
            "wire": wire, "sent_grad_bytes": sent_grad,
            "sent_ratio": wire["grads_bytes"] / sent_grad})
        del carry, p0, state
    if len(final) == 2:
        for k in final[True]:
            d = abs(final[True][k] - final[False][k])
            check(d < DP_GAN_TOL, f"dp {arch}: final {k} int8 vs f32 "
                  f"differ by {d:.3g}")


def dp_step_vs_one_process(run: RankRun, cfg, opt, engine, whole, n_data,
                           dp_state, dp_metrics) -> dict:
    """The first f32 DP GAN step against one process's GAN steps from the
    same params: AdamW's first moment after one step is ``(1 - b1) * g``,
    so the DP step's must equal the mean of one process's steps on each
    rank's shard (the same kernels at the same shapes: only the
    reduction differs), and its losses their mean, within
    ``SHARDED_TOL``.  A sum in place of the mean, a wrong scale or a lost
    gradient is off by a factor.  One process's step on the whole batch
    gives the same gradients up to f32 sums at another batch size, whose
    rounding the generator's cancelling gradients magnify (they pass back
    through both networks' relu / leaky_relu masks): held within
    ``DP_WHOLE_BATCH_TOL``.  Params are not compared, since AdamW's first
    step is ``lr * g / (|g| + eps)`` and flips with the sign of near-zero
    gradients."""
    torch = run.torch
    from repro_torch import tree
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw_init
    step = ST.make_gan_train_step(cfg, opt, engine)

    def first(batch):
        p = ST.real_params(cfg, torch.Generator().manual_seed(0), run.dev)
        state = (adamw_init(p["gen"], opt), adamw_init(p["disc"], opt))
        _, state, metrics = step(p, state, batch)
        return ([tree.leaves(s.m) for s in state],
                {k: float(v) for k, v in metrics.items()})

    per = next(iter(whole.values())).shape[0] // n_data
    parts = [first({k: v[r * per:(r + 1) * per] for k, v in whole.items()})
             for r in range(n_data)]
    mean_m = [[sum(part[0][n][i] for part in parts) / n_data
               for i in range(len(parts[0][0][n]))] for n in range(2)]
    mean_loss = {k: sum(part[1][k] for part in parts) / n_data
                 for k in parts[0][1]}
    whole_m, whole_loss = first(whole)
    dp_m = [tree.leaves(s.m) for s in dp_state]

    def rel(got, want):
        return {name: max(float((a - b).abs().max()) for a, b in zip(g, w))
                / max(float(b.abs().max()) for b in w)
                for name, g, w in zip(("gen", "disc"), got, want)}

    out = {"shards": {"first_moment_rel_err": rel(dp_m, mean_m),
                      "loss_abs_err": {k: abs(dp_metrics[k] - v)
                                       for k, v in mean_loss.items()},
                      "tol": SHARDED_TOL},
           "whole_batch": {"first_moment_rel_err": rel(dp_m, whole_m),
                           "loss_abs_err": {k: abs(dp_metrics[k] - v)
                                            for k, v in whole_loss.items()},
                           "tol": DP_WHOLE_BATCH_TOL},
           # one process alone: its shards' mean against its whole batch
           "one_process_split_rel_err": rel(mean_m, whole_m)}
    for name, tol in (("shards", SHARDED_TOL),
                      ("whole_batch", DP_WHOLE_BATCH_TOL)):
        errs = out[name]
        check(all(v <= tol for v in errs["first_moment_rel_err"].values())
              and all(v <= tol for v in errs["loss_abs_err"].values()),
              f"DP GAN step vs one process ({name}): {errs}")
    return out


def sharded_rank(rank: int, world: int, backend: str, rendezvous: str,
                 job: str, spec: dict, out_dir: str) -> None:
    """One rank of the sharded phase, spawned by ``torch.multiprocessing``:
    joins the world (``file://`` rendezvous), runs its job's sharded runs
    on the card's device 0, and writes what it measured and recorded to
    ``out_dir``.  A failed check raises, which fails the phase."""
    sys.path.insert(0, str(ROOT / "src"))
    import pickle

    import torch

    from repro_torch.launch import mesh as M
    run = RankRun(rank, spec)
    if run.dev.type == "cuda":
        torch.cuda.set_device(run.dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    M.init_world(backend, init_method=f"file://{rendezvous}",
                 world_size=world, rank=rank, timeout_s=SHARDED_TIMEOUT)
    try:
        data = M.make_host_mesh()
        if job == "nccl":
            sharded_vnet_serve(run, data, "")
            sharded_dp_train(run, data, "dcgan", 2, (True,))
        else:       # "multi": a world of 2 or more
            sharded_vnet_serve(run, data, "")
            sharded_dcgan_chain(run, M.make_host_mesh(model=2))
            sharded_dp_train(run, data, "dcgan", 3, (True, False))
            sharded_dp_train(run, data, "v-net", 1, (True,))
    finally:
        M.leave_world()
    out = {"rank": rank, "backend": backend, "rows": run.rows,
           "launches": run.launches, "recorded": run.recorded}
    (Path(out_dir) / f"{job}.rank{rank}.pkl").write_bytes(pickle.dumps(out))


def spawn_world(job: str, world: int, backend: str, spec: dict,
                target=None) -> list:
    """Run ``job`` on ``world`` spawned ranks (``target``, by default
    ``sharded_rank``) and return each rank's results; a rank that raises,
    exits or runs over ``SHARDED_TIMEOUT`` fails the phase, and no rank
    outlives the call."""
    import pickle
    import tempfile

    import torch.multiprocessing as tmp
    with tempfile.TemporaryDirectory() as td:
        ctx = tmp.start_processes(
            target or sharded_rank,
            args=(world, backend, f"{td}/rendezvous", job, spec, td),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARDED_TIMEOUT
        try:
            while not ctx.join(timeout=max(0.1, deadline
                                           - time.monotonic())):
                check(time.monotonic() < deadline, f"sharded {job}: ranks "
                      f"ran over {SHARDED_TIMEOUT} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        return [pickle.loads(Path(td, f"{job}.rank{r}.pkl").read_bytes())
                for r in range(world)]


def sharded_geometries(spec: dict):
    """The sharded path's layer geometries beyond the other paths', as
    (model, layer, batch): forwards, and layers that train (whose dw and dx
    run too).  V-Net at 2 per rank, the DCGAN chain's channel shards at
    the batch, the DP GAN's networks at 32 per rank."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core import engine as E
    from repro_torch.core import networks
    from repro_torch.launch import steps as ST
    half = spec["batch"] // 2
    vnet = networks.vnet_graph(in_spatial=spec["vnet_spatial"],
                               chans=spec["vnet_chans"]).layers
    chain = networks.dcgan()
    if spec["reduced"]:
        chain = networks.scale_channels(chain, div=32)
    parts = E._partition_layers(chain, E.MeshPolicy(
        model_axis="model", min_channel_block=spec["min_channel_block"]), 2)
    shards = [dc.replace(l, cin=pt.local_cin, cout=pt.local_cout)
              for l, pt in zip(chain, parts)]
    cfg = get_config("dcgan")
    if spec["reduced"]:
        cfg = cfg.reduced()
    gan = [(f"dcgan_dp_{name}", l, spec["gan_batch"] // 2)
           for name, graph in ST.train_graphs(cfg).items()
           for l in graph.layers]
    forward = ([("vnet_dp", l, half) for l in vnet]
               + [("dcgan_mp2", l, spec["batch"]) for l in shards] + gan)
    train = [("vnet_dp", l, half) for l in vnet] + gan
    return forward, train


# -- the sharded (LM) phase ---------------------------------------------------

def lm_sharded_cases(spec: dict) -> list[dict]:
    """(a) llama3.2-1b on (1 data x 2 model), a bf16 step and an f32
    control; (b) the same with FSDP on (2 data x 1 model); (c) dbrx-132b
    at its moe_groups=4 and 8-bit moments on (1 x 2), one f32 step
    teacher-forced to the ranks' routing."""
    llama = {"arch": "llama3.2-1b", "layers": spec["layers"],
             "batch": LM_SHARDED_BATCH}
    return [{"name": "a_bf16", "mesh": "tp", "dtype": "bfloat16", **llama},
            {"name": "a_f32", "mesh": "tp", "dtype": "float32", **llama},
            {"name": "b_bf16", "mesh": "dp", "dtype": "bfloat16",
             "fsdp": True, **llama},
            {"name": "b_f32", "mesh": "dp", "dtype": "float32",
             "fsdp": True, **llama},
            {"name": "c_moe", "mesh": "tp", "dtype": "float32",
             "arch": "dbrx-132b", "layers": spec["moe_layers"], "batch": 1,
             "moe": True}]


def lm_sharded_serve_cases(spec: dict) -> list[dict]:
    """llama3.2-1b at full width and LM_SHARDED_LAYERS layers served on
    (1 data x 2 model): head-parallel (each rank its 4 of 8 KV heads'
    cache), and split-KV (``kv_seq_shard``: every head, the cache's
    positions cut over ``model``, the partial softmaxes combined)."""
    llama = {"arch": "llama3.2-1b", "layers": spec["layers"],
             "batch": LM_SHARDED_BATCH}
    return [{"name": "serve_heads", **llama},
            {"name": "serve_split_kv", "kv_seq_shard": True, **llama}]


def lm_serve_setup(case: dict, spec: dict, dev):
    """(config, prompt tokens on ``dev``) of a serve case: f32 weights."""
    import torch

    from repro_torch.configs import get_config
    cfg = get_config(case["arch"])
    if spec["reduced"]:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=min(case["layers"],
                                                cfg.n_layers),
                              master_dtype="float32",
                              kv_seq_shard=case.get("kv_seq_shard", False))
    toks = torch.randint(0, cfg.vocab, (case["batch"], LM_TRAIN_SEQ),
                         generator=torch.Generator().manual_seed(7))
    return cfg, toks.to(dev)


def lm_serve_run(cfg, toks, params, dev, mesh=None, specs=None):
    """The prefill of ``toks`` and LM_SHARDED_SERVE_STEPS greedy decode
    steps, on ``mesh`` (this rank's blocks; ``None``: one process): the
    prefill's logits, the decode steps' logits, the greedy tokens and
    the final cache (gathered whole on a mesh), each on the host, and
    the prefill's and decode steps' ms.  The decode cache is the
    prefill's, gathered whole over its heads and cut by
    ``launch.steps.cache_specs`` (positions over ``model`` under
    ``kv_seq_shard``)."""
    import torch

    from repro_torch import tree
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serve_loop import splice
    from repro_torch.sharding import mesh as SM
    from repro_torch.sharding import partition as P
    rows, s = toks.shape
    c_specs = None
    if mesh is not None:
        _, c_specs = ST.cache_specs(cfg, ShapeConfig(
            "d", "decode", LM_SHARDED_SERVE_LEN, rows), mesh)

    def whole(cache):
        leaves = [t for t in tree.leaves(cache) if torch.is_tensor(t)]
        if mesh is None:
            return [t.cpu() for t in leaves]
        out = []
        for t, sp in zip(tree.leaves(cache), P.spec_leaves(c_specs, cache)):
            if torch.is_tensor(t):
                for d, e in enumerate(sp):
                    if e is not None:
                        t = SM.gather(t, mesh, P.spec_axes(e), d)
                out.append(t.cpu())
        return out

    def forward(batch, mode, cache=None):
        if mesh is None:
            return T.forward(params, cfg, batch, mode=mode, cache=cache,
                             param_dtype=torch.float32)
        return ST.serve_forward(params, cfg, batch, mode, cache, mesh,
                                specs, c_specs, torch.float32)

    def synced():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()
    t0 = synced()
    logits, pcache = forward({"tokens": toks}, "prefill")
    prefill_ms = 1e3 * (synced() - t0)
    k, v = pcache["kv"]
    if mesh is not None:
        # the prefill's cache holds this rank's KV heads
        k, v = (SM.gather(t, mesh, ("model",), 3) for t in (k, v))
    cache = T.init_cache(None, cfg, rows, LM_SHARDED_SERVE_LEN, device=dev)
    cache["kv"] = tuple(t.float() for t in cache["kv"])
    cache = splice(cache, {"kv": (k, v)}, s)
    if mesh is not None:
        cache = tree.unflatten(cache, [
            P.local_block(t, sp, mesh).clone() if torch.is_tensor(t) else t
            for t, sp in zip(tree.leaves(cache),
                             P.spec_leaves(c_specs, cache))])
    tok = torch.argmax(logits[:, -1], dim=-1)
    toks_out, d_logits, d_ms = [tok.cpu()], [], []
    for _ in range(LM_SHARDED_SERVE_STEPS):
        t0 = synced()
        lg, cache = forward({"tokens": tok[:, None]}, "decode", cache)
        d_ms.append(1e3 * (synced() - t0))
        d_logits.append(lg.cpu())
        tok = torch.argmax(lg[:, -1], dim=-1)
        toks_out.append(tok.cpu())
    return {"prefill": logits.cpu(), "decode": d_logits,
            "tokens": torch.stack(toks_out), "cache": whole(cache),
            "prefill_ms": prefill_ms, "decode_ms": d_ms}


def lm_sharded_setup(case: dict, spec: dict, dev):
    """(config, global batch on ``dev``, AdamWConfig) of a case."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig
    cfg = get_config(case["arch"])
    if spec["reduced"]:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=min(case["layers"],
                                                cfg.n_layers),
                              fsdp=case.get("fsdp", cfg.fsdp))
    toks = torch.randint(0, cfg.vocab, (case["batch"], LM_TRAIN_SEQ + 1),
                         generator=torch.Generator().manual_seed(7))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    return cfg, batch, AdamWConfig(state_bits=cfg.opt_state_bits)


def lm_sample_index(numel: int):
    """Every k-th flat index of a leaf (at most LM_SHARDED_SAMPLE, and the
    last)."""
    import torch
    k = max(1, numel // LM_SHARDED_SAMPLE)
    return torch.cat([torch.arange(0, numel, k),
                      torch.tensor([numel - 1])]).unique()


def lm_block_samples(t, whole_shape, index):
    """The sampled elements of a whole leaf of ``whole_shape`` that lie in
    this rank's block ``t`` (at ``index``, ``partition.block_index``):
    (their positions in the sample, their values on the CPU, f32)."""
    import torch
    flat = lm_sample_index(math.prod(whole_shape))
    coords = torch.unravel_index(flat, tuple(whole_shape))
    mine = torch.ones_like(flat, dtype=torch.bool)
    local = []
    index = tuple(index) + (slice(None),) * (len(whole_shape) - len(index))
    for c, sl, n in zip(coords, index, whole_shape):
        lo = sl.start or 0
        hi = n if sl.stop is None else sl.stop
        mine &= (c >= lo) & (c < hi)
        local.append(c - lo)
    sel = mine.nonzero()[:, 0]
    vals = t[tuple(c[sel].to(t.device) for c in local)]
    return sel, vals.float().cpu()


@contextlib.contextmanager
def lm_routes(record: list | None = None, force=None):
    """Within: each MoE routing's experts appended to ``record``, or taken
    from ``force`` in call order (the router's own probabilities at
    those experts, renormalised: teacher-forced)."""
    from repro_torch.models import moe as MOE
    real, calls = MOE.route, iter(force or ())

    def route(xf, w_router, k):
        probs, top_p, top_e = real(xf, w_router, k)
        if record is not None:
            record.append(top_e.cpu())
        if force is None:
            return probs, top_p, top_e
        want = next(calls).to(top_e.device)
        top_p = probs.gather(-1, want)
        return probs, top_p / top_p.sum(dim=-1, keepdim=True), want

    MOE.route = route
    try:
        yield
    finally:
        MOE.route = real


def lm_sharded_step(cfg, opt, box: list, batch, dtype, mesh, dev, keep):
    """One ``make_train_step`` step at AdamW step LM_SHARDED_OPT_STEP of
    the parameters in ``box`` (which it empties: two ranks' full-width
    dbrx-132b blocks share one card).  ``keep(kind, i, t)`` takes what
    the caller compares of leaf ``i`` (``"grads"``, as the step hands
    them to its update, ``"params"``, the new 8-bit moments' ``"m_q"``).
    Returns (loss, aux, the new 8-bit moments' scales or None)."""
    import torch

    from repro_torch import tree
    from repro_torch.launch import steps as ST
    from repro_torch.optim import adamw_init
    params = box.pop()
    state = adamw_init(params, opt)
    state = state._replace(step=torch.full((), LM_SHARDED_OPT_STEP,
                                           dtype=torch.int32, device=dev))
    real = ST.adamw_update

    def capture(grads, *a, **kw):
        for i, g in enumerate(grads):
            keep("grads", i, g)
        return real(grads, *a, **kw)
    ST.adamw_update = capture
    try:
        new_p, new_s, m = ST.make_train_step(
            cfg, opt, mesh, getattr(torch, dtype))(params, state, batch)
    finally:
        ST.adamw_update = real
    del params, state
    for i, x in enumerate(tree.leaves(new_p)):
        keep("params", i, x)
    scales = None
    if opt.state_bits == 8:
        moms = tree.leaves(new_s.m, is_leaf=lambda x: hasattr(x, "scale"))
        for i, q in enumerate(moms):
            keep("m_q", i, q.q)
        scales = [float(q.scale) for q in moms]
    return float(m["loss"]), float(m["aux"]), scales


def lm_sharded_rank(rank: int, world: int, backend: str, rendezvous: str,
                    job: str, spec: dict, out_dir: str) -> None:
    """One rank of the sharded (LM) phase (spawned): each case's
    partitioned step on its blocks, timed, its collectives counted by
    axis, its hand-kernel launches (each wrapper's count set to 0 just
    before the step and read just after), its peak memory; and its
    blocks' samples of the gradients, new parameters and (8-bit)
    moments, which the parent holds against the unpartitioned step."""
    sys.path.insert(0, str(ROOT / "src"))
    import pickle

    if spec["one_card"]:
        # two ranks' blocks, gradients and moments share one card (NCCL's
        # ranks, a card each, keep the default allocator)
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    import torch

    from repro_torch import tree
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps as ST
    from repro_torch.sharding import mesh as SM
    from repro_torch.sharding import partition as P
    dev = (torch.device("cuda", 0 if spec["one_card"] else rank)
           if spec["device"] == "cuda" else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    M.init_world(backend, init_method=f"file://{rendezvous}",
                 world_size=world, rank=rank, timeout_s=SHARDED_TIMEOUT)
    rows = []
    try:
        meshes = {"tp": M.make_host_mesh(model=2),
                  "dp": M.make_host_mesh(model=1)}
        for case in lm_sharded_cases(spec):
            mesh = meshes[case["mesh"]]
            cfg, batch, opt = lm_sharded_setup(case, spec, dev)
            specs = ST.param_specs(cfg, mesh)
            whole = ST.real_params(cfg, None, "meta")
            gen = torch.Generator(device=dev).manual_seed(0)
            box = [ST.real_params(cfg, gen, dev, mesh)]
            param_bytes = sum(t.numel() * t.element_size()
                              for t in tree.leaves(box[0]))
            spec_l = tree.leaves(specs, is_leaf=P.is_logical_leaf)
            shapes = [tuple(w.shape) for w in tree.leaves(whole)]
            idx = [P.block_index(mesh, sp, sh)
                   for sp, sh in zip(spec_l, shapes)]
            kept = {"grads": {}, "params": {}, "m_q": {}}

            def keep(kind, i, t_, idx=idx, shapes=shapes, kept=kept):
                kept[kind][i] = lm_block_samples(t_, shapes[i], idx[i])
            routes: list = []
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            SM.reset_collective_stats()
            zero_launch_counts(dk, ck)
            t0 = time.perf_counter()
            with lm_routes(record=routes):
                loss, aux, scales = lm_sharded_step(
                    cfg, opt, box, batch, case["dtype"], mesh, dev, keep)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = launch_counts(dk, ck)
            stats = SM.collective_stats()
            row = {
                "case": case["name"], "rank": rank, "backend": backend,
                "coords": mesh.coords, "loss": loss, "aux": aux,
                "step_ms": 1e3 * seconds, "launches": launches,
                "collectives": {f"{op}/{'+'.join(ax)}": {"calls": n,
                                                         "bytes": b}
                                for (op, ax), (n, b) in stats.items()},
                "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None),
                "param_bytes": param_bytes,
                "whole_param_bytes": sum(t.numel() * t.element_size()
                                         for t in tree.leaves(whole)),
                "routes": routes if rank == 0 else None,
                **{k: [v_[i] for i in sorted(v_)] for k, v_ in kept.items()},
                "m_scale": scales}
            rows.append(row)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        serve = []
        for case in lm_sharded_serve_cases(spec):
            mesh = meshes["tp"]
            cfg, toks = lm_serve_setup(case, spec, dev)
            params = ST.real_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev, mesh)
            SM.reset_collective_stats()
            zero_launch_counts(dk, ck)
            res = lm_serve_run(cfg, toks, params, dev, mesh,
                               ST.param_specs(cfg, mesh))
            stats = SM.collective_stats()
            res.update(case=case["name"], rank=rank,
                       launches=launch_counts(dk, ck),
                       collectives={f"{op}/{'+'.join(ax)}": {"calls": n,
                                                             "bytes": b}
                                    for (op, ax), (n, b) in stats.items()})
            if rank:        # the rows are whole on every rank: keep one
                res["prefill"] = None
            serve.append(res)
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        M.leave_world()
    Path(out_dir, f"{job}.rank{rank}.pkl").write_bytes(
        pickle.dumps({"rank": rank, "rows": rows, "serve": serve}))


def lm_sharded_phase(smi: str, detail: dict, backend: str = "gloo",
                     one_card: bool = True, spec: dict | None = None) -> None:
    """The sharded (LM) phase: the cases on a spawned world of 2 ranks,
    then each against the same step unpartitioned here on the card."""
    import torch

    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.deconv import kernel as dk
    spec = spec or {"device": "cuda", "one_card": one_card,
                    "reduced": False, "layers": LM_SHARDED_LAYERS,
                    "moe_layers": LM_SHARDED_MOE_LAYERS}
    dev = torch.device("cuda", 0) if spec["device"] == "cuda" \
        else torch.device("cpu")
    t_phase = time.perf_counter()
    out = {"card": smi, "backend": backend,
           "note": ("gloo ranks share one card and stage collectives "
                    "through the host: not NCCL's times"
                    if backend == "gloo" else "NCCL, one rank per card")}
    detail["sharded_lm"] = out
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    ranks = spawn_world("lm", 2, backend, spec, target=lm_sharded_rank)
    out["ranks_s"] = time.perf_counter() - t_phase
    by_case = {}
    out["ranks"] = []
    for res in ranks:
        for row in res["rows"]:
            by_case.setdefault(row["case"], []).append(row)
            rec = {"sharded_lm": row["case"], "rank": row["rank"],
                   "backend": backend, "coords": row["coords"],
                   "step_ms": row["step_ms"], "launches": row["launches"],
                   "peak_gb": row["peak_gb"],
                   "param_bytes": row["param_bytes"],
                   "whole_param_bytes": row["whole_param_bytes"],
                   "collectives": row["collectives"]}
            out["ranks"].append(rec)
            print(json.dumps({**rec, "card": smi, "times": out["note"]}))
            check(not any(row["launches"].values()),
                  f"{row['case']} rank {row['rank']} launched hand "
                  f"kernels: {row['launches']}")
    for case in lm_sharded_cases(spec):
        rows = sorted(by_case[case["name"]], key=lambda r: r["rank"])
        check(len({r["loss"] for r in rows}) == 1,
              f"{case['name']}: the ranks' losses {[r['loss'] for r in rows]}")
        zero_launch_counts(dk, ck)
        res = lm_sharded_reference(case, rows, spec, dev)
        res["launches"] = launch_counts(dk, ck)
        out[case["name"]] = res
        print(json.dumps({"sharded_lm_vs_one": case["name"], **res,
                          "card": smi}))
        bf16 = case["dtype"] == "bfloat16"
        tol = LM_SHARDED_BF16_TOL if bf16 else LM_SHARDED_F32_TOL
        check(res["loss_rel_err"] <= (LM_TRAIN_LOSS_TOL if bf16 else tol),
              f"{case['name']}: loss {res['loss_rel_err']:.3g}")
        check(res["grad_rel_err"] <= tol,
              f"{case['name']}: gradients {res['grad_rel_err']:.3g} > {tol}")
        check(res["replicas_equal"],
              f"{case['name']}: ranks' replicated samples differ")
        check(not any(res["launches"].values()),
              f"{case['name']}: the unpartitioned step launched hand "
              f"kernels: {res['launches']}")
        if case.get("moe"):
            check(res["routing_calls"] == res["routing_calls_ranks"],
                  f"{case['name']}: {res['routing_calls']} routings, the "
                  f"ranks' {res['routing_calls_ranks']}")
            check(res["moment_scale_rel_err"] <= tol and
                  res["moment_code_diff"] <= 1,
                  f"{case['name']}: 8-bit moments {res}")
        most = 2 * lm_adam_step() + 0.01 if bf16 else LM_SHARDED_F32_UPDATE
        share = LM_SHARDED_BF16_APART if bf16 else 1.0
        check(res["update_lr_err"] <= most
              and res["update_apart_share"] <= share,
              f"{case['name']}: new parameters {res['update_lr_err']:.3g} "
              f"lr apart (limit {most:.3g}), {res['update_apart_share']:.3g}"
              f" of a leaf's elements beyond {LM_SHARDED_APART} lr "
              f"(limit {share})")
    lm_sharded_serve_check(ranks, spec, dev, smi, backend, out)
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"sharded_lm_s": out["phase_s"], "card": smi}))


def lm_sharded_serve_check(ranks: list, spec: dict, dev, smi: str,
                           backend: str, out: dict) -> None:
    """Each serve case's ranks against the same prefill and greedy decode
    unpartitioned here on ``dev``: the prefill's and every decode step's
    logits and the final cache (gathered) within LM_SHARDED_F32_TOL of
    max |x|, the greedy tokens equal, the ranks' tokens equal, no
    hand-kernel launch."""
    import torch

    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.launch import steps as ST

    def rel(got, want) -> float:
        want = want.double()
        return float((got.double() - want).abs().max()
                     / want.abs().max().clamp_min(1e-30))
    for case in lm_sharded_serve_cases(spec):
        rows = sorted((r for res in ranks for r in res["serve"]
                       if r["case"] == case["name"]),
                      key=lambda r: r["rank"])
        cfg, toks = lm_serve_setup(case, spec, dev)
        params = ST.real_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        zero_launch_counts(dk, ck)
        want = lm_serve_run(cfg, toks, params, dev)
        one_launches = launch_counts(dk, ck)
        del params
        got = rows[0]
        res = {"prefill_rel_err": rel(got["prefill"], want["prefill"]),
               "decode_rel_err": max(rel(a, b) for a, b in
                                     zip(got["decode"], want["decode"])),
               "cache_rel_err": max(rel(a, b) for a, b in
                                    zip(got["cache"], want["cache"])),
               "cache_leaves": [len(got["cache"]), len(want["cache"])],
               "tokens_equal": bool(torch.equal(got["tokens"],
                                                want["tokens"])),
               "ranks_tokens_equal": all(torch.equal(r["tokens"],
                                                     got["tokens"])
                                         for r in rows),
               "prefill_ms": [r["prefill_ms"] for r in rows],
               "decode_ms": [r["decode_ms"] for r in rows],
               "one_prefill_ms": want["prefill_ms"],
               "one_decode_ms": want["decode_ms"],
               "launches": [r["launches"] for r in rows],
               "one_launches": one_launches,
               "collectives": [r["collectives"] for r in rows]}
        out[case["name"]] = res
        print(json.dumps({"sharded_lm_serve": case["name"], **res,
                          "backend": backend, "card": smi}))
        tol = LM_SHARDED_F32_TOL
        check(res["prefill_rel_err"] <= tol and res["decode_rel_err"] <= tol
              and res["cache_rel_err"] <= tol
              and res["cache_leaves"][0] == res["cache_leaves"][1],
              f"{case['name']}: partitioned serve vs one process {res}")
        check(res["tokens_equal"] and res["ranks_tokens_equal"],
              f"{case['name']}: greedy tokens differ {res}")
        check(not any(v for r in res["launches"] + [one_launches]
                      for v in r.values()),
              f"{case['name']}: hand kernels launched {res['launches']}")
        check(any(k.startswith("all_reduce") for k in got["collectives"]),
              f"{case['name']}: no all-reduce over model "
              f"{got['collectives']}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def lm_sharded_reference(case: dict, rows: list, spec: dict, dev) -> dict:
    """The case's step unpartitioned on ``dev`` (dbrx-132b's MoE as the
    plain single-process ``moe_shardmap``, routed as the ranks routed),
    against the ranks' samples: each leaf's max |diff| / max |g| (and of
    the new parameters, in units of the step's update)."""
    import torch

    from repro_torch import tree
    from repro_torch.launch import steps as ST
    from repro_torch.models import moe as MOE
    from repro_torch.optim import cosine_schedule
    cfg, batch, opt = lm_sharded_setup(case, spec, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    box = [ST.real_params(cfg, gen, dev)]
    real_sm = MOE.moe_shardmap
    if case.get("moe"):
        MOE.moe_shardmap = lambda p, x, c: MOE.moe_shardmap_plain(
            p, x, c, 1, 1)
    forced = rows[0]["routes"] if case.get("moe") else None
    seen: list = []
    kept = {"grads": {}, "params": {}, "m_q": {}}

    def keep(kind, i, t_):
        """The sampled elements of the whole leaf, and its max |t|."""
        kept[kind][i] = (t_.reshape(-1)[lm_sample_index(t_.numel()).to(
            t_.device)].float().cpu(), float(t_.abs().max()))
    try:
        with lm_routes(record=seen, force=forced):
            loss, aux, scales = lm_sharded_step(
                cfg, opt, box, batch, case["dtype"], None, dev, keep)
    finally:
        MOE.moe_shardmap = real_sm
    lr = opt.lr * float(cosine_schedule(torch.tensor(LM_SHARDED_OPT_STEP)))

    def compare(key, scale_by=None):
        """The worst leaf's max |diff| / scale, whether the ranks'
        replicated samples agree, and the largest share of a leaf's
        sampled elements more than LM_SHARDED_APART scales apart."""
        worst, replicas, apart = 0.0, True, 0.0
        for i in sorted(kept[key]):
            want, wmax = kept[key][i]
            got = torch.full_like(want, float("nan"))
            for r in rows:
                sel, vals = r[key][i]
                if bool((~torch.isnan(got[sel])).any()):
                    replicas &= bool(torch.equal(
                        got[sel][~torch.isnan(got[sel])],
                        vals[~torch.isnan(got[sel])]))
                got[sel] = vals
            assert not bool(torch.isnan(got).any()), (key, i)
            scale = scale_by or wmax or 1.0
            diff = (got - want).abs() / scale
            worst = max(worst, float(diff.max()))
            apart = max(apart, float((diff > LM_SHARDED_APART).float()
                                     .mean()))
        return worst, replicas, apart

    g_err, g_rep, _ = compare("grads")
    p_err, p_rep, p_apart = compare("params", scale_by=lr)
    res = {"loss": rows[0]["loss"], "loss_one": loss,
           "loss_rel_err": abs(rows[0]["loss"] - loss) / abs(loss),
           "aux": rows[0]["aux"], "aux_one": aux,
           "grad_rel_err": g_err, "update_lr_err": p_err,
           "update_apart_share": p_apart,
           "replicas_equal": g_rep and p_rep, "update_lr": lr,
           "param_bytes_share": [r["param_bytes"] / r["whole_param_bytes"]
                                 for r in rows]}
    if case.get("moe"):
        res["routing_calls"] = len(seen)
        res["routing_calls_ranks"] = len(rows[0]["routes"])
        q_err, _, _ = compare("m_q", scale_by=1.0)
        res["moment_code_diff"] = q_err
        res["moment_scale_rel_err"] = max(
            abs(a - b) / max(b, 1e-30)
            for a, b in zip(rows[0]["m_scale"], scales))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def multi_card(cli, detail: dict, name: str, smi: str) -> int:
    """``--cards N``: the sharded phase's multi-rank runs over NCCL, one
    rank per card (V-Net data-parallel, the DCGAN chain on a 2-way model
    axis, DP GAN steps int8 and f32, a DP V-Net step), every check as in
    the one-card phase; then the result line."""
    import torch
    check(torch.cuda.device_count() >= cli.cards,
          f"--cards {cli.cards}: {torch.cuda.device_count()} cards")
    phase(f"sharded ({cli.cards} cards, NCCL)")
    t0 = time.perf_counter()
    ranks = spawn_world("multi", cli.cards, "nccl",
                        dict(SHARDED_SPEC, one_card=False))
    detail["sharded_cards"] = {"cards": cli.cards, "card": smi,
                               "wall_s": time.perf_counter() - t0,
                               "ranks": [r_["rows"] for r_ in ranks]}
    for res in ranks:
        for row in res["rows"]:
            print(json.dumps({"sharded": "multi", "backend": "nccl",
                              "rank": res["rank"], **row}))
        print(json.dumps({"sharded_rank_launches": "multi",
                          "rank": res["rank"], "launches": res["launches"]}))
        check(all(v_ > 0 for v_ in res["launches"].values()),
              f"rank {res['rank']} launched {res['launches']}")
    print(json.dumps({"sharded_cards_s": detail["sharded_cards"]["wall_s"],
                      "card": smi}))
    phase(f"sharded (LM) ({cli.cards} cards, NCCL)")
    lm_sharded_phase(smi, detail, backend="nccl", one_card=False)
    if cli.json is not None:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(detail, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def _mem_available() -> int:
    """The host's available memory in bytes (``/proc/meminfo``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def lm_train_phase(dev, smi: str, detail: dict, counts, zero_counts) -> None:
    """The train (LM) phase: llama3.2-1b trained through
    ``launch.train.main`` at full width and depth on the card, each step's
    gradients and AdamW update held against the port's CPU, a resume from
    step 2 bit-equal to the uninterrupted run, step times, peak memory and
    one profiled step; then one teacher-forced step of each of
    ``LM_TRAIN``.  No hand kernel may launch."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.data import TokenBatches
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as LT
    from repro_torch.models import moe as LMMOE
    from repro_torch.models import transformer as LMT
    from repro_torch.optim import AdamWConfig, AdamWState

    phase("train (LM)")
    torch.backends.cuda.matmul.allow_tf32 = True
    zero_counts()
    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    detail["train_lm"] = out
    real_grads, real_adamw = ST.lm_grads, ST.adamw_update

    def to(t_, device):
        return tree.tree_map(lambda a: a.to(device), t_)

    def leaf_errs(got, want):
        """Each leaf's max |got - want| / max |want| (on ``got``'s
        device)."""
        errs = []
        for g, w in zip(tree.leaves(got), tree.leaves(want)):
            g, w = g.float(), w.to(g.device).float()
            scale = float(w.abs().max())
            errs.append(float((g - w).abs().max()) / scale if scale
                        else float(g.abs().max()))
        return errs

    def ulps(got, want, *operands) -> float:
        """max |got - want| in units in the last place of the largest of
        them and ``operands`` at each element (f32, one device)."""
        big = torch.maximum(got.abs(), want.abs())
        for o in operands:
            big = torch.maximum(big, o.abs())
        ulp = torch.nextafter(big, torch.full_like(big, math.inf)) - big
        return float(((got - want).abs() / ulp).max())

    def finite(grads) -> bool:
        return all(bool(torch.isfinite(g).all()) for g in tree.leaves(grads))

    real_route = LMMOE.route

    @contextlib.contextmanager
    def routing(record=None, force=None):
        """Within: each MoE call's expert choice and router probabilities
        appended to ``record`` (the card's), or the choice taken from
        ``force`` in call order (the CPU's, teacher-forced: its own router
        probabilities, the card's experts).  Yields what the forced calls
        saw: the tokens routed, the margin (k-th minus (k+1)-th
        probability) of each whose own choice differs, and the largest
        difference between its router probabilities and the card's."""
        calls = iter(force or ())
        seen = {"tokens": 0, "flips": [], "prob_err": 0.0}

        def route(xf, w_router, k):
            probs, top_p, top_e = real_route(xf, w_router, k)
            if record is not None:
                record.append((top_e.cpu(), probs.detach().cpu()))
            if force is None:
                return probs, top_p, top_e
            want, card_probs = next(calls)
            want = want.to(top_e.device)
            seen["tokens"] += top_e.shape[0]
            err = (probs.detach() - card_probs.to(probs.device)).abs()
            seen["prob_err"] = max(seen["prob_err"], float(err.max()))
            srt = torch.sort(probs, dim=-1, descending=True).values
            moved = (want.sort(dim=-1).values
                     != top_e.sort(dim=-1).values).any(dim=-1)
            seen["flips"].extend(float(m) for m in
                                 (srt[:, k - 1] - srt[:, k])[moved].tolist())
            top_p = probs.gather(-1, want)
            return probs, top_p / top_p.sum(dim=-1, keepdim=True), want

        LMMOE.route = route
        try:
            yield seen
        finally:
            LMMOE.route = real_route

    def grads_vs_cpu(params, cfg, batch, param_dtype, card=None):
        """One step's gradients on the card (``card``, or computed) and on
        the CPU from the same parameters and batch (the CPU without remat:
        its values and gradients those with remat, bit for bit): losses,
        MoE terms, the worst leaf's error, finiteness, seconds."""
        t0 = time.perf_counter()
        routes: list = []
        if card is None:
            with routing(record=routes):
                card = real_grads(params, cfg, batch, param_dtype)
        loss, metrics, g_dev = card
        ok = finite(g_dev)
        t1 = time.perf_counter()
        # the forward's MoE calls come first, then the remat's again
        with routing(force=routes[:cfg.n_layers] if routes else None) \
                as seen:
            loss_c, metrics_c, g_cpu = real_grads(
                to(params, "cpu"), dataclasses.replace(cfg, remat=False),
                to(batch, "cpu"), param_dtype)
        t2 = time.perf_counter()
        errs = leaf_errs(g_dev, g_cpu)
        return {"loss": float(loss), "loss_cpu": float(loss_c),
                "routed_tokens": seen["tokens"],
                "routing_flips": len(seen["flips"]),
                "routing_flip_margin": max(seen["flips"], default=0.0),
                "router_prob_err": seen["prob_err"],
                "loss_rel_err": abs(float(loss) - float(loss_c))
                / abs(float(loss_c)),
                "aux": float(metrics["aux"]),
                "aux_cpu": float(metrics_c["aux"]),
                "grad_rel_err": max(errs), "finite": ok,
                "nonfinite_leaves": [i for i, g in enumerate(
                    tree.leaves(g_dev)) if not bool(torch.isfinite(g).all())],
                "worst_leaf": int(np.argmax(errs)),
                "card_s": t1 - t0, "cpu_s": t2 - t1,
                "compare_s": time.perf_counter() - t2}

    def sample(t_):
        """Every k-th element of ``t_`` (at most LM_TRAIN_SAMPLE and the
        last), on the CPU."""
        flat = t_.reshape(-1)
        k = max(1, flat.numel() // LM_TRAIN_SAMPLE)
        idx = torch.cat([torch.arange(0, flat.numel(), k, device=t_.device),
                         torch.tensor([flat.numel() - 1], device=t_.device)])
        return flat[idx].cpu()

    # -- the main path: llama3.2-1b through the launcher ---------------------
    cfg = get_config(LM_TRAIN_ARCH)
    opt_bits = cfg.opt_state_bits
    n_params = LMT.param_count(ST.real_params(cfg, None, "meta"))
    steps: list = []                 # one record per recorded step
    recording = [True]

    def lm_grads(params, lm_cfg, batch, param_dtype=torch.bfloat16):
        card = real_grads(params, lm_cfg, batch, param_dtype)
        if not recording[0]:
            return card
        rec = {"step": len(steps) + 1, "finite": finite(card[2]),
               "loss": float(card[0])}
        steps.append(rec)
        if rec["step"] == 1:
            # the same gradients twice on the card: the floor of the
            # resume's comparison
            again = real_grads(params, lm_cfg, batch, param_dtype)
            rec["repeat_bit_equal"] = all(
                torch.equal(a, b) for a, b in zip(tree.leaves(card[2]),
                                                  tree.leaves(again[2])))
            rec["repeat_rel_err"] = max(leaf_errs(again[2], card[2]))
            del again
            # the f32 control: the step's forward at f32, card vs CPU
            rec["f32_control"] = grads_vs_cpu(params, lm_cfg, batch,
                                              torch.float32)
        if rec["step"] in LM_TRAIN_CPU_STEPS:
            rec.update(grads_vs_cpu(params, lm_cfg, batch, param_dtype,
                                    card))
        return card

    def adamw_update(grads, state, params, opt, lr_scale=1.0, **kw):
        # the gradients sampled first: the step's update frees them
        g_sampled = ([sample(t_) for t_ in tree.leaves(grads)]
                     if recording[0] else None)
        new_p, new_s = real_adamw(grads, state, params, opt, lr_scale, **kw)
        if not recording[0]:
            return new_p, new_s
        t0 = time.perf_counter()
        rec = steps[-1]
        rec["lr_scale"] = float(lr_scale)
        if int(state.step) == 0:
            rec["params_unchanged"] = all(
                torch.equal(a, b) for a, b in zip(tree.leaves(new_p),
                                                  tree.leaves(params)))
        # the update applied on the CPU to the card's gradients, moments
        # and parameters, on a sample of each leaf's elements (the update
        # is elementwise)
        worst = {"params": 0.0, "m": 0.0, "v": 0.0}
        lr_cpu = torch.as_tensor(lr_scale).cpu()
        t_ = (state.step + 1).to(torch.float32)
        rec["bias_corrections_bit_equal"] = all(
            torch.equal((1.0 - b ** t_).cpu(), 1.0 - b ** t_.cpu())
            for b in (opt.b1, opt.b2))
        p_, m_, v_, p2_, m2_, v2_ = (
            [sample(t_) for t_ in tree.leaves(x)]
            for x in (params, state.m, state.v, new_p, new_s.m, new_s.v))
        for p, g, m, v, p2, m2, v2 in zip(p_, g_sampled, m_, v_, p2_, m2_,
                                          v2_):
            cp, cs = real_adamw([g], AdamWState(state.step.cpu(), [m], [v]),
                                [p], opt, lr_cpu)
            for key, got, want, old in (("params", p2, cp[0], p),
                                        ("m", m2, cs.m[0], m),
                                        ("v", v2, cs.v[0], v)):
                worst[key] = max(worst[key], ulps(got, want, old,
                                                  old - want))
        rec["adamw_ulps"] = worst
        rec["adamw_check_s"] = time.perf_counter() - t0
        return new_p, new_s

    check(opt_bits == 32, f"{LM_TRAIN_ARCH}: the update check reads f32 "
          f"moments, not {opt_bits}-bit ones")
    ST.lm_grads, ST.adamw_update = lm_grads, adamw_update
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 1.0, f"train (LM): {held_gb:.2f} GB held on the card")
    ckroot = ROOT / "build" / "train_lm_checkpoints"
    ckroot.mkdir(parents=True, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=ckroot) as ckdir:
            argv = ["--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_STEPS),
                    "--checkpoint-every", "2", "--batch",
                    str(LM_TRAIN_BATCH), "--seq", str(LM_TRAIN_SEQ),
                    "--checkpoint-dir", ckdir, "--device", dev.type]
            t0 = time.perf_counter()
            trainer = LT.main(argv)
            out["run_s"] = time.perf_counter() - t0
            recording[0] = False
            final = to(trainer.params, "cpu")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            # resume from step 2: the newest checkpoint, step 4, removed
            check(sorted(int(p.name.split("_")[1]) for p in
                         Path(ckdir).glob("step_*")) == [2, 4],
                  f"checkpoints {sorted(Path(ckdir).iterdir())}")
            shutil.rmtree(Path(ckdir) / f"step_{LM_TRAIN_STEPS:08d}")
            t0 = time.perf_counter()
            resumed = LT.main(argv + ["--resume"])
            out["resume_s"] = time.perf_counter() - t0
            check(resumed.step == LM_TRAIN_STEPS,
                  f"the resumed run ended at step {resumed.step}")
            out["resume_bit_equal"] = all(
                torch.equal(a.cpu(), b) for a, b in zip(
                    tree.leaves(resumed.params), tree.leaves(final)))
            out["resume_rel_err"] = max(leaf_errs(resumed.params, final))
    finally:
        ST.lm_grads, ST.adamw_update = real_grads, real_adamw
    del final
    out.update(params=n_params, steps=steps)
    print(json.dumps({"train_lm": LM_TRAIN_ARCH, **out}))
    check(len(steps) == LM_TRAIN_STEPS,
          f"{len(steps)} recorded steps, not {LM_TRAIN_STEPS}")
    check(steps[0].get("params_unchanged") is True,
          "step 1 (the cosine schedule's rate 0) moved the parameters")
    check(steps[0]["f32_control"]["grad_rel_err"] <= LM_TRAIN_F32_TOL
          and steps[0]["f32_control"]["finite"],
          f"the f32 control's gradients {steps[0]['f32_control']}")
    for rec in steps:
        check(rec["finite"], f"step {rec['step']}: gradients not finite")
        check(rec["step"] not in LM_TRAIN_CPU_STEPS
              or (rec["grad_rel_err"] <= LM_TRAIN_BF16_TOL
                  and rec["loss_rel_err"] <= LM_TRAIN_LOSS_TOL),
              f"step {rec['step']}: card vs CPU {rec}")
        check(max(rec["adamw_ulps"].values()) <= LM_TRAIN_ULPS,
              f"step {rec['step']}: AdamW update card vs CPU "
              f"{rec['adamw_ulps']} ulps")
    # the resume is the uninterrupted run bit for bit, unless the card's
    # own gradients differ between two runs of one step: then no leaf of
    # the resumed parameters may lie further from the uninterrupted run's,
    # relative to its largest value, than the two runs' gradients lie
    # apart (an AdamW step moves a parameter by a few times lr x the
    # schedule's rate at most, whatever its gradient: 0.03 lr at step 4),
    # and that spread is within the bf16 tolerance
    first = steps[0]
    check(out["resume_bit_equal"]
          or (not first["repeat_bit_equal"]
              and out["resume_rel_err"] <= first["repeat_rel_err"]
              <= LM_TRAIN_BF16_TOL),
          f"the resumed run's parameters differ from the uninterrupted "
          f"run's ({out['resume_rel_err']:.3g}; two runs of step 1's "
          f"gradients: bit-equal {first['repeat_bit_equal']}, "
          f"{first['repeat_rel_err']:.3g})")

    # step times, tokens/s, model FLOP/s, peak memory and one profiled
    # step, on the resumed run's parameters and moments
    step = ST.make_train_step(cfg, AdamWConfig(state_bits=opt_bits))
    batch = TokenBatches(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                         prefetch=False, device=dev).make_batch(LM_TRAIN_STEPS)
    params, state = resumed.params, resumed.opt_state
    del resumed
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    PA = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[PA.CPU, PA.CUDA]) as prof:
        params, state, metrics = step(params, state, batch)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    step_ms = statistics.median(times[1:])
    busy_ms = sum(e.device_time_total for e in ev) / 1e3
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = 6 * n_params * tokens
    out.update(peak_mem_gb=peak_gb, step_ms=step_ms, step_ms_all=times,
               tokens_per_s=tokens / (step_ms / 1e3),
               model_flops=flops,
               mfu_bf16=flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"],
               profile={"kernels": len(ev), "device_busy_ms": busy_ms,
                        "idle_share": 1 - busy_ms / step_ms})
    print(json.dumps({"train_lm_times": LM_TRAIN_ARCH, "card": smi,
                      **{k: out[k] for k in ("peak_mem_gb", "step_ms",
                                             "step_ms_all", "tokens_per_s",
                                             "mfu_bf16", "profile")}}))
    check(math.isfinite(float(metrics["loss"])),
          f"a timed step's loss {float(metrics['loss'])}")
    del params, state, metrics, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # -- one teacher-forced step of each other family ------------------------
    out["cells"] = {}
    for cell in LM_TRAIN:
        t_model = time.perf_counter()
        lm_cfg = get_config(cell.arch)
        full_layers = lm_cfg.n_layers
        if cell.layers is not None:
            lm_cfg = dataclasses.replace(lm_cfg, n_layers=cell.layers)
        row = {"train_lm_cell": cell.arch, "card": smi,
               "batch": [cell.batch, LM_TRAIN_SEQ]}
        if cell.host_need:
            f32_bytes = 4 * LMT.param_count(
                ST.real_params(lm_cfg, None, "meta"))
            avail = _mem_available()
            row.update(host_available_gb=avail / 1e9,
                       host_need_gb=cell.host_need * f32_bytes / 1e9)
            if avail < cell.host_need * f32_bytes:
                lm_cfg = lm_cfg.reduced()
                row["reduced"] = "the host cannot hold its CPU side"
        held_gb = torch.cuda.memory_allocated() / 1e9
        check(held_gb < 1.0, f"{cell.arch}: {held_gb:.2f} GB held on the "
              f"card before its weights")
        torch.cuda.reset_peak_memory_stats()
        params = ST.real_params(
            lm_cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batch = TokenBatches(lm_cfg.vocab, cell.batch, LM_TRAIN_SEQ,
                             prefetch=False, extra_fn=LT.lm_extra(lm_cfg),
                             device=dev).make_batch(0)
        row.update(layers=f"{lm_cfg.n_layers} of {full_layers}",
                   params=LMT.param_count(params),
                   bf16=grads_vs_cpu(params, lm_cfg, batch, torch.bfloat16))
        if cell.f32_tol is not None:
            row["f32_control"] = grads_vs_cpu(params, lm_cfg, batch,
                                              torch.float32)
        row.update(peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   model_s=time.perf_counter() - t_model,
                   bf16_tol=str(cell.bf16_tol), f32_tol=cell.f32_tol)
        print(json.dumps(row))
        out["cells"][cell.arch] = row
        for key, tol in (("bf16", cell.bf16_tol),
                         ("f32_control", cell.f32_tol)):
            if tol is None:
                continue
            r = row[key]
            check(r["finite"] and r["grad_rel_err"] <= tol
                  and r["loss_rel_err"] <= LM_TRAIN_LOSS_TOL,
                  f"{cell.arch}: {key} card vs CPU {r}")
            if lm_cfg.family == "moe":
                check(r["aux"] > 0 and abs(r["aux"] - r["aux_cpu"])
                      <= LM_TRAIN_LOSS_TOL * r["aux_cpu"]
                      and r["routed_tokens"] > 0
                      and r["router_prob_err"] <= LM_TRAIN_ROUTE_TIE
                      and r["routing_flip_margin"] <= LM_TRAIN_ROUTE_TIE
                      and r["routing_flips"]
                      <= LM_TRAIN_FLIP_SHARE * r["routed_tokens"],
                      f"{cell.arch}: {key} load-balance term or routing "
                      f"{r}")
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = counts()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"train_lm_launches": launches,
                      "train_lm_s": out["phase_s"]}))
    check(not any(launches.values()),
          f"the LM training path launched hand kernels: {launches}")


# -- the dry run phase ---------------------------------------------------------

# the production cell it traces (rank 0 of the 16 x 16 layout, no world)
DRYRUN_CELL = ("llama3.2-1b", "train_4k")


def dryrun_phase(dev, smi: str, detail: dict) -> None:
    """The dry run (``launch.dryrun``) against the steps it predicts:
    (a) llama3.2-1b at full width and depth at the train (LM) phase's
    shape on a 1 x 1 mesh without a world: its argument bytes and FLOPs
    held exactly against one real step on the card (``FlopCounterMode``),
    its roofline printed beside that phase's median step and peak memory;
    (b) V-Net training at full width on a 1 x 1 mesh: the kernel
    wrappers' dry tally held against ``train_step_launches`` and the
    launches the train phase counted, its roofline beside the measured
    step; (c) one production cell on the abstract 16 x 16 layout, which
    must trace ``ok``.  Reads ``detail["train_lm"]``,
    ``detail["train"]["v-net"]`` and ``detail["train_step_ms"]["v-net"]``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.data import TokenBatches
    from repro_torch.launch import analysis as AN
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.optim import AdamWConfig, adamw_init

    phase("dry run")
    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    detail["dryrun"] = out
    one = abstract_mesh((1, 1))
    keys = ("compute_s", "memory_s", "collective_s", "step_s", "dominant")

    # (a) llama3.2-1b, the train (LM) phase's shape
    cfg = get_config(LM_TRAIN_ARCH)
    shape = ShapeConfig("train_lm", "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH)
    t0 = time.perf_counter()
    bundle = ST.build_bundle(cfg, shape, one)
    _, rec = AN.analyse_step(bundle.fn, bundle.args, one, 1,
                             alias=bundle.args[:2])
    trace_s = time.perf_counter() - t0
    opt = AdamWConfig(state_bits=cfg.opt_state_bits)
    torch.cuda.empty_cache()
    params = ST.real_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    state = adamw_init(params, opt)
    batch = TokenBatches(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                         prefetch=False, device=dev).make_batch(0)
    real_bytes = AN.tree_bytes((params, state, batch))
    with FlopCounterMode(display=False) as fc:
        ST.make_train_step(cfg, opt)(params, state, batch)
    torch.cuda.synchronize()
    real_flops = fc.get_total_flops()
    del params, state, batch
    torch.cuda.empty_cache()
    lm = detail.get("train_lm", {})
    rl = rec["roofline"]
    out["llama"] = {
        "shape": [LM_TRAIN_BATCH, LM_TRAIN_SEQ], "trace_s": trace_s,
        "predicted": {**{k: rl[k] for k in keys},
                      "step_ms": 1e3 * rl["step_s"],
                      "total_per_device_gb":
                          rec["memory"]["total_per_device"] / 1e9,
                      "flops": rl["flops_per_device"]},
        "memory": rec["memory"],
        "measured": {"step_ms": lm.get("step_ms"),
                     "peak_mem_gb": lm.get("peak_mem_gb")},
        "argument_bytes": rec["memory"]["argument_bytes"],
        "real_step_bytes": real_bytes,
        "real_step_flops": real_flops}
    print(json.dumps({"dryrun_llama": out["llama"]}))
    check(rec["memory"]["argument_bytes"] == real_bytes,
          f"dry run: llama's argument bytes {rec['memory']['argument_bytes']}"
          f" against the real step's {real_bytes}")
    check(rl["flops_per_device"] == real_flops,
          f"dry run: llama's abstract FLOPs {rl['flops_per_device']} "
          f"against the real step's {real_flops}")

    # (b) V-Net training, its kernels' tally
    cfg = get_config("v-net")
    bundle = ST.build_bundle(cfg, None, one)
    _, rec = AN.analyse_step(bundle.fn, bundle.args, one, 1,
                             alias=bundle.args[:2])
    tally = {k: v["calls"] for k, v in rec["kernels"].items()}
    want = ST.train_step_launches(cfg)
    counted = detail["train"]["v-net"]["counted_per_step"]
    ms = detail["train_step_ms"]["v-net"]
    rl = rec["roofline"]
    out["vnet"] = {
        "batch": cfg.dcnn_batch, "tally": tally, "kernels": rec["kernels"],
        "train_step_launches": want, "counted_per_step": counted,
        "predicted": {**{k: rl[k] for k in keys},
                      "step_ms": 1e3 * rl["step_s"],
                      "kernel_flops": rec["kernel_flops"],
                      "total_per_device_gb":
                          rec["memory"]["total_per_device"] / 1e9},
        "measured": {"step_ms": ms,
                     "median_ms_after_first": statistics.median(ms[1:])}}
    print(json.dumps({"dryrun_vnet": out["vnet"]}))
    check(tally == want and all(c == tally for c in counted),
          f"dry run: V-Net's tally {tally}, train_step_launches {want}, "
          f"counted per step {counted}")

    # (c) one production cell on the abstract 16 x 16 layout
    prod = DR.run_cell(*DRYRUN_CELL, False, probe=False)
    out["production"] = {k: prod.get(k) for k in
                         ("arch", "shape", "mesh", "status", "trace_s",
                          "roofline", "memory", "error")}
    print(json.dumps({"dryrun_production": out["production"]}))
    check(prod["status"] == "ok",
          f"dry run: {DRYRUN_CELL} on 16 x 16 is {prod['status']}: "
          f"{prod.get('error')}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(json.dumps({"dryrun_s": out["phase_s"], "card": smi}))


def main() -> int:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="write every check and time to this file")
    parser.add_argument("--cards", type=int, default=1,
                        help="with more than 1: build, then run only the "
                             "sharded phase's multi-rank runs over NCCL, "
                             "one rank per card")
    cli = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch import obs, quant, tree, tune
    from repro_torch.configs import get_config
    from repro_torch.core import functional as tfunc
    from repro_torch.core import networks as nets
    from repro_torch.core import tiling
    from repro_torch.core.engine import (
        EngineConfig,
        UniformEngine,
        compile_network,
        init_network_weights,
    )
    from repro_torch.kernels import build
    from repro_torch.kernels.conv import kernel as ck
    from repro_torch.kernels.conv import ops as cops
    from repro_torch.kernels.conv import ref as cref
    from repro_torch.kernels.deconv import kernel as dk
    from repro_torch.kernels.deconv import ops as dops
    from repro_torch.kernels.deconv import ref as dref
    from repro_torch.launch import steps as ST
    from repro_torch.models import dcnn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.dcnn_server import (
        DcnnServer,
        ServeRequest,
        dcgan_gen_spec,
        pad_to,
        vnet_spec,
    )
    from repro_torch.runtime.faults import FaultEvent, FaultScript
    from repro_torch.runtime.serving import Backoff, DispatchFailedError

    detail: dict = {}
    # -- 1. device ----------------------------------------------------------
    phase("device")
    name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {name}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    detail["card"] = smi
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    engine = UniformEngine(device=dev)

    # -- 2. build -----------------------------------------------------------
    phase("build")
    t0 = time.perf_counter()
    _, log = build.build()
    build.library()
    detail["build_s"] = time.perf_counter() - t0
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             log))
    detail["ptxas"] = {"kernels": len(regs), "max_registers": max(regs,
                                                                  default=0),
                       "spill_store_bytes": spills}
    # per source: no kernel may spill
    for src_log in log.split("== ")[1:]:     # one per nvcc process
        src = src_log.split()[0]
        src_regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                               src_log)]
        row = detail["ptxas"].setdefault(src, {
            "kernels": 0, "max_registers": 0, "spill_store_bytes": 0})
        row["kernels"] += len(src_regs)
        row["max_registers"] = max([row["max_registers"], *src_regs])
        row["spill_store_bytes"] += sum(int(m) for m in re.findall(
            r"(\d+) bytes spill stores", src_log))
        # per object: the forward parts 0-1 are the FMA route, 2-3 the bf16
        # route (bf16 x bf16), 4-7 the TF32 route (f32 x int8, bf16 x
        # int8), 8-10 the s8 route (A copies of 16, 4, 1 bytes)
        head = src_log.split("\n", 1)[0]
        unit = " ".join(head.split("(")[0].split())
        detail["ptxas"].setdefault("units", {})[unit] = {
            "compile_s": float(re.findall(r"\(([\d.]+) s\)", head)[0]),
            "kernels": len(src_regs),
            "max_registers": max(src_regs, default=0),
            "spill_store_bytes": sum(int(m) for m in re.findall(
                r"(\d+) bytes spill stores", src_log))}
    print(f"build_s {detail['build_s']:.1f} ptxas {detail['ptxas']}")
    for src_log in log.split("== ")[1:]:     # the lines of any spill
        lines = src_log.splitlines()
        for i, line in enumerate(lines):
            if re.search(r"[1-9]\d* bytes spill stores", line):
                print("SPILL", lines[0], *lines[max(0, i - 3):i + 1],
                      sep="\n  ")
    for src in ("deconv_fwd.cu", "conv_fwd.cu", "deconv_dw.cu"):
        if src in detail["ptxas"]:      # absent when the build was cached
            check(detail["ptxas"][src]["spill_store_bytes"] == 0,
                  f"{src}: ptxas reports spill stores")
    units = detail["ptxas"].get("units", {})
    for unit, row in units.items():
        check(row["kernels"] > 0 and row["spill_store_bytes"] == 0,
              f"{unit}: {row['kernels']} kernels, "
              f"{row['spill_store_bytes']} bytes of spill stores")
    if units:
        check(len(units) == len(build.compile_units()),
              f"ptxas reported {len(units)} of "
              f"{len(build.compile_units())} objects")
    if cli.cards > 1:
        return multi_card(cli, detail, name, smi)

    # -- helpers --------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    # op -> (main-path wrapper arguments, kernel wrapper, plain version)
    KERNELS = {"deconv": (dops.deconv_kernel_args, dk.deconv_fwd,
                          dref.deconv_fwd_plain),
               "conv": (cops.conv_kernel_args, ck.conv_fwd,
                        cref.conv_fwd_plain)}

    def operands(op, in_spatial, cin, w_shape, dtype, stride, padding,
                 dilation=1, groups=1, bias=True, scale=False,
                 activation="none", alpha=0.2, batch=BATCH):
        """Random main-path operands -> (x, w, b, s, wrapper args)."""
        x = rand((batch, *in_spatial, cin), dtype)
        fan_in = math.prod(w_shape[:-1])
        w = rand(w_shape, dtype, 1.0 / math.sqrt(fan_in))
        b = rand((w_shape[-1],), dtype, 0.1) if bias else None
        s = (rand((w_shape[-1],), torch.float32).abs() + 0.5) if scale \
            else None
        args = KERNELS[op][0](x, w, stride, padding, dilation=dilation,
                              groups=groups, bias=b, w_scale=s,
                              activation=activation, alpha=alpha,
                              engine=engine)
        return x, w, b, args

    def layer_operands(layer, dtype, batch=BATCH):
        epi = layer.epilogue
        return operands(layer.op, layer.in_spatial, layer.cin,
                        layer.weight_shape, dtype, layer.stride,
                        layer.padding, layer.dilation, layer.groups,
                        bias=epi.bias, activation=epi.activation,
                        alpha=epi.alpha, batch=batch)

    def run_kernel(op, args):
        x3, wk, kw, _ = args
        return KERNELS[op][1](x3, wk, **kw)

    def run_plain(op, args):
        x3, wk, kw, _ = args
        kw = {k: v for k, v in kw.items() if k not in TILE_KWARGS}
        return KERNELS[op][2](x3, wk, **kw)

    def run_plain64(op, args):
        """The plain version summed in float64 (the operands' values
        exact there)."""
        x3, wk, kw, _ = args
        kw = {k: v for k, v in kw.items() if k not in TILE_KWARGS}
        return KERNELS[op][2](x3.double(), wk.double(),
                              **dict(kw, out_dtype=torch.float64))

    def fwd_launches():
        """Both forward wrappers' launches so far, by (x, w, route,
        passes): the wrappers' launch records (``operand_launches``)."""
        out = {}
        for mod in (dk, ck):
            for k_, v_ in mod.operand_launches.items():
                out[k_] = out.get(k_, 0) + v_
        return out

    def launches_since(before):
        """``fwd_launches()`` less ``before``, the launches in between."""
        return {k_: v_ - before.get(k_, 0)
                for k_, v_ in fwd_launches().items()
                if v_ != before.get(k_, 0)}

    def check_routes(tag, codes):
        """Every launch in ``codes`` ran its operand pair's kernel, at its
        passes, as its C entry reported."""
        for key, n in codes.items():
            want = launch_key(*key[:2])
            check(key == want, f"{tag}: {n} launches of {key[0]} x "
                  f"{key[1]} on {key[2:]}, not {want[2:]}")

    dcgan_layers = dcgan_gen_spec(chans=DCGAN_CHANS).graph_for(None).layers
    vnet_layers = nets.vnet_graph(in_spatial=VNET_SPATIAL,
                                  chans=VNET_CHANS).layers
    train_cfgs = {arch: get_config(arch) for arch in TRAIN_STEPS}
    # every training geometry: the DCGAN generator and discriminator at
    # batch 64, V-Net at batch 4
    train_layers = [(name, l, cfg.dcnn_batch)
                    for cfg in train_cfgs.values()
                    for name, graph in ST.train_graphs(cfg).items()
                    for l in graph.layers]

    def distinct(layers):
        """(model, layer, batch) triples, one per layer geometry."""
        seen, out = set(), []
        for model, l, batch in layers:
            key = (l.op, l.in_spatial, l.cin, l.weight_shape, l.stride,
                   l.padding, l.dilation, l.groups, l.epilogue, batch)
            if key not in seen:
                seen.add(key)
                out.append((model, l, batch))
        return out

    # the paper-benchmark path: the GP-GAN and 3D-GAN generators at full
    # width, batch 4, and 3D-GAN's GAN train step at its config's batch (32)
    paper_cfgs = {arch: get_config(arch) for arch in PAPER_GENERATORS}
    gan3d_cfg = paper_cfgs["3d_gan"]
    paper_layers = [(arch, l, BATCH) for arch in PAPER_GENERATORS
                    for l in dcnn._generator_graph(arch, False).layers]
    train_layers += [(f"3d_gan_{name}", l, gan3d_cfg.dcnn_batch)
                     for name, graph in ST.train_graphs(gan3d_cfg).items()
                     for l in graph.layers]
    # the sharded path's geometries: V-Net at 2 per rank, the DCGAN chain's
    # channel shards, the DP GAN's networks at 32 per rank
    sharded_fwd, sharded_train = sharded_geometries(SHARDED_SPEC)
    train_layers += sharded_train

    # every forward geometry of the main paths, served (batch 4) and
    # trained (V-Net trains at the served shapes)
    main_layers = distinct([("dcgan", l, BATCH) for l in dcgan_layers]
                           + [("vnet", l, BATCH) for l in vnet_layers]
                           + paper_layers + train_layers + sharded_fwd)

    # -- 3. kernels against their plain versions ------------------------------
    phase("kernels vs plain versions")
    # each kernel's worst f32 error against its plain version
    max_abs = {"deconv_fwd": 0.0, "conv_fwd": 0.0, "deconv_dw": 0.0,
               "deconv_dx": 0.0, "deconv_fwd_int8": 0.0,
               "conv_fwd_int8": 0.0}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for model, layer, batch in main_layers:
            cases.append((f"{model}:{layer.name}:b{batch}", layer.op, dtype,
                          lambda l=layer, d=dtype, n=batch:
                          layer_operands(l, d, n)))
        extra = [
            ("groups2+dil2+scale+leaky", "deconv", (6, 7, 5), 16,
             (3, 3, 3, 8, 24), 2, 1, 2, 2),
            ("groups2+dil2+scale+leaky", "conv", (9, 7, 8), 16,
             (3, 3, 3, 8, 24), 2, 1, 2, 2),
            ("rank1", "deconv", (50,), 12, (5, 12, 20), 3, ((1, 2),), 1, 1),
            ("rank1", "conv", (50,), 12, (5, 12, 20), 2, 2, 1, 1),
            ("k5s1", "deconv", (12, 12, 12), 16, (5, 5, 5, 16, 32), 1, 2,
             1, 1),
            ("k5s1", "conv", (12, 12, 12), 16, (5, 5, 5, 16, 32), 1, 2, 1,
             1),
        ]
        for tag, op, sp, cin, ws, st, pad, dil, g in extra:
            cases.append((tag, op, dtype, lambda op=op, sp=sp, cin=cin,
                          ws=ws, st=st, pad=pad, dil=dil, g=g, d=dtype:
                          operands(op, sp, cin, ws, d, st, pad, dil, g,
                                   scale=True, activation="leaky_relu",
                                   alpha=0.1, batch=2)))
    detail["checks"] = []
    for tag, op, dtype, make in cases:
        _, _, _, args = make()
        before = fwd_launches()
        got = run_kernel(op, args)
        codes = launches_since(before)
        torch.cuda.synchronize()
        ref = run_plain(op, args)
        err = float((got.float() - ref.float()).abs().max())
        mag = float(ref.float().abs().max())
        dname = str(dtype).split(".")[-1]
        rel = err / mag if mag else err
        route = PAIR_ROUTE[(dname, dname)]
        print(json.dumps({"check": tag, "op": op, "dtype": dname,
                          "route": route, "shape": list(got.shape),
                          "max_abs_err": err, "rel_err": rel,
                          "tol": TOL[dname]}))
        detail["checks"].append({"check": tag, "op": op, "dtype": dname,
                                 "route": route, "max_abs_err": err,
                                 "rel_err": rel})
        check(codes == {launch_key(dname, dname): 1}, f"{tag}/{op}/{dname}: "
              f"launches by operands and route {codes}")
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"{tag}/{op}/{dname}: kernel output {got.shape} {got.dtype} "
              f"vs plain {ref.shape} {ref.dtype}")
        check(rel <= TOL[dname], f"{tag}/{op}/{dname}: relative error "
              f"{rel:.3g} above {TOL[dname]}")
        if dtype == torch.float32:
            max_abs[f"{op}_fwd"] = max(max_abs[f"{op}_fwd"], err)
        del got, ref, args
    torch.cuda.empty_cache()

    # -- 3a. the forward block's code paths -----------------------------------
    # each case in f32 and bf16, run twice (the same bits both times) and
    # held against the plain version at TOL: one geometry split by the
    # planner and forced unsplit (the two sum in different orders, so they
    # need not agree bit for bit with each other), scalar copies (Ci 1, 3,
    # 6; Co 2, 3), ragged rows and channel tiles, groups whose Cig is not a
    # multiple of 4, and forced splits of shallow-grid shapes.  The
    # wrappers call tiling.launch_split per launch; it is wrapped here to
    # record each launch's slices, and to force them in these cases only
    phase("forward kernel paths")
    real_split = tiling.launch_split
    split_log, force = [], [None]

    def logged_split(*a, **k):
        out = (force[0] or real_split)(*a, **k)
        split_log.append(out[0])
        return out

    def forced(n):
        """launch_split giving about n slices to every launch (1: none)."""
        def f(plan, rows, depth, cout, groups, phases=1):
            if n == 1:
                return tiling.split_reduction(1 << 30, depth, 1)
            return tiling.split_reduction(1, depth, n, phases)
        return f

    tiling.launch_split = logged_split
    dpad2, dpad3 = ((0, 1),) * 2, ((0, 1),) * 3
    # (tag, op, in_spatial, cin, w_shape, stride, padding, groups, batch,
    #  slices forced: None = the planner's; whether the run must split,
    #  None: either)
    path_cases = [
        ("dcgan:deconv1:planner", "deconv", (4, 4), 1024,
         (3, 3, 1024, 512), 2, dpad2, 1, 4, None, True),
        ("dcgan:deconv1:unsplit", "deconv", (4, 4), 1024,
         (3, 3, 1024, 512), 2, dpad2, 1, 4, 1, False),
        ("vnet:enc5:planner", "conv", (16, 16, 8), 128,
         (3, 3, 3, 128, 256), 2, 1, 1, 4, None, True),
        ("vnet:enc5:unsplit", "conv", (16, 16, 8), 128,
         (3, 3, 3, 128, 256), 2, 1, 1, 4, 1, False),
        ("scalar:ci1", "conv", (20, 18, 9), 1, (3, 3, 3, 1, 16), 1, 1, 1,
         2, None, None),
        ("scalar:ci3", "conv", (33, 31), 3, (3, 3, 3, 8), 2, 1, 1, 3, None,
         None),
        ("scalar:ci6", "deconv", (9, 11, 7), 6, (3, 3, 3, 6, 16), 2, dpad3,
         1, 2, None, None),
        ("scalar:co2", "conv", (21, 19, 10), 16, (1, 1, 1, 16, 2), 1, 0, 1,
         2, None, None),
        ("scalar:co3", "deconv", (17, 15), 128, (3, 3, 128, 3), 2, dpad2,
         1, 3, None, None),
        ("scalar:co3:split", "deconv", (17, 15), 128, (3, 3, 128, 3), 2,
         dpad2, 1, 3, 4, True),
        ("ragged:co24", "conv", (13, 11, 7), 32, (3, 3, 3, 32, 24), 1, 1,
         1, 3, None, None),
        ("ragged:co48", "deconv", (7, 9, 5), 24, (3, 3, 3, 24, 48), 2,
         dpad3, 1, 3, None, None),
        ("ragged:co80", "conv", (9, 7, 6), 64, (3, 3, 3, 64, 80), 2, 1, 1,
         3, None, None),
        ("ragged:co80:split", "conv", (9, 7, 6), 64, (3, 3, 3, 64, 80), 2,
         1, 1, 3, 3, True),
        ("groups2:cig6", "conv", (11, 9, 8), 12, (3, 3, 3, 6, 20), 1, 1, 2,
         2, None, None),
        ("groups3:cig6", "deconv", (7, 6, 5), 18, (3, 3, 3, 6, 30), 2,
         dpad3, 3, 2, None, None),
        ("groups2:cig10:split", "conv", (11, 9, 8), 20, (3, 3, 3, 10, 28),
         1, 1, 2, 2, 2, True),
    ]
    detail["path_checks"] = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (tag, op, sp, cin, ws, st, pad, g, batch, n_split,
             must_split) in path_cases:
            force[0] = None if n_split is None else forced(n_split)
            _, _, _, args = operands(op, sp, cin, ws, dtype, st, pad,
                                     groups=g, scale=True,
                                     activation="leaky_relu", alpha=0.1,
                                     batch=batch)
            split_log.clear()
            before = fwd_launches()
            got = run_kernel(op, args)
            again = run_kernel(op, args)
            codes = launches_since(before)
            torch.cuda.synchronize()
            force[0] = None
            ref = run_plain(op, args)
            err = float((got.float() - ref.float()).abs().max())
            mag = float(ref.float().abs().max())
            rel = err / mag if mag else err
            route = PAIR_ROUTE[(dname, dname)]
            check(codes == {launch_key(dname, dname): 2}, f"{tag}/{dname}: "
                  f"launches by operands and route {codes}")
            row = {"check": tag, "op": op, "dtype": dname, "route": route,
                   "shape": list(got.shape), "splits": split_log[0],
                   "block_co": args[2]["block_co"],
                   "repeat_equal": bool(torch.equal(got, again)),
                   "max_abs_err": err, "rel_err": rel, "tol": TOL[dname]}
            print(json.dumps(row))
            detail["path_checks"].append(row)
            check(len(split_log) == 2 and split_log[0] == split_log[1],
                  f"{tag}/{dname}: launches split {split_log}")
            check(must_split is None or (split_log[0] > 1) == must_split,
                  f"{tag}/{dname}: {split_log[0]} slices")
            check(row["repeat_equal"], f"{tag}/{dname}: a repeated launch "
                  f"gave other bits")
            check(got.shape == ref.shape and got.dtype == ref.dtype,
                  f"{tag}/{dname}: {got.shape} {got.dtype} vs plain "
                  f"{ref.shape} {ref.dtype}")
            check(rel <= TOL[dname], f"{tag}/{dname}: relative error "
                  f"{rel:.3g} above {TOL[dname]}")
            if dtype == torch.float32:
                max_abs[f"{op}_fwd"] = max(max_abs[f"{op}_fwd"], err)
            del got, again, ref, args
    torch.cuda.empty_cache()

    # bf16 x bf16 with f32 output against float64 of the same bf16
    # operands, at W8_TOL: the bf16 route keeps its f32 sums in the mma's
    # registers, whose truncation grows with the reduction's depth; depths
    # 864 (V-Net merge4's 27 x 32), 3,456 (enc5's 27 x 128) and 4,096
    # (DCGAN deconv1's deepest phase, 4 x 1,024), unsplit and split, each
    # launch run twice for the same bits; the unsplit deconv on the gather
    # (the wgmma route made to decline) and on the wgmma route, its sums in
    # wgmma's registers
    bf16_deep_cases = [
        ("bf16:d864:unsplit", "conv", (13, 11, 9), 32, (3, 3, 3, 32, 32),
         1, 1, 1, 2, 1, False),
        ("bf16:d864:split", "conv", (13, 11, 9), 32, (3, 3, 3, 32, 32),
         1, 1, 1, 2, 3, True),
        ("bf16:d3456:unsplit", "conv", (16, 16, 8), 128,
         (3, 3, 3, 128, 256), 2, 1, 1, 4, 1, False),
        ("bf16:d3456:planner", "conv", (16, 16, 8), 128,
         (3, 3, 3, 128, 256), 2, 1, 1, 4, None, True),
        ("bf16:d4096:unsplit", "deconv", (4, 4), 1024, (3, 3, 1024, 512),
         2, dpad2, 1, 4, 1, False),
        ("bf16:d4096:wgmma", "deconv", (4, 4), 1024, (3, 3, 1024, 512),
         2, dpad2, 1, 4, 1, False),
        ("bf16:d4096:planner", "deconv", (4, 4), 1024, (3, 3, 1024, 512),
         2, dpad2, 1, 4, None, True),
    ]
    detail["bf16_f32_checks"] = []
    for (tag, op, sp, cin, ws, st, pad, g, batch, n_split,
         must_split) in bf16_deep_cases:
        force[0] = None if n_split is None else forced(n_split)
        real_wgmma = tiling.plan_wgmma
        if tag == "bf16:d4096:unsplit":
            tiling.plan_wgmma = lambda *a_, **k_: None
        _, _, _, (x3, wk, kw, rest) = operands(
            op, sp, cin, ws, torch.bfloat16, st, pad, groups=g, scale=True,
            activation="leaky_relu", alpha=0.1, batch=batch)
        kw = dict(kw, out_dtype=torch.float32)
        split_log.clear()
        before = fwd_launches()
        got = KERNELS[op][1](x3, wk, **kw)
        again = KERNELS[op][1](x3, wk, **kw)
        codes = launches_since(before)
        torch.cuda.synchronize()
        force[0] = None
        tiling.plan_wgmma = real_wgmma
        ref = run_plain64(op, (x3, wk, kw, rest))
        err = float((got.double() - ref).abs().max())
        mag = float(ref.abs().max())
        rel = err / mag if mag else err
        row = {"check": tag, "op": op, "pair": "bfloat16/bfloat16",
               "route": PAIR_ROUTE[("bfloat16", "bfloat16")],
               "out": "float32", "shape": list(got.shape),
               "depth": math.prod(ws[:-2]) * ws[-2] if op == "conv" else
               math.prod(-(-k // st) for k in ws[:-2]) * ws[-2],
               "splits": split_log[0], "block_co": kw["block_co"],
               "repeat_equal": bool(torch.equal(got, again)),
               "max_abs_err": err, "rel_err": rel, "tol": W8_TOL}
        print(json.dumps(row))
        detail["bf16_f32_checks"].append(row)
        check(codes == {launch_key("bfloat16", "bfloat16"): 2},
              f"{tag}: launches by operands and route {codes}")
        check(len(split_log) == 2 and split_log[0] == split_log[1],
              f"{tag}: launches split {split_log}")
        check((split_log[0] > 1) == must_split,
              f"{tag}: {split_log[0]} slices")
        check(row["repeat_equal"], f"{tag}: a repeated launch gave other "
              f"bits")
        check(got.shape == ref.shape and got.dtype == torch.float32,
              f"{tag}: {got.shape} {got.dtype} vs plain {ref.shape}")
        check(rel <= W8_TOL, f"{tag}: relative error {rel:.3g} above "
              f"{W8_TOL}")
        del x3, wk, kw, got, again, ref
    check(sorted({r_["depth"] for r_ in detail["bf16_f32_checks"]})
          == [864, 3456, 4096], "bf16 f32-output depths "
          f"{[r_['depth'] for r_ in detail['bf16_f32_checks']]}")
    torch.cuda.empty_cache()

    # bf16 x bf16 launches that stage each box's input footprint once
    # (igemm_bf16_halo_kernel, tiling.plan_halo): each case run twice for
    # the same bits, held against the plain version at TOL and, with f32
    # output, against float64 at W8_TOL; the staging each launch reports
    # must be the planner's (the wrappers raise otherwise).  A case names
    # the staging the planner must choose ("halo", "gather"), or a box
    # to force a halo where the planner keeps the gather (its
    # cost model: stride-2 layers), so that those footprints' arithmetic
    # (phases of 1-8 taps, residue classes, ragged boxes) runs on the card
    # too; the planner's own choice is recorded beside it.
    # (tag, op, in_spatial, cin, w_shape, stride, padding, dilation,
    #  groups, batch, staging)
    halo_cases = [
        ("halo:deconv:taps1-8:forced", "deconv", (17, 15, 13), 32,
         (3, 3, 3, 32, 16), 2, dpad3, 1, 1, 2, ((4, 8, 8),)),
        ("halo:vnet:enc2:s2:forced", "conv", VNET_SPATIAL, 16,
         (3, 3, 3, 16, 32), 2, 1, 1, 1, 1, ((2, 8, 16),)),
        ("halo:vnet:merge4:b1", "conv", VNET_SPATIAL, 32,
         (3, 3, 3, 32, 16), 1, 1, 1, 1, 1, "halo"),
        ("halo:vnet:merge4:dx", "deconv", (64, 64, 32), 16,
         (3, 3, 3, 16, 32), 1, 1, 1, 1, 2, "halo"),
        ("halo:dcgan:deconv3:2d:forced", "deconv", (16, 16), 256,
         (3, 3, 256, 128), 2, dpad2, 1, 1, 16, ((8, 1, 16),)),
        ("halo:2d:s1", "conv", (128, 128), 32, (3, 3, 32, 16), 1, 1, 1, 1,
         8, "halo"),
        ("halo:ragged:forced", "conv", (13, 11, 19), 16, (3, 3, 3, 16, 24),
         1, 1, 1, 1, 3, ((3, 4, 8),)),
        ("halo:groups2:cig8", "conv", (40, 36, 30), 16, (3, 3, 3, 8, 32), 1,
         1, 1, 2, 2, "halo"),
        ("halo:dil2", "conv", (44, 40, 36), 32, (3, 3, 3, 32, 16), 1, 2, 2,
         1, 2, "halo"),
        ("halo:deconv:dil2:forced", "deconv", (11, 9, 10), 16,
         (3, 3, 3, 16, 16), 2, 1, 2, 1, 2, ((4, 4, 8),)),
        ("gather:ci1", "conv", (64, 64, 32), 1, (3, 3, 3, 1, 16), 1, 1, 1,
         1, 2, "gather"),
    ]
    PLANNED = {"deconv": dk.planned_halo, "conv": ck.planned_halo}
    real_plan_halo = tiling.plan_halo
    real_plan_wgmma = tiling.plan_wgmma

    def stagings():
        out = {}
        for mod in (dk, ck):
            for k_, v_ in mod.staging_launches.items():
                out[k_] = out.get(k_, 0) + v_
        return out

    def forced_halo(op, x3, kw, box):
        """The halo staging of ``box`` (cut to the grid) for this
        launch."""
        grid = (dref.phase_rows(tuple(x3.shape[1:4]), kw["kernel"],
                                kw["stride"], kw["dilation"], kw["crop_lo"],
                                kw["out_spatial"])
                if op == "deconv" else kw["out_spatial"])
        box = tuple(min(b_, p_) for b_, p_ in zip(box, grid))
        return tiling.halo_for_box(op, box, kw["kernel"], kw["stride"],
                                   kw["dilation"], kw["block_co"], grid)

    detail["halo_checks"] = []
    t_halo = time.perf_counter()
    for (tag, op, sp, cin, ws, st, pad, dil, g, batch,
         want) in halo_cases:
        _, _, _, (x3, wk, kw, rest) = operands(
            op, sp, cin, ws, torch.bfloat16, st, pad, dilation=dil, groups=g,
            scale=True, activation="leaky_relu", alpha=0.1, batch=batch)
        planner = PLANNED[op](x3, wk, **kw)
        if planner is None and op == "deconv" and dk.planned_wgmma(
                x3, wk, **kw) is not None:
            planner = "wgmma"
        if isinstance(want, tuple):        # a halo launch is unsplit
            pinned = forced_halo(op, x3, kw, *want)
            tiling.plan_halo = lambda *a_, h_=pinned, **k_: h_
            tiling.plan_wgmma = lambda *a_, **k_: None
            force[0] = forced(1)
        halo = PLANNED[op](x3, wk, **kw)
        staging = "halo" if halo is not None else "gather"
        row = {"check": tag, "op": op, "staging": staging,
               "forced": isinstance(want, tuple),
               "planner": (planner if isinstance(planner, str) else
                           "halo" if planner is not None else "gather"),
               "halo": None if halo is None else list(halo.fields()),
               "block_co": kw["block_co"]}
        for out_dtype in (torch.bfloat16, torch.float32):
            okw = dict(kw, out_dtype=out_dtype)
            before = stagings()
            got = KERNELS[op][1](x3, wk, **okw)
            again = KERNELS[op][1](x3, wk, **okw)
            torch.cuda.synchronize()
            seen = {k_: v_ - before.get(k_, 0)
                    for k_, v_ in stagings().items()
                    if v_ != before.get(k_, 0)}
            if out_dtype == torch.bfloat16:
                ref = run_plain(op, (x3, wk, okw, rest))
                tol = TOL["bfloat16"]
            else:
                ref = run_plain64(op, (x3, wk, okw, rest))
                tol = W8_TOL
            err = float((got.double() - ref.double()).abs().max())
            mag = float(ref.double().abs().max())
            rel = err / mag if mag else err
            oname = str(out_dtype).split(".")[-1]
            row[oname] = {"max_abs_err": err, "rel_err": rel, "tol": tol,
                          "repeat_equal": bool(torch.equal(got, again)),
                          "launches": {"/".join(k_): v_
                                       for k_, v_ in seen.items()}}
            check(seen == {("bfloat16", "bfloat16", "bf16", staging): 2},
                  f"{tag}/{oname}: launches by staging {seen}, the planner "
                  f"chose {staging}")
            check(row[oname]["repeat_equal"], f"{tag}/{oname}: a repeated "
                  f"launch gave other bits")
            check(got.shape == ref.shape and got.dtype == out_dtype,
                  f"{tag}/{oname}: {got.shape} {got.dtype} vs plain "
                  f"{ref.shape}")
            check(rel <= tol, f"{tag}/{oname}: relative error {rel:.3g} "
                  f"above {tol}")
            del got, again, ref
        tiling.plan_halo, force[0] = real_plan_halo, None
        tiling.plan_wgmma = real_plan_wgmma
        print(json.dumps(row))
        detail["halo_checks"].append(row)
        check(staging == ("halo" if isinstance(want, tuple) else want),
              f"{tag}: the planner chose {staging}, not {want}")
        del x3, wk, kw, rest
    detail["halo_checks_s"] = time.perf_counter() - t_halo
    print(json.dumps({"halo_checks_s": detail["halo_checks_s"]}))
    torch.cuda.empty_cache()

    # -- 3w. kernel 1's TMA + wgmma route ------------------------------------
    # (csrc/deconv_wgmma.cu, tiling.plan_wgmma): every case of WGMMA_CASES
    # run twice for the same bits, in bf16 and f32 output, against float64
    # of the same bf16 operands; each launch reports the wgmma staging (the
    # wrapper raises on any other)
    phase("wgmma route")
    t_wg = time.perf_counter()
    detail["wgmma_checks"] = []
    for case in WGMMA_CASES:
        row = wgmma_case(case, dev)
        print(json.dumps(row))
        detail["wgmma_checks"].append(row)
        check(row["ok"], f"{row['check']}: the wgmma route {row}")
        torch.cuda.empty_cache()
    detail["wgmma_checks_s"] = time.perf_counter() - t_wg
    print(json.dumps({"wgmma_checks_s": detail["wgmma_checks_s"]}))

    # -- 3q. int8 operands against their plain versions ----------------------
    # (x, w) operand pairs: int8 weights beside f32 activations (w:int8),
    # int8 activations and weights (w:int8+a:int8), int8 weights beside
    # bf16 activations; held against the plain version summed in float64
    # (int8 and bf16 values are exact there) at TOL of the output's type
    phase("int8 kernels vs plain versions")
    Q_PAIRS = {"w8": "float32/int8", "w8a8": "int8/int8",
               "bf16w8": "bfloat16/int8"}

    def q_operands(op, in_spatial, cin, w_shape, pair, stride, padding,
                   dilation=1, groups=1, bias=True, activation="none",
                   alpha=0.2, batch=BATCH):
        """Random main-path operands under a quantized pair: the kernel's
        x and w, the dequant scale (the activations' per-tensor scale
        folded in, as the engine folds it), the wrapper arguments and the
        dequantized f32 x and w (cuDNN's operands)."""
        xf = rand((batch, *in_spatial, cin), torch.float32)
        wf = rand(w_shape, torch.float32,
                  1.0 / math.sqrt(math.prod(w_shape[:-1])))
        b = rand((w_shape[-1],), torch.float32, 0.1) if bias else None
        qw = quant.quantize_tensor(wf)
        w, s = qw["w_q"], qw["scale"]
        x, x_deq = xf, xf
        if pair == "w8a8":
            sx = quant.absmax_scale(xf)
            x = quant.quantize_q8(xf, sx)
            x_deq, s = quant.dequantize_int8(x, sx), s * sx
        elif pair == "bf16w8":
            x = xf.to(torch.bfloat16)
            x_deq = x.float()
        args = KERNELS[op][0](x, w, stride, padding, dilation=dilation,
                              groups=groups, bias=b, w_scale=s,
                              activation=activation, alpha=alpha,
                              engine=engine)
        return {"x": x, "w": w, "b": b, "args": args, "x_deq": x_deq,
                "w_deq": quant.dequantize_int8(w, qw["scale"])}

    def q_layer_operands(layer, pair, batch=BATCH):
        epi = layer.epilogue
        return q_operands(layer.op, layer.in_spatial, layer.cin,
                          layer.weight_shape, pair, layer.stride,
                          layer.padding, layer.dilation, layer.groups,
                          bias=epi.bias, activation=epi.activation,
                          alpha=epi.alpha, batch=batch)

    # every distinct geometry of the quantized serving path (batch 4)
    q_layers = distinct([("dcgan", l, BATCH) for l in dcgan_layers]
                        + [("vnet", l, BATCH) for l in vnet_layers])
    # the block's code paths under int8: (tag, op, in_spatial, cin,
    # w_shape, stride, padding, dilation, groups, batch, slices forced:
    # None = the planner's, whether the run must split: None = either)
    q_path_cases = [
        ("dcgan:deconv1:planner", "deconv", (4, 4), 1024,
         (3, 3, 1024, 512), 2, dpad2, 1, 1, 4, None, True),
        ("dcgan:deconv1:unsplit", "deconv", (4, 4), 1024,
         (3, 3, 1024, 512), 2, dpad2, 1, 1, 4, 1, False),
        ("vnet:enc5:planner", "conv", (16, 16, 8), 128,
         (3, 3, 3, 128, 256), 2, 1, 1, 1, 4, None, True),
        ("vnet:enc5:unsplit", "conv", (16, 16, 8), 128,
         (3, 3, 3, 128, 256), 2, 1, 1, 1, 4, 1, False),
        ("scalar:ci1", "conv", (20, 18, 9), 1, (3, 3, 3, 1, 16), 1, 1, 1,
         1, 2, None, None),
        ("scalar:ci6", "deconv", (9, 11, 7), 6, (3, 3, 3, 6, 16), 2, dpad3,
         1, 1, 2, None, None),
        ("scalar:co3:split", "deconv", (17, 15), 128, (3, 3, 128, 3), 2,
         dpad2, 1, 1, 3, 4, True),
        ("ragged:co48", "deconv", (7, 9, 5), 32, (3, 3, 3, 32, 48), 2,
         dpad3, 1, 1, 3, None, None),
        ("groups2:cig16", "conv", (11, 9, 8), 32, (3, 3, 3, 16, 64), 1, 1,
         1, 2, 2, None, None),
        ("groups2:cig16:split", "conv", (11, 9, 8), 32, (3, 3, 3, 16, 64),
         1, 1, 1, 2, 2, 3, True),
        ("groups2:dil2", "deconv", (7, 6, 5), 32, (3, 3, 3, 16, 32), 2,
         dpad3, 2, 2, 2, None, None),
        ("dil2", "conv", (13, 11, 9), 16, (3, 3, 3, 16, 32), 1, 2, 2, 1,
         2, None, None),
        ("a4:cig8", "conv", (13, 11, 9), 8, (3, 3, 3, 8, 16), 1, 1, 1, 1,
         2, None, None),
        ("a4:cig36:split", "deconv", (7, 6, 5), 36, (3, 3, 3, 36, 24), 2,
         dpad3, 1, 1, 2, 3, True),
    ]
    q_cases = [(f"{model}:{layer.name}:b{batch}", layer.op, pair,
                lambda l=layer, p=pair, n=batch: q_layer_operands(l, p, n),
                None, None)
               for model, layer, batch in q_layers
               for pair in ("w8", "w8a8", "bf16w8")]
    q_cases += [(tag, op, pair,
                 lambda op=op, sp=sp, cin=cin, ws=ws, st=st, pad=pad,
                 dil=dil, g=g, p=pair, n=batch: q_operands(
                     op, sp, cin, ws, p, st, pad, dil, g,
                     activation="leaky_relu", alpha=0.1, batch=n),
                 n_split, must_split)
                for (tag, op, sp, cin, ws, st, pad, dil, g, batch, n_split,
                     must_split) in q_path_cases
                for pair in ("w8", "w8a8", "bf16w8")]
    detail["int8_checks"] = []
    q_copies = {}
    for tag, op, pair, make, n_split, must_split in q_cases:
        ops = make()
        x3, wk, kw, _ = ops["args"]
        before = fwd_launches()
        force[0] = None if n_split is None else forced(n_split)
        split_log.clear()
        got = run_kernel(op, ops["args"])
        again = run_kernel(op, ops["args"])
        torch.cuda.synchronize()
        force[0] = None
        codes = launches_since(before)
        ref = run_plain64(op, ops["args"])
        err = float((got.double() - ref).abs().max())
        mag = float(ref.abs().max())
        rel = err / mag if mag else err
        oname = str(got.dtype).split(".")[-1]
        cig = x3.shape[-1] // kw["groups"]
        cog = ops["w"].shape[-1] // kw["groups"]
        # the s8 route's A bytes per copy; else 16-byte copies or not
        copy = build.copy_variant(x3, wk, cig, cog)
        q_copies.setdefault(pair, set()).add(copy)
        route = PAIR_ROUTE[tuple(Q_PAIRS[pair].split("/"))]
        tol = (S8_TOL if route == "s8" else W8_TOL if oname == "float32"
               else TOL[oname])
        row = {"check": tag, "op": op, "pair": Q_PAIRS[pair],
               "route": route,
               "out": oname, "shape": list(got.shape),
               "splits": split_log[0], "block_co": kw["block_co"],
               "copy": copy, "w_layout": list(wk.shape),
               "launches_by_operands": {
                   "/".join(map(str, k)): v for k, v in codes.items()},
               "repeat_equal": bool(torch.equal(got, again)),
               "max_abs_err": err, "rel_err": rel, "tol": tol}
        print(json.dumps(row))
        detail["int8_checks"].append(row)
        check(codes == {launch_key(*Q_PAIRS[pair].split("/")): 2},
              f"{tag}/{pair}: launches by operands and route {codes}")
        check((wk.dim() == 4) == (pair == "w8a8"),
              f"{tag}/{pair}: weights {tuple(wk.shape)} (K-major exactly "
              f"for the s8 route)")
        check(len(split_log) == 2 and split_log[0] == split_log[1],
              f"{tag}/{pair}: launches split {split_log}")
        check(must_split is None or (split_log[0] > 1) == must_split,
              f"{tag}/{pair}: {split_log[0]} slices")
        check(row["repeat_equal"], f"{tag}/{pair}: a repeated launch gave "
              f"other bits")
        want_out = (torch.bfloat16 if pair == "bf16w8" else torch.float32)
        check(got.shape == ref.shape and got.dtype == want_out,
              f"{tag}/{pair}: {got.shape} {got.dtype} vs plain {ref.shape}")
        check(rel <= tol, f"{tag}/{pair}: relative error {rel:.3g} "
              f"above {tol}")
        if oname == "float32":
            k = f"{op}_fwd_int8"
            max_abs[k] = max(max_abs[k], err)
        del ops, got, again, ref
    for pair, widths in (("w8", {0, 1}), ("w8a8", {16, 4, 1}),
                         ("bf16w8", {0, 1})):
        check(q_copies.get(pair) == widths,
              f"{pair}: copy widths run {q_copies.get(pair)}, not "
              f"{widths}")
    torch.cuda.empty_cache()

    # -- 3b. backward kernels against their plain versions -------------------
    phase("backward kernels vs plain versions")
    train_layers = distinct(train_layers)

    def backward_operands(layer, batch, dtype):
        """Random x, w, dy at the layer's training shapes and the
        backward's exact kernel arguments ((a, b, kwargs) for dx, dw)."""
        x = rand((batch, *layer.in_spatial, layer.cin), dtype)
        w = rand(layer.weight_shape, dtype,
                 1.0 / math.sqrt(math.prod(layer.weight_shape[:-1])))
        dy = rand((batch, *layer.out_spatial, layer.cout), dtype)
        make = (dops.deconv_backward_args if layer.op == "deconv"
                else cops.conv_backward_args)
        dx_args, dw_args = make(x, w, dy, layer.stride, layer.padding,
                                dilation=layer.dilation,
                                groups=layer.groups, engine=engine)
        return x, w, dy, dx_args, dw_args

    # backward route -> (kernel wrapper, plain version, its tile kwargs)
    BACKWARD = {
        ("deconv", "dx"): (dk.deconv_dx, cref.conv_fwd_plain,
                           ("block_co",)),
        ("conv", "dx"): (dk.deconv_fwd, dref.deconv_fwd_plain,
                         ("block_co",)),
        ("deconv", "dw"): (dk.deconv_dw, dref.deconv_dw_plain,
                           ("block_a", "block_c", "splits")),
        ("conv", "dw"): (dk.deconv_dw, dref.deconv_dw_plain,
                         ("block_a", "block_c", "splits")),
    }

    def run_backward(op, which, args):
        a, b, kw = args
        return BACKWARD[(op, which)][0](a, b, **kw)

    def run_backward_plain(op, which, args, dtype=None):
        a, b, kw = args
        tiles = BACKWARD[(op, which)][2]
        kw = {k: v for k, v in kw.items() if k not in tiles}
        if dtype is not None:
            a, b, kw = a.to(dtype), b.to(dtype), dict(kw, out_dtype=dtype)
        return BACKWARD[(op, which)][1](a, b, **kw)

    # the wrapper whose launch computes each backward route
    BACKWARD_KERNEL = {("deconv", "dx"): "deconv_dx",
                       ("conv", "dx"): "deconv_fwd",
                       ("deconv", "dw"): "deconv_dw",
                       ("conv", "dw"): "deconv_dw"}
    detail["backward_checks"] = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for model, layer, batch in train_layers:
            _, _, _, dx_args, dw_args = backward_operands(layer, batch,
                                                          dtype)
            for which, args in (("dx", dx_args), ("dw", dw_args)):
                before = fwd_launches()
                got = run_backward(layer.op, which, args)
                codes = launches_since(before)
                torch.cuda.synchronize()
                # dx runs on a forward kernel, on its pair's route
                route = PAIR_ROUTE[(dname, dname)]
                check(codes == ({launch_key(dname, dname): 1} if which == "dx"
                                else {}),
                      f"{model}:{layer.name}/{which}/{dname}: forward "
                      f"launches by operands and route {codes}")
                # the yardstick sums in float64 (the same bf16-rounded
                # inputs for bf16), so its own rounding is not charged
                ref = run_backward_plain(layer.op, which, args,
                                         torch.float64)
                err = float((got.double() - ref).abs().max())
                mag = float(ref.abs().max())
                rel = err / mag if mag else err
                tol = BACKWARD_TOL[dname]
                row = {"check": f"{model}:{layer.name}", "op": layer.op,
                       "grad": which, "dtype": dname, "batch": batch,
                       "route": route if which == "dx" else None,
                       "shape": list(got.shape), "max_abs_err": err,
                       "rel_err": rel, "tol": tol}
                print(json.dumps(row))
                detail["backward_checks"].append(row)
                check(got.shape == ref.shape and got.dtype == dtype,
                      f"{row['check']}/{which}/{dname}: kernel output "
                      f"{got.shape} {got.dtype} vs plain {ref.shape}")
                check(rel <= tol, f"{row['check']}/{which}/{dname}: "
                      f"relative error {rel:.3g} above {tol}")
                if dtype == torch.float32:
                    kname = BACKWARD_KERNEL[(layer.op, which)]
                    max_abs[kname] = max(max_abs[kname], err)
                    if kname == "deconv_dx":    # it runs on conv_fwd
                        max_abs["conv_fwd"] = max(max_abs["conv_fwd"], err)
                del got, ref
            del dx_args, dw_args
    # a conv's dx over input rows no tap reads: conv k3 s2 pad 0 on an
    # extent of 8 reads rows 0..6, so row 7 of each dim gets exactly zero
    # from the deconv kernel's widened phase grid
    # (and again with 64 output channels, the dx's reduction forced into
    # four slices: the widened phase grid under a split)
    for dtype, cout, n_split in ((torch.float32, 24, None),
                                 (torch.bfloat16, 24, None),
                                 (torch.float32, 64, 4),
                                 (torch.bfloat16, 64, 4)):
        dname = str(dtype).split(".")[-1]
        x = rand((2, 8, 8, 8, 16), dtype)
        w = rand((3, 3, 3, 16, cout), dtype, 1.0 / math.sqrt(27 * 16))
        dy = rand((2, 3, 3, 3, cout), dtype)
        dx_args, dw_args = cops.conv_backward_args(x, w, dy, 2, 0,
                                                   engine=engine)
        for which, args in (("dx", dx_args), ("dw", dw_args)):
            force[0] = (forced(n_split) if n_split and which == "dx"
                        else None)
            split_log.clear()
            got = run_backward("conv", which, args)
            torch.cuda.synchronize()
            force[0] = None
            if n_split and which == "dx":
                again = run_backward("conv", which, args)
                check(split_log[0] > 1 and torch.equal(got, again),
                      f"conv dx split {split_log}: repeat differs or no "
                      f"split")
            ref = run_backward_plain("conv", which, args, torch.float64)
            err = float((got.double() - ref).abs().max())
            rel = err / float(ref.abs().max())
            tag = "conv_k3s2p0_extent8" + (f"_co{cout}_split" if n_split
                                            else "")
            row = {"check": tag, "op": "conv",
                   "grad": which, "dtype": dname, "shape": list(got.shape),
                   "splits": split_log[0] if which == "dx" else None,
                   "max_abs_err": err, "rel_err": rel,
                   "tol": BACKWARD_TOL[dname]}
            if which == "dx":
                row["uncovered_max_abs"] = max(
                    float(got[:, 7].abs().max()),
                    float(got[:, :, 7].abs().max()),
                    float(got[:, :, :, 7].abs().max()))
                check(row["uncovered_max_abs"] == 0.0,
                      f"conv dx: rows no tap reads hold "
                      f"{row['uncovered_max_abs']}, not 0")
            print(json.dumps(row))
            detail["backward_checks"].append(row)
            check(rel <= BACKWARD_TOL[dname], f"conv k3s2p0 {which}/"
                  f"{dname}: relative error {rel:.3g}")
    torch.cuda.empty_cache()

    # -- 3c. the dw kernel's code paths ---------------------------------------
    # each case in f32 and bf16, run twice (the same bits both times) and
    # held against the float64 plain version at BACKWARD_TOL: every tile
    # with 16-byte and scalar copies of A and of B (Ag 2, 6, 16, 18, 32,
    # 50, 64, 1024; Bg 1, 3, 6, 10, 16, 32), groups, both store layouts,
    # lo at both edges of B's extent, dilation 2, stride 2 with reads past
    # B's extent, and forced splits of 1, 4 and 16 beside the planner's
    phase("dw kernel paths")
    d3 = (1, 1, 1)
    # (tag, A spatial, Ac, B spatial, Bc, kernel, stride, dilation, groups,
    #  lo, transpose, batch, slices: None = the planner's)
    merge4ish = ((16, 14, 10), 16, (16, 14, 10), 32, (3, 3, 3), d3, d3, 1,
                 (1, 1, 1), True, 2)
    dcganish = ((1, 4, 4), 1024, (1, 8, 8), 16, (1, 3, 3), (1, 2, 2), d3, 1,
                (0, 0, 0), False, 64)
    dw_cases = [
        ("16x32:ag2:bg16", (24, 20, 16), 2, (24, 20, 16), 16, d3, d3, d3, 1,
         (0, 0, 0), True, 2, None),
        ("16x32:ag16:bg1", (20, 18, 9), 16, (20, 18, 9), 1, (3, 3, 3), d3,
         d3, 1, (1, 1, 1), True, 2, None),
        ("16x32:ag1024:bg3", (1, 5, 6), 1024, (1, 11, 13), 3, (1, 3, 3),
         (1, 2, 2), d3, 1, (0, 0, 0), False, 3, None),
        *((f"16x256:ag16:bg32{tag}", *merge4ish, n) for tag, n in (
            ("", None), (":split1", 1), (":split4", 4), (":split16", 16))),
        ("16x256:groups2:ag6:bg10", (7, 6, 5), 12, (7, 6, 5), 20, (3, 3, 3),
         d3, d3, 2, (1, 1, 1), True, 2, None),
        ("16x256:groups2:ag6:bg10:untransposed", (7, 6, 5), 12, (7, 6, 5),
         20, (3, 3, 3), d3, d3, 2, (1, 1, 1), False, 2, None),
        ("16x256:lo-edges", (9, 8, 7), 16, (7, 6, 5), 32, (3, 3, 3), d3, d3,
         1, (2, 0, 1), True, 2, None),
        ("16x256:dil2", (6, 5, 4), 16, (10, 9, 8), 16, (3, 3, 3), d3,
         (2, 2, 2), 1, (2, 2, 2), True, 2, None),
        ("32x256:ag32:bg16:s2-past-extent", (5, 5, 5), 32, (10, 10, 10), 16,
         (3, 3, 3), (2, 2, 2), d3, 1, (0, 0, 0), False, 2, None),
        ("32x256:ag18:bg6", (8, 7, 6), 18, (8, 7, 6), 6, (3, 3, 3), d3, d3,
         1, (1, 1, 1), True, 2, None),
        ("64x128:ag64:bg32:s2", (6, 6, 5), 64, (12, 12, 10), 32, (3, 3, 3),
         (2, 2, 2), d3, 1, (1, 1, 1), True, 2, None),
        ("64x128:ag50:bg3", (6, 5, 4), 50, (6, 5, 4), 3, (3, 3, 3), d3, d3,
         1, (1, 1, 1), True, 2, None),
        *((f"64x128:ag1024:bg16{tag}", *dcganish, n) for tag, n in (
            ("", None), (":split1", 1), (":split4", 4), (":split16", 16))),
    ]
    detail["dw_path_checks"] = []
    copies_seen: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for (tag, asp, ac, bsp, bc, kern, st, dil, g, lo, tr, batch,
             n_split) in dw_cases:
            a = rand((batch, *asp, ac), dtype)
            b = rand((batch, *bsp, bc), dtype)
            rows = batch * math.prod(asp)
            plan = tiling.plan_dw_tiles(ac, bc, math.prod(kern), rows,
                                        groups=g,
                                        dtype_bytes=a.element_size())
            want = plan.splits if n_split is None else n_split
            splits = tiling.split_rows(rows, want)[0]  # what the wrapper runs
            check(splits == want, f"{tag}/{dname}: {want} slices asked, "
                  f"{splits} run")
            geo = dict(kernel=kern, stride=st, dilation=dil, groups=g,
                       lo=lo, transpose=tr)
            kw = dict(geo, block_a=plan.block_a, block_c=plan.block_c,
                      splits=want)
            got = dk.deconv_dw(a, b, **kw)
            again = dk.deconv_dw(a, b, **kw)
            torch.cuda.synchronize()
            ref = dref.deconv_dw_plain(a.double(), b.double(), **geo,
                                       out_dtype=torch.float64)
            err = float((got.double() - ref).abs().max())
            mag = float(ref.abs().max())
            rel = err / mag if mag else err
            vec = build.dw_vector_copies(a, b, ac // g, bc // g)
            tile = f"{plan.block_a}x{plan.block_c}"
            copies_seen.setdefault((dname, tile), set()).add(vec)
            row = {"check": tag, "dtype": dname, "shape": list(got.shape),
                   "tile": tile, "splits": splits,
                   "planner_splits": plan.splits, "vec_a": vec[0],
                   "vec_b": vec[1],
                   "repeat_equal": bool(torch.equal(got, again)),
                   "max_abs_err": err, "rel_err": rel,
                   "tol": BACKWARD_TOL[dname]}
            print(json.dumps(row))
            detail["dw_path_checks"].append(row)
            check(row["repeat_equal"], f"{tag}/{dname}: a repeated dw "
                  f"launch gave other bits")
            check(got.shape == ref.shape and got.dtype == dtype,
                  f"{tag}/{dname}: {got.shape} {got.dtype} vs plain "
                  f"{ref.shape}")
            check(rel <= BACKWARD_TOL[dname], f"{tag}/{dname}: relative "
                  f"error {rel:.3g} above {BACKWARD_TOL[dname]}")
            if dtype == torch.float32:
                max_abs["deconv_dw"] = max(max_abs["deconv_dw"], err)
            del a, b, got, again, ref
    for dname in ("float32", "bfloat16"):
        for ba, bc_ in tiling.DW_KERNEL_TILES:
            seen_v = copies_seen.get((dname, f"{ba}x{bc_}"), set())
            check({v[0] for v in seen_v} == {True, False}
                  and {v[1] for v in seen_v} == {True, False},
                  f"dw tile {ba}x{bc_}/{dname}: copies covered {seen_v}")
    torch.cuda.empty_cache()

    # the main path's calls of each wrapper by call shape and path,
    # recorded while the serve and train runs below are on (``recording``
    # names the path), so that each kernel's times cover exactly the
    # launches it counts, and each path's share of them; the sharded
    # phase's ranks record their own and hand them back
    recorded: dict = {}
    recording = [None]
    record_calls(dk, ck, recorded, recording)

    # -- 4. serve -------------------------------------------------------------
    phase("serve")
    gen_spec = dcgan_gen_spec(chans=DCGAN_CHANS)
    vol_spec = vnet_spec(chans=VNET_CHANS, base_spatial=VNET_SPATIAL)
    server = DcnnServer([gen_spec, vol_spec], max_batch=BATCH)
    rng = np.random.default_rng(0)
    seeds = [rng.standard_normal((4, 4, DCGAN_CHANS[0]), dtype=np.float32)
             for _ in range(8)]
    vols = [rng.standard_normal((*VNET_SPATIAL, 1), dtype=np.float32)
            for _ in range(3)]
    vols.append(rng.standard_normal((120, 124, 60, 1), dtype=np.float32))
    reqs = [ServeRequest("dcgan_gen", x) for x in seeds] + \
        [ServeRequest("vnet", x) for x in vols]
    for r in reqs:
        server.submit(r)
    dk.launches = ck.launches = 0           # the main path's run starts
    recording[0] = "serve"
    results, steps = [], []
    t_serve = time.perf_counter()
    while server.queue.depth:
        before = (dk.launches, ck.launches)
        got = server.step()
        delta = (dk.launches - before[0], ck.launches - before[1])
        models = {r.model for r in got}
        steps.append({"models": sorted(models), "requests": len(got),
                      "deconv_launches": delta[0],
                      "conv_launches": delta[1]})
        print(json.dumps({"served_batch": steps[-1]}))
        check(len(models) == 1, f"one batch served {models}")
        want = (4, 0) if models == {"dcgan_gen"} else (4, 10)
        check(delta == want, f"{models} batch launched (deconv, conv) = "
              f"{delta}, expected {want}")
        results.extend(got)
    serve_s = time.perf_counter() - t_serve
    launches = {"deconv": dk.launches, "conv": ck.launches}
    recording[0] = None
    print(json.dumps({"main_path_launches": launches,
                      "serve_s": serve_s}))
    check(launches == {"deconv": 12, "conv": 10},
          f"main path launches {launches}")
    # a broken kernel must not be served quietly by the fallback
    check(server.stats()["fallbacks"] == 0,
          f"serve: {server.stats()['fallbacks']} buckets fell back")
    by_id = {r.id: r for r in results}
    check(sorted(by_id) == [r.id for r in reqs], "a request went missing")
    for r in reqs:
        res = by_id[r.id]
        want = ((64, 64, 3) if r.model == "dcgan_gen"
                else (*r.x.shape[:-1], 2))
        check(res.ok, f"request {r.id} failed: {res.error!r}")
        check(res.engine == "pallas",
              f"request {r.id} served by {res.engine!r}")
        check(res.output.shape == want,
              f"request {r.id} shape {res.output.shape} != {want}")
        check(bool(np.isfinite(res.output).all()),
              f"request {r.id} output not finite")

    # the same graph, weights and input on the CPU (plain versions)
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = UniformEngine(device="cpu")
    detail["cpu_parity"] = {}
    for req in (reqs[0], reqs[-1]):
        spec = server.specs[req.model]
        bsp = spec.bucket_spatial(tuple(req.x.shape[:-1]))
        apply, _ = compile_network(spec.graph_for(bsp), cpu)
        t0 = time.perf_counter()
        with torch.inference_mode():
            ref = apply(spec.weights,
                        torch.from_numpy(pad_to(req.x, bsp))[None])[0]
        ref = ref.numpy()[tuple(slice(0, d)
                                for d in by_id[req.id].output.shape)]
        err = float(np.abs(by_id[req.id].output - ref).max())
        rel = err / float(np.abs(ref).max())
        detail["cpu_parity"][req.model] = {"max_abs_err": err,
                                           "rel_err": rel,
                                           "cpu_s": time.perf_counter() - t0}
        print(json.dumps({"cpu_parity": req.model, "bucket": list(bsp),
                          "max_abs_err": err, "rel_err": rel,
                          "tol": SERVE_TOL}))
        check(rel <= SERVE_TOL, f"{req.model}: card vs CPU relative error "
              f"{rel:.3g} above {SERVE_TOL}")

    # -- 4q. serve, quantized -------------------------------------------------
    # the f32 serve's requests again, through the same entry points under
    # each policy: weights from quant.quantize_weights, an engine configured
    # with the policy.  Launch counts per batch as in f32, every launch an
    # int8 one of the policy's operand types
    phase("serve (quantized)")
    POLICIES = {
        "w:int8": quant.Precision(weight_quant="int8"),
        "w:int8+a:int8": quant.Precision(weight_quant="int8",
                                         act_quant="int8")}
    WANT_PAIR = {"w:int8": launch_key("float32", "int8"),
                 "w:int8+a:int8": launch_key("int8", "int8")}
    # the int8 activations every quantize_q8 call of a run produced, and
    # (replay) the card's, handed to a CPU run in their place
    from repro_torch.quant import qint8
    real_q8 = qint8.quantize_q8
    q8_log, q8_replay = [], [None]

    def logged_q8(x, scale):
        q = real_q8(x, scale)
        i = len(q8_log)
        q8_log.append(q.detach().cpu())
        if q8_replay[0] is not None:
            card_q = q8_replay[0][i]
            check(card_q.shape == q.shape, f"activation quantization {i}: "
                  f"{tuple(q.shape)} vs the card's {tuple(card_q.shape)}")
            q = card_q.to(q.device)
        return q

    q_servers, q_batches = {}, {}
    q_launches = {"deconv": 0, "conv": 0}
    detail["serve_quant"] = {}
    f32_out = {r_.id: by_id[r_.id].output for r_ in reqs}
    for pol, prec in POLICIES.items():
        q_specs = [
            dcgan_gen_spec(chans=DCGAN_CHANS, weights=quant.quantize_weights(
                dict(gen_spec.weights), prec)),
            vnet_spec(chans=VNET_CHANS, base_spatial=VNET_SPATIAL,
                      weights=quant.quantize_weights(dict(vol_spec.weights),
                                                     prec))]
        srv = DcnnServer(q_specs, max_batch=BATCH, engine=UniformEngine(
            EngineConfig(precision=prec)))
        q_servers[pol] = srv
        qreqs = [ServeRequest(r_.model, r_.x) for r_ in reqs]
        for r_ in qreqs:
            srv.submit(r_)
        dk.launches = ck.launches = 0       # this path's run starts
        recording[0] = "serve_quantized"
        qres, qsteps = [], []
        t_serve = time.perf_counter()
        while srv.queue.depth:
            before = (dk.launches, ck.launches,
                      dict(dk.operand_launches), dict(ck.operand_launches))
            got = srv.step()
            delta = (dk.launches - before[0], ck.launches - before[1])
            codes = {}
            for mod, prev in ((dk, before[2]), (ck, before[3])):
                for k_, v_ in mod.operand_launches.items():
                    if v_ != prev.get(k_, 0):
                        codes[k_] = codes.get(k_, 0) + v_ - prev.get(k_, 0)
            models = {r_.model for r_ in got}
            qsteps.append({"models": sorted(models), "requests": len(got),
                           "ids": [r_.id for r_ in got],
                           "deconv_launches": delta[0],
                           "conv_launches": delta[1],
                           "launches_by_operands": {
                               "/".join(map(str, k_)): v_
                               for k_, v_ in codes.items()}})
            print(json.dumps({"served_batch": qsteps[-1], "policy": pol}))
            check(len(models) == 1, f"{pol}: one batch served {models}")
            want = (4, 0) if models == {"dcgan_gen"} else (4, 10)
            check(delta == want, f"{pol}: {models} batch launched (deconv, "
                  f"conv) = {delta}, expected {want}")
            check(codes == {WANT_PAIR[pol]: sum(delta)},
                  f"{pol}: launches by operands and route {codes}, "
                  f"expected {sum(delta)} of {WANT_PAIR[pol]}")
            qres.extend(got)
        serve_s = time.perf_counter() - t_serve
        recording[0] = None
        got_l = {"deconv": dk.launches, "conv": ck.launches}
        check(got_l == {"deconv": 12, "conv": 10},
              f"{pol}: launches {got_l}")
        check(srv.stats()["fallbacks"] == 0,
              f"{pol}: {srv.stats()['fallbacks']} buckets fell back")
        for k_ in q_launches:
            q_launches[k_] += got_l[k_]
        qby = {r_.id: r_ for r_ in qres}
        qby_req = {r_.id: r_ for r_ in qreqs}
        check(sorted(qby) == [r_.id for r_ in qreqs],
              f"{pol}: a request went missing")
        # against the f32 outputs, reported: at full width the seeded DCGAN
        # generator's tanh output lies 11.7 % of max |y| from f32 under
        # w:int8 in the JAX package too (same weights), so the reference's
        # 5 %, stated for its small test networks, bounds nothing here; the
        # check is the parity with the port's CPU run below
        vs_f32 = {}
        for r_, rf in zip(qreqs, reqs):
            res = qby[r_.id]
            check(res.ok, f"{pol}: request {r_.id} failed: {res.error!r}")
            check(res.engine == "pallas",
                  f"{pol}: request {r_.id} served by {res.engine!r}")
            check(res.output.shape == f32_out[rf.id].shape,
                  f"{pol}: request {r_.id} shape {res.output.shape}")
            check(bool(np.isfinite(res.output).all()),
                  f"{pol}: request {r_.id} output not finite")
            rel = (float(np.abs(res.output - f32_out[rf.id]).max())
                   / float(np.abs(f32_out[rf.id]).max()))
            vs_f32[r_.model] = max(vs_f32.get(r_.model, 0.0), rel)
        print(json.dumps({"quant_vs_f32": pol, "rel_err": vs_f32}))
        # the batches the server formed (queue order, BATCH at a time per
        # bucket), for the CPU runs: with int8 activations a request's
        # output depends on its batch (the scale is per tensor)
        q_batches[pol] = [st["ids"] for st in qsteps]
        detail["serve_quant"][pol] = {"batches": qsteps, "serve_s": serve_s,
                                      "launches": got_l, "vs_f32": vs_f32}
        # one request of each model against the port's CPU run of its
        # served batch
        cpu_q = UniformEngine(EngineConfig(precision=prec, device="cpu"))
        parity = {}
        for held in (qreqs[0], qreqs[-1]):
            ids = next(b_ for b_ in q_batches[pol] if held.id in b_)
            spec = srv.specs[held.model]
            bsp = held._bucket_sp
            xb = np.zeros((len(ids), *bsp, spec.cin), np.float32)
            for row_, i_ in enumerate(ids):
                xb[row_] = pad_to(qby_req[i_].x, bsp)
            row = ids.index(held.id)
            apply, _ = compile_network(spec.graph_for(bsp), cpu_q,
                                       batch=len(ids))
            card_out = qby[held.id].output
            crop = (row,) + tuple(slice(0, d) for d in card_out.shape)
            runs = {}
            # the card's int8 activations of this batch, for the replay
            card_q = None
            if prec.act_quant == "int8":
                cuda_apply, _ = compile_network(spec.graph_for(bsp),
                                                srv.engine, batch=len(ids))
                q8_log.clear()
                qint8.quantize_q8 = logged_q8
                try:
                    with torch.inference_mode():
                        again = cuda_apply(srv._weights(held.model),
                                           torch.from_numpy(xb))
                        torch.cuda.synchronize()
                    check(np.array_equal(again.float().cpu().numpy()[crop],
                                         card_out),
                          f"{pol}/{held.model}: the batch re-run on the "
                          f"card differs from the served one")
                    card_q = list(q8_log)
                finally:
                    qint8.quantize_q8 = real_q8
            for run in (("free", "card_int8") if card_q else ("free",)):
                q8_log.clear()
                q8_replay[0] = card_q if run == "card_int8" else None
                qint8.quantize_q8 = logged_q8
                t0 = time.perf_counter()
                try:
                    with torch.inference_mode():
                        ref = apply(spec.weights, torch.from_numpy(xb))
                finally:
                    qint8.quantize_q8 = real_q8
                    q8_replay[0] = None
                ref = ref.numpy()[crop]
                err = float(np.abs(card_out - ref).max())
                rel = err / float(np.abs(ref).max())
                tol = None if run == "free" and card_q else SERVE_TOL
                runs[run] = {"max_abs_err": err, "rel_err": rel, "tol": tol,
                             "cpu_s": time.perf_counter() - t0}
                if card_q and run == "free":
                    runs[run]["int8_flips"] = [
                        int((a_ != b_).sum()) for a_, b_ in
                        zip(card_q, q8_log)]
                    runs[run]["int8_elements"] = [a_.numel()
                                                  for a_ in card_q]
            parity[held.model] = runs
            print(json.dumps({"cpu_parity": held.model, "policy": pol,
                              "bucket": list(bsp), "batch": len(ids),
                              "row": row, "runs": runs}))
            for run, r_ in runs.items():
                check(r_["tol"] is None or r_["rel_err"] <= r_["tol"],
                      f"{pol}/{held.model}/{run}: card vs CPU relative "
                      f"error {r_['rel_err']:.3g} above {r_['tol']}")
        detail["serve_quant"][pol]["cpu_parity"] = parity
    print(json.dumps({"quant_launches": q_launches}))

    # -- 4b. train --------------------------------------------------------------
    phase("train")
    import tempfile

    from repro_torch.data import DcnnBatches, VolumeBatches
    from repro_torch.runtime.train_loop import Trainer, TrainLoopConfig

    def counts():
        return launch_counts(dk, ck)

    def zero_counts():
        zero_launch_counts(dk, ck)

    def train_setup(arch, device, eng, batch=None, seed=0):
        cfg = train_cfgs[arch]
        if batch is not None:
            cfg = dataclasses.replace(cfg, dcnn_batch=batch)
        opt = AdamWConfig()
        params = ST.real_params(cfg, torch.Generator().manual_seed(seed),
                                device)
        if arch == "v-net":
            state = adamw_init(params, opt)
            step = ST.make_vnet_train_step(cfg, opt, eng)
        else:
            state = (adamw_init(params["gen"], opt),
                     adamw_init(params["disc"], opt))
            step = ST.make_gan_train_step(cfg, opt, eng)
        return cfg, params, state, step

    def batches(arch, cfg, device, start=0):
        if arch == "v-net":
            return VolumeBatches(cfg.dcnn_batch, dcnn._vnet_spatial(cfg),
                                 start_step=start, device=device)
        last = dcnn._scaled_layers(cfg)[-1]
        return DcnnBatches(cfg.dcnn_batch, cfg.dcnn_z,
                           (*last.out_spatial, last.cout), start_step=start,
                           device=device)

    detail["train"] = {}
    train_launches = dict.fromkeys(ST.LAUNCH_COUNTERS, 0)
    train_steps = {}
    for arch in TRAIN_STEPS:
        cfg, params, state, step_fn = train_setup(arch, dev, engine)
        want = ST.train_step_launches(cfg)
        per_step = []

        def counted(p, s, b, _fn=step_fn, _log=per_step):
            before = counts()
            out = _fn(p, s, b)
            torch.cuda.synchronize()
            _log.append({k: v - before[k] for k, v in counts().items()})
            return out

        n = TRAIN_STEPS[arch]
        with tempfile.TemporaryDirectory() as ckdir:
            loop = TrainLoopConfig(total_steps=n - 1, checkpoint_every=1,
                                   log_every=1, checkpoint_dir=ckdir)
            zero_counts()               # the training path's run starts
            recording[0] = "train"
            first = Trainer(counted, params, state, batches(arch, cfg, dev),
                            loop)
            first.run()
            # a second trainer resumes from the checkpoint for the last step
            _, fresh, fresh_state, _ = train_setup(arch, dev, engine,
                                                   seed=1)
            second = Trainer(counted, fresh, fresh_state,
                             batches(arch, cfg, dev, start=n - 1),
                             dataclasses.replace(loop, total_steps=n))
            check(second.maybe_resume() and second.step == n - 1,
                  f"{arch}: resume found no checkpoint of step {n - 1}")
            check(all(torch.equal(a, b) for a, b in zip(
                tree.leaves(second.params), tree.leaves(first.params))),
                f"{arch}: resumed params differ from the checkpointed")
            second.run()
            got_counts = counts()       # the training path's run ends
            recording[0] = None
        logs = first.metrics_log + second.metrics_log
        print(json.dumps({"train": arch, "batch": cfg.dcnn_batch,
                          "steps": [{k: v for k, v in r.items()}
                                    for r in logs],
                          "launches_per_step": per_step,
                          "expected_per_step": want}))
        check(second.step == n and len(logs) == n,
              f"{arch}: ran {second.step} steps, logged {len(logs)}")
        check(all(math.isfinite(v) for r in logs for k, v in r.items()
                  if k.endswith("loss")), f"{arch}: a loss is not finite")
        check(all(d == want for d in per_step),
              f"{arch}: launches per step {per_step}, expected {want}")
        check(got_counts == {k: n * v for k, v in want.items()},
              f"{arch}: launches over the run {got_counts}")
        for k in train_launches:
            train_launches[k] += got_counts[k]
        train_steps[arch] = step_fn
        detail["train"][arch] = {"batch": cfg.dcnn_batch, "metrics": logs,
                                 "launches_per_step": want,
                                 "counted_per_step": per_step}
        del first, second, params, state, fresh, fresh_state
    torch.cuda.empty_cache()
    print(json.dumps({"train_launches": train_launches}))

    # one DCGAN step's gradients at full width, batch 4, on the card
    # against the port's CPU run: a free CPU run, and one whose forward
    # kernels return the card's outputs (so both backward passes read the
    # same relu masks); the masks' flips between card and free CPU run are
    # counted per forward launch
    seen, fwd_log = [], []
    real_update = ST.adamw_update
    real_fwd = {"deconv": dops._forward, "conv": cops._forward}
    replay = [None]

    def capture(grads, *a, **k):
        seen.append(grads)
        return real_update(grads, *a, **k)

    def logged(op):
        def fwd(*args):
            y = real_fwd[op](*args)
            i = len(fwd_log)
            fwd_log.append((op, args[8], y.detach().cpu()))
            if replay[0] is not None:
                card_y = replay[0][i][2]
                check(replay[0][i][0] == op and card_y.shape == y.shape,
                      f"forward {i}: {op} {tuple(y.shape)} vs the card's "
                      f"{replay[0][i][0]} {tuple(card_y.shape)}")
                y = card_y.to(y.device, y.dtype, copy=True)
            return y
        return fwd

    def named(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from named(t[k], f"{prefix}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                yield from named(v, f"{prefix}/{i}")
        else:
            yield prefix, t

    ST.adamw_update = capture
    dops._forward, cops._forward = logged("deconv"), logged("conv")
    try:
        grads, logs = {}, {}
        for run, eng in (("cuda", engine), ("cpu", cpu),
                         ("cpu_card_fwd", cpu)):
            seen.clear()
            fwd_log.clear()
            replay[0] = logs["cuda"] if run == "cpu_card_fwd" else None
            cfg4, p4, s4, fn4 = train_setup("dcgan", "cpu", eng, batch=4,
                                            seed=2)
            b4 = batches("dcgan", cfg4, "cpu").make_batch(0)
            if run == "cuda":
                p4, s4, b4 = (tree.tree_map(lambda t: t.to(dev), v)
                              for v in (p4, s4, b4))
            fn4(p4, s4, b4)
            grads[run] = {n: t.detach().cpu() for who, g in
                          zip(("gen", "disc"), seen)
                          for n, t in named(g, who)}
            logs[run] = list(fwd_log)
    finally:
        ST.adamw_update = real_update
        dops._forward, cops._forward = real_fwd["deconv"], real_fwd["conv"]
        replay[0] = None
    # relu/leaky_relu masks that differ between the card and the free CPU
    # run, per forward launch (y > 0 exactly where the pre-activation is)
    flips = [{"op": op, "activation": act, "elements": yc.numel(),
              "flips": int(((yc > 0) != (yp > 0)).sum())}
             for (op, act, yc), (_, _, yp) in zip(logs["cuda"], logs["cpu"])
             if act in ("relu", "leaky_relu")]
    # a flip in a generator relu reaches the projection and every deconv
    # up to the last relu one; the last deconv (tanh) and the
    # discriminator (trained on real data only) are out of its reach
    gen_graph = ST.train_graphs(train_cfgs["dcgan"])["gen"].layers
    last_relu = max(i for i, l in enumerate(gen_graph)
                    if l.epilogue.activation == "relu")
    reach = ("gen/proj",) + tuple(f"gen/deconvs/{i}/"
                                  for i in range(last_relu + 1))
    parity = {}
    for run in ("cpu", "cpu_card_fwd"):
        rows = {}
        for n, ref in grads[run].items():
            got = grads["cuda"][n]
            rel = (float((got - ref).abs().max())
                   / (float(ref.abs().max()) or 1.0))
            loose = run == "cpu" and n.startswith(reach)
            rows[n] = {"rel_err": rel,
                       "tol": GRAD_TOL if loose else GRAD_TOL_EXACT}
        parity[run] = rows
    detail["train"]["dcgan_grad_parity"] = parity
    detail["train"]["dcgan_relu_flips"] = flips
    print(json.dumps({"grad_parity": "dcgan", "batch": 4,
                      "leaves": len(grads["cpu"]), "mask_flips": flips,
                      "runs": parity}))
    check(len(logs["cuda"]) == len(logs["cpu"]) == len(logs["cpu_card_fwd"])
          > 0, "the three runs launched different forwards")
    for run, rows in parity.items():
        check(len(rows) == len(grads["cuda"]) > 0,
              f"{run}: {len(rows)} gradient leaves")
        for n, r in rows.items():
            check(r["rel_err"] <= r["tol"], f"dcgan gradient {n}, card vs "
                  f"{run}: relative error {r['rel_err']:.3g} above "
                  f"{r['tol']}")

    # one DCGAN generator step through int8 weights at full width, batch 4:
    # the generator's deconvs on {"w_q", "scale", "b"} entries (quantized
    # once, on the CPU), the gradient half of make_gan_train_step with the
    # scales, biases and projection trained (the int8 weights take none).
    # Its launches are a train step's; its gradients (dscale, db, and dx
    # through the projection's) are held against the port's CPU run as the
    # f32 step's are
    phase("train (int8 weights)")
    cfg_q, p_q, _, _ = train_setup("dcgan", "cpu", cpu, batch=4, seed=3)
    batch_q = batches("dcgan", cfg_q, "cpu").make_batch(0)
    gen_q = {"proj": p_q["gen"]["proj"],
             "deconvs": [dict(quant.quantize_tensor(e_["w"]), b=e_["b"])
                         for e_ in p_q["gen"]["deconvs"]]}

    def q_gen_step(gen_p, disc_p, b_, eng):
        """The gradients of one GAN step with an int8-weight generator, by
        leaf name."""
        with torch.enable_grad():
            gp = tree.tree_map(lambda t: (t.detach().requires_grad_()
                                          if t.is_floating_point() else t),
                               gen_p)
            fake = dcnn.generator_forward(gp, cfg_q, b_["z"], eng)
            d_fake = dcnn.discriminator_forward(
                tree.tree_map(torch.Tensor.detach, disc_p), cfg_q, fake, eng)
            g_loss = dcnn.bce(d_fake, torch.ones_like(d_fake))
            g_named = [(n_, t_) for n_, t_ in named(gp, "gen")
                       if t_.requires_grad]
            g_grads = torch.autograd.grad(g_loss, [t_ for _, t_ in g_named])
            dp = tree.tree_map(lambda t: t.detach().requires_grad_(),
                               disc_p)
            d_real = dcnn.discriminator_forward(dp, cfg_q, b_["real"], eng)
            d_loss = 0.5 * (
                dcnn.bce(d_real, torch.ones_like(d_real))
                + dcnn.bce(d_fake.detach(), torch.zeros_like(d_fake)))
            d_named = list(named(dp, "disc"))
            d_grads = torch.autograd.grad(d_loss, [t_ for _, t_ in d_named])
        return {n_: g.detach().cpu() for (n_, _), g in
                zip(g_named + d_named, g_grads + d_grads)}

    qgrads, qlogs = {}, {}
    want_q = ST.train_step_launches(cfg_q)
    dops._forward, cops._forward = logged("deconv"), logged("conv")
    try:
        for run, eng in (("cuda", engine), ("cpu", cpu),
                         ("cpu_card_fwd", cpu)):
            fwd_log.clear()
            replay[0] = qlogs["cuda"] if run == "cpu_card_fwd" else None
            dev_ = dev if run == "cuda" else torch.device("cpu")
            on = (lambda v: tree.tree_map(lambda t: t.to(dev_), v))
            zero_counts()
            qgrads[run] = q_gen_step(on(gen_q), on(p_q["disc"]),
                                     on(batch_q), eng)
            if run == "cuda":
                torch.cuda.synchronize()
                got_counts = counts()
                print(json.dumps({"train_int8_launches": got_counts,
                                  "expected": want_q}))
                check(got_counts == want_q, f"int8-weight generator step "
                      f"launched {got_counts}, expected {want_q}")
            qlogs[run] = list(fwd_log)
    finally:
        dops._forward, cops._forward = real_fwd["deconv"], real_fwd["conv"]
        replay[0] = None
    check(all(t_.dtype == torch.int8 for e_ in gen_q["deconvs"]
              for k_, t_ in e_.items() if k_ == "w_q"), "int8 weights")
    check(any(n_.endswith("/scale") for n_ in qgrads["cuda"]),
          "no scale gradient")
    qparity = {}
    for run in ("cpu", "cpu_card_fwd"):
        rows = {}
        for n_, ref in qgrads[run].items():
            got = qgrads["cuda"][n_]
            rel = (float((got - ref).abs().max())
                   / (float(ref.abs().max()) or 1.0))
            loose = run == "cpu" and n_.startswith(reach)
            rows[n_] = {"rel_err": rel,
                        "tol": GRAD_TOL if loose else GRAD_TOL_EXACT}
        qparity[run] = rows
    detail["train"]["dcgan_int8_grad_parity"] = qparity
    print(json.dumps({"grad_parity": "dcgan_int8_weights", "batch": 4,
                      "leaves": len(qgrads["cpu"]), "runs": qparity}))
    for run, rows in qparity.items():
        check(len(rows) == len(qgrads["cuda"]) > 0,
              f"int8 weights, {run}: {len(rows)} gradient leaves")
        for n_, r_ in rows.items():
            check(r_["rel_err"] <= r_["tol"], f"int8-weight gradient {n_}, "
                  f"card vs {run}: relative error {r_['rel_err']:.3g} "
                  f"above {r_['tol']}")
    del p_q, gen_q, qgrads, qlogs
    torch.cuda.empty_cache()

    # -- 4s. sharded -------------------------------------------------------
    # the multi-GPU path on torch.distributed, its ranks spawned here (the
    # kernels are built already; each rank loads the same library) and all
    # on device 0: one rank over NCCL (V-Net served data-parallel at batch
    # 4, two int8-compressed DP GAN steps of DCGAN at batch 64), then two
    # ranks sharing the card over gloo, which stages every collective's
    # CUDA tensors through the host, so none of these times is NCCL's
    # (V-Net at 2 per rank against the unsharded engine, the DCGAN chain
    # on a 2-way model axis with its collectives' bytes counted, three DP
    # GAN steps at 32 per rank int8 and f32, one DP V-Net step at 2 per
    # rank).  Each rank sets the counts to 0 before each run and reads them
    # after; its calls by shape come back for the times phase
    phase("sharded")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sharded_launches = dict.fromkeys(ST.LAUNCH_COUNTERS, 0)
    detail["sharded"] = {"card": smi, "note": "gloo ranks share one card "
                         "and stage collectives through the host: not "
                         "NCCL's times"}
    t_phase = time.perf_counter()
    for job, world, backend in (("nccl", 1, "nccl"), ("multi", 2, "gloo")):
        t0 = time.perf_counter()
        ranks = spawn_world(job, world, backend, SHARDED_SPEC)
        detail["sharded"][job] = {"world": world, "backend": backend,
                                  "wall_s": time.perf_counter() - t0,
                                  "ranks": [r_["rows"] for r_ in ranks]}
        check(sorted(r_["rank"] for r_ in ranks) == list(range(world)),
              f"sharded {job}: ranks {[r_['rank'] for r_ in ranks]}")
        for res in ranks:
            for row in res["rows"]:
                print(json.dumps({"sharded": job, "backend": backend,
                                  "rank": res["rank"], **row}))
            print(json.dumps({"sharded_rank_launches": job,
                              "rank": res["rank"],
                              "launches": res["launches"]}))
            for k_, v_ in res["launches"].items():
                sharded_launches[k_] += v_
            for key, paths in res["recorded"].items():
                mine = recorded.setdefault(key, {})
                for path, n_ in paths.items():
                    mine[path] = mine.get(path, 0) + n_
    detail["sharded_s"] = time.perf_counter() - t_phase
    print(json.dumps({"sharded_launches": sharded_launches,
                      "sharded_s": detail["sharded_s"], "card": smi}))
    check(all(v_ > 0 for v_ in sharded_launches.values()),
          f"the sharded path launched {sharded_launches}")

    # -- 4p. paper benchmarks ----------------------------------------------
    # the GP-GAN and 3D-GAN generators at full width (batch 4) through
    # models.dcnn.generator_forward on the kernels, each output held against
    # the same generator on the xla lowering (cuDNN at IEEE f32) at REF_TOL;
    # then two GAN train steps of 3D-GAN at its config's batch (32) through
    # Trainer: launches per step exactly train_step_launches, losses finite
    phase("paper benchmarks")
    paper_launches = dict.fromkeys(ST.LAUNCH_COUNTERS, 0)
    detail["paper_benchmarks"] = {}
    xla_engine = UniformEngine(method="xla", device=dev)
    zero_counts()                       # the paper-benchmark path starts
    recording[0] = "paper_benchmarks"
    for arch in PAPER_GENERATORS:
        cfg = paper_cfgs[arch]
        gen_p = ST.real_params(cfg, torch.Generator().manual_seed(4),
                               dev)["gen"]
        z = rand((BATCH, cfg.dcnn_z), torch.float32)
        before = counts()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y = dcnn.generator_forward(gen_p, cfg, z, engine)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
            want = dcnn.generator_forward(gen_p, cfg, z, xla_engine)
        got_l = {k: v - before[k] for k, v in counts().items()}
        last = dcnn._generator_graph(arch, False).layers[-1]
        rel = float((y - want).abs().max()) / float(want.abs().max())
        row = {"generator": arch, "batch": BATCH, "shape": list(y.shape),
               "launches": got_l, "rel_err_vs_xla": rel, "tol": REF_TOL,
               "cold_s": fwd_s}
        print(json.dumps(row))
        detail["paper_benchmarks"][arch] = row
        check(got_l == {"deconv_fwd": 4, "conv_fwd": 0, "deconv_dw": 0,
                        "deconv_dx": 0}, f"{arch} generator launched {got_l}")
        check(tuple(y.shape) == (BATCH, *last.out_spatial, last.cout),
              f"{arch} generator output {tuple(y.shape)}")
        check(bool(torch.isfinite(y).all()) and float(y.abs().max()) <= 1.0,
              f"{arch} generator output not finite or beyond tanh's range")
        check(rel <= REF_TOL, f"{arch} generator: kernels vs xla relative "
              f"error {rel:.3g} above {REF_TOL}")
        del gen_p, y, want
    train_cfgs["3d-gan"] = gan3d_cfg
    cfg, params, state, step_fn = train_setup("3d-gan", dev, engine)
    want = ST.train_step_launches(cfg)
    per_step = []

    def counted_3d(p, s_, b):
        before = counts()
        out = step_fn(p, s_, b)
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in counts().items()})
        return out

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckdir:
        tr3 = Trainer(counted_3d, params, state, batches("3d-gan", cfg, dev),
                      TrainLoopConfig(total_steps=PAPER_TRAIN_STEPS,
                                      checkpoint_every=PAPER_TRAIN_STEPS,
                                      log_every=1, checkpoint_dir=ckdir))
        t0 = time.perf_counter()
        tr3.run()
        train3_s = time.perf_counter() - t0
    recording[0] = None                 # the paper-benchmark path ends
    for k in paper_launches:
        paper_launches[k] = counts()[k]
    logs = tr3.metrics_log
    row = {"train": "3d-gan", "batch": cfg.dcnn_batch, "steps": logs,
           "launches_per_step": per_step, "expected_per_step": want,
           "run_s": train3_s, "peak_mem_gb":
           torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(row))
    detail["paper_benchmarks"]["train_3d_gan"] = row
    check(tr3.step == PAPER_TRAIN_STEPS and len(logs) == PAPER_TRAIN_STEPS,
          f"3d-gan: ran {tr3.step} steps, logged {len(logs)}")
    check(all(math.isfinite(v) for r in logs for k, v in r.items()
              if k.endswith("loss")), "3d-gan: a loss is not finite")
    check(all(d == want for d in per_step),
          f"3d-gan: launches per step {per_step}, expected {want}")
    print(json.dumps({"paper_benchmark_launches": paper_launches}))
    del tr3, params, state
    torch.cuda.empty_cache()

    # -- 4d. reference methods -------------------------------------------------
    # the four reference lowerings (cuDNN and plain tensor code, the port's
    # counterparts of the JAX package's XLA methods) over the full-width
    # graphs at batch 4, the serve phase's weights and inputs, held against
    # the hand kernels' output of the same batch.  TF32 is on in cuDNN (its
    # default) and in cuBLAS for the phase: the lowerings scope IEEE f32
    # around their library calls themselves and leave the flags as they are
    phase("reference methods")
    tf32_flags = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    ref_x = {"dcgan_gen": np.stack(seeds[:BATCH]),
             "vnet": np.stack([pad_to(v, VNET_SPATIAL) for v in vols])}

    def event_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def graph_apply(m, model, spec):
        apply, _ = compile_network(spec.graph_for(None),
                                   UniformEngine(EngineConfig(method=m)),
                                   batch=BATCH)
        xb = torch.from_numpy(ref_x[model]).to(dev)
        return apply, server._weights(model), xb

    def rel_to(y, ref):
        return float((y - ref).abs().max() / ref.abs().max())

    detail["reference_methods"] = {}
    hand_out = {}
    for m in ("pallas", *REF_METHODS):
        row = {}
        for model, spec in (("dcgan_gen", gen_spec), ("vnet", vol_spec)):
            apply, ws, xb = graph_apply(m, model, spec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.inference_mode():
                y, cold_ms = event_ms(lambda: apply(ws, xb))
                peak = torch.cuda.max_memory_allocated()
                ms = [event_ms(lambda: apply(ws, xb))[1] for _ in range(3)]
            check(bool(torch.isfinite(y).all()), f"{m}/{model}: not finite")
            r = {"cold_ms": cold_ms, "ms": ms,
                 "median_ms": statistics.median(ms),
                 "peak_mib": peak / 2**20,
                 "peak_above_inputs_mib": (peak - base) / 2**20}
            if m == "pallas":
                hand_out[model] = y
            else:
                ref = hand_out[model]
                check(y.shape == ref.shape and y.dtype == ref.dtype,
                      f"{m}/{model}: {tuple(y.shape)} {y.dtype} vs the "
                      f"kernels' {tuple(ref.shape)} {ref.dtype}")
                r["rel_err"] = rel_to(y, ref)
                r["tol"] = REF_TOL
                check(r["rel_err"] <= REF_TOL, f"{m}/{model}: relative "
                      f"error {r['rel_err']:.3g} to the kernels above "
                      f"{REF_TOL}")
            row[model] = r
            del y
        check((torch.backends.cudnn.allow_tf32,
               torch.backends.cuda.matmul.allow_tf32) == (True, True),
              f"{m}: a lowering left the TF32 flags changed")
        detail["reference_methods"][m] = row
        print(json.dumps({"reference_method": m, **row}))
        del apply
        torch.cuda.empty_cache()
    # the gate's control: the same graphs with the lowerings' IEEE scope
    # removed, so that their library calls run in TF32 as the flags allow;
    # the gate must fail every method's control
    ieee_f32, tfunc.ieee_f32 = tfunc.ieee_f32, contextlib.nullcontext
    control = {}
    try:
        for m in REF_METHODS:
            for model, spec in (("dcgan_gen", gen_spec),
                                ("vnet", vol_spec)):
                apply, ws, xb = graph_apply(m, model, spec)
                with torch.inference_mode():
                    y = apply(ws, xb)
                control.setdefault(m, {})[model] = rel_to(y, hand_out[model])
                del apply, y
            torch.cuda.empty_cache()
    finally:
        tfunc.ieee_f32 = ieee_f32
    detail["reference_tf32_control"] = control
    print(json.dumps({"reference_tf32_control": control, "tol": REF_TOL}))
    for m, row in control.items():
        check(max(row.values()) > REF_TOL, f"{m}: without the IEEE scope "
              f"the graphs read {row}, under the gate {REF_TOL}: the gate "
              f"cannot tell TF32 from IEEE f32")
    del hand_out
    # int8 operands per layer, each layer's input the same on both methods
    # (through the graph, int8 activations' rounding ties cascade): the
    # lowering dequantizes the weights up front and fake-quantizes the
    # activations; the kernels fold both scales into the epilogue
    q_ref = {}
    for pol, prec in POLICIES.items():
        pe = UniformEngine(EngineConfig(precision=prec))
        xe = UniformEngine(EngineConfig(method="xla", precision=prec))
        worst = 0.0
        for model, layer in ([("dcgan", l) for l in dcgan_layers]
                             + [("vnet", l) for l in vnet_layers]):
            x = rand((BATCH, *layer.in_spatial, layer.cin), torch.float32)
            fan_in = math.prod(layer.weight_shape[:-1])
            q = quant.quantize_tensor(rand(layer.weight_shape, torch.float32,
                                           1.0 / math.sqrt(fan_in)))
            b = (rand((layer.cout,), torch.float32, 0.1)
                 if layer.epilogue.bias else None)
            with torch.inference_mode():
                yk = pe(layer, x, q["w_q"], b, w_scale=q["scale"])
                yl = xe(layer, x, q["w_q"], b, w_scale=q["scale"])
            rel = float((yk - yl).abs().max() / yk.abs().max())
            check(rel <= SERVE_TOL, f"{pol}/{model}:{layer.name}: xla vs "
                  f"the kernels {rel:.3g} above {SERVE_TOL}")
            worst = max(worst, rel)
            del x, q, b, yk, yl
        q_ref[pol] = {"layers": len(dcgan_layers) + len(vnet_layers),
                      "max_rel_err": worst, "tol": SERVE_TOL}
        print(json.dumps({"reference_int8_per_layer": pol, **q_ref[pol]}))
    detail["reference_int8"] = q_ref
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32_flags
    torch.cuda.empty_cache()

    # -- 4e. serve (fallback) ---------------------------------------------------
    # the degradation path through the normal entry point: V-Net's bucket
    # fails on the hand kernels (scripted dispatch errors through every
    # retry and the first probe), is served by the cuDNN lowering, and the
    # second probe brings it back onto the kernels.  Counts set to 0 just
    # before this path and read just after; the degraded batches launch no
    # hand kernel
    phase("serve (fallback)")
    retries = Backoff().max_retries
    fsrv = DcnnServer([gen_spec, vol_spec], max_batch=BATCH, probe_every=1,
                      faults=FaultScript([FaultEvent(
                          "error", match="pallas:vnet",
                          count=2 * (retries + 1))]))
    vnet_ids = [r_.id for r_ in reqs if r_.model == "vnet"]
    vbucket = f"vnet/{'x'.join(map(str, VNET_SPATIAL))}/b{BATCH}"
    f_steps = []

    def serve_batch(srv, model, xs):
        for x in xs:
            srv.submit(ServeRequest(model, x))
        before = (dk.launches, ck.launches)
        t0 = time.perf_counter()
        got = srv.step()
        dt = time.perf_counter() - t0
        delta = (dk.launches - before[0], ck.launches - before[1])
        check(len(got) == len(xs), f"{model}: {len(got)} of {len(xs)} "
              f"results")
        return got, delta, dt

    dk.launches = ck.launches = 0           # this path's run starts
    recording[0] = "serve_fallback"
    got, delta, dt = serve_batch(fsrv, "dcgan_gen", seeds[:BATCH])
    check(delta == (4, 0) and all(r_.ok and r_.engine == "pallas"
                                  for r_ in got),
          f"dcgan beside the faulted bucket: {delta}, "
          f"{[(r_.code, r_.engine) for r_ in got]}")
    f_steps.append({"model": "dcgan_gen", "engines": ["pallas"],
                    "launches": delta, "s": dt})
    # batch 1: degraded; batch 2: the first probe fails; batch 3: recovered
    want = [("xla", (0, 0)), ("xla", (0, 0)), ("pallas", (4, 10))]
    for i, (engine_want, launches_want) in enumerate(want):
        got, delta, dt = serve_batch(fsrv, "vnet", vols)
        st = fsrv.stats()
        b_ = st["buckets"][vbucket]
        errs = []
        for r_, rid in zip(got, vnet_ids):
            check(r_.ok and r_.engine == engine_want,
                  f"fallback batch {i}: {r_.code} on {r_.engine!r}, "
                  f"expected {engine_want!r}")
            ref = by_id[rid].output
            check(r_.output.shape == ref.shape, f"fallback batch {i}: "
                  f"shape {r_.output.shape} vs {ref.shape}")
            errs.append(float(np.abs(r_.output - ref).max()
                              / np.abs(ref).max()))
        check(delta == launches_want, f"fallback batch {i} launched "
              f"(deconv, conv) = {delta}, expected {launches_want}")
        check(max(errs) <= SERVE_TOL, f"fallback batch {i}: relative "
              f"error {max(errs):.3g} to the un-faulted kernels' outputs")
        f_steps.append({"model": "vnet", "engine": engine_want,
                        "launches": delta, "s": dt, "rel_err": max(errs),
                        **{k: st[k] for k in ("fallbacks", "recoveries",
                                              "probes_failed", "retries")},
                        "degraded": b_["degraded"],
                        "fallback_reason": b_["fallback_reason"]})
        print(json.dumps({"fallback_batch": f_steps[-1]}))
        if i == 0:
            check(st["fallbacks"] == 1 and b_["degraded"]
                  and "InjectedDispatchError" in b_["fallback_reason"],
                  f"first batch: {b_}")
        if i == 1:
            check(st["probes_failed"] >= 1 and st["recoveries"] == 0,
                  f"second batch: {st['probes_failed']} failed probes, "
                  f"{st['recoveries']} recoveries")
    recording[0] = None
    fb_launches = {"deconv": dk.launches, "conv": ck.launches}
    st = fsrv.stats()
    print(json.dumps({"fallback_launches": fb_launches,
                      **{k: st[k] for k in ("fallbacks", "recoveries",
                                            "probes_failed", "retries")}}))
    check(fb_launches == {"deconv": 8, "conv": 10},
          f"fallback path launches {fb_launches}")
    check(st["fallbacks"] == 1 and st["recoveries"] == 1
          and st["probes_failed"] >= 1 and fsrv.health()["fully_primary"],
          f"fallback path stats {st}")
    detail["serve_fallback"] = {"steps": f_steps, "launches": fb_launches}
    del fsrv

    # a compile failure degrades the bucket: its batches run on the
    # lowering until the probe (every 4th), warm from the second on
    csrv = DcnnServer([vol_spec], max_batch=BATCH, faults=FaultScript([
        FaultEvent("compile_error", match="pallas:vnet")]))
    c_rows = []
    for i in range(3):
        got, delta, dt = serve_batch(csrv, "vnet", vols)
        check(delta == (0, 0) and all(r_.ok and r_.engine == "xla"
                                      for r_ in got),
              f"compile_error batch {i}: {delta}, "
              f"{[(r_.code, r_.engine) for r_ in got]}")
        c_rows.append(dt)
    b_ = csrv.stats()["buckets"][vbucket]
    check(b_["degraded"] and "InjectedCompileError" in b_["fallback_reason"],
          f"compile_error bucket {b_}")
    print(json.dumps({"fallback_compile_error": {
        "batch_s": c_rows, "fallback_reason": b_["fallback_reason"]}}))
    detail["serve_fallback"]["compile_error_batch_s"] = c_rows
    del csrv

    # a poisoned row is quarantined and the rest re-run on the kernels
    nsrv = DcnnServer([gen_spec], max_batch=BATCH, faults=FaultScript([
        FaultEvent("nan", match="pallas:dcgan_gen", rows=(0,))]))
    got, _, _ = serve_batch(nsrv, "dcgan_gen", seeds[:BATCH])
    by_req = {r_.id: r_ for r_ in got}
    st = nsrv.stats()
    check(by_req[0].code == "poisoned_output"
          and all(by_req[i].ok and by_req[i].engine == "pallas"
                  for i in (1, 2, 3))
          and st["quarantined"] == 1 and st["reruns"] == 1,
          f"nan script: {[(r_.id, r_.code) for r_ in got]}, {st}")
    for i in (1, 2, 3):
        ref = by_id[reqs[i].id].output
        err = float(np.abs(by_req[i].output - ref).max() / np.abs(ref).max())
        check(err <= SERVE_TOL, f"re-run request {i}: {err:.3g}")
    del nsrv

    # both engines failing: every request completes typed
    esrv = DcnnServer([gen_spec], max_batch=BATCH,
                      backoff=Backoff(sleep=lambda s: None),
                      faults=FaultScript([FaultEvent("error", count=0)]))
    got, delta, _ = serve_batch(esrv, "dcgan_gen", seeds[:BATCH])
    check(delta == (0, 0) and all(
        not r_.ok and isinstance(r_.error, DispatchFailedError)
        for r_ in got) and esrv.stats()["dispatch_failures"] == 1,
        f"both engines failing: {[(r_.code, r_.error) for r_ in got]}")
    print(json.dumps({"fallback_scripts": "ok", "nan_quarantined": 1,
                      "all_failed_typed": len(got)}))
    del esrv
    torch.cuda.empty_cache()

    # -- 4l. serve (LM) ----------------------------------------------------
    # the LM serving path at full width, one model after another (each
    # freed before the next is built; LM_SERVE): llama3.2-1b, qwen2-vl-2b
    # (M-RoPE), xlstm-350m, zamba2-2.7b (hybrid), whisper-tiny (enc-dec)
    # at full depth, dbrx-132b and arctic-480b (MoE) at full width and cut
    # depth.  Each goes through the port's Server (8 requests of 4-16
    # tokens drawn as launch/serve.py draws them, 16 new tokens each) on
    # the card and on the CPU from the same seeded weights.  TF32 is on in
    # cuBLAS for the phase: the LM forward scopes IEEE f32 itself.  Counts
    # set to 0 before the phase and read after it: the LM path launches no
    # hand kernel
    phase("serve (LM)")
    from repro_torch.models import moe as LMMOE
    from repro_torch.models import transformer as LMT
    from repro_torch.runtime.serve_loop import Request as LMRequest
    from repro_torch.runtime.serve_loop import Server as LMServer
    from repro_torch.runtime.serve_loop import splice as lm_splice

    LM_PREFILL_TOL, LM_DECODE_TOL = 1e-4, 1e-2
    LM_RTOL, LM_ATOL = 5e-2, 5e-3
    # a routing decision may differ between the card and the CPU only at
    # a tie: its k-th and (k+1)-th router probabilities this close; and
    # between a bf16-cache decode and an f32 prefill (the continuation),
    # where the cache's rounding (2^-9) moves the router's input a
    # thousandfold more, within a bf16 tie
    LM_ROUTE_TIE, LM_ROUTE_TIE_BF16 = 1e-3, 1e-2
    lm_forward, lm_init_cache, lm_moe = LMT.forward, LMT.init_cache, \
        LMMOE.moe

    def lm_submit(srv, vocab):
        rng = np.random.RandomState(0)
        for _ in range(8):
            plen = int(rng.randint(4, 17))
            srv.submit(LMRequest(
                prompt=[int(t_) for t_ in rng.randint(0, vocab, plen)],
                max_new_tokens=16))

    def lm_f32_cache(cache):
        """``cache`` with every tensor in it f32: kv, cross keys and
        values, the conv caches."""
        return {k: v if k == "pos" else tree.tree_map(torch.Tensor.float, v)
                for k, v in cache.items()}

    def lm_route(p, x, lm_cfg):
        """A MoE layer's routing of ``x``'s tokens: each token's top_k
        experts (ascending) and its margin, the k-th minus the (k+1)-th
        router probability."""
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p.w_router.float(), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        k = lm_cfg.top_k
        return (top.indices[:, :k].sort(dim=-1).values.cpu(),
                (top.values[:, k - 1] - top.values[:, k]).cpu())

    def lm_to(tree_, device):
        """A batch or cache (``pos`` an int) on ``device``."""
        return {k: v if k == "pos" else tree.tree_map(
            lambda a: a.to(device), v) for k, v in tree_.items()}

    @contextlib.contextmanager
    def lm_recording(seen=None, routes=None, f32_cache=False, shadow=None):
        """Within: every forward call's last-position logits appended to
        ``seen`` (prefill, then each decode call), each call's MoE routing
        (one entry per layer) to ``routes``, and ``f32_cache`` makes the
        decode cache f32 (the Server's kv is bf16), so that the decode
        rounds nothing to bf16.  ``shadow`` (a list, with the card's
        parameters as its first item) runs each CPU decode call on the
        card too, first, fed a copy of the CPU's cache and batch, and
        appends its last-position logits: the card's arithmetic of that
        call on the CPU's very inputs."""
        def forward(params, lm_cfg, batch, **kw):
            if shadow and kw.get("mode") == "decode":
                logits, _ = lm_forward(
                    shadow[0], lm_cfg, lm_to(batch, dev),
                    **dict(kw, cache=lm_to(kw["cache"], dev)))
                shadow.append(logits[:, -1].float().cpu())
            if routes is not None:
                routes.append([])
            logits, cache = lm_forward(params, lm_cfg, batch, **kw)
            if seen is not None:
                seen.append(logits[:, -1].float().cpu())
            return logits, cache

        def moe(p, x, lm_cfg):
            if routes:
                routes[-1].append(lm_route(p, x, lm_cfg))
            return lm_moe(p, x, lm_cfg)
        LMT.forward, LMMOE.moe = forward, moe
        if f32_cache:
            LMT.init_cache = lambda *a, **kw: lm_f32_cache(
                lm_init_cache(*a, **kw))
        try:
            yield
        finally:
            LMT.forward, LMT.init_cache, LMMOE.moe = (
                lm_forward, lm_init_cache, lm_moe)

    def lm_serve(params, lm_cfg, device, seen=None, routes=None,
                 f32_cache=False, shadow=None):
        """One batch of the phase's requests through a new Server on
        ``device``: the server and its tokens."""
        srv = LMServer(params, lm_cfg, max_batch=8, max_len=128,
                       device=device)
        lm_submit(srv, lm_cfg.vocab)
        with lm_recording(seen, routes, f32_cache, shadow):
            return srv, srv.step()

    def lm_forced(params, lm_cfg, tokens, calls, seen, routes,
                  f32_cache=False, shadow=None):
        """The phase's batch on the CPU through the Server's own prefill,
        splice and decode, for ``calls`` forward calls (the prefill, then
        decode calls fed ``tokens``, the card's, teacher-forced): each
        request's greedy tokens of those calls."""
        srv = LMServer(params, lm_cfg, max_batch=8, max_len=128,
                       device="cpu")
        lm_submit(srv, lm_cfg.vocab)
        toks, _ = srv._pad_batch([t_.item for t_ in srv._queue.take(8)])
        b, s = toks.shape
        with torch.inference_mode(), lm_recording(seen, routes, f32_cache,
                                                  shadow):
            _, pc = srv._prefill(params, {"tokens": toks,
                                          **srv._extra_for(b, s)})
            cache = srv._splice(LMT.init_cache(params, lm_cfg, b, 128),
                                pc, s)
            for step in range(calls - 1):
                tok = torch.tensor([row[step] for row in tokens])
                _, cache = srv._decode(params, cache, {
                    "tokens": tok[:, None], **srv._extra_for(b, 1)})
        return [[int(seen[c][i].argmax()) for c in range(calls)]
                for i in range(b)]

    def lm_flips(routes_dev, routes_cpu):
        """The (call, layer, token) routing decisions that differ between
        two runs, each with the second run's margin."""
        out = []
        for c, (calls_d, calls_c) in enumerate(zip(routes_dev, routes_cpu)):
            for layer, ((e_d, _), (e_c, m_c)) in enumerate(zip(calls_d,
                                                                calls_c)):
                for tok in (e_d != e_c).any(dim=-1).nonzero()[:, 0].tolist():
                    out.append({"call": c, "layer": layer, "token": tok,
                                "margin": float(m_c[tok])})
        return out

    def lm_compare(lm_arch, out_dev, out_cpu, seen_dev, seen_cpu,
                   routes_dev, routes_cpu, tol):
        """The card's run against the CPU's: the routing decisions that
        differ (each must be a tie), the first divergence of the greedy
        tokens (a tie within the decode tolerance, or None) and each decode
        call's logits' max |diff| / max |logit| (gated at ``tol``) while
        both runs read the same tokens and the same routing: through the
        call before the first that routes a token otherwise (its flipped
        token's layer outputs enter the later calls' caches)."""
        flips = lm_flips(routes_dev, routes_cpu)
        check(all(f["margin"] <= LM_ROUTE_TIE for f in flips),
              f"{lm_arch}: routing decisions differ beyond a tie: {flips}")
        calls = min([len(seen_cpu)] + [f["call"] for f in flips])
        diverged = lm_first_divergence([r[:calls] for r in out_dev],
                                       [r[:calls] for r in out_cpu],
                                       seen_cpu, LM_DECODE_TOL)
        last = calls - 1 if diverged is None else diverged
        errs = [float((seen_dev[k] - seen_cpu[k]).abs().max()
                      / seen_cpu[k].abs().max()) for k in range(1, last + 1)]
        check(max(errs, default=0.0) <= tol,
              f"{lm_arch}: decode logits {errs} of max |logit| from the "
              f"CPU's (routing flips {flips})")
        return diverged, errs, flips

    def lm_batch(lm_cfg, toks):
        """A forward batch of ``toks`` [B, S] (Whisper's frames zeros, as
        the Server gives them)."""
        batch = {"tokens": toks}
        if lm_cfg.family == "encdec":
            batch["enc_embeds"] = torch.zeros(
                (toks.shape[0], lm_cfg.enc_seq, lm_cfg.d_model),
                device=toks.device)
        return batch

    def lm_prefilled(params, lm_cfg, toks, max_len,
                     cache_dtype=torch.bfloat16):
        """A ``max_len`` decode cache holding the f32 prefill of ``toks``
        [B, S], at position S (its kv in ``cache_dtype``)."""
        _, pc = LMT.forward(params, lm_cfg, lm_batch(lm_cfg, toks),
                            mode="prefill", param_dtype=torch.float32)
        cache = LMT.init_cache(params, lm_cfg, toks.shape[0], max_len)
        if cache_dtype == torch.float32:
            cache = lm_f32_cache(cache)
        return lm_splice(cache, pc, toks.shape[1])

    def lm_continuation(params, lm_cfg, device, cache_dtype=torch.bfloat16):
        """Logits of one token decoded from a spliced prefill cache or
        state against a prefill over the extended sequence
        (``tests/test_models.py::test_decode_matches_prefill_continuation``
        at full width): ``of_tol``, the largest |diff| / (atol + rtol
        |logit|) with atol 5e-3 of max |logit| and rtol 5e-2; the same
        with the reference test's absolute atol; max |diff| / max |logit|;
        for a MoE model the decoded token's routing decisions that differ
        from the prefill's, with their margins."""
        routes = []
        with torch.inference_mode(), lm_recording(routes=routes):
            toks = torch.arange(16, device=device).reshape(2, 8) \
                % lm_cfg.vocab
            seven = torch.full((2, 1), 7, device=device)
            full, _ = LMT.forward(params, lm_cfg, lm_batch(
                lm_cfg, torch.cat([toks, seven], 1)), mode="prefill",
                param_dtype=torch.float32)
            dec, _ = LMT.forward(
                params, lm_cfg, {"tokens": seven}, mode="decode",
                cache=lm_prefilled(params, lm_cfg, toks, 16, cache_dtype),
                param_dtype=torch.float32)
        diff, scale = (dec - full).abs(), float(full.abs().max())
        rtol_part = LM_RTOL * full.abs()
        # calls: the extended prefill, the cache's prefill, the decode;
        # the extended prefill's rows 8 and 17 are the decoded token's
        last = [(e[8::9], m[8::9]) for e, m in routes[0]]
        return {"of_tol": float((diff / (LM_ATOL * scale
                                         + rtol_part)).max()),
                "of_absolute_tol": float((diff / (LM_ATOL
                                                  + rtol_part)).max()),
                "rel_err": float(diff.max()) / scale,
                "max_logit": scale,
                "routing_flips": lm_flips([routes[2]], [last])}

    def lm_profile_decode(params, lm_cfg):
        """One decode step of 8 rows at position 16 under torch.profiler:
        its CUDA kernels (memory copies included) and their summed
        device time."""
        PA = torch.profiler.ProfilerActivity
        with torch.inference_mode():
            toks = torch.zeros((8, 16), dtype=torch.long, device=dev)
            cache = lm_prefilled(params, lm_cfg, toks, 128)

            def step():
                LMT.forward(params, lm_cfg, {"tokens": toks[:, :1]},
                            mode="decode", cache=dict(cache),
                            param_dtype=torch.float32)
            step()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[PA.CPU, PA.CUDA]) as pr:
                step()
                torch.cuda.synchronize()
        ev = [e for e in pr.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"kernels": len(ev),
                "device_busy_ms": sum(e.device_time_total
                                      for e in ev) / 1e3}

    def synced(fn, times):
        """``fn`` timed on the host clock between two synchronizations."""
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    def lm_params(lm_cfg, card_draw):
        """The model's seeded weights on the card and on the CPU: drawn on
        the card (a CUDA generator) and copied to the host, or drawn on
        the host and copied to the card."""
        if card_draw:
            on_dev = ST.real_params(
                lm_cfg, torch.Generator(device=dev).manual_seed(0), dev)
            return on_dev, tree.tree_map(lambda v: v.cpu(), on_dev)
        on_cpu = ST.real_params(lm_cfg, torch.Generator().manual_seed(0),
                                "cpu")
        return tree.tree_map(lambda v: v.to(dev), on_cpu), on_cpu

    torch.backends.cuda.matmul.allow_tf32 = True
    zero_counts()
    detail["serve_lm"] = {}
    t_phase = time.perf_counter()
    for cell in LM_SERVE:
        lm_arch, cpu_calls = cell.arch, cell.cpu_calls
        t_model = time.perf_counter()
        lm_cfg = get_config(lm_arch)
        full_layers = lm_cfg.n_layers
        if cell.layers is not None:        # full width, depth cut
            lm_cfg = dataclasses.replace(lm_cfg, n_layers=cell.layers)
        # the previous model freed: what the earlier phases hold, < 1 GB
        held_gb = torch.cuda.memory_allocated() / 1e9
        check(held_gb < 1.0, f"{lm_arch}: {held_gb:.2f} GB held on the "
              f"card before its weights")
        torch.cuda.reset_peak_memory_stats()
        params_dev, params_cpu = lm_params(lm_cfg, cell.card_draw)
        leaves = tree.leaves(params_cpu)
        weight_bytes = sum(v.numel() * v.element_size() for v in leaves)
        # the f32 serve casts every lower-precision weight to f32 (arctic's
        # bf16): a copy written and read again on each call
        cast_bytes = sum(8 * v.numel() for v in leaves
                         if v.dtype != torch.float32)
        # the gates' batch on the card, then on the CPU (all 17 calls, or
        # ``cpu_calls`` of them fed the card's tokens); the CPU's f32-cache
        # decode calls also run on the card, fed the CPU's cache
        calls = 17 if cpu_calls is None else cpu_calls
        runs, shadow = {}, [params_dev]
        for key, f32_cache in (("bf16_cache", False), ("f32_cache", True)):
            seen_dev, seen_cpu, r_dev, r_cpu = [], [], [], []
            out_dev = lm_serve(params_dev, lm_cfg, dev, seen_dev, r_dev,
                               f32_cache)[1]
            out_cpu = (lm_serve(params_cpu, lm_cfg, "cpu", seen_cpu, r_cpu,
                                f32_cache, shadow if f32_cache else None)[1]
                       if cpu_calls is None else
                       lm_forced(params_cpu, lm_cfg, out_dev, cpu_calls,
                                 seen_cpu, r_cpu, f32_cache,
                                 shadow if f32_cache else None))
            check(len(seen_dev) == 17 and len(seen_cpu) == calls,
                  f"{lm_arch}: {len(seen_dev)} card and {len(seen_cpu)} "
                  f"CPU forward calls, not 1 prefill + 16 decode (CPU "
                  f"{calls})")
            runs[key] = (out_dev, seen_dev, seen_cpu, lm_compare(
                lm_arch, out_dev, out_cpu, seen_dev, seen_cpu, r_dev, r_cpu,
                LM_DECODE_TOL if key == "bf16_cache" else cell.f32_tol))
        out_dev, seen_dev, seen_cpu, (diverged, dec_errs, flips) = \
            runs["bf16_cache"]
        # each decode call's arithmetic on the card, fed the CPU's f32
        # cache and tokens: no rounding difference carried in from earlier
        # calls, and none rounded apart into a bf16 cache (a bf16 kv read
        # 1.1e-3-1.6e-3 of max |logit| so on llama3.2-1b, measured on one
        # H100)
        shadow_errs = [float((g - w).abs().max() / w.abs().max())
                       for g, w in zip(shadow[1:], runs["f32_cache"][2][1:])]
        check(len(shadow_errs) == calls - 1
              and max(shadow_errs, default=0.0) <= LM_PREFILL_TOL,
              f"{lm_arch}: decode calls fed the CPU's cache read "
              f"{shadow_errs} of max |logit| from the CPU's")
        # the f32 prefill's logits, with no exception; each decode call's
        # logits while both runs read the same tokens and routing, at the
        # decode tolerance with the bf16 cache: two implementations of the
        # reference's bf16 cache and probs round near-equal f32 values
        # apart (the JAX package's and the port's CPU decodes lie 2.0e-3 /
        # 2.3e-3 of max |logit| apart, scripts/continuation_witness.py);
        # with an f32 decode cache, which rounds nothing to bf16, at the
        # model's f32 tolerance and no token may diverge
        pre_err = float((seen_dev[0] - seen_cpu[0]).abs().max()
                        / seen_cpu[0].abs().max())
        check(pre_err <= cell.f32_tol,
              f"{lm_arch}: prefill logits {pre_err:.3g} of max |logit| "
              f"from the CPU's")
        # with the f32 cache no token may diverge, unless the model's own
        # f32 noise reaches the decode tolerance (xlstm-350m): there a
        # divergence at a tie, as with the bf16 cache
        f32_div, f32_errs, f32_flips = runs["f32_cache"][3]
        check(f32_div is None or cell.f32_tol >= LM_DECODE_TOL,
              f"{lm_arch}: with an f32 decode cache, first divergence "
              f"{f32_div}, decode logits {f32_errs} of max |logit|")
        # a warm batch with each call synchronized (prefill ms, decode ms
        # per step), then one as the server runs it (tokens/s)
        srv = lm_serve(params_dev, lm_cfg, dev)[0]
        pre_ms, dec_ms = [], []
        srv._prefill = synced(srv._prefill, pre_ms)
        srv._decode = synced(srv._decode, dec_ms)
        lm_submit(srv, lm_cfg.vocab)
        check(srv.step() == out_dev,
              f"{lm_arch}: a second batch served other tokens")
        t0 = time.perf_counter()
        out_e2e = lm_serve(params_dev, lm_cfg, dev)[1]
        batch_s = time.perf_counter() - t0
        check(out_e2e == out_dev,
              f"{lm_arch}: the timed batch served other tokens")
        prof = lm_profile_decode(params_dev, lm_cfg)
        prof["idle_share"] = 1 - prof["device_busy_ms"] / statistics.median(
            dec_ms)
        # the reference's KV-cache check at full width: one token decoded
        # from a spliced cache or state against a prefill over the
        # extended sequence, at its rtol and its atol taken relative to
        # max |logit| (the absolute 5e-3 was sized for the reduced model's
        # logits, ~0.7 at most); the same with an f32 cache, whose
        # rounding is then the only difference, at the model's
        # continuation tolerance; and the CPU's, reported (not for a model
        # whose CPU comparison is cut).  With the bf16 cache a MoE model's
        # decoded token may route otherwise than in the prefill at a bf16
        # tie, and then its logits are not compared; with the f32 cache
        # it may not route otherwise
        cont = {"bf16": lm_continuation(params_dev, lm_cfg, dev),
                "f32_cache": lm_continuation(params_dev, lm_cfg, dev,
                                             torch.float32),
                "cpu_bf16": (lm_continuation(params_cpu, lm_cfg, "cpu")
                             if cpu_calls is None else None)}
        for key, gate, tol, tie in (
                ("bf16", "of_tol", 1.0, LM_ROUTE_TIE_BF16),
                ("f32_cache", "rel_err", cell.cont_tol, 0.0)):
            c_flips = cont[key]["routing_flips"]
            check(all(f["margin"] <= tie for f in c_flips),
                  f"{lm_arch}: the continuation ({key}) routes beyond a "
                  f"tie {cont[key]}")
            check(bool(c_flips) or cont[key][gate] <= tol,
                  f"{lm_arch}: decode vs prefill continuation ({key}) "
                  f"{cont[key]}")
        lm_row = {"serve_lm": lm_arch, "card": smi,
                  "params": LMT.param_count(params_cpu),
                  "layers": f"{lm_cfg.n_layers} of {full_layers}",
                  "weight_bytes": weight_bytes, "batch": 8,
                  "new_tokens": 16, "prefill_rel_err": pre_err,
                  "f32_tol": cell.f32_tol, "continuation_f32_tol":
                  cell.cont_tol,
                  "decode_rel_err": max(dec_errs, default=0.0),
                  "decode_calls_compared": len(dec_errs),
                  "decode_tol": LM_DECODE_TOL,
                  "decode_f32_cache_rel_err": max(f32_errs, default=0.0),
                  "decode_f32_cache_calls_compared": len(f32_errs),
                  "decode_on_cpu_cache_rel_err": max(shadow_errs,
                                                     default=0.0),
                  "cpu_calls": calls, "first_divergence": diverged,
                  "routing_flips": flips, "routing_flips_f32_cache":
                  f32_flips, "continuation": cont,
                  "prefill_ms": statistics.median(pre_ms),
                  "decode_ms_per_step": statistics.median(dec_ms),
                  "decode_ms_per_step_min": min(dec_ms),
                  "decode_bound_ms": 1e3 * weight_bytes / PEAK_BYTES,
                  "decode_cast_bytes": cast_bytes,
                  "decode_profile": prof,
                  "batch_s": batch_s,
                  "tokens_per_s": sum(map(len, out_e2e)) / batch_s,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "held_before_gb": held_gb,
                  "model_s": time.perf_counter() - t_model}
        print(json.dumps(lm_row))
        detail["serve_lm"][lm_arch] = dict(lm_row, tokens=out_dev)
        # the timing wrappers hold srv's own methods: collect the cycle
        del params_dev, params_cpu, leaves, srv, runs, shadow
        gc.collect()
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    lm_launches = counts()
    detail["serve_lm_s"] = time.perf_counter() - t_phase
    print(json.dumps({"serve_lm_launches": lm_launches,
                      "serve_lm_s": detail["serve_lm_s"]}))
    check(not any(lm_launches.values()),
          f"the LM path launched hand kernels: {lm_launches}")

    # -- 4t. train (LM) ----------------------------------------------------
    # llama3.2-1b trained through launch.train at full width and depth,
    # then one teacher-forced step of each other family (lm_train_phase)
    lm_train_phase(dev, smi, detail, counts, zero_counts)

    # -- 4u. sharded (LM) --------------------------------------------------
    # the LM's parameters partitioned over a model axis and FSDP: two gloo
    # ranks on the card (lm_sharded_phase); no hand kernel may launch, on
    # a rank or in the reference here
    phase("sharded (LM)")
    lm_sharded_phase(smi, detail)

    # -- 5. times -------------------------------------------------------------
    phase("times")
    print(json.dumps({"bound_peaks": {
        "float32_flops": PEAK_FLOPS["float32"],
        "bfloat16_flops": PEAK_FLOPS["bfloat16"], "hbm_bytes_per_s":
        PEAK_BYTES, "source": "H100 SXM data sheet, dense; f32 on CUDA "
        "cores"}}))

    def per_call_ms(fn, calls, groups=5):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(groups):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b) / calls)
        return statistics.median(ts)

    def library_call(layer, x, w, b):
        """One cuDNN call computing the same conv/deconv (+bias; the
        activation is a separate op there), channels-last, layouts
        permuted outside the timed region."""
        r = layer.rank
        fmt = torch.channels_last if r == 2 else torch.channels_last_3d
        xl = x.permute(0, r + 1, *range(1, r + 1))
        if layer.op == "deconv":
            wl = w.permute(r, r + 1, *range(r)).contiguous(
                memory_format=fmt)
            fn = F.conv_transpose2d if r == 2 else F.conv_transpose3d
            return lambda: fn(xl, wl, b, stride=layer.stride,
                              dilation=layer.dilation)
        wl = w.permute(r + 1, r, *range(r)).contiguous(memory_format=fmt)
        fn = F.conv2d if r == 2 else F.conv3d
        pad = tuple(lo for lo, _ in layer.padding)
        check(all(lo == hi for lo, hi in layer.padding), "symmetric pad")
        return lambda: fn(xl, wl, b, stride=layer.stride, padding=pad,
                          dilation=layer.dilation)

    def tile_name(block_co, route="fma"):
        """rows x output channels of a forward kernel's block."""
        return f"{tiling.ROUTE_TILES[route][block_co].block_m}x{block_co}"

    # each kernel's totals over the main path's launches: every call
    # shape's times, weighted by the calls of that shape it recorded
    def zero_total():
        return {"launches": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                "ms_by_path": {}}

    totals = {k: zero_total() for k in max_abs}
    # each kernel's totals again per (x, w) operand pair; a pair the main
    # path does not launch (bf16 x bf16, bf16 x int8) stands in for the
    # path's f32 (w:int8) pair: its call shapes in bf16, weighted by the
    # launches of the f32 shapes
    pair_totals = {k: {} for k in max_abs}
    stand_in_pairs = set()
    timed, timed_stand_in = set(), set()

    def as_f32(key):
        """The call-shape signature with every bf16 tensor f32."""
        if isinstance(key, tuple):
            return tuple(as_f32(k_) for k_ in key)
        return torch.float32 if key is torch.bfloat16 else key

    def account(row, keys, ops_ms, bytes_ms, stand_in=False):
        """Add a call shape's times to its kernels' totals, weighted by the
        main path's launches of that shape; a ``stand_in`` row (a bf16
        pair) only to its pair's totals, weighted by the launches of the
        same shape in f32."""
        row["launches"] = {}
        for key in keys:
            seen = timed_stand_in if stand_in else timed
            if key in seen:         # a shape two layers share counts once
                continue
            paths = recorded.get(as_f32(key) if stand_in else key, {})
            n = sum(paths.values())
            seen.add(key)
            row["launches"][key[0]] = n
            tots = [] if stand_in else [totals[key[0]]]
            if "pair" in row:
                tots.append(pair_totals[key[0]].setdefault(row["pair"],
                                                           zero_total()))
                if stand_in:
                    stand_in_pairs.add((key[0], row["pair"]))
            for tot in tots:
                tot["launches"] += n
                for f in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    tot[f] += n * row[f]
                tot["ops_ms" if ops_ms >= bytes_ms else "bytes_ms"] += \
                    n * row["bound_ms"]
                for path, n_p in paths.items():
                    tot["ms_by_path"][path] = (tot["ms_by_path"].get(path, 0.0)
                                               + n_p * row["ms"])

    def time_forward(model, layer, batch, args, operands, lib_call, peak,
                     kname, stand_in=False, **extra):
        """One forward call shape on the card: the kernel (CUDA events),
        the wrapper's host time per call, the plain version, ``lib_call``
        and the bound (the operations at ``peak``, or the bytes of
        ``operands`` and the output), accounted to ``kname``'s totals
        (``account``)."""
        split_log.clear()
        y = run_kernel(layer.op, args)
        splits = split_log[0]
        kms = per_call_ms(lambda: run_kernel(layer.op, args), 10)
        # the wrapper's host time per call (enqueue, no synchronize): where
        # it exceeds the kernel's, back-to-back launches time the host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            run_kernel(layer.op, args)
        hms = 1e3 * (time.perf_counter() - t0) / 20
        torch.cuda.synchronize()
        pms = per_call_ms(lambda: run_plain(layer.op, args), 2, groups=3)
        lms = per_call_ms(lib_call, 10)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (*operands, y) if t is not None)
        flops = 2 * batch * layer.valid_macs
        ops_ms = 1e3 * flops / peak
        bytes_ms = 1e3 * nbytes / PEAK_BYTES
        row = {"layer": f"{model}:{layer.name}", "op": layer.op, **extra,
               "batch": batch, "in": list(operands[0].shape),
               "out": list(y.shape), "ms": kms, "plain_ms": pms,
               "library_ms": lms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "share": max(ops_ms, bytes_ms) / kms, "host_ms": hms,
               "tile": tile_name(args[2]["block_co"],
                                 extra.get("route", "fma")),
               "splits": splits,
               "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
               "tflops": flops / kms / 1e9}
        account(row, [signature(kname, *args[:3])], ops_ms, bytes_ms,
                stand_in)
        print(json.dumps(row))
        return row

    # every main-path forward shape in f32 (the FMA route), then again in
    # bf16 (the bf16 route, igemm_bf16_kernel's mma.sync m16n8k16; cuDNN
    # in bf16 beside it), standing in for the path in bf16; each bound at
    # the card's rate for the operands' type
    print(json.dumps({"bound_peaks_tf32": {
        "tf32_flops": PEAK_TF32,
        "source": "H100 SXM data sheet, dense TF32 tensor cores"}}))
    detail["layers"] = []
    for dtype, stand_in in ((torch.float32, False), (torch.bfloat16, True)):
        dname = str(dtype).split(".")[-1]
        for model, layer, batch in main_layers:
            x, w, b, args = layer_operands(layer, dtype, batch)
            detail["layers"].append(time_forward(
                model, layer, batch, args, (x, w, b),
                library_call(layer, x, w, b), PEAK_FLOPS[dname],
                f"{layer.op}_fwd",
                stand_in, pair=f"{dname}/{dname}",
                route=PAIR_ROUTE[(dname, dname)]))
            del x, w, b, args
    torch.cuda.empty_cache()

    # the int8 launches at every call shape of the quantized serving path,
    # the same way, and bf16 activations beside the int8 weights standing
    # in for the w:int8 path in bf16; the library time is cuDNN's on the
    # dequantized f32 operands (dequantized outside the timed region, TF32
    # off), the bound the card's rate for the operands' types (2 x MACs:
    # dense TF32 for f32 x int8, bf16 for bf16 x int8, int8 for int8 x
    # int8) or the bytes at their true widths
    print(json.dumps({"bound_peaks_int8": {
        "int8_ops": PEAK_INT8_OPS, "hbm_bytes_per_s": PEAK_BYTES,
        "source": "H100 SXM data sheet, dense int8 tensor cores"}}))
    Q_PEAK = {"w8": PEAK_TF32, "w8a8": PEAK_INT8_OPS,
              "bf16w8": PEAK_FLOPS["bfloat16"]}
    from repro_torch.kernels import common as kcommon

    def weight_layout(layer, pair, w, kw):
        """The call the ops layer makes per launch to lay the weights out
        for the kernel: K-major for the s8 route, else the deconv's
        phase-major gather or the conv's reshape."""
        k3, s3, d3, g = (kw["kernel"], kw["stride"], kw["dilation"],
                         kw["groups"])
        w3 = w.reshape(*k3, *w.shape[-2:])
        if pair == "w8a8":
            s3 = s3 if layer.op == "deconv" else (1, 1, 1)
            return "k-major", lambda: kcommon.kmajor_weights(w3, k3, s3, d3,
                                                             g)
        if layer.op == "deconv":
            return "phase-major", lambda: kcommon.phase_major_weights(
                w3, k3, s3, d3)
        return "reshape", lambda: w3.reshape(-1, *w.shape[-2:]).contiguous()

    detail["int8_layers"] = []
    for model, layer, batch in q_layers:
        for pair in ("w8", "w8a8", "bf16w8"):
            ops = q_layer_operands(layer, pair, batch)
            # the weight layout's cost per launch: device time (CUDA
            # events) and host time per call (enqueue, no synchronize)
            layout, lay = weight_layout(layer, pair, ops["w"],
                                        ops["args"][2])
            lay_ms = per_call_ms(lay, 10)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                lay()
            lay_host = 1e3 * (time.perf_counter() - t0) / 20
            torch.cuda.synchronize()
            detail["int8_layers"].append(time_forward(
                model, layer, batch, ops["args"],
                (ops["x"], ops["w"], ops["b"], ops["args"][2]["scale"]),
                library_call(layer, ops["x_deq"], ops["w_deq"], ops["b"]),
                Q_PEAK[pair], f"{layer.op}_fwd_int8", pair == "bf16w8",
                pair=Q_PAIRS[pair],
                route=PAIR_ROUTE[tuple(Q_PAIRS[pair].split("/"))],
                library="cuDNN on the dequantized f32 operands",
                w_layout=layout, layout_ms=lay_ms, layout_host_ms=lay_host))
            del ops
    torch.cuda.empty_cache()
    # the int8 call shapes summed per operand pair (once each; the summary
    # line weighs them by their launches)
    for pair in ("float32/int8", "int8/int8", "bfloat16/int8"):
        rows = [r_ for r_ in detail["int8_layers"] if r_["pair"] == pair]
        print(json.dumps({"int8_pair": pair, "call_shapes": len(rows), **{
            f: sum(r_[f] for r_ in rows)
            for f in ("ms", "library_ms", "bound_ms", "layout_ms",
                      "layout_host_ms")}}))

    detail["e2e"] = {}
    for pol, srv in (("f32", server), *q_servers.items()):
        for model, xs in (("dcgan_gen", seeds[:BATCH]), ("vnet", vols)):
            lat = []
            for _ in range(3):
                for x in xs:
                    srv.submit(ServeRequest(model, x))
                t0 = time.perf_counter()
                got = srv.step()
                lat.append(time.perf_counter() - t0)
                check(len(got) == len(xs) and all(r.ok for r in got),
                      f"{pol}/{model} timing batch failed")
                # a batch the fallback served must not be timed as the
                # kernels'
                check(all(r.engine == "pallas" for r in got),
                      f"{pol}/{model} timing batch served by "
                      f"{sorted({r.engine for r in got})}")
            detail["e2e"].setdefault(pol, {})[model] = {"batch": len(xs),
                                                        "seconds": lat}
            print(json.dumps({"e2e_batch": model, "policy": pol,
                              "batch": len(xs), "seconds": lat,
                              "median_ms": 1e3 * statistics.median(lat)}))
        check(srv.stats()["fallbacks"] == 0,
              f"{pol}: {srv.stats()['fallbacks']} buckets fell back while "
              f"timed")

    def library_backward(layer, x, w, dy, which):
        """One cuDNN ``convolution_backward`` computing the same dw or dx
        (only that output's mask set), channels-last, layouts prepared
        outside the timed region; the deconv's dy is zero-padded back to
        the Eq. (1) extent its crop removed."""
        r = layer.rank
        fmt = torch.channels_last if r == 2 else torch.channels_last_3d
        to_nc = (0, r + 1, *range(1, r + 1))
        if layer.op == "deconv":
            pads = [0, 0]
            for lo, hi in reversed(layer.padding):
                pads += [lo, hi]
            dy = F.pad(dy, pads)
            wl = w.permute(r, r + 1, *range(r)).contiguous(
                memory_format=fmt)
            padding, transposed = [0] * r, True
        else:
            wl = w.permute(r + 1, r, *range(r)).contiguous(
                memory_format=fmt)
            check(all(lo == hi for lo, hi in layer.padding), "symmetric pad")
            padding, transposed = [lo for lo, _ in layer.padding], False
        xl, dyl = x.permute(*to_nc), dy.contiguous().permute(*to_nc)
        mask = [which == "dx", which == "dw", False]
        return lambda: torch.ops.aten.convolution_backward(
            dyl, xl, wl, None, list(layer.stride), padding,
            list(layer.dilation), transposed, [0] * r, layer.groups, mask)

    # backward kernels at every training geometry (batch 64 / 4), f32;
    # then dx again in bf16 (a forward kernel on the bf16 route,
    # igemm_bf16_kernel), standing in for the path's dx in bf16
    detail["backward_layers"] = []
    for dtype, grads in ((torch.float32, ("dw", "dx")),
                         (torch.bfloat16, ("dx",))):
        dname = str(dtype).split(".")[-1]
        route = PAIR_ROUTE[(dname, dname)]
        for model, layer, batch in train_layers:
            x, w, dy, dx_args, dw_args = backward_operands(layer, batch,
                                                           dtype)
            for which in grads:
                args = dx_args if which == "dx" else dw_args
                kname = BACKWARD_KERNEL[(layer.op, which)]
                split_log.clear()
                out = run_backward(layer.op, which, args)
                kw = args[2]
                tile = (tile_name(kw["block_co"], route) if which == "dx"
                        else f"{kw['block_a']}x{kw['block_c']}")
                splits = split_log[0] if which == "dx" else kw["splits"]
                kms = per_call_ms(
                    lambda: run_backward(layer.op, which, args), 5,
                    groups=3)
                pms = per_call_ms(
                    lambda: run_backward_plain(layer.op, which, args), 1,
                    groups=3)
                lms = per_call_ms(library_backward(layer, x, w, dy, which),
                                  5, groups=3)
                nbytes = sum(t.numel() * t.element_size()
                             for t in ((x, dy, out) if which == "dw"
                                       else (dy, w, out)))
                flops = 2 * batch * layer.valid_macs
                ops_ms = 1e3 * flops / PEAK_FLOPS[dname]
                bytes_ms = 1e3 * nbytes / PEAK_BYTES
                row = {"layer": f"{model}:{layer.name}", "op": layer.op,
                       "grad": which, "kernel": kname, "batch": batch,
                       "ms": kms, "plain_ms": pms,
                       "library_ms": lms, "bound_ms": max(ops_ms, bytes_ms),
                       "bound_by": ("operations" if ops_ms >= bytes_ms
                                    else "bytes"),
                       "share": max(ops_ms, bytes_ms) / kms, "tile": tile,
                       "splits": splits,
                       "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                       "tflops": flops / kms / 1e9}
                if which == "dx":               # a forward kernel's pair
                    row.update(pair=f"{dname}/{dname}", route=route)
                keys = [signature(kname, *args)]
                if kname == "deconv_dx":        # its launch is conv_fwd's
                    keys.append(signature("conv_fwd", *args))
                account(row, keys, ops_ms, bytes_ms,
                        dtype == torch.bfloat16)
                print(json.dumps(row))
                detail["backward_layers"].append(row)
                del out
            del x, w, dy, dx_args, dw_args
    torch.cuda.empty_cache()
    untimed = set(recorded) - timed
    check(not untimed, f"main-path calls of no timed shape: {untimed}")

    # whole train steps (host clock around the step and a synchronize)
    detail["train_step_ms"] = {}
    for arch in ("dcgan", "v-net"):
        cfg, params, state, step_fn = train_setup(arch, dev, engine)
        batch = batches(arch, cfg, dev)
        ms = []
        for _ in range(4):
            b = batch.next()
            t0 = time.perf_counter()
            params, state, _ = step_fn(params, state, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        batch.close()
        detail["train_step_ms"][arch] = ms
        print(json.dumps({"train_step": arch, "batch": cfg.dcnn_batch,
                          "ms": ms, "median_ms_after_first":
                          statistics.median(ms[1:])}))
        del params, state
    torch.cuda.empty_cache()

    # -- 5d. dry run --------------------------------------------------------
    # launch.dryrun's abstract steps against the train steps measured
    # above (llama3.2-1b's of train (LM), V-Net's of train and times), and
    # one production cell traced on the abstract 16 x 16 layout
    dryrun_phase(dev, smi, detail)

    # -- 6. runtime report ------------------------------------------------------
    # obs.measure_network at full width, batch 4: every node of V-Net's graph
    # and of DCGAN's chain timed alone after a warm call (the device's time
    # on CUDA events and the host's issue time, best of 3) against the
    # calibrated f32 roof (a matmul probe under
    # functional.ieee_f32: the CUDA cores' rate, the f32 route's); then the
    # instrumented callable against the bare one, and the server's registry
    # exported after a served batch.  Not a main path: its launches are
    # reported on their own, never added to the counts above
    phase("runtime report")
    t_phase = time.perf_counter()
    launches_before = (dk.launches, ck.launches)
    peak = obs.machine_peak_gflops(device=dev)
    mem = obs.machine_mem_gbps(device=dev)
    detail["calibrated"] = {"f32_gflops": peak, "mem_gbps": mem}
    print(json.dumps({"calibrated_peaks": detail["calibrated"],
                      "probe": "IEEE f32 8192^3 matmul; copy of 1 GiB",
                      "card": smi}))
    report_nets = {"vnet": nets.vnet_graph(in_spatial=VNET_SPATIAL,
                                           chans=VNET_CHANS),
                   "dcgan": nets.dcgan()}
    detail["runtime_report"] = {}
    for net_name, network in report_nets.items():
        rpt = obs.measure_network(network, UniformEngine(device=dev),
                                  batch=BATCH, repeats=3, name=net_name)
        order = (list(network.order) if isinstance(network, nets.UniformGraph)
                 else [l.name for l in network])
        check([r.name for r in rpt.layers] == order,
              f"{net_name}: report rows {[r.name for r in rpt.layers]}")
        for r in rpt.layers:
            print(json.dumps({"fig6": net_name, "node": r.name, "op": r.op,
                              "ms": r.measured_s * 1e3,
                              "host_ms": r.host_s * 1e3,
                              "gflops": r.achieved_gflops,
                              "f32_roof_share": r.utilization,
                              "blocks": r.blocks, "splits": r.splits}))
            if r.op in ("conv", "deconv"):
                check(r.measured_s > 0, f"{net_name}/{r.name}: no time")
            check(r.utilization <= 1.05, f"{net_name}/{r.name}: "
                  f"{r.utilization:.3f} of the calibrated f32 roof")
        check(rpt.utilization <= 1.05, f"{net_name}: whole network at "
              f"{rpt.utilization:.3f} of the calibrated f32 roof")
        print(json.dumps({"fig6_network": net_name, "batch": BATCH,
                          "net_ms": rpt.net_wall_s * 1e3,
                          "net_host_ms": rpt.net_host_s * 1e3,
                          "sum_layer_ms": rpt.sum_layer_s * 1e3,
                          "gflops": rpt.achieved_gflops,
                          "f32_roof_share": rpt.utilization,
                          "peak_gflops": rpt.peak_gflops}))
        detail["runtime_report"][net_name] = rpt.to_json()

    # the instrumented callable: the schedule's launches per call, the bare
    # callable's bits, one dispatch recorded per call
    tel = obs.Telemetry.create()
    inst_eng = UniformEngine(EngineConfig(telemetry=tel, device=dev))
    bare_eng = UniformEngine(device=dev)
    for net_name, network in report_nets.items():
        ws = tree.tree_map(lambda t: t.to(dev), init_network_weights(
            network, torch.Generator().manual_seed(0)))
        first = (network.in_shape if isinstance(network, nets.UniformGraph)
                 else (network[0].in_spatial, network[0].cin))
        x = rand((BATCH, *first[0], first[1]), torch.float32)
        inst, sched = compile_network(network, inst_eng, batch=BATCH)
        bare, _ = compile_network(network, bare_eng, batch=BATCH)
        with torch.inference_mode():
            want = bare(ws, x)
            for call in range(3):
                before = dk.launches + ck.launches
                got = inst(ws, x)
                n = dk.launches + ck.launches - before
                check(n == sched.kernel_launches, f"{net_name}: the "
                      f"instrumented call launched {n}, the schedule "
                      f"{sched.kernel_launches}")
                check(torch.equal(got, want), f"{net_name}: instrumented "
                      f"output differs from the bare one")
        hist = tel.registry.get("engine_dispatch_seconds",
                                schedule=inst.telemetry_tag)
        check(hist is not None and hist.count == 3,
              f"{net_name}: dispatch histogram {hist}")
        print(json.dumps({"instrumented": net_name,
                          "launches_per_call": sched.kernel_launches,
                          "dispatch_ms": [1e3 * v for v in hist.samples()]}))
        del ws, x, want, got

    # the server's registry, exported after one served batch
    esrv = DcnnServer([gen_spec], max_batch=BATCH)
    for x_ in seeds[:BATCH]:
        esrv.submit(ServeRequest("dcgan_gen", x_))
    got = esrv.step()
    check(len(got) == BATCH and all(r_.ok for r_ in got),
          f"export batch: {[r_.code for r_ in got]}")
    prom = obs.render_prometheus(esrv.telemetry.registry)
    exported = obs.render_json(esrv.telemetry.registry, indent=None)
    check(json.loads(exported)["serve_completed_total"][0]["value"] == BATCH
          and "# TYPE engine_dispatch_seconds summary" in prom,
          "server registry export")
    print(prom, end="")
    print(json.dumps({"registry_json": json.loads(exported)}))
    detail["registry_export"] = {"prometheus": prom,
                                 "json": json.loads(exported)}
    del esrv
    report_launches = {"deconv": dk.launches - launches_before[0],
                       "conv": ck.launches - launches_before[1]}
    detail["runtime_report_s"] = time.perf_counter() - t_phase
    print(json.dumps({"runtime_report_launches": report_launches,
                      "phase_s": detail["runtime_report_s"]}))
    torch.cuda.empty_cache()

    # -- 7. tune ----------------------------------------------------------------
    # tune.tune_network at batch 4 (the server's), measure_topk=3: V-Net's
    # graph in f32 (the FMA route) and under w:int8 (the TF32 route), DCGAN's
    # chain in f32.  Every candidate the tuner measured then launches once
    # more at full width through the wrappers, held against its plain
    # version (f32: TOL; f32 x int8: W8_TOL against float64); the checks
    # run after the timing, since a plain version run between a
    # candidate's warm call and its timed calls slowed them by up to 0.2
    # ms.  Then the cache is saved under build/, reloaded search-free, and
    # a V-Net batch served on the tuned plans is held against the untuned
    # server's.  The probes' launches are reported on their own
    phase("tune")
    t_phase = time.perf_counter()
    launches_before = (dk.launches, ck.launches)
    tune_checks: dict = {}
    wrapped_fwd = {"deconv": (dk, "deconv_fwd"), "conv": (ck, "conv_fwd")}
    real_fwd = {op: getattr(m, n) for op, (m, n) in wrapped_fwd.items()}

    def checked(op):
        real = real_fwd[op]

        def launch(a, b, **kw):
            y = real(a, b, **kw)
            key = (op, tuple(a.shape), str(a.dtype), tuple(b.shape),
                   str(b.dtype), kw["block_co"], kw["split"])
            if key not in tune_checks:
                torch.cuda.synchronize()
                w8_ = b.dtype == torch.int8
                ref = (run_plain64 if w8_ else run_plain)(op, (a, b, kw,
                                                               None))
                tol = W8_TOL if w8_ else TOL["float32"]
                err = float((y.double() - ref.double()).abs().max())
                mag = float(ref.double().abs().max())
                tune_checks[key] = {"rel_err": err / mag if mag else err,
                                    "tol": tol}
                del ref
            return y
        return launch

    model = tune.LatencyModel.calibrate(device=dev)
    w8 = quant.Precision(weight_quant="int8")
    sweeps = (("vnet", "f32", report_nets["vnet"], quant.Precision()),
              ("vnet", "w:int8", report_nets["vnet"], w8),
              ("dcgan", "f32", report_nets["dcgan"], quant.Precision()))
    cache = tune.TunedPlanCache()
    results = []
    for net_name, policy, network, prec in sweeps:
        _, res = tune.tune_network(network, batch=BATCH, measure_topk=3,
                                   repeats=TUNE_REPEATS, model=model,
                                   device=dev, precision=prec, cache=cache)
        results += [(net_name, policy, r) for r in res]
    tune_s = time.perf_counter() - t_phase
    # each winner that is not the heuristic, timed again in turns (winner,
    # heuristic, winner, heuristic): with the tuner's own, each such plan
    # has three times, and the run's spread is the largest (max - min) /
    # min of one plan's
    retimed = {}
    for net_name, policy, r in results:
        if r.improved:
            retimed[r.key] = [tune.measure_plan(
                p, r.geometry, repeats=TUNE_REPEATS, batch=BATCH, device=dev)
                for p in (r.plan, r.heuristic) * 2]
    for op, (m, n) in wrapped_fwd.items():
        setattr(m, n, checked(op))
    try:
        for net_name, policy, r in results:
            by_name = {p.describe(): p
                       for p in tune.candidate_plans(r.geometry)}
            for name_ in r.measured:
                tune.measure_plan(by_name[name_], r.geometry, repeats=1,
                                  batch=BATCH, device=dev)
    finally:
        for op, (m, n) in wrapped_fwd.items():
            setattr(m, n, real_fwd[op])
    times_of = [times for _, _, r in results if r.key in retimed
                for times in ((r.entry.measured_s, *retimed[r.key][0::2]),
                              (r.entry.heuristic_measured_s,
                               *retimed[r.key][1::2]))]
    spread = max([(max(ts) - min(ts)) / min(ts) for ts in times_of],
                 default=0.0)
    tune_rows = []
    for net_name, policy, r in results:
        e = r.entry
        row = {"network": net_name, "policy": policy, "key": r.key,
               "heuristic": r.heuristic.describe(),
               "heuristic_ms": e.heuristic_measured_s * 1e3,
               "winner": r.plan.describe(), "winner_ms": e.measured_s * 1e3,
               "source": e.winner_source, "measured": {
                   k: v * 1e3 for k, v in r.measured.items()}}
        check(e.measured_s <= e.heuristic_measured_s,
              f"{r.key}: winner {e.measured_s} above the heuristic's "
              f"{e.heuristic_measured_s}")
        if r.key in retimed:
            ts = retimed[r.key]
            row["retimed_ms"] = [t_ * 1e3 for t_ in ts]
            check(min(ts[0], ts[2]) <= min(ts[1], ts[3]) * (1 + spread),
                  f"{r.key}: retimed winner {ts[0::2]} vs heuristic "
                  f"{ts[1::2]} beyond the run's spread {spread:.3g}")
        tune_rows.append(row)
        print(json.dumps({"tuned": row}))
    for key, c in sorted(tune_checks.items(), key=str):
        check(c["rel_err"] <= c["tol"], f"tuned launch {key}: relative "
              f"error {c['rel_err']:.3g} above {c['tol']}")
    n_measured = sum(len(r.measured) for _, _, r in results)
    check(len(tune_checks) == n_measured, f"{len(tune_checks)} checked "
          f"launches of {n_measured} measured candidates")
    print(json.dumps({"tune_checks": len(tune_checks), "max_rel_err": {
        tol: max(c["rel_err"] for c in tune_checks.values()
                 if c["tol"] == tol) for tol in {c["tol"] for c in
                                                 tune_checks.values()}},
        "run_spread": spread}))
    changed = [r.key for _, _, r in results if r.improved]
    sums = {}
    for net_name, policy, r in results:
        row_ = sums.setdefault(f"{net_name}:{policy}", {
            "geometries": 0, "changed": 0, "heuristic_ms": 0.0,
            "tuned_ms": 0.0, "model_top1_is_winner": 0})
        row_["geometries"] += 1
        row_["changed"] += r.improved
        row_["heuristic_ms"] += r.entry.heuristic_measured_s * 1e3
        row_["tuned_ms"] += r.entry.measured_s * 1e3
        row_["model_top1_is_winner"] += r.plan == model.rank(
            tune.distinct_launches(tune.candidate_plans(r.geometry),
                                   r.geometry, batch=BATCH),
            r.geometry, batch=BATCH)[0]
    print(json.dumps({"tuned_geometries": len(results),
                      "changed_from_heuristic": len(changed),
                      "per_network": sums}))

    # persist, reload strictly, replan every network search-free
    cache.meta.update({"batch": BATCH, "card": smi})
    path = cache.save(ROOT / "build" / "chip_smoke_tuned_plans.json")
    loaded = tune.TunedPlanCache.load(path, strict=True)
    check(len(loaded) == len(results), f"reloaded {len(loaded)} entries")
    from repro_torch.launch.tune import verify_zero_search
    zero = {policy: verify_zero_search(
        loaded, {"vnet": report_nets["vnet"]} if policy == "w:int8"
        else report_nets, device=dev, precision=prec)
        for _, policy, _, prec in sweeps[:2]}
    print(json.dumps({"zero_search_reload": zero}))

    # one V-Net batch served on the tuned plans against the untuned server's
    tsrv = DcnnServer([vol_spec], max_batch=BATCH, engine=UniformEngine(
        EngineConfig(tuned_plans=loaded, strict_vmem=True, device=dev)))
    for x_ in vols:
        tsrv.submit(ServeRequest("vnet", x_))
    before = (dk.launches, ck.launches)
    got = tsrv.step()
    delta = (dk.launches - before[0], ck.launches - before[1])
    check(delta == (4, 10), f"tuned V-Net batch launched {delta}")
    srcs = tsrv.engine.plan_sources
    check(srcs["heuristic"] == 0 and srcs["tuned"] > 0,
          f"tuned server planned {srcs}")
    t_errs = []
    for r_, rid in zip(got, vnet_ids):
        check(r_.ok and r_.engine == "pallas",
              f"tuned batch: {r_.code} on {r_.engine!r}")
        ref = by_id[rid].output
        t_errs.append(float(np.abs(r_.output - ref).max()
                            / np.abs(ref).max()))
    check(max(t_errs) <= SERVE_TOL, f"tuned V-Net batch {max(t_errs):.3g} "
          f"from the untuned server's")
    del tsrv
    # V-Net's graph on the heuristic's plans and on the tuned ones, inputs
    # on the card, in turns (heuristic, tuned, tuned, heuristic; CUDA
    # events, median of 5 groups of 3 calls)
    graph_ms = {}
    vnet_ws = tree.tree_map(lambda t: t.to(dev), init_network_weights(
        report_nets["vnet"], torch.Generator().manual_seed(0)))
    vx = rand((BATCH, *VNET_SPATIAL, 1), torch.float32)
    for policy, prec in (("f32", quant.Precision()), ("w:int8", w8)):
        ws_ = quant.quantize_weights(vnet_ws, prec)
        fns = {plans: compile_network(report_nets["vnet"], UniformEngine(
            EngineConfig(precision=prec, device=dev, tuned_plans=(
                loaded if plans == "tuned" else None))), batch=BATCH)[0]
            for plans in ("heuristic", "tuned")}
        with torch.inference_mode():
            for plans in ("heuristic", "tuned", "tuned", "heuristic"):
                graph_ms.setdefault(policy, {}).setdefault(plans, []).append(
                    per_call_ms(lambda f=fns[plans]: f(ws_, vx), 3))
    print(json.dumps({"vnet_graph_ms": graph_ms, "batch": BATCH,
                      "card": smi}))
    del vnet_ws, vx
    tune_launches = {"deconv": dk.launches - launches_before[0],
                     "conv": ck.launches - launches_before[1]}
    detail["tune"] = {"rows": tune_rows, "checks": len(tune_checks),
                      "run_spread": spread, "changed": changed,
                      "served_rel_err": t_errs, "plan_sources": srcs,
                      "per_network": sums, "vnet_graph_ms": graph_ms,
                      "probe_launches": tune_launches, "tune_s": tune_s,
                      "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"tuned_serve_rel_err": t_errs, "plan_sources": srcs,
                      "tune_probe_launches": tune_launches,
                      "phase_s": detail["tune"]["phase_s"]}))
    torch.cuda.empty_cache()

    # -- 8. paper figures -------------------------------------------------
    # the paper's figures from the package modules they live in: Fig. 1
    # (insertion sparsity of all four benchmarks), Table II (both FPGA
    # engines, and the Hopper blocking of each network's layer 2), Fig. 6a
    # (the FPGA model per network), Fig. 6c (obs.measure_network of the
    # four full-width generator chains at batch 4 on the kernels and on
    # the xla lowering: every layer timed, no share of the calibrated f32
    # roof above 1.05) and Fig. 7 (the platform models, spec arithmetic,
    # and measured_cpu_speedup on the card at full width: oom, iom_phase
    # and the kernels on the JAX package's layers, within REF_TOL of oom's
    # output).  Not a main path: its launches are reported on their own
    phase("paper figures")
    from repro_torch.core import comparison, sparsity
    t_phase = time.perf_counter()
    launches_before = (dk.launches, ck.launches)
    fig = {"fig1": {net: [(l.name, sparsity.layer_sparsity(l))
                          for l in nets.benchmark_layers(net)]
                    for net in PAPER_NETWORKS}}
    means = {net: statistics.mean(s_ for _, s_ in rows)
             for net, rows in fig["fig1"].items()}
    print(sparsity.summarize())
    check(means["3d_gan"] > means["dcgan"], f"Fig. 1: 3D sparsity "
          f"{means['3d_gan']:.4f} not above 2D {means['dcgan']:.4f}")
    fig["table2"] = {
        name: {**dataclasses.asdict(e_), "total_pes": e_.total_pes,
               "adder_tree_adders": e_.adder_tree_adders}
        for name, e_ in (("2d", tiling.ENGINE_2D), ("3d", tiling.ENGINE_3D))}
    fig["gpu_blocking"] = {}
    for net in PAPER_NETWORKS:
        l2 = nets.benchmark_layers(net)[1]
        blk = tiling.gpu_blocking(l2.cin, l2.cout)
        fig["gpu_blocking"][net] = {"layer": l2.name,
                                    **dataclasses.asdict(blk)}
        check(blk.smem_bytes <= blk.smem_budget,
              f"{net}: blocking {blk} beyond the shared-memory budget")
    fig["fig6a"] = {net: tiling.network_summary(net)
                    for net in PAPER_NETWORKS}
    for key in ("fig1", "table2", "gpu_blocking", "fig6a"):
        print(json.dumps({key: fig[key]}))
    fig["fig6c"] = {}
    for net in PAPER_NETWORKS:
        chain = nets.benchmark_layers(net)
        for method in ("pallas", "xla"):
            rpt = obs.measure_network(
                chain, UniformEngine(method=method, device=dev), batch=BATCH,
                repeats=3, peak_gflops=peak, name=net)
            check([r.name for r in rpt.layers] == [l.name for l in chain],
                  f"Fig. 6c {net}/{method}: rows {rpt.layers}")
            for r in rpt.layers:
                print(json.dumps({"fig6c": net, "method": method,
                                  "node": r.name, "ms": r.measured_s * 1e3,
                                  "host_ms": r.host_s * 1e3,
                                  "gflops": r.achieved_gflops,
                                  "f32_roof_share": r.utilization}))
                check(r.measured_s > 0, f"Fig. 6c {net}/{method}/{r.name}: "
                      f"no time")
                check(r.utilization <= 1.05, f"Fig. 6c {net}/{method}/"
                      f"{r.name}: {r.utilization:.3f} of the f32 roof")
            print(json.dumps({"fig6c_network": net, "method": method,
                              "batch": BATCH, "net_ms": rpt.net_wall_s * 1e3,
                              "sum_layer_ms": rpt.sum_layer_s * 1e3,
                              "gflops": rpt.achieved_gflops,
                              "f32_roof_share": rpt.utilization}))
            fig["fig6c"][f"{net}/{method}"] = rpt.to_json()
    fig["fig7_modeled"] = {net: comparison.modeled_comparison(net)
                           for net in PAPER_NETWORKS}
    print(json.dumps({"fig7_modeled": fig["fig7_modeled"],
                      "source": "public-spec platform models, not "
                                "measurements"}))
    fig["fig7_measured"] = {}
    for net in ("dcgan", "3d_gan"):
        res = comparison.measured_cpu_speedup(nets.benchmark_layers(net)[1],
                                              repeats=10, device=dev)
        print(json.dumps({"fig7_measured": net, **res, "card": smi}))
        fig["fig7_measured"][net] = res
        for m_, rel in res["max_rel_diff"].items():
            check(rel <= REF_TOL, f"Fig. 7 {net}: {m_} vs oom relative "
                  f"difference {rel:.3g} above {REF_TOL}")
    fig["launches"] = {"deconv": dk.launches - launches_before[0],
                       "conv": ck.launches - launches_before[1]}
    fig["phase_s"] = time.perf_counter() - t_phase
    detail["paper_figures"] = fig
    print(json.dumps({"paper_figures_launches": fig["launches"],
                      "phase_s": fig["phase_s"]}))
    torch.cuda.empty_cache()

    # -- 9. examples -------------------------------------------------------
    # each example's main on the card with --method pallas: train_dcgan
    # --full --steps 2 (DCGAN at batch 64), segment_vnet3d --steps 2,
    # serve_dcnn without and with --inject-faults (one fallback, one
    # recovery), quickstart as it is; each must launch the hand kernels.
    # Their output goes to the --json file; not a main path
    phase("examples")
    import io

    from repro_torch.examples import (
        quickstart,
        segment_vnet3d,
        serve_dcnn,
        train_dcgan,
    )
    t_phase = time.perf_counter()
    detail["examples"] = {}
    with tempfile.TemporaryDirectory() as ckdir:
        runs = (("train_dcgan", train_dcgan.main,
                 ["--full", "--steps", "2", "--method", "pallas",
                  "--checkpoint-dir", ckdir]),
                ("segment_vnet3d", segment_vnet3d.main,
                 ["--steps", "2", "--method", "pallas"]),
                ("serve_dcnn", serve_dcnn.main, []),
                ("serve_dcnn --inject-faults", serve_dcnn.main,
                 ["--inject-faults"]),
                ("quickstart", quickstart.main, []))
        for tag, fn, argv in runs:
            zero_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = fn(argv)
            torch.cuda.synchronize()
            row = {"example": tag, "launches": counts(),
                   "run_s": time.perf_counter() - t0}
            out = buf.getvalue()
            print(json.dumps(row))
            print("  " + "\n  ".join(out.rstrip().splitlines()[-3:]))
            detail["examples"][tag] = dict(row, stdout=out)
            check(row["launches"]["deconv_fwd"] + row["launches"]["conv_fwd"]
                  > 0, f"{tag}: no hand-kernel launch")
            if tag == "train_dcgan":
                check(res.step == 2 and all(
                    math.isfinite(v) for r_ in res.metrics_log
                    for k_, v in r_.items() if k_.endswith("loss")),
                    f"{tag}: {res.step} steps, {res.metrics_log}")
                check(row["launches"]["deconv_dw"] > 0, f"{tag}: no dw")
            elif tag == "segment_vnet3d":
                check(len(res["losses"]) == 2 and all(
                    math.isfinite(v) for v in res["losses"]),
                    f"{tag}: losses {res['losses']}")
                check(row["launches"]["deconv_dw"] > 0, f"{tag}: no dw")
            elif tag.startswith("serve_dcnn"):
                faulted = tag.endswith("faults")
                got = (res["fallbacks"], res["recoveries"])
                check(out.rstrip().endswith("serve_dcnn OK")
                      and res["completed"] == 8
                      and got == ((1, 1) if faulted else (0, 0)),
                      f"{tag}: completed {res['completed']}, (fallbacks, "
                      f"recoveries) {got}")
            else:
                check(out.rstrip().endswith("quickstart OK"),
                      f"{tag}: {out[-200:]}")
    detail["examples_s"] = time.perf_counter() - t_phase
    print(json.dumps({"examples_s": detail["examples_s"]}))
    torch.cuda.empty_cache()

    run_launches = {
        "deconv_fwd": {"serve": launches["deconv"],
                       "train": train_launches["deconv_fwd"],
                       "serve_fallback": fb_launches["deconv"],
                       "paper_benchmarks": paper_launches["deconv_fwd"],
                       "sharded": sharded_launches["deconv_fwd"]},
        "conv_fwd": {"serve": launches["conv"],
                     "train": train_launches["conv_fwd"],
                     "serve_fallback": fb_launches["conv"],
                     "paper_benchmarks": paper_launches["conv_fwd"],
                     "sharded": sharded_launches["conv_fwd"]},
        "deconv_dw": {"train": train_launches["deconv_dw"],
                      "paper_benchmarks": paper_launches["deconv_dw"],
                      "sharded": sharded_launches["deconv_dw"]},
        "deconv_dx": {"train": train_launches["deconv_dx"],
                      "paper_benchmarks": paper_launches["deconv_dx"],
                      "sharded": sharded_launches["deconv_dx"]},
        "deconv_fwd_int8": {"serve_quantized": q_launches["deconv"]},
        "conv_fwd_int8": {"serve_quantized": q_launches["conv"]}}
    summary = {"kernels": [
        {"name": "deconv_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/deconv_fwd.cu",
         "replaces": "src/repro/kernels/deconv/kernel.py:180"},
        {"name": "conv_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/conv_fwd.cu",
         "replaces": "src/repro/kernels/conv/kernel.py:146"},
        {"name": "deconv_dw", "route": "cuda",
         "source": "src/repro_torch/csrc/deconv_dw.cu",
         "replaces": "src/repro/kernels/deconv/kernel.py:443"},
        {"name": "deconv_dx", "route": "cuda",
         "source": "src/repro_torch/csrc/conv_fwd.cu",
         "wrapper": "src/repro_torch/kernels/deconv/kernel.py::deconv_dx",
         "replaces": "src/repro/kernels/deconv/kernel.py:330"},
        {"name": "deconv_fwd_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/deconv_fwd.cu",
         "replaces": "src/repro/kernels/deconv/kernel.py:180",
         "operands": "int8 weights beside f32 or int8 activations",
         "library": "cuDNN on the dequantized f32 operands"},
        {"name": "conv_fwd_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/conv_fwd.cu",
         "replaces": "src/repro/kernels/conv/kernel.py:146",
         "operands": "int8 weights beside f32 or int8 activations",
         "library": "cuDNN on the dequantized f32 operands"},
    ]}
    # the block each route runs on
    ROUTE_BLOCKS = {
        "fma": "f32 FMAs on the CUDA cores (igemm_kernel)",
        "bf16": "bf16 tensor cores (igemm_bf16_kernel: mma.sync m16n8k16, "
                "A by ldmatrix.x4, B by ldmatrix.x4.trans, f32 sums; "
                "igemm_bf16_halo_kernel where tiling.plan_halo stages "
                "each box's input footprint once a chunk; "
                "igemm_bf16_wgmma_kernel, TMA boxes and wgmma, where "
                "tiling.plan_wgmma gives a deep stride-2 deconv the route)",
        "tf32": "TF32 tensor cores (igemm_tf32_kernel: mma.sync m16n8k8, "
                "int8 and bf16 operands exact, f32 activations split hi + "
                "lo in two passes)",
        "s8": "s8 tensor cores (igemm_s8_kernel: mma.sync m16n8k32, "
              "exact s32 sums, K-major weights)"}
    # every forward launch of the run on its pair's route: none of the
    # TF32 route's pairs on igemm_kernel, no bf16 x bf16 launch on
    # igemm_tf32_kernel, and each pair launched
    run_routes = fwd_launches()
    detail["launches_by_route"] = {"/".join(map(str, k_)): v_
                                   for k_, v_ in sorted(run_routes.items())}
    print(json.dumps({"launches_by_route": detail["launches_by_route"]}))
    check_routes("the run", run_routes)
    # the run's launches by how they staged A: every bf16 x bf16 launch
    # reported the staging the planner chose (the wrappers raise on any
    # other), and both stagings ran; the other routes always gather
    run_stagings = stagings()
    detail["launches_by_staging"] = {"/".join(k_): v_ for k_, v_ in
                                     sorted(run_stagings.items())}
    print(json.dumps({"launches_by_staging":
                      detail["launches_by_staging"]}))
    for how in ("gather", "halo", "wgmma"):
        check(run_stagings.get(("bfloat16", "bfloat16", "bf16", how), 0) > 0,
              f"no bf16 x bf16 launch staged by {how} in the run")
    check(all(k_[3] == "gather" for k_ in run_stagings if k_[2] != "bf16"),
          f"a launch off the bf16 route staged a halo: {run_stagings}")
    check(sum(run_stagings.values()) == sum(run_routes.values()),
          f"launches by staging {sum(run_stagings.values())} vs by route "
          f"{sum(run_routes.values())}")
    for pair in PAIR_ROUTE:
        check(run_routes.get(launch_key(*pair), 0) > 0,
              f"{pair}: no launch on {launch_key(*pair)[2:]} in the run")
    for entry in summary["kernels"]:
        k = entry["name"]
        tot = totals[k]
        n = sum(run_launches[k].values())
        check(tot["launches"] == n, f"{k}: timed call shapes cover "
              f"{tot['launches']} launches of the {n} counted")
        check({p: tot["ms_by_path"].get(p, 0.0) > 0
               for p in run_launches[k]}
              == {p: n_p > 0 for p, n_p in run_launches[k].items()},
              f"{k}: timed paths {tot['ms_by_path']} vs the counted "
              f"{run_launches[k]}")
        # each path's share of ``ms``: the sum over the earlier slices'
        # paths alone is the total without the later slices' paths
        # (serve_fallback, paper_benchmarks)
        entry.update(launches=n, launches_by_path=run_launches[k],
                     max_abs_err=max_abs[k], ms=tot["ms"],
                     ms_by_path=tot["ms_by_path"],
                     plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                     bound_by=("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                               else "bytes"),
                     library_ms=tot["library_ms"])
        if pair_totals[k]:
            # a bf16 pair's launches are those of the f32 (w:int8) shapes
            # it stands in for: not launched on the main path
            entry["by_pair"] = {}
            for pair, pt in sorted(pair_totals[k].items()):
                route = PAIR_ROUTE[tuple(pair.split("/"))]
                entry["by_pair"][pair] = {
                    "route": route, "block": ROUTE_BLOCKS[route],
                    "on_main_path": (k, pair) not in stand_in_pairs,
                    "launches": pt["launches"], "ms": pt["ms"],
                    "plain_ms": pt["plain_ms"], "bound_ms": pt["bound_ms"],
                    "bound_by": ("operations"
                                 if pt["ops_ms"] >= pt["bytes_ms"]
                                 else "bytes"),
                    "library_ms": pt["library_ms"]}
            check(sum(v["launches"] for v in entry["by_pair"].values()
                      if v["on_main_path"]) == n,
                  f"{k}: launches per pair {entry['by_pair']}")
    detail["summary"] = summary
    if cli.json is not None:
        cli.json.parent.mkdir(parents=True, exist_ok=True)
        cli.json.write_text(json.dumps(detail, indent=1))
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
