"""Smoke test of the PyTorch/CUDA port (``dsml_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py                         # every phase, then the result line
    python3 chip_smoke.py sass kernel kernel_stream  # only the named phases, no result line

Builds the port's CUDA kernels from ``dsml_tpu_torch/ops/csrc/`` with
``nvcc`` (one process per source, all at once), holds each against its
plain PyTorch version at the shapes its path gives it, then drives the
port's paths on GPT-2-small (124M, vocab 50257, bf16, weights from seed 0)
and checks that each went through its kernels (launch counters zeroed just
before the path and read just after):

- static serving: ``GPT2.generate``, batch 8, a 512-token prompt, 32 greedy
  tokens (the prefill's attention is the flash forward kernel);
- training: train steps at batch 8 × 1024, ``GPT2.loss(attn_impl="flash")``
  with dense logits, ``backward()`` and AdamW(3e-4, weight_decay=0.01) —
  the JAX bench's headline step — through the flash forward and the two
  tensor-core backward kernels (bf16); an f32 gradient check through the
  two FMA backward kernels (f32);
- continuous serving: ``ContinuousBatcher(paged_kv="int4")`` on 48
  requests through both paged-attention kernels;
- the serving fleet: ``build_fleet`` with 2 ``PrefillWorker``s and 2
  decode batchers of 8 slots behind the SLO router (int4 pages, the KV
  handoff in process and through the CRC32C codec, a registered prefix
  shared by the decode side), 20 requests under two SLO classes with
  obs on, then 4 at f32 with a prefill worker killed mid-prefill: the
  prefill chunks and the decode ticks through the paged kernels;
- decode workers over several devices (``serving/mesh_worker.py``):
  TinyLlama-1.1B served by ``build_fleet(n_decode=2, devices=["cuda:0"] *
  4)``, two tp = 2 ``MeshDecodeWorker``s of two rank processes each
  sharing the card (phase fleet_tp, after tp_serve): f32 tokens against
  one device, bf16 timed with every decode rank's kernel 5 and 6
  launches, a worker killed mid-drain, a ``DecodeFleet`` of tp = 2
  replicas with one killed, no rank process left after;
- elasticity and chaos (``runtime/controller.py``, ``parallel/world.py``):
  GPT-2-small bf16 trains on four rank slots (one worker process a slot,
  sharing the card) under ``ElasticController`` through three kills and a
  restore, its final parameters bit-identical to an uninterrupted run; a
  torn dp × fsdp state falls back to its checkpoint; a rank killed inside
  a step surfaces within seconds; a ``DecodeFleet`` replica is killed
  mid-drain (f32, int4 pages); the two-host migration smoke; the flash
  kernels 1–3 on every training leg, the paged kernels on the fleet;
- the wire (``dsml_tpu_torch.comm``, the reference's own architecture):
  the MNIST MLP (784-128-64-10) trained data-parallel over gRPC through 3
  device servers on the card (buffers uint8 tensors there, RunForward /
  RunBackward on it) and the coordinator (AllReduceRing(AVG) on the
  native runtime's host path), 300 steps at batch 64 through
  ``PipelineClient``; the RPCs' medians, the native runtime against its
  Python versions, a GPT-2-small shard migration under wire faults, a
  cross-host fleet handoff and the launchers as processes;
- quantized-weight serving: the first 24 of those requests with
  ``weight_quant="int4"``, every projection through the dequant-fused
  matmul kernel (qmm), and a 16-request int8 drain;
- compressed-remat training: the train step with ``remat="int8"``, each
  block's input stashed through the stochastic int8 quantizer kernel;
- context-parallel training: two spawned ranks (gloo, one process each; on
  one card they share it) train GPT-2-small over the cp = 2 flash ring
  through ``make_hybrid_train_step`` under ``DSML_RING_FUSED=dma``: every
  hop but the last is the fused ring-hop kernel (kernel 4), which stores
  the resident K/V into the neighbour's CUDA-IPC-mapped receive slot;
- data-parallel training: two spawned ranks train GPT-2-small at dp = 2
  through ``make_dp_train_step`` (global batch 8 × 1024, ring sync in
  4 MiB buckets over the CUDA IPC transport), the flash kernels 1–3 on
  every rank; before it, the all-reduce family on its own;
- compressed gradient communication: the same dp = 2 step under the q8
  sync (the stochastic int8 quantizer kernel on every float bucket, then
  an int8 gather over the IPC ring), q8_ring2 and q8_ring2 with error
  feedback, and the MNIST ``Trainer`` at dp = 2 full-precision and
  compressed; before it, the quantized all-reduces on their own;
- Llama, at the full width of TinyLlama-1.1B (22 × 2048, 32 query / 4 kv
  heads, vocab 32000, weights from seed 0): train steps at batch 2 × 2048
  in bf16 (the JAX bench's llama1b row: flash kernels 1–3 over K/V
  repeated to the query heads, the chunked loss through the untied
  lm_head, AdamW); ``ContinuousBatcher(paged_kv="int4")`` on 48 requests
  through the pipelined paged kernel, plain and with the speculative tick
  (prompt-lookup drafts, one W = 4 verify call a tick over the GQA pages),
  and at f32 through the single-buffer kernel; the dense int8-KV batcher
  under turbo, adaptive and plain ticks; and the ``train_gpt2``,
  ``serve_continuous`` and ``decode_speculative`` entry points with
  ``--family llama``;
- observability (``dsml_tpu_torch.obs``): the paged GPT-2-small drain with
  obs off and on (identical tokens; counters, spans, pool gauges, the
  memory ledger on ``torch.cuda.memory_stats``), a speculative drain, the
  hybrid train step with obs off and on in turns, dp = 2 under q8, three
  forensic runs in their own processes (a sentinel halt, a hang-watch
  expiry, an OOM), and the disabled hooks' cost against a tick and a step;
- checkpointing (``dsml_tpu_torch.checkpoint``): GPT-2-small bf16 train
  steps as ``train_gpt2`` takes them, an async save, a restore into a
  fresh model and optimizer, the continued run, ``ContinuousBatcher.
  from_checkpoint`` through both paged kernels, and a dp = 2 q8_ring +
  error-feedback ``Trainer`` resumed from its checkpoint;
- model parallelism (``parallel.tp``, ``parallel.pp``, ``parallel.fsdp``
  through ``make_hybrid_train_step`` on spawned rank meshes sharing the
  card): TinyLlama-1.1B at tp = 2 (kernels 1–3 over each rank's 16 local
  heads), GPT-2-small at pp = 2 under gpipe, 1f1b and the interleaved
  schedule (and one remat="int8" step through kernel 8), GPT-2-small at
  fsdp = 2 under ZeRO-3 and ZeRO-2 (full precision, int8 + error feedback)
  against the dp = 2 ring, TinyLlama-1.1B (4 of its 22 layers) at pp = 2 × tp = 2 on four
  ranks, and ``train_gpt2 --tp 2`` / ``--pp 2 --schedule 1f1b`` (started
  beside the Llama entry points);
- expert parallelism: Mixtral-8x7B's full widths (d 4096, 32/8 heads of
  128, 8 experts of d_ff 14336, top 2) at 2 of its 32 layers, weights from
  seed 0 drawn once in a process of their own: kernels 1–3 and 5–6 at head
  dim 128, bf16 train steps at 2 × 2048 through the expert layer, an f32
  gradient check, two spawned ranks at ep = 2 (the token payloads over
  ``all_to_all``), and ``ContinuousBatcher(paged_kv="int4")`` serving 16
  requests;
- tensor-parallel serving: TinyLlama-1.1B at full width and depth on two
  spawned ranks at tp = 2 (16 query and 2 kv heads, half the vocabulary
  and the KV shard a rank): ``GPT2.generate_spmd`` at 2 × 512 + 32 tokens
  (the prefill through kernel 1) and ``ContinuousBatcher(mesh=...,
  paged_kv="int4")`` on 8 requests (kernels 5 and 6 over the rank's pool),
  f32 tokens (unquantized pages) held to the single-device port's, bf16
  for the times;
- the vision family (BASELINE configs 3 and 4): ``cli.train_mnist
  --model cnn`` for one epoch on the repo's MNIST; ResNet-18 at full width
  in f32 through ``cli.train_cifar_resnet``'s config (batch 256, momentum,
  the ring, the reduce-on-plateau scheduler) at dp = 2 on two spawned
  ranks sharing the card, on the synthetic CIFAR-shaped set (no CIFAR-10
  binaries in the repo); one single-device ResNet-18 step timed. No
  kernel of the port lies on this path (cuDNN convolutions);
- long context (``ops.attention``'s XLA ring and Ulysses,
  ``ops.flash.ring_flash_attention``, ``attention_2d``, the ``sp`` axis):
  GPT-2-small at sp = 2 through ``ring``, ``ulysses``, ``ulysses_flash``
  and ``ring_flash`` on the cp slice's two ranks, TinyLlama-1.1B at full
  width and depth at cp = 2 × tp = 2 through ring2 (kernel 4), GPT-2-small
  at cp = 2 × dp = 2 and ``attention_2d(flash=True)`` on sp = 2 × tp = 2
  on the pp × tp program's four ranks, and kernels 1–3 at the ring_flash
  hops' and ulysses_flash's shapes.

Each phase prints one JSON line; a phase that fails ends the run with a
non-zero exit and no result line. The line before the last is the card's
name and power limit as ``nvidia-smi`` prints them; the last line is
``{"ok": true, "device": {...}}``.

Phases: device, build (always); sass (HMMA instructions in the SASS of the
tensor-core kernels: the backward's two and the bf16 instantiations of
kernels 1 and 4, none in their f32 instantiations; no register spills in
them at d = 64; HMMA in the paged kernels' tensor-core instantiations,
none in their register-regime ones, no spills in any; HMMA in qmm's bf16-x
instantiations, none in its f32-x ones, no spills in any); kernel, kernel_bwd,
kernel_paged (also at the split plan's edges, each case twice for
identical bits), paged_time (the paged kernels' times alone, which a parent
tree runs too), kernel_qmm (both regimes: rows 16, 256, 7, 1, 17, 300; a
kb = 40 weight; bf16 x the wrapper pads; the integer-exact case in f32 and
bf16 x; each case twice for identical bits), qmm_time (qmm's times alone,
which a parent tree runs too), kernel_quant8 (each kernel against its
plain version, then a kernel_time line with its device time, bound, plain
time and library yardstick; kernel 1 at the prefill and the train step's
shapes, bf16 and f32; kernel 8's bound from the operations its function
defines per element, its IEEE division read from its SASS); slice and
trace (the generate run, its launches, logits and greedy tokens against the
plain path, device-busy time); cli
(``generate_text``); train and its trace; train_cli (``train_gpt2`` and the
MNIST ``Trainer``); paged_slice; fleet (run alone, it runs paged_slice
first: every request complete, every pool back to all but the scratch
and registry pages, kernel 6 launched 12 times a chunk on the prefill
workers and a tick on the decode workers, kernel 5 the same in the f32
run, the prefix requests' handoffs with 256 shared rows and only their
suffix grid's pages, two of them through the codec byte for byte with
its MB/s, one request's trace chain, tokens/s, TTFT and e2e by class,
the decode gaps, handoff bytes against dense f32 rows,
``router.slo.report()``; f32 tokens against paged_slice's f32 drain under
the margin rule after a prefill-worker kill; kernels 5 and 6 at the 8-
and 4-slot decode shapes against their plain versions, with CUDA-event
times; the codec's CRC32C on the native ds_crc32c, with the Python-CRC
run's MB/s and decode-gap p99 beside); wire (the device line carries
grpc's, protobuf's and g++'s versions and the build line the native
library's seconds; 300 wire steps from a seed-0 MLP: steps/s, samples/s,
the first and last loss falling, the 2000-image holdout's accuracy; the
flat weights after 20 steps bit for bit those of the same steps driven
through the runtimes directly, and within TOL_WIRE_AUTOGRAD of one
device's plain MLP with autograd; the median ms of Memcpy H2D and D2H at
437,544 bytes, RunForward, RunBackward, AllReduceRing(AVG) at 3 ranks and
a 4 MiB BeginSend/StreamSend with its MB/s; ds_reduce_f32 and ds_crc32c
against their Python versions, equal; the native calls of the path;
GPT-2-small's seed-0 f32 weights migrated under drop@1, resumed and bit
for bit, and a leaf under corrupt@* raising MigrationError; a GPT-2-small
f32 fleet's greedy tokens through register_with_donor /
fetch_from_migrator equal to the in-process handoff's; launch_devices and
launch_coordinator as processes and one AllReduceRing over them); wq_slice
(qmm launches = 48 per chunk or
tick, tokens/s, TTFT, tick ms and idle share, the twin's bytes, f32 int4
greedy tokens against a dense model holding the same codes dequantized);
serve_cli (``serve_continuous``, also with ``DSML_WEIGHT_QUANT=int4``);
train_int8remat (12 quantizer launches per step, the step-0 loss equal to
remat=False's, f32 gradients within 0.1, peak memory of the three remat
modes); kernel_stream (kernel 4 against its plain version, its K/V copy
bit-exact, its (out, lse) bit-identical to kernel 1's; times beside a
two-call SDPA + copy yardstick); kernel_head_dim (head_dim 8, 32, 96
through flash_fwd/flash_bwd); cp_slice (per rank: off, dma and sendahead
losses bit-identical, 24 kernel-4 launches per forward, ring_pass values,
f32 ring gradients against single-device flash, bf16 steps tracking the
single-device step, identical replicas, step ms and peak memory;
then sp_impls: GPT-2-small at sp = 2 through each of ring, ulysses,
ulysses_flash and ring_flash from the same weights, the step-0 loss
against ring2's and one device's within TOL_CP_BF16_LOSS, 0 / 0 / 12 / 24
launches of kernels 1–3 a step, step ms and peak memory a rank);
kernel_long_context (kernels 1–3, bf16, with an lse cotangent, at the sp
= 2 ring_flash hops of GPT-2-small 8 × 1024 — the diagonal, the visible
and the fully masked one, whose out is zero, lse at the −1e20 floor and
gradients zero — and at ulysses_flash's [48, 1024, 64], each against its
plain version, then a kernel_time line with device ms, bounds, plain
times and SDPA under the global positions' mask);
cp_cli (``train_gpt2 --cp 2``); allreduce (ring, ring2 and naive through
the IPC ring bit-identical to a + b and xla through gloo within one ulp,
at 4 KiB, 4 MiB, 64 MiB and GPT-2-small's gradient in f32 and bf16, with times,
wire bytes, bounds and routes; int8 SUM, MIN, MAX, PROD); quant_allreduce
(q8, q8_ring, q8_ring2, q4_ring, q4_ring2 and a deterministic q8_ring
beside the ring, bf16 SUM at 4 MiB, 64 MiB and GPT-2-small's gradient:
times, wire bytes beside the ring's, kernel-8 launches per call, error
against the exact sum, both ranks bit-identical, the IPC route); dp_slice
(per rank: 12 launches of kernels 1-3 a step, ring / ring2 / naive losses
bit-identical, identical replicas, f32 dp gradients against single-device
flash, bf16 steps tracking the single-device steps, step and sync ms,
buckets, peak memory and IPC slot bytes, a traced step; then q8, q8_ring2
and q8_ring2 with error feedback from the same weights: kernel 8 once per
float bucket a q8 step, step and sync ms, wire bytes, losses within 0.06
of the ring's, identical replicas; the MNIST Trainer under ring and
q8_ring2 with error feedback); dp_cli (``train_gpt2 --dp 2``); llama_cli
(the three Llama entry points as processes, started beside the
two-rank programs and waited for before any Llama phase: each exit code
0 and its closing log line; TinyLlama's and the cut Mixtral's weights
are drawn in processes of their own beside the build); llama_kernel (kernels 1–3 at [64, 2048, 64]
bf16 causal and kernels 5–6 at the Llama decode, W = 4 verify and
256-row chunk shapes with int4 pages and rep 8, each against its plain
version, then kernel_time lines beside the bounds); llama_train (22
launches of kernels 1–3 a step, step ms, tokens/s, MFU, peak memory, a
first loss within 0.5 of ln 32000 that falls, a traced step); llama_serve
(the first 24 of the 48 requests: tokens/s, verify ticks, acceptance
and committed-token EWMAs, 22 launches a dispatch, every request complete and every page back, the
idle share of a plain and of a speculative tick; its first 8 requests
at f32, speculative tokens equal to plain ones wherever the top-2 margin
exceeds 1e-3); llama_ticks (identical tokens under turbo, adaptive and plain
ticks, tokens/s, tick counts, host syncs a decode tick; the adaptive
tick's EOS branch: tokens cut at the EOS, read-backs, dropped steps); obs
(the paged drain of the first 16 requests off then on: tokens identical, launches,
serving_tokens_total = tokens emitted, 16 admissions and retirements, the
pool gauges, the kv_pages source = the pool's bytes, serving_memory_pressure
= bytes_in_use / bytes_limit of torch.cuda.memory_stats, the decode_tick
Chrome trace saved under build/obs, median tick wall off and on; an
8-request speculative drain whose acceptance gauge = accept_ewma; the
hybrid step (8 x 1024, flash, dp_sync ring on one rank) off / on / on / off
from the same weights: equal losses, one watermark a step from
memory_stats equal to max_memory_allocated, one plan; dp = 2 under q8 at
4 MiB (in dp_slice's spawn): the buckets gauge = the plan, wire bytes =
steps x the plan's, one plan; a sentinel halt, a hang-watch expiry and an OOM bundle from child
processes; obs_disabled_overhead_pct of a tick and a step); checkpoint
(the snapshot stall, the commit ms, bytes written, GB/s and step ms
beside the card; the restored state bit for bit with the in-memory copy,
the continued run within the copy's run-to-run gap, the tokens served
from the checkpoint through both paged kernels equal to the in-memory
weights', the dp = 2 q8_ring + EF resume (in dp_slice's spawn)
bit-identical with each rank writing only its own residual rows); model_parallel (per tp rank: 22
launches of kernels 1–3 a step, the step-0 loss against the single-device
step's, f32 gradients of a 2-layer model at TinyLlama's width within
TOL_TRAIN_GRADS of the single-device plain path's, identical replicated
leaves, step ms, tp all-reduces a step and the 16 MiB all-reduce's ms,
peak memory, IPC slot bytes; per pp schedule: 24 launches a step a rank,
losses agreeing, step ms, peak memory, f32 gradients at 4 layers, kernel
8 launched 24 times in the int8-remat step; ZeRO-3 / ZeRO-2 / ZeRO-2
int8 + EF losses against the dp = 2 ring's and optimizer-state bytes near
half of dp's; pp × tp identical losses and replicas on four ranks; its
phase_seconds; the pp and fsdp eval losses against one device's in f32
and bf16, the fsdp mesh from ``plan_mesh``, and at pp = 2 × tp = 2 a
checkpoint after step 1 whose restore into fresh objects takes step 2 to
the same loss and leaf bytes, read back at pp = 4 and refused at tp = 2:
the mp_checkpoint line; and the long-context program on the pp × tp
ranks: TinyLlama at cp = 2 × tp = 2, 44 kernel-4 launches a step a rank,
its step-0 loss against the tp = 2 step's, 2-layer f32 gradients within
TOL_TRAIN_GRADS of one device's; GPT-2-small at cp = 2 × dp = 2 against
one device's loss; attention_2d(flash=True) blocks and gradients against
the f32 plain attention: the long_context_* lines); plan (the card's memory as ``plan_mesh`` reads
it, provenance memory_stats, and the plans of TinyLlama-1.1B, Llama-2-7B
and Mixtral-8x7B on 1, 2, 4 and 8 cards); activation_measurement
(``measured_activation_bytes`` of the TinyLlama step beside its peak less
its resident state, after llama_train); mp_cli (the two model-parallel
``train_gpt2`` runs, the pp = 2 one with an eval and a checkpoint at step
3 and a one-step resume from it; in the full run cp_cli, dp_cli and mp_cli
run as processes together, beside the Llama entry points);
moe_weights, moe_kernel and a kernel_time line per kernel family (at the
Mixtral shapes, beside the other kernel phases), moe_train (2 launches of
kernels 1–3 a step, step ms, tokens/s, active MFU, peak memory, the first
loss near ln 32000 + 0.02²·d/2 and falling, a traced step), moe_f32_grads
(the expert leaves' and wq's f32 gradients through the kernels against
the plain path), moe_ep (per rank: 4 all_to_all calls a MoE layer a step
and their bytes, the dispatch and return exchanges' ms alone, the step-0
loss against one device's, identical replicated leaves, f32 gradients of a
1-layer cut against one device, step ms, peak memory, IPC slot bytes) and
moe_serve (the pipelined kernel's launches, tokens/s, TTFT, median tick,
the idle share of a steady tick; 4 requests at f32 through the
single-buffer kernel against the gather path under the margin rule);
tp_serve (kernels 1, 5 and 6 at a tp = 2 rank's shapes against their plain
versions, with CUDA-event times; f32 ``generate_spmd`` and 4-request drain
(unquantized pages) tokens against the single-device port's under the margin rule, both ranks'
tokens and prefill logits identical, the rank's cache and pool holding 2
kv heads, 22 kernel-1 launches a generate, 22 kernel-5/6 launches a chunk
or tick, 45 all-reduces and one all-gather a decode step; bf16 prefill
ms, decode ms a step, tokens/s, the 8-request drain's tokens/s, TTFT and
median tick, a steady tick's wall and device-busy ms with its collectives,
their bytes and ms alone, peak memory and IPC slot bytes a rank);
fleet_tp (the tp = 2 fleet's legs: tokens against one device, margins,
every decode rank's launches and ticks, the ranks' own metrics by worker,
tokens/s, TTFT, decode gaps, the lockstep round trip beside tp_serve's
one batcher, the killed worker's requeues and processes, the DecodeFleet's
kill; a kernel_time line "D" of kernels 5 and 6 at a tp = 2 decode rank's
shape); kernel_time lines "E" (kernels 1–3 at a dp = 4 rank's [24, 1024,
64]) and "L" (kernel 7 at TinyLlama's projections);
vision (vision_cnn: the CNN's holdout accuracy > 0.85, steps/s, seconds;
vision_resnet_single: ResNet-18 f32 at batch 256, the median step ms of
10 after a warm-up, images/s, peak memory; vision_resnet_dp: per rank the
ring and naive Trainer runs' epoch losses, weights and plateau state
bit-identical (cuDNN deterministic for them), both replicas identical, the
loss falling over 3 epochs of 8 steps, the plateau's windows closed, the
first ring step's f32 gradients within TOL_TRAIN_GRADS of one device's
per-rank batch norm, a rank's step ms, images/s, peak memory, the sync's
ms and IPC slot bytes); kernels (one line for the run; kernel 8's entry counts its three paths,
kernels 5 and 6 their fleet path,
kernels 1–3, 5 and 6 their Llama, checkpoint, model-parallel and MoE
paths too; kernels 1, 5 and 6 their tp_serve path; kernels 5 and 6 the
tp fleet's ("D:", its decode ranks summed; ``path_timing`` holds the D:,
E: and L: times); kernels 1–3 the
resumed pp × tp step and the pp eval, ``mp_resume_eval``; kernels 1–3
the sp = 2 impls (``sp_impls``) and, with kernel 4, the long-context
program's ``cp_tp_llama``, ``cp_dp`` and ``attention_2d``).

Every phase line carries ``t_s``, its seconds since the script started.
In the full run two spawns of two ranks carry every two-rank program, one
after another in the same processes: cp_slice's, the two all-reduce
phases', dp_slice's, the checkpoint phase's dp = 2 resume, the vision
phase's dp = 2 ResNet-18 and the obs phase's dp = 2 q8 program in one; the model-parallel tp, pp, fsdp and
tp_serve programs in the other, beside the four-rank spawn of the pp × tp
and long-context programs. A phase run alone spawns its own ranks.

Float32 matmuls stay in full f32 (TF32 off, PyTorch's default, set here
explicitly): the f32 phases compare two paths at f32 tolerances.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import shlex
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# card peaks (NVIDIA H100 SXM data sheet, dense): bf16 tensor cores, f32
# outside the tensor cores, device-memory bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# profiler traces taken for one timing before it settles for less (the
# card's traces now and then lose or double events, more often on a busy host)
PROFILER_TRIES = 6

# kernel against its plain version on the same inputs. f32: both sum in f32
# in another order. bf16: both compute in f32 from the same bf16 inputs; out
# is rounded to bf16 on both sides (one bf16 ulp at |out| < 4 is <= 1/64)
TOL = {torch.float32: {"out": 1e-4, "lse": 1e-4}, torch.bfloat16: {"out": 2e-2, "lse": 1e-3}}
# prefill logits, kernel path against the plain-attention path. f32: the
# JAX suite's tolerance for the same comparison. bf16: the plain path rounds
# scores, probabilities and the attention output to bf16 in every layer,
# the kernel only its output; over 12 layers that is a few bf16 ulps of a
# logit of magnitude 2-4 (ulp 1/64). A wrong mask or a dropped tile moves
# the logits by O(1).
TOL_LOGITS = {torch.float32: 2e-4, torch.bfloat16: 1e-1}
MARGIN = 1e-3  # f32 greedy: below this top-2 margin a step compares logits, not tokens

B, H, D, S = 8, 12, 64, 512  # GPT-2-small's prefill attention shape in the slice
NEW_TOKENS = 32
F32_TOKENS = 8

# the backward kernels against their plain version, as a share of the
# largest |gradient| of the tensor compared. f32: both sum in f32 in
# another order. bf16: both compute in f32 from the same bf16 inputs and
# round the result to bf16 (one bf16 ulp is at most 2^-7 of the largest
# entry)
TOL_BWD = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TRAIN_B, TRAIN_S = 8, 1024  # the JAX bench's GPT-2-small train step
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# f32 gradients, flash kernels against plain attention, as a share of each
# tensor's largest |gradient|: f32 sums in another order through 12 layers
# (a dropped tile or a wrong mask moves them by O(1))
TOL_TRAIN_GRADS = 1e-4


_T0 = time.perf_counter()  # the run's start: every phase line carries its seconds since
# the environment of the processes that run beside others (the weights'
# draws, the entry points): one host thread each, or a dozen of them
# oversubscribe the host's cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


GPT2_SHAPE = ("vocab_size", "max_seq", "n_layer", "n_head", "d_model", "d_ff", "n_experts")
GPT2_WEIGHTS_ENV = "CHIP_SMOKE_GPT2_WEIGHTS"  # the file spawned ranks read them from


@functools.lru_cache(maxsize=1)
def gpt2_small_weights():
    """GPT-2-small's f32 weights from seed 0 (``GPT2.init``: the JAX init's
    numpy draws) on the host, once a process: read from the file
    :func:`share_gpt2_small_weights` wrote when the environment names one
    (spawned ranks inherit it), else drawn."""
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

    path = os.environ.get(GPT2_WEIGHTS_ENV)
    if path:
        return torch.load(path, mmap=True)
    return GPT2(GPT2Config.small(), device="cpu").init(0).state_dict()


def share_gpt2_small_weights() -> None:
    """Write :func:`gpt2_small_weights` to a file (deleted at exit) and name
    it in the environment, so that every spawned rank reads the weights
    instead of drawing them again."""
    import atexit
    import tempfile

    wdir = tempfile.mkdtemp(prefix="chip_smoke_gpt2_")
    atexit.register(shutil.rmtree, wdir, True)
    path = os.path.join(wdir, "gpt2_small_f32.pt")
    torch.save(gpt2_small_weights(), path)
    os.environ[GPT2_WEIGHTS_ENV] = path


def gpt2_small(cfg, dev):
    """``GPT2(cfg)`` on ``dev`` with seed 0's weights: a config of
    GPT-2-small's shapes loads :func:`gpt2_small_weights` (rounded to its
    dtype as ``init`` rounds them), any other draws its own."""
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

    model = GPT2(cfg, device=dev)
    small = GPT2Config.small()
    if any(getattr(cfg, key) != getattr(small, key) for key in GPT2_SHAPE):
        return model.init(0)
    model.load_state_dict(gpt2_small_weights())
    return model


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound_ms(bh, s_q, s_kv, d, dtype, causal, q_start=0, k_start=0):
    """Least time for one flash forward: the larger of its bytes (q, k, v
    read once, out and the f32 lse written once) over the memory rate and
    its operations (2·d multiply-adds per kept score in each of q·kᵀ and
    p·v, counting only the scores the mask keeps) over the peak rate of the
    inputs' type. Where the mask keeps no score (a fully masked ring hop)
    no input is needed: the bytes are the outputs'. Returns (ms, "bytes" |
    "operations")."""
    elt = torch.tensor([], dtype=dtype).element_size()
    rows = q_start + np.arange(s_q) - k_start + 1
    kept = np.clip(rows, 0, s_kv).sum() if causal else s_q * s_kv
    inputs = bh * (s_q * d + s_kv * d * 2) * elt if kept else 0
    nbytes = inputs + bh * s_q * d * elt + bh * s_q * 4
    flops = 4.0 * d * bh * float(kept)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def backward_bound_ms(bh, s_q, s_kv, d, dtype, causal, products, n_out, q_start=0, k_start=0):
    """Least time for one backward kernel: the larger of its bytes (q, k, v
    and do read once, the f32 lse and delta read once, ``n_out`` gradient
    tensors of the inputs' shape written once) over the memory rate and its
    operations (``products`` products of 2·d operations per kept score,
    the mask comparing global positions from ``q_start``/``k_start``)
    over the peak rate of the inputs' type. Where the mask keeps no score
    no input is needed: the bytes are the (zero) gradients'."""
    elt = torch.tensor([], dtype=dtype).element_size()
    rows = q_start + np.arange(s_q) - k_start + 1
    kept = np.clip(rows, 0, s_kv).sum() if causal else s_q * s_kv
    inputs = bh * (2 * s_q * d + 2 * s_kv * d) * elt + bh * s_q * 4 * 2 if kept else 0
    nbytes = inputs + n_out * bh * s_kv * d * elt
    flops = products * 2.0 * d * bh * float(kept)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


BWD_TC_SOURCE = "dsml_tpu_torch/ops/csrc/flash_bwd_tc.cu"
BWD_FMA_SOURCE = "dsml_tpu_torch/ops/csrc/flash_bwd.cu"
# the backward's kernels by route: bf16 on the tensor cores, f32 on FMAs
BWD_KERNELS = {torch.bfloat16: ("flash_bwd_dq_tc", "flash_bwd_dkv_tc"),
               torch.float32: ("flash_bwd_dq", "flash_bwd_dkv")}


def bwd_counts(tflash):
    return {name: getattr(tflash, f"{name}_launches") for names in BWD_KERNELS.values()
            for name in names}


def ptxas_report(log):
    """{function: {"registers", "stack", "spill_stores", "spill_loads"}}
    from an ``-Xptxas -v`` report."""
    out, fn = {}, None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            fn = m.group(1)
            out[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                    r"(\d+) bytes spill loads", line)):
            out[fn].update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m[1])
    return out


# the tensor-core kernels' SASS: {library: [(label, mangled-name prefix,
# HMMA expected)]}, each at d = 64 and 128. The forward's two kernels route
# bf16 to the tensor cores and f32 to FMAs (a tensor-core product rounds f32
# to TF32), so their f32 instantiations must hold no HMMA.
SASS_KERNELS = {
    "flash_bwd_tc": [("flash_bwd_dq_tc_kernel<{d}>", "flash_bwd_dq_tc_kernelILi{d}E", True),
                     ("flash_bwd_dkv_tc_kernel<{d}>", "flash_bwd_dkv_tc_kernelILi{d}E", True)],
    "flash_fwd": [("flash_fwd_kernel<bf16, {d}>", "flash_fwd_kernelI13__nv_bfloat16Li{d}E", True),
                  ("flash_fwd_kernel<float, {d}>", "flash_fwd_kernelIfLi{d}E", False)],
    "flash_stream": [("flash_stream_fwd_kernel<bf16, {d}>",
                      "flash_stream_fwd_kernelI13__nv_bfloat16Li{d}E", True),
                     ("flash_stream_fwd_kernel<float, {d}>", "flash_stream_fwd_kernelIfLi{d}E",
                      False)],
}


# The paged kernels' instantiations, by their mangled names: kernel, Q (f or
# bf16), P (the fp pool's type, written as a substitution when it is Q's
# class type; a = int8, h = uint8), head dim, codec, rows of a row tile
PAGED_MANGLED = re.compile(r"(paged_attn(?:_pipelined)?_kernel)I(f|13__nv_bfloat16)(f|a|h|S\d*_)"
                           r"Li(\d+)ELi(\d)ELi(\d+)E")


def sass_dumps(tool, build, libs) -> dict:
    """``cuobjdump -sass`` of each library in ``libs``, all at once (one
    process each): {lib: its SASS text}."""
    from concurrent.futures import ThreadPoolExecutor

    def dump(lib):
        return subprocess.run([tool, "-sass", str(build._target(lib))], capture_output=True,
                              text=True, check=False)

    with ThreadPoolExecutor(len(libs)) as pool:
        results = dict(zip(libs, pool.map(dump, libs)))
    for lib, res in results.items():
        check(res.returncode == 0, f"cuobjdump -sass {lib} failed ({res.returncode}): "
                                   f"{res.stderr[-2000:]}")
    return {lib: res.stdout for lib, res in results.items()}


def paged_sass(sass, report):
    """Both paged kernels in every instantiation: HMMA instructions in the
    tensor-core regime's (bf16 q, 64-row tiles), none in the register
    regime's, and no spills in any. ``sass`` is the library's SASS text.
    Returns ({label: {hmma, registers, spills}} of each, [the faults
    found])."""
    ptxas = ptxas_report(report)
    out, faults = {}, []
    for chunk in sass.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        m = PAGED_MANGLED.search(name)
        if not m:
            continue
        kern, q, _, hd, codec, rows = m.groups()
        label = (f"{kern}<{'bf16' if q != 'f' else 'f32'} q, {('fp', 'int8', 'int4')[int(codec)]}, "
                 f"hd {hd}, {rows} rows>")
        props = [v for fn, v in ptxas.items() if fn == name.split()[0]]
        check(len(props) == 1, f"{label}: no single -Xptxas -v entry")
        hmma = body.count("HMMA")
        out[label] = {"hmma": hmma, "registers": props[0].get("registers"),
                      "spill_stores": props[0].get("spill_stores"),
                      "spill_loads": props[0].get("spill_loads")}
        if (hmma > 0) != (rows == "64"):
            faults.append(f"{label}: {hmma} HMMA instructions, expected "
                          f"{'some' if rows == '64' else 'none'}")
        if props[0].get("spill_stores") or props[0].get("spill_loads"):
            faults.append(f"{label} spills registers: {props[0]}")
    # per kernel: f32 q in 1- and 4-row tiles, bf16 q in 1-, 4- and 64-row
    # tiles, for 3 codecs and 2 head dims
    if len(out) != 2 * 5 * 3 * 2:
        faults.append(f"{len(out)} paged instantiations in the SASS, expected 60: {sorted(out)}")
    return out, faults


# qmm's instantiations: x (f or bf16), int4, rows of a tile
QMM_MANGLED = re.compile(r"qmm_kernelI(f|13__nv_bfloat16)Lb([01])ELi(\d+)E")


def qmm_sass(sass, report):
    """qmm in every instantiation: HMMA instructions in the bf16-x ones (the
    decode and chunk regimes, both codecs), none in the f32-x FMA body's,
    and no spills in any. ``sass`` is the library's SASS text. Returns
    ({label: {hmma, registers, spills}}, [the faults found])."""
    ptxas = ptxas_report(report)
    out, faults = {}, []
    for chunk in sass.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        m = QMM_MANGLED.search(name)
        if not m:
            continue
        x, int4, rows = m.groups()
        bf16 = x != "f"
        label = f"qmm_kernel<{'bf16' if bf16 else 'f32'} x, {'int4' if int4 == '1' else 'int8'}, {rows} rows>"
        props = [v for fn, v in ptxas.items() if fn == name.split()[0]]
        check(len(props) == 1, f"{label}: no single -Xptxas -v entry")
        hmma = body.count("HMMA")
        out[label] = {"hmma": hmma, "registers": props[0].get("registers"),
                      "spill_stores": props[0].get("spill_stores"),
                      "spill_loads": props[0].get("spill_loads")}
        if (hmma > 0) != bf16:
            faults.append(f"{label}: {hmma} HMMA instructions, expected {'some' if bf16 else 'none'}")
        if props[0].get("spill_stores") or props[0].get("spill_loads"):
            faults.append(f"{label} spills registers: {props[0]}")
    # bf16 x: 2 codecs × the decode and chunk regimes; f32 x: 2 codecs
    if len(out) != 6:
        faults.append(f"{len(out)} qmm instantiations in the SASS, expected 6: {sorted(out)}")
    return out, faults


def phase_sass(build, reports):
    """The tensor-core kernels run on the tensor cores: ``cuobjdump -sass``
    of each built library shows HMMA instructions in the backward's two
    kernels and in the bf16 instantiations of the forward's two kernels
    (kernel 1, kernel 4) at d = 64 and 128, and none in the forward's f32
    instantiations; ``-Xptxas -v`` reports no spills in any tensor-core
    kernel at d = 64 (the train and prefill shapes; d = 128 is reported).
    The paged kernels (``paged_sass``): HMMA in the tensor-core regime's
    instantiations, none in the register regime's, no spills in any. qmm
    (``qmm_sass``): HMMA in the bf16-x instantiations, none in the f32-x
    ones, no spills in any."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                     "bin", "cuobjdump")
    check(os.path.exists(tool), "cuobjdump not found on PATH or under CUDA_HOME: the SASS check "
                                "of the tensor-core kernels needs it")
    row = {"phase": "sass", "sources": {lib: f"dsml_tpu_torch/ops/csrc/{lib}.cu" for lib in SASS_KERNELS},
           "hmma": {}, "ptxas": {}}
    sass = sass_dumps(tool, build, [*SASS_KERNELS, "paged_attn", "qmm"])
    for lib, kernels in SASS_KERNELS.items():
        hmma = {name.split()[0]: body.count("HMMA") for name, body in
                (chunk.split("\n", 1) for chunk in sass[lib].split("Function : ")[1:])}
        ptxas = ptxas_report(reports[lib])
        for label, prefix, tensor_cores in kernels:
            for d in (64, 128):
                key, pattern = label.format(d=d), prefix.format(d=d)
                found = [n for fn, n in hmma.items() if pattern in fn]
                check(len(found) == 1 and (found[0] > 0) == tensor_cores,
                      f"{key}: HMMA instructions in its SASS {found}, expected "
                      f"{'some' if tensor_cores else 'none'} (functions: {sorted(hmma)})")
                row["hmma"][key] = found[0]
                props = [v for fn, v in ptxas.items() if pattern in fn]
                check(len(props) == 1, f"{key}: no single -Xptxas -v entry: {sorted(ptxas)}")
                row["ptxas"][key] = props[0]
    row["sources"]["paged_attn"] = PAGED_SOURCE
    row["paged_attn"], paged_faults = paged_sass(sass["paged_attn"], reports["paged_attn"])
    row["sources"]["qmm"] = QMM_SOURCE
    row["qmm"], qmm_faults = qmm_sass(sass["qmm"], reports["qmm"])
    emit(row)
    check(not paged_faults + qmm_faults, "; ".join(paged_faults + qmm_faults))
    for kernels in SASS_KERNELS.values():
        for label, _, tensor_cores in kernels:
            props = row["ptxas"][label.format(d=64)]
            check(not tensor_cores or (props.get("spill_stores") == 0
                                       and props.get("spill_loads") == 0),
                  f"{label.format(d=64)} spills registers: {props}")


def phase_kernel_bwd(tflash, dev):
    """The backward against _flash_bwd_reference: bf16 through the
    tensor-core kernels, f32 through the FMA kernels (launch counts checked
    per case); then each pair's times at the train step's shape in its
    type."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bh_train = TRAIN_B * H

    def inputs(bh, s_q, s_kv, d, dtype, q_start, causal, glse):
        q, do = (torch.randn(bh, s_q, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, s_kv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        out, lse = tflash._flash_fwd_reference(q, k, v, causal, q_start, 0)
        g_lse = torch.randn(bh, s_q, generator=gen, device=dev) if glse else None
        return q, k, v, out, lse, do, g_lse

    cases = [  # (bh, s_q, s_kv, d, q_start, causal, with an lse cotangent)
        (bh_train, TRAIN_S, TRAIN_S, D, 0, True, False), (bh_train, TRAIN_S, TRAIN_S, D, 0, False, True),
        (bh_train, 700, 700, D, 0, True, True), (bh_train, 700, 700, D, 0, False, False),
        (bh_train, 256, 512, D, 256, True, True), (16, TRAIN_S, TRAIN_S, 128, 0, True, True),
    ]
    main_err = {}
    for dtype in (torch.bfloat16, torch.float32):
        kernels = BWD_KERNELS[dtype]
        for bh, s_q, s_kv, d, q_start, causal, glse in cases:
            args = inputs(bh, s_q, s_kv, d, dtype, q_start, causal, glse)
            before = bwd_counts(tflash)
            got = tflash.flash_bwd(*args, causal, q_start, 0)
            torch.cuda.synchronize()
            launched = {k: n - before[k] for k, n in bwd_counts(tflash).items()}
            want = tflash._flash_bwd_reference(*args, causal, q_start, 0)
            errs, rel = {}, 0.0
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs().max().item()
                errs[name] = err
                rel = max(rel, err / max(w.float().abs().max().item(), 1e-30))
            ok = (all(g.shape == a.shape and g.dtype == dtype for g, a in zip(got, args[:3]))
                  and all(bool(torch.isfinite(g).all()) for g in got) and rel <= TOL_BWD[dtype])
            emit({"phase": "kernel_bwd", "kernels": list(kernels), "launched": launched,
                  "dtype": str(dtype)[6:], "bh": bh, "s_q": s_q, "s_kv": s_kv, "d": d,
                  "q_start": q_start, "causal": causal, "g_lse": glse, "max_abs_err": errs,
                  "max_err_over_max_abs": rel, "tol": TOL_BWD[dtype], "ok": ok})
            check(launched == {k: int(k in kernels) for k in launched},
                  f"flash_bwd ({dtype}) launched {launched}, expected one launch of each of {kernels}")
            check(ok, f"flash_bwd disagrees with its plain version ({dtype}, s_q={s_q}, "
                      f"s_kv={s_kv}, d={d}, q_start={q_start}, causal={causal}, g_lse={glse})")
            if (s_q, d, causal) == (TRAIN_S, D, True):
                main_err[dtype] = errs

    # times at the train step's shape, [96, 1024, 64] causal, no lse
    # cotangent: the tensor-core kernels in bf16, the FMA kernels in f32;
    # profiler device time, as the forward's
    timing, wrapper = {}, {}
    for dtype, names in BWD_KERNELS.items():
        q, k, v, out, lse, do, _ = inputs(bh_train, TRAIN_S, TRAIN_S, D, dtype, 0, True, False)
        call = functools.partial(tflash.flash_bwd, q, k, v, out, lse, do)
        ms = {name: device_ms(call, reps=10, pattern=f"{name}_kernel<") for name in names}
        wrapper[str(dtype)[6:]] = {"device_ms": device_ms(call, reps=10), "call_ms": cuda_ms(call)}
        plain_ms = device_ms(functools.partial(tflash._flash_bwd_reference, q, k, v, out, lse, do),
                             reps=10)
        q4, k4, v4, do4 = (t.view(TRAIN_B, H, TRAIN_S, D).detach().requires_grad_() for t in (q, k, v, do))

        def sdpa(backward):
            o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            if backward:
                torch.autograd.grad(o, (q4, k4, v4), do4)

        library_ms = (device_ms(functools.partial(sdpa, True), reps=10)
                      - device_ms(functools.partial(sdpa, False), reps=10))
        for name, products, n_out in zip(names, (3, 4), (1, 2)):
            bound_ms, bound_by = backward_bound_ms(bh_train, TRAIN_S, TRAIN_S, D, dtype, True,
                                                   products, n_out)
            timing[name] = {"ms": ms[name], "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "library_ms": library_ms}
        del q, k, v, out, lse, do, q4, k4, v4, do4
    emit({"phase": "kernel_time", "kernels": [n for names in BWD_KERNELS.values() for n in names],
          "shape": [bh_train, TRAIN_S, D], "causal": True,
          "dtype": {n: str(dt)[6:] for dt, names in BWD_KERNELS.items() for n in names},
          "flash_bwd": wrapper, "plain_note": "profiler device times; plain_ms and library_ms "
          "are whole backwards (dq, dk and dv) in the kernels' type; library_ms is SDPA "
          "forward+backward minus forward; flash_bwd is the wrapper, delta included (device_ms), "
          "and CUDA events around one call (call_ms)", **timing})
    return main_err, timing


def phase_kernel(tflash, dev):
    """Kernel 1 against _flash_fwd_reference: bf16 (the tensor-core body)
    and f32 (the FMA body), causal and not, ragged 700, offsets, d = 64
    and 128, the prefill and the train step's shapes; then its times at
    those two shapes in both types, beside SDPA and the bound."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(bh, s_q, s_kv, d, dtype):
        return [torch.randn(bh, s, d, generator=gen, device=dev).to(dtype)
                for s in (s_q, s_kv, s_kv)]

    cases = [(S, S, 0, True), (S, S, 0, False), (700, 700, 0, True), (700, 700, 0, False),
             (256, 512, 256, True), (TRAIN_S, TRAIN_S, 0, True)]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for s_q, s_kv, q_start, causal in cases:
            for d, bh in ((D, B * H), (128, 16)) if (s_q, causal) == (S, True) else ((D, B * H),):
                q, k, v = qkv(bh, s_q, s_kv, d, dtype)
                out, lse = tflash.flash_fwd(q, k, v, causal, q_start, 0)
                torch.cuda.synchronize()
                ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, causal, q_start, 0)
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_lse = (lse - ref_lse).abs().max().item()
                tol = TOL[dtype]
                ok = (out.shape == q.shape and out.dtype == dtype and lse.shape == (bh, s_q)
                      and bool(torch.isfinite(out).all()) and err_out <= tol["out"]
                      and err_lse <= tol["lse"])
                emit({"phase": "kernel", "kernel": "flash_fwd", "dtype": str(dtype)[6:],
                      "bh": bh, "s_q": s_q, "s_kv": s_kv, "d": d, "q_start": q_start,
                      "causal": causal, "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                      "tol_out": tol["out"], "tol_lse": tol["lse"], "ok": ok})
                check(ok, f"flash_fwd disagrees with its plain version ({dtype}, s_q={s_q}, "
                          f"s_kv={s_kv}, d={d}, q_start={q_start}, causal={causal})")
                if (dtype, s_q, d, causal) == (torch.bfloat16, S, D, True):
                    main_err = err_out

    # times at the prefill's shape [b·h, 512, 64] and the train step's
    # [b·h, 1024, 64], causal: bf16 (the tensor-core body) and f32 (the FMA body)
    timings = {}
    for s_len in (S, TRAIN_S):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(B * H, s_len, s_len, D, dtype)
            q4, k4, v4 = (t.view(B, H, s_len, D) for t in (q, k, v))
            kernel = functools.partial(tflash.flash_fwd, q, k, v, True)
            plain = functools.partial(tflash._flash_fwd_reference, q, k, v, True)
            library = functools.partial(F.scaled_dot_product_attention, q4, k4, v4, is_causal=True)
            bound_ms, bound_by = attention_bound_ms(B * H, s_len, s_len, D, dtype, True)
            timings[s_len, dtype] = {
                "ms": device_ms(kernel, pattern="flash_fwd_kernel<"),
                "plain_ms": device_ms(plain), "library_ms": device_ms(library),
                "bound_ms": bound_ms, "bound_by": bound_by}
            emit({"phase": "kernel_time", "kernel": "flash_fwd", "shape": [B * H, s_len, D],
                  "dtype": str(dtype)[6:], "causal": True, **timings[s_len, dtype],
                  "call_ms": {"flash_fwd": cuda_ms(kernel), "plain": cuda_ms(plain),
                              "library": cuda_ms(library)},
                  "note": "ms, plain_ms and library_ms are profiler device time per call; call_ms "
                  "are CUDA events around one call, host time between launches included"})
            del q, k, v, q4, k4, v4
    return main_err, timings[S, torch.bfloat16]


def greedy_trace(model, prompt, n, forced=None):
    """Greedy tokens [b, n] and f32 logits [b, n, vocab] from prefill and
    decode steps; the steps after the first are fed ``forced``'s tokens when
    given (teacher forcing), else the run's own."""
    logits, cache = model.prefill(prompt)
    toks, logs = [], []
    for i in range(n):
        logs.append(logits.float())
        toks.append(logits.argmax(-1))
        if i + 1 < n:
            feed = toks[-1] if forced is None else forced[:, i]
            logits, cache = model.decode_step(cache, feed, prompt.shape[1] + i)
    return torch.stack(toks, 1), torch.stack(logs, 1)


def phase_slice(tflash, dev, card):
    from dsml_tpu_torch.models.gpt2 import GPT2Config

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    model = gpt2_small(cfg, dev)
    prompt_np = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    prompt = torch.as_tensor(prompt_np, device=dev)
    model.generate(prompt, 2)  # warm-up: cuBLAS handles, the kernel's library
    torch.cuda.synchronize()

    # the main path, counted
    tflash.flash_fwd_launches = 0
    t0 = time.perf_counter()
    out = model.generate(prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_ms = (time.perf_counter() - t0) * 1e3
    launches = tflash.flash_fwd_launches
    check(launches == cfg.n_layer,
          f"flash_fwd launched {launches} times in one generate, expected n_layer={cfg.n_layer}")
    check(out.shape == (B, NEW_TOKENS) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          f"generate returned {tuple(out.shape)} tokens in [{int(out.min())}, {int(out.max())}]")

    prefill_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits_flash, _ = model.prefill(prompt)
        torch.cuda.synchronize()
        prefill_times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(prefill_times)
    decode_ms = (generate_ms - prefill_ms) / (NEW_TOKENS - 1)

    # bf16 prefill logits: kernel path against the plain-attention path,
    # and both against the f32 model from the same seed
    model._prefill_use_flash = lambda t: False
    logits_plain, _ = model.prefill(prompt)
    del model._prefill_use_flash
    err_bf16 = (logits_flash.float() - logits_plain.float()).abs().max().item()
    finite = bool(torch.isfinite(logits_flash).all())
    check(finite and logits_flash.shape == (B, cfg.vocab_size), "bf16 prefill logits")

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = gpt2_small(cfg32, dev)
    logits32_flash, _ = model32.prefill(prompt)
    model32._prefill_use_flash = lambda t: False
    toks_plain, logs_plain = greedy_trace(model32, prompt, F32_TOKENS)
    logits32_plain = logs_plain[:, 0]
    del model32._prefill_use_flash
    toks_kernel, logs_kernel = greedy_trace(model32, prompt, F32_TOKENS, forced=toks_plain)
    err_f32 = (logits32_flash - logits32_plain).abs().max().item()
    err_vs_f32 = {"flash_bf16": (logits_flash.float() - logits32_plain).abs().max().item(),
                  "plain_bf16": (logits_plain.float() - logits32_plain).abs().max().item()}

    near_ties, mismatches = [], 0
    top2 = logs_plain.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # [b, n]
    for row, step in zip(*torch.nonzero(toks_kernel != toks_plain, as_tuple=True)):
        row, step = int(row), int(step)
        m = margin[row, step].item()
        if m < MARGIN:
            gap = (logs_kernel[row, step] - logs_plain[row, step]).abs().max().item()
            near_ties.append({"row": row, "step": step, "margin": m, "max_abs_err_logits": gap})
            mismatches += gap > TOL_LOGITS[torch.float32]
        else:
            mismatches += 1
    emit({"phase": "slice", "model": "gpt2-small", "params": sum(p.numel() for p in model.parameters()),
          "dtype": "bfloat16", "batch": B, "prompt": S, "new_tokens": NEW_TOKENS,
          "flash_fwd_launches": launches, "n_layer": cfg.n_layer,
          "prefill_ms": prefill_ms, "generate_ms": generate_ms,
          "decode_ms_per_token": decode_ms, "decode_tokens_per_s": B * 1e3 / decode_ms,
          "prefill_logits_max_abs_err_bf16": err_bf16, "tol_bf16": TOL_LOGITS[torch.bfloat16],
          "prefill_logits_max_abs_err_vs_f32_plain": err_vs_f32,
          "prefill_logits_max_abs_err_f32": err_f32, "tol_f32": TOL_LOGITS[torch.float32],
          "f32_greedy_tokens_equal": bool(torch.equal(toks_kernel, toks_plain)),
          "f32_near_ties": near_ties, "card": card})
    check(err_bf16 <= TOL_LOGITS[torch.bfloat16],
          f"bf16 prefill logits: kernel vs plain max abs err {err_bf16}")
    check(err_f32 <= TOL_LOGITS[torch.float32],
          f"f32 prefill logits: kernel vs plain max abs err {err_f32}")
    check(mismatches == 0, f"f32 greedy tokens: {mismatches} steps differ beyond the margin rule")
    return launches, model, prompt


def device_events(fn) -> list[tuple[str, float]]:
    """(name cut to 80 characters, device ms) of each kernel, memset and
    copy ``fn`` launches, from a ``torch.profiler`` trace; empty where the
    trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a record_function range on the device (Optimizer.step#AdamW.step) spans
    # kernels already counted: user annotations are not device work; an
    # event the trace holds twice (same name, start and end) counts once
    seen, out = set(), []
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        key = (e.name, e.time_range.start, e.time_range.end)
        if key not in seen:
            seen.add(key)
            out.append((e.name[:80], e.time_range.elapsed_us() / 1e3))
    return out


def device_kernel_ms(fn) -> dict[str, float]:
    """{kernel name: device ms} of the kernels ``fn`` launches, summed from
    a ``torch.profiler`` trace; empty where the trace holds no device
    events. Names are cut to 80 characters, which sums the instances of one
    template (PyTorch's elementwise kernels) under one name."""
    by_name: dict[str, float] = {}
    for name, ms in device_events(fn):
        by_name[name] = by_name.get(name, 0.0) + ms
    return by_name


def device_busy_ms(fn):
    """(device ms, {kernel name: ms} of the 6 costliest) of the kernels
    ``fn`` launches (kernels of one stream do not overlap); (None, {})
    where the trace holds no device events."""
    by_name = device_kernel_ms(fn)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])
    return (sum(by_name.values()) if by_name else None), top


def device_ms(fn, reps: int = 20, pattern: str | None = None) -> float:
    """Device ms per call of ``fn`` from a profiler trace of ``reps`` calls
    after one warm-up: every kernel, memset and copy the calls launch, or
    only the launches of the one kernel whose name holds ``pattern``
    (:func:`device_ms_by`). Unlike ``cuda_ms`` it leaves out the host's
    time between launches, which exceeds the device time of a ~0.02 ms
    kernel behind a Python wrapper. The card's traces sometimes miss
    events (none at all, or part of a run of calls): a trace counts only
    when it holds a whole multiple of ``reps`` events, and is taken again
    otherwise, up to ``PROFILER_TRIES`` times; then the calls are timed by
    CUDA events (:func:`events_ms_per_call`, host gaps included)."""
    if pattern is not None:
        return device_ms_by(fn, (pattern,), reps)[pattern]
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        events = device_events(lambda: [fn() for _ in range(reps)])
        if events and len(events) % reps == 0:
            return sum(ms for _, ms in events) / reps
    return events_ms_per_call(fn, reps, None, f"{len(events)} events, not a multiple of {reps}")


def device_ms_by(fn, patterns, reps: int = 10) -> dict:
    """{pattern: device ms per call} of the kernels named by ``patterns``
    (each launched once a call) from one profiler trace of ``reps`` calls
    of ``fn`` (after a warm-up): a trace counts when it holds ``reps``
    launches of one kernel for each pattern, and is taken again otherwise,
    up to ``PROFILER_TRIES`` times. Then the last trace that held at least
    half the launches of each pattern, under one name, gives the mean of
    the launches it holds (a lost event takes no time from the others);
    failing that, the calls are timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    partial, counts = None, {}
    for _ in range(PROFILER_TRIES):
        events = device_events(lambda: [fn() for _ in range(reps)])
        found = {p: [(name, ms) for name, ms in events if p in name] for p in patterns}
        counts = {p: len(v) for p, v in found.items()}
        one_name = all(len({name for name, _ in v}) == 1 for v in found.values())
        if one_name and all(len(v) == reps for v in found.values()):
            return {p: sum(ms for _, ms in v) / reps for p, v in found.items()}
        if one_name and all(reps // 2 <= len(v) <= reps for v in found.values()):
            partial = ({p: sum(ms for _, ms in v) / len(v) for p, v in found.items()}, counts)
    if partial is not None:
        emit({"phase": "profiler_partial_trace", "patterns": list(patterns), "reps": reps,
              "launches_traced": partial[1], "tries": PROFILER_TRIES,
              "note": "ms is the mean of the launches the trace held"})
        return partial[0]
    return {p: events_ms_per_call(fn, reps, p, f"launches traced {counts}") for p in patterns}


def events_ms_per_call(fn, reps, pattern, why) -> float:
    """Ms per call of ``fn`` by CUDA events around ``reps`` calls in a row
    (after a warm-up): the fallback where ``PROFILER_TRIES`` profiler
    traces held no usable set of events. It counts the host's gaps
    between launches and everything a call launches, so it is at least the
    kernel's device time; the line it emits says which number it is."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    emit({"phase": "profiler_fallback", "pattern": pattern, "reps": reps, "tries": PROFILER_TRIES,
          "why": why, "ms_per_call_by_events": ms,
          "note": "CUDA events around the calls: host gaps and every launch of a call included"})
    return ms


def phase_trace(model, prompt):
    """Where a prefill and a decode step spend their time: device-busy ms
    from a profiler trace against the wall ms of the same call untraced."""
    logits, cache = model.prefill(prompt)
    tok = logits.argmax(-1)
    calls = {"prefill": lambda: model.prefill(prompt),
             "decode_step": lambda: model.decode_step(cache, tok, S)}
    row = {"phase": "trace"}
    for name, fn in calls.items():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = statistics.median(walls)
        busy, top = device_busy_ms(fn)
        row[name] = {"wall_ms": wall, "device_busy_ms": busy,
                     "device_idle_share": None if busy is None else 1 - busy / wall,
                     "top_kernels_ms": top}
    emit(row)


def train_counts(tflash):
    return {"flash_fwd": tflash.flash_fwd_launches, **bwd_counts(tflash)}


def reset_counts(tflash):
    for name in train_counts(tflash):
        setattr(tflash, f"{name}_launches", 0)


def bf16_step_counts_ok(counts, n_fwd, n_bwd):
    """A bf16 run: the forward n_fwd times, the tensor-core backward n_bwd
    times of each kernel, the f32 FMA backward never."""
    return counts == {"flash_fwd": n_fwd, "flash_bwd_dq_tc": n_bwd, "flash_bwd_dkv_tc": n_bwd,
                      "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def phase_train(tflash, dev, card):
    """The train step on GPT-2-small bf16 at batch 8 × 1024 (flash
    attention, dense logits, AdamW(3e-4, weight_decay=0.01)) on one batch
    repeated: launch counts, step time, tokens/s, MFU and a falling loss;
    then f32 gradients of the kernel path against the plain-attention
    path at batch 2."""
    from dsml_tpu_torch.models.common import transformer_train_flops
    from dsml_tpu_torch.models.gpt2 import GPT2Config

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    model = gpt2_small(cfg, dev)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, y, attn_impl="flash")
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path, counted
    reset_counts(tflash)
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = train_counts(tflash)
    losses = torch.stack(losses).float().tolist()
    flops = transformer_train_flops(cfg, TRAIN_B * TRAIN_S, TRAIN_S)
    row = {"phase": "train", "model": "gpt2-small", "params": model.n_params(), "dtype": "bfloat16",
           "batch": TRAIN_B, "seq": TRAIN_S, "attn_impl": "flash", "xent_chunk": 0,
           "optimizer": "AdamW(3e-4, weight_decay=0.01)", "steps": TRAIN_STEPS,
           "launches": counts, "step_ms": step_ms,
           "tokens_per_s": TRAIN_B * TRAIN_S * 1e3 / step_ms, "model_flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": losses, "card": card}
    want = cfg.n_layer * TRAIN_STEPS
    check(bf16_step_counts_ok(counts, want, want),
          f"train steps launched {counts}, expected {want} of the forward and of each "
          f"tensor-core backward kernel ({cfg.n_layer} per step) and no FMA backward")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"train loss not finite and falling on a repeated batch: {losses}")

    # f32, batch 2: gradients through the kernels against plain attention
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = gpt2_small(cfg32, dev)
    grads = {}
    for impl in ("flash", "xla"):
        model32.zero_grad(set_to_none=True)
        reset_counts(tflash)
        model32.loss(x[:2], y[:2], attn_impl=impl).backward()
        grads[impl] = {n: p.grad.detach().clone() for n, p in model32.named_parameters()}
        if impl == "flash":
            f32_counts = train_counts(tflash)
    n = cfg.n_layer
    check(f32_counts == {"flash_fwd": n, "flash_bwd_dq_tc": 0, "flash_bwd_dkv_tc": 0,
                         "flash_bwd_dq": n, "flash_bwd_dkv": n},
          f"the f32 flash backward launched {f32_counts}, expected {n} of each FMA kernel")
    worst, worst_name = 0.0, None
    for name, g in grads["xla"].items():
        rel = (grads["flash"][name] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        if rel >= worst:
            worst, worst_name = rel, name
    row.update({"f32_grads_max_err_over_max_abs": worst, "f32_grads_worst_tensor": worst_name,
                "tol_f32_grads": TOL_TRAIN_GRADS, "f32_launches": f32_counts})
    emit(row)
    check(worst <= TOL_TRAIN_GRADS,
          f"f32 gradients: flash kernels vs plain attention {worst} of max |g| in {worst_name}")
    del model32, grads
    return counts, f32_counts, step


def phase_train_trace(step, label="train_step"):
    """Where a train step spends its time: device-busy ms from a profiler
    trace against the wall ms of untraced steps."""
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    by_name = device_kernel_ms(step)
    busy = sum(by_name.values()) if by_name else None
    by_kind = {"flash": 0.0, "quantize_int8": 0.0, "gemm": 0.0, "elementwise_reduce": 0.0,
               "other": 0.0}
    for name, t in by_name.items():
        kind = ("flash" if "flash_" in name else "quantize_int8" if "quantize_int8" in name else
                "gemm" if any(w in name for w in ("gemm", "nvjet", "cutlass")) else
                "elementwise_reduce" if any(w in name for w in ("elementwise", "reduce", "vectorized"))
                else "other")
        by_kind[kind] += t
    emit({"phase": "trace", label: {
        "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall, "by_kind_ms": by_kind,
        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])}})


def phase_train_cli(tflash):
    """The training entry points: cli.train_gpt2 on GPT-2-small bf16 with
    the flash kernels, and the MNIST Trainer for one epoch."""
    from dsml_tpu_torch.cli import train_gpt2
    from dsml_tpu_torch.models import MLP
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils.data import load_mnist

    reset_counts(tflash)
    out = train_gpt2.main(["--model", "small", "--attn", "flash", "--dtype", "bfloat16",
                           "--steps", "4", "--batch_size", "8", "--grad_accum", "1",
                           "--log_every", "1", "--warmup_steps", "1"])
    counts = train_counts(tflash)
    ok_cli = bf16_step_counts_ok(counts, 4 * 12, 4 * 12) and np.isfinite(out["last_loss"])
    data = load_mnist(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mnist"))
    t0 = time.perf_counter()
    _, history, test_acc = Trainer(MLP(device="cuda"), TrainConfig(epochs=1)).train(data)
    mnist_s = time.perf_counter() - t0
    emit({"phase": "train_cli", "entry": "python -m dsml_tpu_torch.cli.train_gpt2", **out,
          "launches": counts, "mnist_trainer": {"epochs": 1, "n_train": data.n_train,
                                                "avg_loss": history[0]["avg_loss"],
                                                "test_accuracy": test_acc, "seconds": mnist_s}})
    check(ok_cli, f"the train_gpt2 entry point: launches {counts}, result {out}")
    check(np.isfinite(history[0]["avg_loss"]) and test_acc > 0.5,
          f"the MNIST trainer: loss {history[0]['avg_loss']}, test accuracy {test_acc}")


def phase_cli(tflash):
    from dsml_tpu_torch.cli import generate_text

    tflash.flash_fwd_launches = 0
    texts = generate_text.main(["--model", "small", "--prompt_len", "512", "--n_samples", "2",
                                "--max_new_tokens", "4", "--temperature", "0"])
    launches = tflash.flash_fwd_launches
    emit({"phase": "cli", "entry": "python -m dsml_tpu_torch.cli.generate_text",
          "continuations": len(texts), "flash_fwd_launches": launches})
    check(len(texts) == 2 and launches == 12, "the generate_text entry point")


# ---- paged attention and the continuous batcher --------------------------------

PAGE = 16  # the paged slice's page size
PAGED_SLOTS, PAGED_CHUNK = 16, 256
PAGED_REQUESTS, PAGED_F32_REQUESTS = 48, 8
PAGED_SOURCE = "dsml_tpu_torch/ops/csrc/paged_attn.cu"
# paged kernels against their plain version: f32 out, both sum in f32 in
# another order; bf16 out, both round an f32 result to bf16 once, so they
# may differ by one bf16 ulp of the value (2^-7 of its binade) plus the f32
# difference
TOL_PAGED_F32 = 1e-4


def paged_case(dev, rng, gen, b, hq, hkv, hd, n_pt, positions, q_dtype, mode):
    """Inputs of one paged-attention call: a pool whose live pages sit at
    shuffled physical indices (dead entries at scratch page 0), the table,
    the [b, C] positions and q [b, hq, C, hd]."""
    from dsml_tpu_torch.ops.quantization import quantize_kv_rows

    live = [0 if p.max() < 0 else int(p.max()) // PAGE + 1 for p in positions]
    n_pages = 1 + sum(live)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, n_pt), np.int32)
    at = 0
    for i, n in enumerate(live):
        table[i, :n] = perm[at:at + n]
        at += n
    k, v = (torch.randn(n_pages, hkv, PAGE, hd, generator=gen, device=dev) for _ in range(2))
    if mode:
        (kq, ks), (vq, vs) = quantize_kv_rows(k, mode), quantize_kv_rows(v, mode)
        pool = {"k": kq, "k_s": ks, "v": vq, "v_s": vs}
    else:
        pool = {"k": k.to(q_dtype), "v": v.to(q_dtype)}
    q = torch.randn(b, hq, positions.shape[1], hd, generator=gen, device=dev).to(q_dtype)
    return (q, pool, torch.as_tensor(table, device=dev),
            torch.as_tensor(positions, dtype=torch.int32, device=dev))


def paged_bound_ms(q, pool, table, positions):
    """Least time of one paged-attention call: the larger of its bytes (the
    live K and V rows and their scales — positions 0..max_pos of each slot,
    every kv head — q and out once, the table and positions) over the
    memory rate and its operations (4·hd per kept score: key_pos <=
    query_pos, per query head) over 989 TFLOP/s. Returns (ms, by)."""
    b, hq, c, hd = q.shape
    hkv = pool["k"].shape[1]
    row = sum(pool[key].shape[-1] * pool[key].element_size() for key in pool)  # K + V (+ scales)
    pos = positions.long().cpu()
    live_rows = int((pos.amax(1) + 1).clamp_min(0).sum())
    kept = int((pos + 1).clamp_min(0).sum()) * hq
    nbytes = (live_rows * hkv * row + 2 * q.numel() * q.element_size()
              + pos.numel() * 4 + table.numel() * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 4.0 * hd * kept / PEAK_FLOPS[torch.bfloat16] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulp(x):
    """One bf16 ulp at each |x| (2^-7 of its binade)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def paged_kernel_ms(tpa, args, reps=20):
    """{kernel name: device ms per call} of both paged kernels (each call is
    one launch: the split merge runs in the same kernel), from profiler
    traces of ``reps`` calls each, and {kernel name + "_call": ms} of
    everything a call launches on the card (the wrapper's copies
    included)."""
    out = {}
    for name, pipeline in (("paged_attn", False), ("paged_attn_pipelined", True)):
        def call():
            return tpa.paged_attention(*args, pipeline=pipeline)
        out[name] = device_ms(call, reps, pattern=f"::{name}_kernel<")
        out[f"{name}_call"] = device_ms(call, reps)
    return out


def paged_time(dev, cases):
    """The paged kernels' times at the main path's decode and chunk shapes
    (bf16 q, int4 pages) and the fp bf16 decode beside SDPA over the already
    gathered view. Uses only ``paged_attention`` and its plain version, so
    a parent tree runs it too (``python3 chip_smoke.py paged_time``)."""
    from dsml_tpu_torch.ops import paged_attention as tpa

    timing = {}
    for shape in ("decode", "chunk"):
        args, mode = cases[shape]
        call = (*args, mode)
        per_kernel = paged_kernel_ms(tpa, call)
        plain_ms = cuda_ms(lambda: tpa._paged_attention_reference(*call))
        bound_ms, bound_by = paged_bound_ms(*args)
        for name in ("paged_attn", "paged_attn_pipelined"):
            pipe = name == "paged_attn_pipelined"
            timing.setdefault(name, {})[shape] = {
                "ms": per_kernel[name], "call_device_ms": per_kernel[f"{name}_call"],
                "wrapper_ms": cuda_ms(lambda: tpa.paged_attention(*call, pipeline=pipe)),
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
    # the library yardstick for fp pages: SDPA over the already gathered
    # dense view (the gather excluded; no PyTorch call reads a page table)
    (q, pool, table, positions), _ = cases["decode_fp"]
    b, hq, c, hd = q.shape
    kd, vd = (pool[key][table.long()].permute(0, 2, 1, 3, 4).reshape(b, hq, -1, hd)
              for key in ("k", "v"))
    mask = torch.arange(kd.shape[2], device=dev)[None, None, None, :] \
        <= positions.long()[:, None, :, None]
    sdpa_fp_ms = device_ms(lambda: F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask))
    fp_kernel_ms = paged_kernel_ms(tpa, (q, pool, table, positions, None))
    emit({"phase": "kernel_time", "kernels": ["paged_attn", "paged_attn_pipelined"],
          "decode_shape": {"slots": PAGED_SLOTS, "hq": H, "hd": D, "page": PAGE,
                           "depths": "1-1023 (2 dead)", "q": "bfloat16", "codec": "int4"},
          "chunk_shape": {"rows": PAGED_CHUNK, "start": 512, "q": "bfloat16", "codec": "int4"},
          **timing,
          "fp_bf16_decode": {"kernel_ms": fp_kernel_ms,
                             "sdpa_over_gathered_view_ms": sdpa_fp_ms,
                             "note": "SDPA excludes the gather; no PyTorch call reads a page table"}})
    return timing


def paged_shapes(rng):
    """The kernel_paged shapes: {name: (b, hq, hkv, hd, positions [b, C])}."""
    n_pt = 1024 // PAGE
    depths = rng.integers(1, 1024, PAGED_SLOTS)
    decode_pos = (depths - 1)[:, None].copy()
    decode_pos[[3, 11]] = -1  # dead slots
    verify_start = rng.integers(0, 1020, PAGED_SLOTS)
    return n_pt, {
        "decode": (PAGED_SLOTS, H, H, D, decode_pos),
        "chunk": (1, H, H, D, (512 + np.arange(PAGED_CHUNK))[None, :]),
        "verify": (PAGED_SLOTS, H, H, D, verify_start[:, None] + np.arange(4)[None, :]),
        "gqa": (8, 32, 8, 128, (rng.integers(1, 1024, 8) - 1)[:, None]),
    }


PAGED_CODECS = [(torch.float32, None), (torch.bfloat16, None), (torch.float32, "int8"),
                (torch.bfloat16, "int8"), (torch.float32, "int4"), (torch.bfloat16, "int4")]
# the split plan's edges, as decode depths (keys) of 16 slots: one key, a
# unit's edge (15, 16, 17), a split's edge (128 keys, 129), the next one
# (256, 257), the deepest (1023, 1024), a dead slot
SPLIT_EDGE_DEPTHS = [1, 15, 16, 17, 127, 128, 129, 255, 256, 257, 511, 512, 1023, 1024, 0, 640]


def paged_check(dev, tpa, shape, args, mode, q_dtype, positions):
    """One case: both kernels against the plain version at the stated
    tolerance, bit for bit against each other and against a second call,
    dead slots zero. Returns the largest error."""
    single = tpa.paged_attention(*args, mode, pipeline=False)
    piped = tpa.paged_attention(*args, mode, pipeline=True)
    again = (tpa.paged_attention(*args, mode, pipeline=False),
             tpa.paged_attention(*args, mode, pipeline=True))
    torch.cuda.synchronize()
    ref = tpa._paged_attention_reference(*args, mode)
    errs = [(o.float() - ref.float()).abs() for o in (single, piped)]
    if q_dtype == torch.float32:
        ok_tol = all(bool((e <= TOL_PAGED_F32).all()) for e in errs)
    else:
        ulp = torch.maximum(bf16_ulp(single.float()), bf16_ulp(ref.float()))
        ok_tol = all(bool((e <= ulp + TOL_PAGED_F32).all()) for e in errs)
    bit_equal = bool(torch.equal(single, piped))
    repeat_equal = bool(torch.equal(single, again[0]) and torch.equal(piped, again[1]))
    dead = positions.max(1) < 0
    ok = (ok_tol and bit_equal and repeat_equal and single.shape == args[0].shape
          and single.dtype == q_dtype and bool(torch.isfinite(single).all())
          and (not dead.any() or bool((single[torch.as_tensor(dead, device=dev)] == 0).all())))
    err = max(e.max().item() for e in errs)
    b, hq = args[0].shape[:2]
    emit({"phase": "kernel_paged", "kernels": ["paged_attn", "paged_attn_pipelined"],
          "case": shape, "q_dtype": str(q_dtype)[6:], "codec": mode or "fp",
          "b": b, "hq": hq, "hkv": args[1]["k"].shape[1], "hd": args[0].shape[-1],
          "c": int(positions.shape[1]), "max_abs_err": err,
          "tol": "1e-4" if q_dtype == torch.float32 else "one bf16 ulp + 1e-4",
          "bit_identical": bit_equal, "repeat_identical": repeat_equal, "ok": ok})
    check(ok, f"paged kernels disagree with the plain version, each other or themselves ({shape}, "
              f"{q_dtype}, {mode}): max abs err {err}, bit identical {bit_equal}, "
              f"repeat identical {repeat_equal}")
    return err


def phase_kernel_paged(dev):
    """Both paged kernels against _paged_attention_reference at GPT-2-small's
    shapes (decode, a 256-row chunk, a verify window, GQA at hd 128) and at
    the split plan's edges for every codec, against each other and a
    second call bit for bit; the shared memory and scratch accounting
    against the kernel's; then their times (paged_time)."""
    from dsml_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)
    n_pt, shapes = paged_shapes(rng)
    main_err, timed = None, {}
    for shape, (b, hq, hkv, hd, positions) in shapes.items():
        for q_dtype, mode in PAGED_CODECS:
            args = paged_case(dev, rng, gen, b, hq, hkv, hd, n_pt, positions, q_dtype, mode)
            err = paged_check(dev, tpa, shape, args, mode, q_dtype, positions)
            if (q_dtype, mode) == (torch.bfloat16, "int4") and shape in ("decode", "chunk"):
                timed[shape] = (args, mode)
                if shape == "decode":
                    main_err = err
            if (q_dtype, mode, shape) == (torch.bfloat16, None, "decode"):
                timed["decode_fp"] = (args, mode)
    # the split edges at the decode shape, and the chunk at a split edge
    edge_pos = (np.asarray(SPLIT_EDGE_DEPTHS) - 1)[:, None]
    edges = {"split_edges": (PAGED_SLOTS, H, H, D, edge_pos),
             "chunk_edge": (1, H, H, D, (128 - 64 + np.arange(65))[None, :])}
    for shape, (b, hq, hkv, hd, positions) in edges.items():
        for q_dtype, mode in PAGED_CODECS:
            args = paged_case(dev, rng, gen, b, hq, hkv, hd, n_pt, positions, q_dtype, mode)
            paged_check(dev, tpa, shape, args, mode, q_dtype, positions)

    # smem as the kernel carves it, against the Python accounting
    lib = tpa._lib()
    for hd in (64, 128):
        for mode, kind in ((None, 0), ("int8", 1), ("int4", 2)):
            for fp in (4, 2):
                for pipe in (False, True):
                    for tc in ((False, True) if fp == 2 or mode else (False,)):
                        want = tpa.paged_smem_bytes(hd, mode, pipe, fp, tensor_cores=tc)
                        got = lib.paged_attn_smem_bytes(hd, kind, fp, int(pipe), int(tc))
                        check(got == want, f"paged_smem_bytes({hd}, {mode}, {pipe}, {fp}, {tc}) = "
                                           f"{want}, the kernel carves {got}")
    for b, hkv, g, hd, n_keys in ((16, 12, 1, 64, 1024), (1, 12, 256, 64, 1024),
                                  (16, 12, 4, 64, 1024), (8, 8, 4, 128, 1024), (3, 2, 17, 128, 200)):
        for q_dtype in (torch.float32, torch.bfloat16):
            want = tpa.paged_scratch_bytes(b, hkv, g, hd, n_keys, q_dtype)
            got = tuple(lib.paged_attn_scratch_bytes(b, hkv, g, hd, n_keys,
                                                     int(q_dtype == torch.bfloat16), counters)
                        for counters in (1, 0))
            check(got == want, f"paged_scratch_bytes({b}, {hkv}, {g}, {hd}, {n_keys}, {q_dtype}) "
                               f"= {want}, the kernel needs {got}")

    return main_err, paged_time(dev, timed)


def phase_paged_time(dev):
    """paged_time alone, on the kernel_paged inputs of the timed shapes."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)
    n_pt, shapes = paged_shapes(rng)
    cases = {}
    for name, (shape, q_dtype, mode) in {"decode": ("decode", torch.bfloat16, "int4"),
                                         "chunk": ("chunk", torch.bfloat16, "int4"),
                                         "decode_fp": ("decode", torch.bfloat16, None)}.items():
        b, hq, hkv, hd, positions = shapes[shape]
        cases[name] = (paged_case(dev, rng, gen, b, hq, hkv, hd, n_pt, positions, q_dtype, mode), mode)
    paged_time(dev, cases)


def paged_counts(tpa):
    return {"paged_attn": tpa.paged_attn_launches,
            "paged_attn_pipelined": tpa.paged_attn_pipelined_launches}


def drain(srv, prompts, budgets, snapshot=None, probe=None):
    """Submit every request at once and step until the batcher drains;
    ``probe(srv)`` runs after every tick, outside its timing. Returns
    (tokens per request, wall s, decode-only tick ms list)."""
    rids = [srv.submit(p, int(n)) for p, n in zip(prompts, budgets)]
    out, ticks = {}, []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while srv.n_queued or srv.n_active or srv.n_pending:
        p0 = srv.n_prefill_dispatches
        t = time.perf_counter()
        out.update(srv.step())  # each tick ends in a host fetch of its tokens
        if srv.n_prefill_dispatches == p0:
            ticks.append((time.perf_counter() - t) * 1e3)
        if snapshot is not None and srv.n_active > snapshot.get("n_active", 0):
            # layer 0's pool at the fullest tick so far
            snapshot.update(n_active=srv.n_active, table=srv._decode_table().copy(),
                            pos=srv._pos.copy(),
                            pool0={k: v.clone() for k, v in srv._pool[0].items()})
        if probe is not None:
            probe(srv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = srv.collect()
    return [done[r] for r in rids], wall, ticks


def steady_tick(srv, prompts):
    """One decode tick with every slot decoding: the untraced wall ms
    (median of 5) against the device-busy ms of a traced tick. Abandons
    the requests after and checks that every page came back."""
    for p in prompts[:srv.n_slots]:
        srv.submit(p[:64], 64)
    while srv.n_queued or srv.n_pending or srv.n_active < srv.n_slots:
        srv.step()
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        srv.step()
        walls.append((time.perf_counter() - t) * 1e3)
    by_name = device_kernel_ms(srv.step)
    busy = sum(by_name.values()) if by_name else None
    wall = statistics.median(walls)
    srv.abandon()
    check(srv.free_pages == srv.n_pages - 1, "pages leaked by abandon")
    return {"slots": srv.n_slots, "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall,
            "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}


def first_divergence_margin(model, prompt, tokens, step):
    """Top-2 logit margin of the next token after ``prompt`` + ``tokens[:step]``
    through the plain dense prefill: how close the step was to a tie."""
    seq = np.concatenate([prompt, np.asarray(tokens[:step], np.int64)])
    model._prefill_use_flash = lambda t: False
    logits, _ = model.prefill(torch.as_tensor(seq[None], device=model.device))
    del model._prefill_use_flash
    top2 = logits[0].float().topk(2).values
    return (top2[0] - top2[1]).item()


def phase_paged_slice(dev, card):
    """GPT-2-small bf16 through ContinuousBatcher(paged_kv="int4") on 48
    requests submitted at once: launches of the kernels, completion, the
    pool drained, tokens/s, TTFT, decode tick ms, the device idle share of
    one tick; the same drain through the single-buffer kernel with
    identical tokens; f32 fp-page greedy tokens of the kernel against the
    gather path; a pool snapshot through both kernels against the plain
    version."""
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    model = gpt2_small(cfg, dev)
    rng = np.random.default_rng(2)
    lengths = rng.integers(64, 769, PAGED_REQUESTS)
    budgets = rng.integers(16, 129, PAGED_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64) for n in lengths]
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    srv = ContinuousBatcher(model, **kw)
    drain(srv, prompts[:4], [8] * 4)  # warm-up: the kernels' build, cuBLAS, the allocator
    srv.reset_latency_stats()

    # the main path, counted
    tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
    ticks0, pre0 = srv.n_plain_ticks, srv.n_prefill_dispatches
    snapshot = {}
    toks, wall, tick_ms = drain(srv, prompts, budgets, snapshot)
    counts = paged_counts(tpa)
    n_chunks, n_ticks = srv.n_prefill_dispatches - pre0, srv.n_plain_ticks - ticks0
    dispatches = n_chunks + n_ticks * srv.decode_quantum
    n_pages = srv.n_pages
    lat = srv.latency_stats()
    new_tokens = sum(len(t) for t in toks)
    check(counts["paged_attn_pipelined"] == cfg.n_layer * dispatches and counts["paged_attn"] == 0,
          f"the pipelined drain launched {counts}, expected {cfg.n_layer} x {dispatches} "
          "pipelined launches")
    check(all(len(t) == int(n) for t, n in zip(toks, budgets)),
          "a request did not complete its budget")
    check(srv.free_pages == srv.n_pages - 1,
          f"{srv.free_pages} pages free after the drain, expected {srv.n_pages - 1}")

    # the same drain through the single-buffer kernel
    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
    try:
        ticks1, pre1 = srv.n_plain_ticks, srv.n_prefill_dispatches
        toks_single, wall_single, tick_single = drain(srv, prompts, budgets)
    finally:
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
    counts_single = {k: v - counts[k] for k, v in paged_counts(tpa).items()}
    dispatches_single = (srv.n_prefill_dispatches - pre1) + (srv.n_plain_ticks - ticks1)
    check(counts_single["paged_attn"] == cfg.n_layer * dispatches_single
          and counts_single["paged_attn_pipelined"] == 0,
          f"the single-buffer drain launched {counts_single}, expected {cfg.n_layer} x "
          f"{dispatches_single} single-buffer launches")
    check(toks_single == toks, "the single-buffer drain's tokens differ from the pipelined drain's")
    check(srv.free_pages == srv.n_pages - 1, "pages leaked in the single-buffer drain")

    steady = steady_tick(srv, prompts)

    # the snapshot of layer 0's pool through both kernels against the plain version
    gen = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn(PAGED_SLOTS, H, 1, D, generator=gen, device=dev).to(torch.bfloat16)
    table = torch.as_tensor(snapshot["table"], device=dev)
    live = snapshot["table"].any(1)
    pos = torch.as_tensor(np.where(live, snapshot["pos"], -1)[:, None], dtype=torch.int32, device=dev)
    snap_args = (q, snapshot["pool0"], table, pos, "int4")
    outs = [tpa.paged_attention(*snap_args, pipeline=p) for p in (False, True)]
    ref = tpa._paged_attention_reference(*snap_args)
    snap_err = max((o.float() - ref.float()).abs().max().item() for o in outs)
    ulp = torch.maximum(bf16_ulp(outs[0].float()), bf16_ulp(ref.float()))
    snap_ok = all(bool(((o.float() - ref.float()).abs() <= ulp + TOL_PAGED_F32).all()) for o in outs)
    check(snap_ok and torch.equal(outs[0], outs[1]),
          f"the pool snapshot: kernels vs plain max abs err {snap_err}")
    del srv, snapshot, snap_args

    # f32, fp pages, 8 requests: kernel against the gather path, greedy
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = gpt2_small(cfg32, dev)
    sub = slice(0, PAGED_F32_REQUESTS)
    runs = {}
    for impl in ("pallas", "xla"):
        os.environ["DSML_PAGED_ATTN"] = impl
        try:
            srv32 = ContinuousBatcher(model32, paged_kv="fp", page_size=PAGE,
                                      prefill_chunk=PAGED_CHUNK, n_slots=PAGED_F32_REQUESTS)
            runs[impl], _, _ = drain(srv32, prompts[sub], budgets[sub])
        finally:
            del os.environ["DSML_PAGED_ATTN"]
        del srv32
    near_ties, mismatches = [], 0
    for i, (a, w) in enumerate(zip(runs["pallas"], runs["xla"])):
        diff = [j for j, (x, y) in enumerate(zip(a, w)) if x != y]
        if not diff:
            continue
        m = first_divergence_margin(model32, prompts[i], w, diff[0])
        near_ties.append({"request": i, "step": diff[0], "margin": m})
        mismatches += m >= MARGIN
    del model32

    emit({"phase": "paged_slice", "model": "gpt2-small", "dtype": "bfloat16", "paged_kv": "int4",
          "page_size": PAGE, "prefill_chunk": PAGED_CHUNK, "n_slots": PAGED_SLOTS,
          "n_pages": n_pages, "requests": PAGED_REQUESTS, "prompt_tokens": int(lengths.sum()),
          "new_tokens": new_tokens, "launches": counts,
          "dispatches": {"prefill_chunks": n_chunks, "decode_ticks": n_ticks},
          "wall_s": wall, "tokens_per_s": new_tokens / wall,
          "ttft_p50_s": lat.get("ttft_p50_s"), "ttft_p99_s": lat.get("ttft_p99_s"),
          "e2e_p50_s": lat.get("e2e_p50_s"), "e2e_p99_s": lat.get("e2e_p99_s"),
          "decode_tick_ms_median": statistics.median(tick_ms), "decode_ticks": len(tick_ms),
          "single_buffer": {"launches": counts_single, "wall_s": wall_single,
                            "tokens_per_s": new_tokens / wall_single,
                            "decode_tick_ms_median": statistics.median(tick_single),
                            "tokens_identical": True},
          "steady_tick": steady, "snapshot_max_abs_err": snap_err,
          "f32_fp_pages": {"requests": PAGED_F32_REQUESTS,
                           "tokens_equal": runs["pallas"] == runs["xla"],
                           "near_ties": near_ties},
          "card": card})
    check(mismatches == 0, f"f32 fp pages: {mismatches} requests diverge from the gather path "
                           "beyond the margin rule")
    # the fleet phase serves the same requests and holds its tokens to these
    return counts, counts_single, {"prompts": prompts, "budgets": budgets, "bf16_tokens": toks,
                                   "f32_tokens": runs["pallas"]}


# ---- the serving fleet: prefill workers, the KV handoff, decode workers ----------

FLEET_PREFILL, FLEET_DECODE, FLEET_SLOTS = 2, 2, 8  # 16 decode slots in all, as in paged_slice
FLEET_REQUESTS = 16  # the first 16 of the paged row's 48
FLEET_PREFIX, FLEET_PREFIX_REQUESTS = 256, 4  # a registered 256-token prefix + 64-256 suffix tokens
FLEET_F32_REQUESTS, FLEET_F32_SLOTS = 4, 4
FLEET_CODEC_HANDOFFS = 2
# the codec on the pure-Python CRC32C: the fleet line of the run of record
# before the native runtime
PY_CRC_CODEC_MB_PER_S, PY_CRC_DECODE_GAP_P99_S = (4.87, 7.98), 0.868
FLEET_TPOT_MS, FLEET_E2E_MS = 100.0, 15000.0  # the interactive class's budgets


def count_launches_by_role(workers, role, tpa, by_role):
    """Wrap each worker's ``step`` so the paged kernels' launches inside it
    add to ``by_role[role]`` ([single-buffer, pipelined])."""
    for w in workers:
        def step(inner=w.step):
            a, b = tpa.paged_attn_launches, tpa.paged_attn_pipelined_launches
            out = inner()
            by_role[role][0] += tpa.paged_attn_launches - a
            by_role[role][1] += tpa.paged_attn_pipelined_launches - b
            return out

        w.step = step


def phase_fleet(dev, card, paged):
    """GPT-2-small bf16 served disaggregated: ``build_fleet`` with 2
    PrefillWorkers (256-token chunks into int4 pages, kernel 6) and 2
    decode batchers of 8 slots (int4 pages, kernel 6) behind the SLO
    router, obs on. The first 16 of the paged row's requests and 4 made of
    a registered 256-token prefix plus 64-256 suffix tokens, submitted at
    once under two classes (interactive with TPOT and e2e budgets, batch).
    Checks: every request completes its budget; every pool is back to all
    its pages free but the scratch page and the registry's; kernel 6
    launched n_layer times a dispatch on each role (chunks on the prefill
    workers, ticks on the decode workers), kernel 5 never; the prefix
    requests hand off with prefix_rows = 256 and only their suffix's pages
    (its chunk grid's, as the JAX worker ships them);
    2 of those handoffs through the CRC32C codec come back byte for byte
    (and serve from the decoded copy); one request's trace holds its
    prefill, handoff and decode events. Then 4 requests at f32 over fp
    pages through the single-buffer kernel (kernel 5), a prefill worker
    killed while one of them is mid-prefill: their greedy tokens against
    paged_slice's monolithic f32 drain under the margin rule. Last, both
    kernels at the decode ticks' shapes (:func:`fleet_kernel_time`).
    Returns the kernels' launches on the fleet path and their largest
    error there."""
    from dsml_tpu_torch import obs
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.obs.cluster import snapshot, stitch_traces, trace_summary
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.runtime import native
    from dsml_tpu_torch.runtime import chaos
    from dsml_tpu_torch.serving import SLOClass, build_fleet, decode_handoff, encode_handoff
    from dsml_tpu_torch.serving.paging import pages_for

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    hd = cfg.d_model // cfg.n_head
    model = gpt2_small(cfg, dev)
    prompts = paged["prompts"][:FLEET_REQUESTS]
    budgets = [int(n) for n in paged["budgets"][:FLEET_REQUESTS]]
    rng = np.random.default_rng(20)
    prefix = rng.integers(0, cfg.vocab_size, FLEET_PREFIX).astype(np.int64)
    pre_prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, int(n))])
                   for n in rng.integers(64, 257, FLEET_PREFIX_REQUESTS)]
    pre_budgets = [int(n) for n in rng.integers(16, 129, FLEET_PREFIX_REQUESTS)]
    classes = [SLOClass("interactive", tpot_budget_ms=FLEET_TPOT_MS, e2e_budget_ms=FLEET_E2E_MS,
                        objective=0.9),
               SLOClass("batch", priority=1)]
    handoffs, codec = {}, []

    def transport(h):
        """In process (the rows stay on the card), but for the first
        prefix handoffs: those go through the codec and serve decoded."""
        shipped = sum(t.numel() * t.element_size() for layer in h.cache1 for t in layer.values())
        handoffs[h.frid] = {"prefill_len": h.prefill_len, "prefix_rows": h.prefix_rows,
                            "pages": int(h.cache1[0]["k"].shape[0]), "bytes": shipped,
                            "dense_f32_bytes": cfg.n_layer * 2 * cfg.n_head * h.prefill_len * hd * 4}
        if not h.prefix_rows or len(codec) >= FLEET_CODEC_HANDOFFS:
            return h
        t0 = time.perf_counter()
        frame = encode_handoff(h)
        t1 = time.perf_counter()
        back = decode_handoff(frame)
        t2 = time.perf_counter()
        same = torch.equal(back.logits, h.logits.float().cpu()) and all(
            torch.equal(back.cache1[i][k], v.cpu()) for i, layer in enumerate(h.cache1)
            for k, v in layer.items())
        n = len(frame["payload"])
        codec.append({"frid": h.frid, "payload_bytes": n, "frames": len(frame["chunk_crcs"]),
                      "encode_s": t1 - t0, "decode_s": t2 - t1,
                      "encode_mb_per_s": n / (t1 - t0) / 1e6, "decode_mb_per_s": n / (t2 - t1) / 1e6,
                      "byte_for_byte": same})
        return back

    obs.disable()
    obs.get_registry().reset()
    obs.get_tracer().reset()
    obs.enable(forensics=False)
    try:
        router = build_fleet(model, n_prefill=FLEET_PREFILL, n_decode=FLEET_DECODE,
                             prefill_chunk=PAGED_CHUNK, paged_kv="int4", page_size=PAGE,
                             n_slots=FLEET_SLOTS, slo_classes=classes, transport=transport)
        prefill_workers, decode_workers = list(router.prefill_workers), list(router.decode_workers)
        for p, n in zip(prompts[:4], [8] * 4):  # warm-up: cuBLAS at these batches, the allocator
            router.submit(p, n, slo="batch")
        router.run()
        router.reset_latency_stats()
        router.reset_request_records()
        router.slo.reset()
        handoffs.clear()
        router.register_prefix(prefix)  # blocking: every prefill and decode worker
        obs.get_tracer().reset()

        # the main path, counted by role (the codec's CRC32C: native calls)
        native.reset_calls()
        by_role = {"prefill": [0, 0], "decode": [0, 0]}
        count_launches_by_role(prefill_workers, "prefill", tpa, by_role)
        count_launches_by_role(decode_workers, "decode", tpa, by_role)
        chunks0 = [pw.n_chunk_dispatches for pw in prefill_workers]
        ticks0 = [dw.n_plain_ticks for dw in decode_workers]
        requests = ([(p, n, "interactive" if i < FLEET_REQUESTS // 2 else "batch")
                     for i, (p, n) in enumerate(zip(prompts, budgets))]
                    + [(p, n, "interactive") for p, n in zip(pre_prompts, pre_budgets)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frids = [router.submit(p, n, slo=c) for p, n, c in requests]
        out = router.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks = [pw.n_chunk_dispatches - c for pw, c in zip(prefill_workers, chunks0)]
        ticks = [dw.n_plain_ticks - t for dw, t in zip(decode_workers, ticks0)]
        records = {f: router.request_records[f] for f in frids}
        gaps = router.decode_gaps()
        codec_crc_calls = native.CALLS["ds_crc32c"]
        slo_report = router.slo.report()
        pre_frids = frids[FLEET_REQUESTS:]
        chain_tid = records[pre_frids[0]]["trace_id"]
        summary = trace_summary(stitch_traces([snapshot(role="fleet")]))
        chain = summary.get(chain_tid, {})
        chain_events = [(e["name"], e["ph"]) for e in obs.get_tracer().chrome_trace()["traceEvents"]
                        if (e.get("args") or {}).get("trace_id") == chain_tid]
    finally:
        obs.disable()
        obs.get_registry().reset()
        obs.get_tracer().reset()
        obs.get_flight_recorder().clear()
        obs.get_memory_ledger().clear()
    toks = [out[f] for f in frids]
    new_tokens = sum(len(t) for t in toks)
    check(all(len(t) == n for t, (_, n, _) in zip(toks, requests)),
          "the fleet: a request did not complete its budget")
    pools = [(w.obs_role, w._pages.free_pages, w.n_pages, w._registry_pages)
             for w in prefill_workers + decode_workers]
    check(all(free == n_pages - 1 - held for _, free, n_pages, held in pools),
          f"the fleet's pools after the drain (role, free, pages, registry pages): {pools}")
    check(by_role["prefill"] == [0, cfg.n_layer * sum(chunks)]
          and by_role["decode"] == [0, cfg.n_layer * sum(ticks)],
          f"the fleet launched [kernel 5, kernel 6] {by_role}, expected {cfg.n_layer} x "
          f"{sum(chunks)} chunks and {sum(ticks)} ticks on kernel 6")
    # a handoff ships its chunk grid's pages (the JAX worker's payload): a
    # prefix request's are those past the prefix, the suffix's grid
    pre_rows = [handoffs[f] for f in pre_frids]
    for h in pre_rows:
        grid = FLEET_PREFIX + -(-(h["prefill_len"] - FLEET_PREFIX) // PAGED_CHUNK) * PAGED_CHUNK
        h["suffix_grid_pages"] = pages_for(grid, PAGE) - FLEET_PREFIX // PAGE
    check(all(h["prefix_rows"] == FLEET_PREFIX and h["pages"] == h["suffix_grid_pages"]
              for h in pre_rows),
          f"the prefix requests' handoffs (prefix rows, pages shipped): {pre_rows}")
    check(len(codec) == FLEET_CODEC_HANDOFFS and all(c["byte_for_byte"] for c in codec),
          f"the codec's round trips: {codec}")
    check(codec_crc_calls > 0, "the codec's CRC32C did not run on the native ds_crc32c")
    check({"router_submit", "prefill_chunk", "serving_first_token"} <= set(chain.get("names", []))
          and chain.get("flow", {}).get("s") == 1 and chain["flow"].get("t", 0) >= 2
          and chain["flow"].get("f") == 1,
          f"request trace {chain_tid}: {chain}")

    def pct(vals, q):
        return float(np.percentile(np.asarray(vals), q)) if vals else None

    by_class = {}
    for c in ("interactive", "batch"):
        rows = [records[f] for f, (_, _, cls) in zip(frids, requests) if cls == c]
        by_class[c] = {"requests": len(rows),
                       "ttft_p50_s": pct([r["ttft_s"] for r in rows], 50),
                       "ttft_p99_s": pct([r["ttft_s"] for r in rows], 99),
                       "e2e_p50_s": pct([r["e2e_s"] for r in rows], 50),
                       "e2e_p99_s": pct([r["e2e_s"] for r in rows], 99)}
    same16 = sum(a == b for a, b in zip(toks[:FLEET_REQUESTS], paged["bf16_tokens"]))
    hand_bytes = [h["bytes"] for h in handoffs.values()]
    dense_bytes = [h["dense_f32_bytes"] for h in handoffs.values()]
    bf16_s = time.perf_counter() - t_phase
    del router, prefill_workers, decode_workers, model
    gc.collect()
    torch.cuda.empty_cache()

    # f32 over fp pages through the single-buffer kernel, a prefill worker
    # killed mid-prefill: tokens against paged_slice's monolithic f32 drain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = gpt2_small(cfg32, dev)
    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
    try:
        r32 = build_fleet(model32, n_prefill=FLEET_PREFILL, n_decode=FLEET_DECODE,
                          prefill_chunk=PAGED_CHUNK, paged_kv="fp", page_size=PAGE,
                          n_slots=FLEET_F32_SLOTS)
        pw32, dw32 = list(r32.prefill_workers), list(r32.decode_workers)
        by_role32 = {"prefill": [0, 0], "decode": [0, 0]}
        count_launches_by_role(pw32, "prefill", tpa, by_role32)
        count_launches_by_role(dw32, "decode", tpa, by_role32)
        sub = slice(0, FLEET_F32_REQUESTS)
        # the kill through the chaos harness (obs on: its trace verdicts)
        obs.enable(forensics=False)
        kill = MidPrefillKill(r32)
        chaos32 = chaos.run_chaos_serving_fleet(r32, list(prompts[sub]), budgets[sub], kill)
        killed = kill.killed
    finally:
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
        obs.disable()
        obs.get_registry().reset()
        obs.get_tracer().reset()
        obs.get_flight_recorder().clear()
        obs.get_memory_ledger().clear()
    out32 = chaos32.pop("results")
    toks32 = [out32[f] for f in sorted(out32)]
    verdicts32 = {k: v for k, v in chaos32.items() if k.startswith(("requeued", "trace_", "ticks"))}
    check(killed is not None and chaos32["requeued_prefill"] >= 1,
          f"the f32 fleet: no prefill worker was killed mid-prefill ({killed}, {verdicts32})")
    check(all(chaos32[k] == 1 for k in ("trace_requeue_same", "trace_retry_recorded",
                                        "trace_burn_full_latency")),
          f"the f32 fleet's trace verdicts across the prefill kill: {verdicts32}")
    check(all(len(t) == n for t, n in zip(toks32, budgets[sub])),
          "the f32 fleet: a request did not complete its budget")
    chunks32 = sum(pw.n_chunk_dispatches for pw in pw32)
    ticks32 = sum(dw.n_plain_ticks for dw in dw32)
    check(by_role32["prefill"] == [cfg.n_layer * chunks32, 0]
          and by_role32["decode"] == [cfg.n_layer * ticks32, 0],
          f"the f32 fleet launched [kernel 5, kernel 6] {by_role32}, expected {cfg.n_layer} x "
          f"{chunks32} chunks and {ticks32} ticks on kernel 5")
    near_ties, mismatches = [], 0
    for i, (a, w) in enumerate(zip(toks32, paged["f32_tokens"][sub])):
        diff = [j for j, (x, y) in enumerate(zip(a, w)) if x != y]
        if not diff:
            continue
        m = first_divergence_margin(model32, prompts[i], w, diff[0])
        near_ties.append({"request": i, "step": diff[0], "margin": m})
        mismatches += m >= MARGIN
    del r32, model32
    kernel_err = fleet_kernel_time(dev)
    emit({"phase": "fleet", "model": "gpt2-small", "dtype": "bfloat16", "paged_kv": "int4",
          "page_size": PAGE, "prefill_chunk": PAGED_CHUNK, "n_prefill": FLEET_PREFILL,
          "n_decode": FLEET_DECODE, "n_slots_per_decode": FLEET_SLOTS,
          "requests": len(requests), "prefix_requests": FLEET_PREFIX_REQUESTS,
          "new_tokens": new_tokens, "wall_s": wall, "tokens_per_s": new_tokens / wall,
          "by_class": by_class, "decode_gap_p50_s": pct(gaps, 50), "decode_gap_p99_s": pct(gaps, 99),
          "chunk_dispatches_per_prefill_worker": chunks, "decode_ticks_per_decode_worker": ticks,
          "launches_by_role": {r: {"paged_attn": v[0], "paged_attn_pipelined": v[1]}
                               for r, v in by_role.items()},
          "handoffs": len(handoffs), "handoff_bytes_mean": float(np.mean(hand_bytes)),
          "dense_f32_bytes_mean": float(np.mean(dense_bytes)),
          "handoff_bytes_over_dense_f32": float(np.sum(hand_bytes) / np.sum(dense_bytes)),
          "prefix_handoffs": pre_rows, "codec": codec, "codec_crc32c": "ds_crc32c (native)",
          "codec_ds_crc32c_calls": codec_crc_calls,
          "with_python_crc32c": {"codec_mb_per_s": PY_CRC_CODEC_MB_PER_S,
                                 "decode_gap_p99_s": PY_CRC_DECODE_GAP_P99_S},
          "pools": pools,
          "slo_report": slo_report, "trace_chain": {"trace_id": chain_tid, **chain,
                                                    "events": chain_events},
          "bf16_tokens_equal_paged_slice": f"{same16} of {FLEET_REQUESTS}",
          "f32_fp_pages": {"requests": FLEET_F32_REQUESTS, "killed": killed,
                           "chaos_verdicts": verdicts32,
                           "tokens_equal": toks32 == paged["f32_tokens"][sub],
                           "near_ties": near_ties,
                           "launches_by_role": {r: {"paged_attn": v[0], "paged_attn_pipelined": v[1]}
                                                for r, v in by_role32.items()}},
          "bf16_seconds": bf16_s, "phase_seconds": time.perf_counter() - t_phase, "card": card})
    check(mismatches == 0, f"the f32 fleet: {mismatches} requests diverge from the monolithic "
                           "batcher beyond the margin rule")
    return {"paged_attn": by_role32["prefill"][0] + by_role32["decode"][0],
            "paged_attn_pipelined": by_role["prefill"][1] + by_role["decode"][1]}, kernel_err


def fleet_kernel_time(dev):
    """Kernels 5 and 6 at the fleet's decode ticks, the shapes kernel_paged
    does not take: 8 slots (bf16 q, int4 pages) and, at f32, 4 slots over
    fp pages (the prefill workers' 256-row chunks are kernel_paged's chunk
    shape). Each held to the plain version, then timed with CUDA events
    around one call (host launch included) beside its bound and the plain
    version. Returns the largest error."""
    from dsml_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev).manual_seed(21)
    timing, errs = {}, []
    for name, b, q_dtype, mode in (("fleet_decode", FLEET_SLOTS, torch.bfloat16, "int4"),
                                   ("fleet_f32_decode", FLEET_F32_SLOTS, torch.float32, None)):
        positions = (rng.integers(1, 1024, b) - 1)[:, None]
        args = paged_case(dev, rng, gen, b, H, H, D, 1024 // PAGE, positions, q_dtype, mode)
        errs.append(paged_check(dev, tpa, name, args, mode, q_dtype, positions))
        bound_ms, bound_by = paged_bound_ms(*args)
        timing[name] = {
            "shape": [b, H, 1, D], "q": str(q_dtype)[6:], "codec": mode or "fp",
            **{k: {"ms": cuda_ms(lambda p=p: tpa.paged_attention(*args, mode, pipeline=p)),
                   "plain_ms": cuda_ms(lambda: tpa._paged_attention_reference(*args, mode)),
                   "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
               for k, p in (("paged_attn", False), ("paged_attn_pipelined", True))}}
    emit({"phase": "kernel_time", "path": "fleet", "kernels": ["paged_attn", "paged_attn_pipelined"],
          **timing, "note": "CUDA events around one call, host launch included; no PyTorch call "
                            "reads a page table"})
    return max(errs)


def wire_toolchain() -> dict:
    """grpc's, protobuf's and g++'s versions on this machine (None where absent)."""
    import importlib.metadata
    import importlib.util

    out = {}
    for key, module, dist in (("grpc", "grpc", "grpcio"), ("protobuf", "google.protobuf",
                                                           "protobuf")):
        try:
            out[key] = importlib.metadata.version(dist) if importlib.util.find_spec(module) \
                else None
        except (ImportError, importlib.metadata.PackageNotFoundError):
            out[key] = None
    try:
        out["gxx"] = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                                    timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        out["gxx"] = None
    return out


WIRE_DEVICES, WIRE_MEM = 3, 0x1000000  # 3 servers on cuda:0, the example's address space
WIRE_STEPS, WIRE_CHECK_STEPS = 300, 20  # the wire run; its bit-identity prefix
WIRE_BATCH, WIRE_LR = 64, 0.1  # the reference launcher's batch and lr at 3 devices
WIRE_RPC_REPS = 20
WIRE_STREAM_BYTES = 4 << 20  # one 4 MiB BeginSend/StreamSend between two servers
# the wire run's flat weights after 20 steps against one device's plain MLP
# with autograd on the same batches (f32: the host's softmax gradient in
# numpy against torch's cross-entropy on the card, 20 SGD steps apart)
TOL_WIRE_AUTOGRAD = 1e-4
WIRE_HANDOFF_PROMPTS, WIRE_HANDOFF_TOKENS = (64, 97), 16  # two requests' prompt lengths


def median_ms(fn, reps=WIRE_RPC_REPS, setup=None):
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launcher_start():
    """``launch_devices`` (2 servers on the card) and ``launch_coordinator``
    as processes, on ephemeral ports; each prints its addresses as a JSON
    line once it serves."""
    return [subprocess.Popen([sys.executable, "-m", f"dsml_tpu_torch.cli.{name}", *args],
                             stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            for name, args in (("launch_devices", ["--num_devices", "2", "--base_port", "0"]),
                               ("launch_coordinator", ["--port", "0"]))]


def launcher_check(procs):
    """One AllReduceRing over the launched cluster through ``PipelineClient``."""
    from dsml_tpu_torch.comm.client import PipelineClient

    devices = json.loads(procs[0].stdout.readline())["devices"]
    coordinator = json.loads(procs[1].stdout.readline())["coordinator"]
    client = PipelineClient.connect(coordinator, devices, timeout=60.0)
    grads = [np.full(WIRE_STREAM_BYTES // 16, 1.5, np.float32),
             np.full(WIRE_STREAM_BYTES // 16, 2.25, np.float32)]
    t0 = time.perf_counter()
    reduced = client.all_reduce_gradients(grads)
    ms = (time.perf_counter() - t0) * 1e3
    client.finalize()
    return {"devices": devices, "coordinator": coordinator, "all_reduce_gradients_ms": ms,
            "values_ok": bool(np.array_equal(reduced, grads[0] + grads[1]))}


def wire_reference_steps(dev, data, flat0, steps):
    """The same batches through one device's plain MLP with autograd: each
    rank's shard a mean cross-entropy, their average the loss, SGD on the
    module's parameters."""
    from dsml_tpu_torch.models.mlp import MLP
    from dsml_tpu_torch.utils.data import shard_batches

    model = MLP(device=dev)
    with torch.no_grad():
        for name, v in model.unflatten(torch.from_numpy(flat0.copy()).to(dev)).items():
            getattr(model, name).copy_(v)
    for step, (x, y) in enumerate(shard_batches(data.train_x, data.train_y, WIRE_BATCH, seed=1)):
        if step == steps:
            break
        shard = x.shape[0] // WIRE_DEVICES
        xs = torch.from_numpy(x).to(dev)
        ys = torch.from_numpy(y.astype(np.int64)).to(dev)
        loss = sum(F.cross_entropy(model(xs[r * shard:(r + 1) * shard]),
                                   ys[r * shard:(r + 1) * shard])
                   for r in range(WIRE_DEVICES)) / WIRE_DEVICES
        model.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= WIRE_LR * p.grad
    return model.flatten().cpu().numpy()


def wire_migration(dev, weights):
    """GPT-2-small's seed-0 f32 weights from a StateDonor to a
    ShardMigrator over gRPC between two servers on the card: every leaf
    under ``DSML_CHAOS_WIRE=drop@1`` (the first push truncated: it must
    resume), then one leaf under ``corrupt@*`` (it must raise)."""
    from dsml_tpu_torch.comm.device_server import serve_device
    from dsml_tpu_torch.comm.migration import MigrationConfig, MigrationError, ShardMigrator
    from dsml_tpu_torch.runtime import chaos

    biggest = max(t.numel() * t.element_size() for t in weights.values())
    mem = 4 * biggest  # landing in the lower half, the donor's staging in the upper
    recv = serve_device(91, mem_size=mem, device=dev)
    donor = serve_device(92, mem_size=mem, device=dev)
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    out = {}
    try:
        n = donor.runtime.donor.register_state(dict(weights), prefix="gpt2", version=0)
        mig = ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                            config=MigrationConfig(timeout_s=120.0), local_address=recv.address,
                            expect_version=0)
        os.environ["DSML_CHAOS_WIRE"] = "drop@1"
        chaos.set_wire_fault_plan(chaos.WireFaultPlan.parse(os.environ["DSML_CHAOS_WIRE"]))
        t0 = time.perf_counter()
        same, nbytes = True, 0
        for key, t in weights.items():
            got = mig.fetch_piece(f"gpt2/{key}", [[0, s] for s in t.shape], "float32")
            same &= torch.equal(got, t)
            nbytes += t.numel() * t.element_size()
        secs = time.perf_counter() - t0
        out["drop"] = {"leaves": n, "bytes": nbytes, "seconds": secs,
                       "mb_per_s": nbytes / secs / 1e6, "bit_for_bit": bool(same),
                       "fired": chaos.wire_fault_plan().fired, **mig.stats}
        os.environ["DSML_CHAOS_WIRE"] = "corrupt@*"
        chaos.set_wire_fault_plan(chaos.WireFaultPlan.parse(os.environ["DSML_CHAOS_WIRE"]))
        small = ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                              config=MigrationConfig(timeout_s=30.0, retries=1),
                              local_address=recv.address)
        key = "wpe"
        try:
            small.fetch_piece(f"gpt2/{key}", [[0, s] for s in weights[key].shape], "float32")
            out["corrupt"] = {"raised": None}
        except MigrationError as e:
            out["corrupt"] = {"raised": "MigrationError", "message": str(e)[:160],
                              "integrity_failures": small.stats["integrity_failures"]}
        small.close()
        mig.close()
    finally:
        del os.environ["DSML_CHAOS_WIRE"]
        chaos.set_wire_fault_plan(None)
        recv.stop()
        donor.stop()
    return out


def wire_handoff(dev):
    """One GPT-2-small f32 fleet (1 prefill worker, 1 decode batcher)
    drained twice: the handoffs in process, then each published on a
    device server's StateDonor and pulled by another's ShardMigrator."""
    from dsml_tpu_torch.comm.device_server import serve_device
    from dsml_tpu_torch.comm.migration import MigrationConfig, ShardMigrator
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.serving import build_fleet, stream_transport

    model = gpt2_small(GPT2Config.small(), dev)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 50257, n).astype(np.int64) for n in WIRE_HANDOFF_PROMPTS]
    recv = serve_device(93, mem_size=1 << 26, device=dev)
    donor = serve_device(94, mem_size=1 << 26, device=dev)
    peers = {0: recv.address, 1: donor.address}
    recv.runtime.configure_peers(peers, 0)
    donor.runtime.configure_peers(peers, 1)
    mig = ShardMigrator(recv.runtime, 0, [(1, donor.address)],
                        config=MigrationConfig(timeout_s=60.0), local_address=recv.address)
    toks, secs = {}, {}
    try:
        for name, transport in (("in_process", None),
                                ("stream", stream_transport(donor.runtime.donor, mig))):
            router = build_fleet(model, n_prefill=1, n_decode=1, prefill_chunk=PAGED_CHUNK,
                                 n_slots=2, transport=transport)
            t0 = time.perf_counter()
            frids = [router.submit(p, WIRE_HANDOFF_TOKENS) for p in prompts]
            out = router.run()
            secs[name] = time.perf_counter() - t0
            toks[name] = [list(map(int, out[f])) for f in frids]
    finally:
        mig.close()
        recv.stop()
        donor.stop()
    return {"requests": len(prompts), "new_tokens": WIRE_HANDOFF_TOKENS, "dtype": "float32",
            "tokens_equal": toks["stream"] == toks["in_process"], "seconds": secs,
            "pulled": mig.stats, "donor_keys_left": len(donor.runtime.donor.keys())}


def phase_wire(dev, card):
    """The reference's own workload over the port's wire: the MNIST MLP
    (784-128-64-10) trained data-parallel through 3 device servers on the
    card and the coordinator, over gRPC on localhost (``PipelineClient``,
    ``cli/train_mnist_wire.py``'s loop), 300 steps at batch 64 and lr 0.1
    from a seed-0 MLP: steps/s, samples/s, the first and last loss, the
    2000-image holdout's accuracy. The flat weights after 20 steps equal,
    bit for bit, those of the same 20 steps driven through the runtimes
    directly (``LocalClient``), and one device's plain MLP with autograd
    within TOL_WIRE_AUTOGRAD. The median ms of each RPC, the 4 MiB stream's
    MB/s, the native runtime against its Python versions, a GPT-2-small
    migration under ``drop@1`` and ``corrupt@*``, a cross-host fleet
    handoff, and the launchers as processes."""
    import grpc
    import google.protobuf

    from dsml_tpu_torch.cli.train_mnist_wire import (
        AVG, GRAD_ADDR, INPUT_ADDR, LOGITS_ADDR, LocalClient, accuracy, train_wire)
    from dsml_tpu_torch.comm.client import PipelineClient
    from dsml_tpu_torch.comm.coordinator import serve_coordinator
    from dsml_tpu_torch.comm.device_server import serve_local_devices
    from dsml_tpu_torch.models.mlp import MLP
    from dsml_tpu_torch.runtime import native
    from dsml_tpu_torch.utils import crc32c as tcrc
    from dsml_tpu_torch.utils.data import load_mnist

    t_phase = time.perf_counter()
    procs = []
    try:
        native.reset_calls()
        data = load_mnist()
        idx_calls = native.CALLS["ds_idx_parse"]
        model = MLP(device=dev)
        flat0 = model.init(0).flatten().cpu().numpy()
        handles = serve_local_devices(WIRE_DEVICES, mem_size=WIRE_MEM, model=model,
                                      device=None if dev.type == "cuda" else dev)
        coordinator = serve_coordinator()
        client = PipelineClient.connect(coordinator.address, [h.address for h in handles])
        at_check = {}

        def on_step(step, flat, losses):
            if step == WIRE_CHECK_STEPS:
                at_check["flat"] = flat.copy()

        native.reset_calls()
        run = train_wire(client, data, flat0, steps=WIRE_STEPS, batch_size=WIRE_BATCH,
                         lr=WIRE_LR, on_step=on_step)
        train_calls = dict(native.CALLS)
        acc = accuracy(model, run["flat"], data.test_x, data.test_y)
        # the same 20 steps on the runtimes directly: the calls the servicers make
        rt = coordinator.runtime
        comm = rt.comm_init(WIRE_DEVICES, [h.address for h in handles])
        direct = train_wire(LocalClient(rt, [h.runtime for h in handles], comm.comm_id), data,
                            flat0, steps=WIRE_CHECK_STEPS, batch_size=WIRE_BATCH, lr=WIRE_LR)
        ref = wire_reference_steps(dev, data, flat0, WIRE_CHECK_STEPS)
        autograd_err = float(np.abs(ref - at_check["flat"]).max())

        # the median of each RPC
        w = run["flat"].tobytes()
        rpc = {"memcpy_h2d_437544_b": median_ms(lambda: client.write(0, 0x300000, w)),
               "memcpy_d2h_437544_b": median_ms(lambda: client.read(0, 0x300000, len(w))),
               "run_forward": median_ms(lambda: client.run_forward(0, INPUT_ADDR, LOGITS_ADDR))}
        dl = np.full((WIRE_BATCH // WIRE_DEVICES, 10), 0.01, np.float32)
        rpc["run_backward"] = median_ms(lambda: client.run_backward(0, GRAD_ADDR),
                                        setup=lambda: client.write(0, GRAD_ADDR, dl))
        for r in range(WIRE_DEVICES):
            client.write(r, GRAD_ADDR, w)
        rpc["all_reduce_ring_avg_3_ranks"] = median_ms(
            lambda: client.all_reduce_ring(len(w), op=AVG,
                                           mem_addrs={r: GRAD_ADDR for r in range(WIRE_DEVICES)}))
        # staged in process: one 4 MiB Memcpy would exceed gRPC's 4 MiB message cap
        # (the stream itself moves 256 KiB chunks)
        payload = np.random.default_rng(4).integers(0, 256, WIRE_STREAM_BYTES, dtype=np.uint8)
        handles[0].runtime.memcpy_h2d(0x400000, payload)

        def stream():
            sid = client.begin_send(0, 0x400000, WIRE_STREAM_BYTES, dst_rank=1)
            client.begin_receive(1, sid, 0x900000, WIRE_STREAM_BYTES, src_rank=0)
            while client.stream_status(1, sid) == 0:  # IN_PROGRESS
                time.sleep(0.0005)
            return client.stream_status(1, sid)

        rpc["stream_4_mib"] = median_ms(stream, reps=5)
        stream_ok = stream() == 1 and handles[1].runtime.read_bytes(
            0x900000, WIRE_STREAM_BYTES) == payload.tobytes()
        client.finalize()
        coordinator.stop()
        for h in handles:
            h.stop()
        del handles, coordinator, client

        # the launchers boot (after the timed wire run: their start competes
        # for the host's cores) while the native runtime, the migration and
        # the handoff run
        procs = launcher_start()
        # the native runtime against its plain Python versions
        rows = np.random.default_rng(5).standard_normal((WIRE_DEVICES, model.n_params)) \
            .astype(np.float32)
        red_ms = median_ms(lambda: native.reduce_f32(rows, AVG))
        red_py_ms = median_ms(lambda: native.reduce_f32_py(rows, AVG), reps=5)
        blob = payload.tobytes()
        crc_ms = median_ms(lambda: tcrc.crc32c(blob), reps=5)
        mib = blob[: 1 << 20]
        t0 = time.perf_counter()
        crc_py = tcrc.crc32c_py(mib)
        crc_py_ms = (time.perf_counter() - t0) * 1e3
        natives = {
            "ds_reduce_f32": {"rows": list(rows.shape), "ms": red_ms, "python_ms": red_py_ms,
                              "mb_per_s": rows.nbytes / red_ms / 1e3,
                              "python_mb_per_s": rows.nbytes / red_py_ms / 1e3,
                              "equal": bool(np.array_equal(native.reduce_f32(rows, AVG).view(
                                  np.uint32), native.reduce_f32_py(rows, AVG).view(np.uint32)))},
            "ds_crc32c": {"bytes": len(blob), "ms": crc_ms, "python_bytes": len(mib),
                          "python_ms": crc_py_ms, "mb_per_s": len(blob) / crc_ms / 1e3,
                          "python_mb_per_s": len(mib) / crc_py_ms / 1e3,
                          "equal": tcrc.crc32c(mib) == crc_py}}
        native.reset_calls()
        migration = wire_migration(dev, gpt2_small_weights())
        migration_calls = dict(native.CALLS)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        handoff = wire_handoff(dev)
        launchers = launcher_check(procs)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    losses = run["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    row = {"phase": "wire", "model": "mnist-mlp-784-128-64-10", "transport": "grpc",
           "grpc": grpc.__version__, "protobuf": google.protobuf.__version__,
           "device_servers": WIRE_DEVICES, "servers_on": str(dev), "batch": WIRE_BATCH,
           "lr": WIRE_LR, "steps": run["steps"], "train_seconds": run["seconds"],
           "steps_per_s": run["steps"] / run["seconds"],
           "samples_per_s": run["steps"] * WIRE_BATCH / run["seconds"],
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_first10_mean": first, "loss_last10_mean": last,
           "holdout_accuracy": acc, "holdout_images": int(data.test_x.shape[0]),
           f"wire_equals_direct_after_{WIRE_CHECK_STEPS}_steps":
               at_check["flat"].tobytes() == direct["flat"].tobytes(),
           "autograd_max_abs_err": autograd_err, "autograd_tol": TOL_WIRE_AUTOGRAD,
           "rpc_median_ms": rpc, "stream_4_mib_mb_per_s": WIRE_STREAM_BYTES / rpc[
               "stream_4_mib"] / 1e3, "stream_bytes_ok": stream_ok,
           "native_calls": {"load_mnist_ds_idx_parse": idx_calls, "train": train_calls,
                            "migration": migration_calls},
           "native": natives, "migration": migration, "handoff": handoff,
           "launchers": launchers, "phase_seconds": time.perf_counter() - t_phase,
           "card": card}
    emit(row)
    check(all(np.isfinite(losses)) and last < first, f"the wire run's loss did not fall: "
                                                     f"{first} -> {last}")
    check(acc >= 0.85, f"the wire run's holdout accuracy {acc}")
    check(row[f"wire_equals_direct_after_{WIRE_CHECK_STEPS}_steps"],
          "the wire run's weights differ from the direct runtime run's")
    check(autograd_err <= TOL_WIRE_AUTOGRAD,
          f"the wire run against the autograd reference: {autograd_err}")
    check(stream_ok, "the 4 MiB stream did not arrive byte for byte")
    check(idx_calls >= 2 and train_calls["ds_reduce_f32"] >= WIRE_STEPS
          and train_calls["ds_prefetch_next"] >= WIRE_STEPS
          and migration_calls["ds_crc32c"] > 0,
          f"the native runtime's calls: {row['native_calls']}")
    check(natives["ds_reduce_f32"]["equal"] and natives["ds_crc32c"]["equal"],
          f"native against Python: {natives}")
    check(migration["drop"]["bit_for_bit"] and migration["drop"]["resumed"] >= 1
          and migration["drop"]["fired"] and migration["drop"]["fired"][0]["action"] == "drop",
          f"the drop@1 migration: {migration['drop']}")
    check(migration["corrupt"]["raised"] == "MigrationError",
          f"the corrupt@* migration: {migration['corrupt']}")
    check(handoff["tokens_equal"] and handoff["donor_keys_left"] == 0,
          f"the cross-host handoff: {handoff}")
    check(launchers["values_ok"], f"the launched cluster's all-reduce: {launchers}")


def phase_serve_cli(dev):
    from dsml_tpu_torch.cli import serve_continuous
    from dsml_tpu_torch.ops import paged_attention as tpa

    tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
    out = serve_continuous.main(["--model", "small", "--paged_kv", "int4", "--prefill_chunk", "64",
                                 "--requests", "16"])
    counts = paged_counts(tpa)
    emit({"phase": "serve_cli", "entry": "python -m dsml_tpu_torch.cli.serve_continuous",
          **out, "launches": counts})
    check(counts["paged_attn_pipelined"] > 0 and counts["paged_attn_pipelined"] % 12 == 0
          and out["free_pages"] == out["n_pages"] - 1,
          f"the serve_continuous entry point: launches {counts}, result {out}")


# ---- quantized serving weights (kernel 7) and int8 remat (kernel 8) ------------

QMM_SOURCE = "dsml_tpu_torch/ops/csrc/qmm.cu"
QUANT8_SOURCE = "dsml_tpu_torch/ops/csrc/quantize_int8.cu"
Q8_BUCKET_ELEMS = (4 << 20) // 2  # the q8 sync's 4 MiB bf16 bucket
# GPT-2-small's four block projections: (contraction d, trailing shape)
PROJECTIONS = {"wqkv": (768, (3, 768)), "wo": (768, (768,)), "w_in": (768, (3072,)),
               "w_out": (3072, (768,))}
QMM_ROWS = {"decode": PAGED_SLOTS, "chunk": PAGED_CHUNK, "ragged": 7, "one": 1, "decode_plus_one": 17,
            "ragged_chunks": 300}
# qmm against its plain version: both sum in f32 from the same inputs, in
# another order; relative to the largest |output| (the JAX suite's bound
# for its fused matmul, tests/test_quantization.py)
TOL_QMM = 1e-5
WQ_INT4_REQUESTS = 24  # the paged row's first 24 (cut from 48: the run's time)
WQ_INT8_REQUESTS = 16
KERNEL_TIMES = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
TRAIN_F32_B = 2
TOL_INT8_REMAT_GRADS = 0.1  # the JAX suite's bound for int8 remat (tests/test_gpt2.py)


def kernel_event_ms(fn, pattern, expect: int, groups) -> list[float]:
    """Device ms of each launch of the kernels whose name holds
    ``pattern`` while ``fn`` runs, in launch order, from a profiler trace.
    The card's traces sometimes lose an event: a trace counts only when it
    holds the ``expect`` launches ``fn`` makes (an event held twice counts
    once), and is taken again otherwise, up to ``PROFILER_TRIES`` times;
    ``groups`` lists ``fn``'s launches in order as (one call, calls) pairs:
    after that each call is timed by CUDA events (:func:`events_ms_per_call`)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = sorted({(e.time_range.start, e.time_range.end, e.time_range.elapsed_us() / 1e3)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA and pattern in e.name})
        if len(events) == expect:
            return [ms for *_, ms in events]
    why = f"{len(events)} {pattern} launches traced, expected {expect}"
    return [ms for call, n in groups for ms in [events_ms_per_call(call, n, pattern, why)] * n]


def bound(nbytes, ops, peak_ops):
    """(least ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over ``peak_ops``."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qmm_bound_ms(x, qwt):
    """Least time of one quantized_matmul: x read once in its type, the
    packed codes and the scales once, the f32 out written once; 2·m·d·n
    operations at the peak of x's type."""
    m, d = x.shape
    n = int(np.prod(qwt.shape[1:]))
    nbytes = x.numel() * x.element_size() + qwt.qw.nbytes + qwt.qs.nbytes + m * n * 4
    return bound(nbytes, 2.0 * m * d * n, PEAK_FLOPS[x.dtype])


def phase_kernel_qmm(dev):
    """quantized_matmul's kernel against _qmm_reference at GPT-2-small's four
    projections (wqkv in its 3-D form) and a kb = 40 weight (d = 200, block
    40: kb % 16 == 8, ragged n = 130) × rows {16, 256, 7, 1, 17, 300} (both
    regimes, ragged both ways) × {int8, int4} × x {f32, bf16}, each case
    called twice for identical bits; the integer-exact case in f32 and bf16
    x bit for bit against ``x @ w`` and the plain version."""
    from dsml_tpu_torch.ops import quantization as tq

    gen = torch.Generator(device=dev).manual_seed(5)
    weights = {name: torch.randn(d, *rest, generator=gen, device=dev) * 0.02
               for name, (d, rest) in PROJECTIONS.items()}
    weights["kb40"] = torch.randn(200, 130, generator=gen, device=dev) * 0.02
    main_err = 0.0
    for name, w in weights.items():
        for scheme in ("int8", "int4"):
            qwt = tq.quantize_weight_blocks(w, scheme, 40 if name == "kb40" else None)
            worst, cases, identical = 0.0, 0, True
            for rows in QMM_ROWS.values():
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(rows, qwt.shape[0], generator=gen, device=dev).to(dtype)
                    got = tq.quantized_matmul(x, qwt)
                    again = tq.quantized_matmul(x, qwt)
                    torch.cuda.synchronize()
                    ref = tq._qmm_reference(x, qwt)
                    err = (got - ref).abs().max().item()
                    rel = err / max(ref.abs().max().item(), 1e-30)
                    same = bool(torch.equal(got, again))
                    check(got.shape == ref.shape and bool(torch.isfinite(got).all()) and rel <= TOL_QMM
                          and same,
                          f"qmm disagrees with its plain version ({name}, {scheme}, rows {rows}, {dtype}): "
                          f"max abs err {err}, {rel} of max |ref|; a second call identical: {same}")
                    worst, cases, identical = max(worst, rel), cases + 1, identical and same
                    if name != "kb40" and (scheme, dtype, rows) == ("int4", torch.bfloat16,
                                                                    QMM_ROWS["decode"]):
                        main_err = max(main_err, err)
            emit({"phase": "kernel_qmm", "kernel": "qmm", "projection": name, "scheme": scheme,
                  "weight_shape": list(qwt.shape), "kb": qwt.block, "nb": qwt.qs.shape[0],
                  "rows": list(QMM_ROWS.values()), "x_dtypes": ["float32", "bfloat16"], "cases": cases,
                  "max_err_over_max_abs": worst, "tol": TOL_QMM, "second_call_identical": identical,
                  "ok": True})

    # bf16 x that the wrapper pads for the tensor-core body: d % 4 != 0 (d =
    # 201), and a view 2 bytes off an 8-byte boundary
    w = torch.randn(201, 96, generator=gen, device=dev) * 0.02
    buf = torch.randn(16 * 768 + 1, generator=gen, device=dev).to(torch.bfloat16)
    padded = {"odd_d": (torch.randn(16, 201, generator=gen, device=dev).to(torch.bfloat16), w),
              "misaligned": (buf[1:].view(16, 768), weights["wo"])}
    for case, (x, w) in padded.items():
        for scheme in ("int8", "int4"):
            qwt = tq.quantize_weight_blocks(w, scheme)
            got, again = tq.quantized_matmul(x, qwt), tq.quantized_matmul(x, qwt)
            ref = tq._qmm_reference(x, qwt)
            rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
            emit({"phase": "kernel_qmm", "case": case, "scheme": scheme, "x_shape": list(x.shape),
                  "x_offset_bytes": x.data_ptr() % 16, "max_err_over_max_abs": rel,
                  "second_call_identical": bool(torch.equal(got, again))})
            check(rel <= TOL_QMM and bool(torch.equal(got, again)),
                  f"qmm on padded bf16 x ({case}, {scheme}): {rel} of max |ref|")

    # the integer-exact case (tests/test_quantization.py): scales of 1, integer
    # x in [-8, 8] (exact in bf16 too)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.integers(-8, 9, (5, 96)), dtype=torch.float32, device=dev)
    exact = {}
    for scheme, qmax in (("int8", 127), ("int4", 7)):
        w = torch.as_tensor(rng.integers(-qmax, qmax + 1, (96, 160)), dtype=torch.float32, device=dev)
        w[0::32] = qmax
        qwt = tq.quantize_weight_blocks(w, scheme, 32)
        for dtype in (torch.float32, torch.bfloat16):
            got = tq.quantized_matmul(x.to(dtype), qwt)
            exact[f"{scheme}_{str(dtype)[6:]}"] = (
                bool(torch.equal(got, x @ w)) and bool(torch.equal(got, tq._qmm_reference(x.to(dtype), qwt)))
                and bool(torch.equal(got, tq.quantized_matmul(x.to(dtype), qwt))))
    emit({"phase": "kernel_qmm", "case": "integer_exact", "shape": [5, 96, 160], "block": 32,
          "torch_equal": exact})
    check(all(exact.values()), f"qmm is not exact on the integer case: {exact}")
    return main_err


def qmm_time(dev):
    """Every projection's qmm time at the decode and chunk shapes, bf16 x,
    both codecs, with bounds, the plain version and bf16 ``torch.matmul``
    against the dense weight (the same product without the codec), which
    the port never calls. Uses only ``quantized_matmul``, its plain version
    and ``torch.matmul``, so a parent tree runs it too (``python3
    chip_smoke.py qmm_time``)."""
    from dsml_tpu_torch.ops import quantization as tq

    gen = torch.Generator(device=dev).manual_seed(5)
    weights = {name: torch.randn(d, *rest, generator=gen, device=dev) * 0.02
               for name, (d, rest) in PROJECTIONS.items()}
    qweights = {(name, scheme): tq.quantize_weight_blocks(w, scheme)
                for name, w in weights.items() for scheme in ("int8", "int4")}
    reps, timing, configs = 20, {}, []
    for shape in ("decode", "chunk"):
        for (name, scheme), qwt in qweights.items():
            x = torch.randn(QMM_ROWS[shape], qwt.shape[0], generator=gen, device=dev).to(torch.bfloat16)
            configs.append((shape, name, scheme, qwt, x))
    ms = kernel_event_ms(lambda: [tq.quantized_matmul(x, qwt) for *_, qwt, x in configs
                                  for _ in range(reps)], "qmm_kernel<", reps * len(configs),
                         [(functools.partial(tq.quantized_matmul, x, qwt), reps)
                          for *_, qwt, x in configs])
    for i, (shape, name, scheme, qwt, x) in enumerate(configs):
        dense = weights[name].reshape(qwt.shape[0], -1).to(torch.bfloat16)
        bound_ms, bound_by = qmm_bound_ms(x, qwt)
        # the yardstick's device time, as the kernel's (its kernels summed per call)
        library = device_kernel_ms(lambda: [torch.matmul(x, dense) for _ in range(reps)])
        timing.setdefault(scheme, {}).setdefault(shape, {})[name] = {
            "ms": statistics.median(ms[i * reps:(i + 1) * reps]),
            "wrapper_ms": cuda_ms(lambda: tq.quantized_matmul(x, qwt)),
            "plain_ms": cuda_ms(lambda: tq._qmm_reference(x, qwt)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(library.values()) / reps,
            "library_wrapper_ms": cuda_ms(lambda: torch.matmul(x, dense))}
    per_tick = {scheme: {shape: {key: sum(row[key] for row in by_shape[shape].values()) * 12
                                 for key in ("ms", "bound_ms", "library_ms")}
                         for shape in by_shape} for scheme, by_shape in timing.items()}
    emit({"phase": "kernel_time", "kernel": "qmm", "x_dtype": "bfloat16",
          "rows": {k: QMM_ROWS[k] for k in ("decode", "chunk")}, "timing": timing,
          "sum_of_12_layers": per_tick,
          "library": "torch.matmul(x, W) against the dense bf16 weight: the same product "
                     "without the codec (no PyTorch call takes this codec); ms and library_ms "
                     "are profiler device times, *_wrapper_ms and plain_ms CUDA events around "
                     "one call"})
    return timing["int4"]["decode"]["wqkv"]


# TinyLlama-1.1B's projections (contraction d, trailing shape): q, k and v
# as one wqkv (32 query and 2 x 4 kv heads of 64), the MLP's gate and up
# (each [2048, 5632]) and down
LLAMA_PROJECTIONS = {"wqkv": (2048, (2048 + 2 * 256,)), "w_gate": (2048, (5632,)),
                     "w_down": (5632, (2048,))}


def qmm_llama(dev):
    """Kernel 7 at TinyLlama-1.1B's int4 and int8 wqkv and MLP shapes, 16
    decode rows and a 256-row chunk, f32 and bf16 x, each against its plain
    version (twice, identical bits); then the bf16-x times beside the bytes
    bound and bf16 ``torch.matmul`` against the dense weight (the L: path of
    the kernels line). A kernel check, not a serving run. Returns the
    largest relative error and the times."""
    from dsml_tpu_torch.ops import quantization as tq

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {"decode": PAGED_SLOTS, "chunk": PAGED_CHUNK}
    worst, configs = 0.0, []
    for name, (d, rest) in LLAMA_PROJECTIONS.items():
        w = torch.randn(d, *rest, generator=gen, device=dev) * 0.02
        for scheme in ("int8", "int4"):
            qwt = tq.quantize_weight_blocks(w, scheme)
            for shape, m in rows.items():
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
                    got, again = tq.quantized_matmul(x, qwt), tq.quantized_matmul(x, qwt)
                    ref = tq._qmm_reference(x, qwt)
                    rel = (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
                    same = bool(torch.equal(got, again))
                    check(rel <= TOL_QMM and same and bool(torch.isfinite(got).all()),
                          f"qmm at TinyLlama's {name} ({scheme}, {shape}, {dtype}): {rel} of "
                          f"max |ref|, a second call identical: {same}")
                    worst = max(worst, rel)
                    if dtype == torch.bfloat16:
                        configs.append((name, scheme, shape, qwt, x, w))
    reps = 20
    ms = kernel_event_ms(lambda: [tq.quantized_matmul(x, qwt) for _, _, _, qwt, x, _ in configs
                                  for _ in range(reps)], "qmm_kernel<", reps * len(configs),
                         [(functools.partial(tq.quantized_matmul, x, qwt), reps)
                          for _, _, _, qwt, x, _ in configs])
    timing = {}
    for i, (name, scheme, shape, qwt, x, w) in enumerate(configs):
        dense = w.reshape(qwt.shape[0], -1).to(torch.bfloat16)
        bound_ms, bound_by = qmm_bound_ms(x, qwt)
        library = device_kernel_ms(lambda: [torch.matmul(x, dense) for _ in range(reps)])
        timing.setdefault(scheme, {}).setdefault(shape, {})[name] = {
            "ms": statistics.median(ms[i * reps:(i + 1) * reps]),
            "plain_ms": cuda_ms(lambda: tq._qmm_reference(x, qwt)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(library.values()) / reps}
    emit({"phase": "kernel_time", "path": "L", "kernel": "qmm", "x_dtype": "bfloat16",
          "rows": rows, "projections": {k: [d, *r] for k, (d, r) in LLAMA_PROJECTIONS.items()},
          "max_err_over_max_abs": worst, "tol": TOL_QMM, "timing": timing,
          "library": "torch.matmul(x, W) against the dense bf16 weight; ms and library_ms are "
                     "profiler device times (events per call if a trace loses launches), "
                     "plain_ms CUDA events around one call"})
    return worst, timing


# the elasticity legs' attention: a dp = 4 rank's share of the 8 x 1024 step
# (2 rows of GPT-2-small's 12 heads)
E_SHAPE = (2 * 12, 1024, 64)


def elastic_kernel_time(tflash, dev):
    """Kernels 1-3 at a dp = 4 rank's attention in the elasticity legs
    ([24, 1024, 64] causal bf16: GPT-2-small, 2 rows a rank): each against
    its plain version, then profiler device times beside the bounds, the
    plain versions and SDPA (the E: path of the kernels line)."""
    gen = torch.Generator(device=dev).manual_seed(22)
    bh, s, d = E_SHAPE
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = tflash.flash_fwd(q, k, v, True)
    ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, True)
    err = (out.float() - ref_out.float()).abs().max().item()
    check(err <= TOL[torch.bfloat16]["out"], f"flash_fwd at the E: shape: {err}")
    grads = tflash.flash_bwd(q, k, v, out, lse, do)
    want = tflash._flash_bwd_reference(q, k, v, out, lse, do)
    rel = max((g.float() - w.float()).abs().max().item() / max(w.float().abs().max().item(), 1e-30)
              for g, w in zip(grads, want))
    check(rel <= TOL_BWD[torch.bfloat16], f"flash_bwd at the E: shape: {rel}")
    q4, k4, v4, do4 = (t.view(bh // 12, 12, s, d).detach().requires_grad_() for t in (q, k, v, do))

    def sdpa(backward):
        o = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        if backward:
            torch.autograd.grad(o, (q4, k4, v4), do4)

    sdpa_fwd = device_ms(functools.partial(sdpa, False), reps=10)
    fwd_bound = attention_bound_ms(bh, s, s, d, torch.bfloat16, True)
    timing = {"flash_fwd": {
        "ms": device_ms(functools.partial(tflash.flash_fwd, q, k, v, True),
                        pattern="flash_fwd_kernel<"),
        "plain_ms": device_ms(functools.partial(tflash._flash_fwd_reference, q, k, v, True)),
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": sdpa_fwd}}
    call = functools.partial(tflash.flash_bwd, q, k, v, out, lse, do)
    plain_bwd = device_ms(functools.partial(tflash._flash_bwd_reference, q, k, v, out, lse, do),
                          reps=10)
    library_bwd = device_ms(functools.partial(sdpa, True), reps=10) - sdpa_fwd
    for name, products, n_out in zip(BWD_KERNELS[torch.bfloat16], (3, 4), (1, 2)):
        bound_ms, bound_by = backward_bound_ms(bh, s, s, d, torch.bfloat16, True, products, n_out)
        timing[name] = {"ms": device_ms(call, reps=10, pattern=f"{name}_kernel<"),
                        "plain_ms": plain_bwd, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_bwd}
    emit({"phase": "kernel_time", "path": "E", "shape": list(E_SHAPE), "dtype": "bfloat16",
          "causal": True, "max_abs_err_fwd": err, "max_err_over_max_abs_bwd": rel, **timing,
          "note": "profiler device times; the backward's plain_ms and library_ms are whole "
                  "backwards (dq, dk and dv); library_ms is SDPA (backward: forward+backward "
                  "minus forward)"})
    return timing


# Instruction rates of one H100 SM per clock, by pipe (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0): 4
# schedulers issue one warp instruction each (128 lanes); f32 add, multiply
# and fma 128; 32-bit integer multiply-add (which shares the fma pipe) 64;
# logic, shift, compare and min/max 64; conversions other than 8/16 → 32-bit
# integer, and MUFU, 16. An opcode may load two pipes (IMAD: "fma" and
# "imad"); pipes kept apart where the guide does not say they share keep
# the bound a lower one.
LANES_PER_CLOCK = 128
PIPES = {"fma": (128, {"FFMA", "FADD", "FMUL", "IMAD"}),
         "imad": (64, {"IMAD"}),
         "alu": (64, {"LOP3", "SHF", "FMNMX", "I2FP", "FCHK"}),
         "conv": (16, {"FRND", "F2I"}),
         "mufu": (16, {"MUFU"})}
# The operations quantize_int8's function defines per element, as (what,
# count, opcode), the two IEEE divisions apart: a bf16 element's widening,
# its share of the 511 maxima of its block's absmax (|x| is an operand
# modifier), the counter hash (the index multiply-add (lo + 1)·0x9E3779B9,
# the xors with the key and with hi(g), two mix32 of 3 shifts, 3 xors and
# 2 multiplies each, the key's own mix32 shared by a thread's 4 elements,
# bits >> 8), u's conversion and scaling, the add, floor, the clamp and the
# conversion to int8. Left out: index, address and bounds arithmetic,
# loads, stores, shuffles and barriers.
QUANT8_OPS = [("bf16 -> f32 (a 16-bit shift)", 1, "SHF"),
              ("absmax: max of |x| (511 per 512 elements)", 511 / 512, "FMNMX"),
              ("hash: (lo + 1) * 0x9E3779B9", 1, "IMAD"),
              ("hash: xor with the key and with hi(g)", 2, "LOP3"),
              ("hash: two mix32, shifts", 6, "SHF"), ("hash: two mix32, xors", 6, "LOP3"),
              ("hash: two mix32, multiplies", 4, "IMAD"),
              ("the key's mix32 over 4 elements, shifts", 3 / 4, "SHF"),
              ("the key's mix32 over 4 elements, xors", 3 / 4, "LOP3"),
              ("the key's mix32 over 4 elements, multiplies", 2 / 4, "IMAD"),
              ("bits >> 8", 1, "SHF"), ("u: u32 -> f32", 1, "I2FP"), ("u: * 2^-24", 1, "FMUL"),
              ("x / scale + u: the add", 1, "FADD"), ("floor", 1, "FRND"),
              ("clamp to [-127, 127]", 2, "FMNMX"), ("f32 -> int8", 1, "F2I")]
DIVISION_OPS = ("FFMA", "MUFU", "FCHK")  # the only opcodes of an IEEE division's fast path


def quant8_division(tool, build):
    """The average IEEE division of quantize_int8_kernel<bf16> in its SASS:
    every FFMA, MUFU and FCHK up to the first EXIT (no other operation of the
    kernel uses them; the slow path's subroutine lies after the EXIT), over
    its FCHKs, one a division → {opcode: instructions a division}."""
    res = subprocess.run([tool, "-sass", str(build._target("quantize_int8"))], capture_output=True,
                         text=True, check=False)
    check(res.returncode == 0, f"cuobjdump -sass quantize_int8 failed ({res.returncode}): {res.stderr[-2000:]}")
    bodies = [body for name, body in (chunk.split("\n", 1) for chunk in res.stdout.split("Function : ")[1:])
              if "quantize_int8_kernelI13__nv_bfloat16" in name]
    check(len(bodies) == 1, f"{len(bodies)} bf16 quantize_int8 kernels in the SASS")
    ops = dict.fromkeys(DIVISION_OPS, 0)
    for line in bodies[0].splitlines():
        m = re.search(r"/\*[0-9a-f]{4,5}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and m.group(1) == "EXIT":
            break
        if m and m.group(1) in ops:
            ops[m.group(1)] += 1
    check(ops["FCHK"] > 0, "no FCHK (IEEE division) in quantize_int8's SASS")
    return {op: n / ops["FCHK"] for op, n in ops.items()}


def quant8_operations(division):
    """Per element, by opcode: ``QUANT8_OPS`` and the divisions, x / scale
    and 1/512 of absmax / 127, each ``division``'s instructions."""
    ops: dict[str, float] = {}
    for _, n, op in QUANT8_OPS:
        ops[op] = ops.get(op, 0) + n
    for op, n in division.items():
        ops[op] = ops.get(op, 0) + n * (1 + 1 / 512)
    return ops


def quant8_bound_ms(x, ops, sm_clock_hz, sms):
    """Least time of one quantize_int8: the larger of the bytes (x read once
    in its type, the int8 codes and f32 scales of every 512-element block
    written once) over the memory rate and the function's operations per
    element (``quant8_operations``) over the card's issue rate and each
    pipe's own (``PIPES``), ``sms`` SMs at ``sm_clock_hz`` → (ms, "bytes" |
    "operations", SM cycles per element by pipe)."""
    rows = -(-x.numel() // 512)
    nbytes = x.numel() * x.element_size() + rows * 512 + rows * 4
    cycles = {"issue": sum(ops.values()) / LANES_PER_CLOCK}
    for pipe, (rate, names) in PIPES.items():
        cycles[pipe] = sum(n for op, n in ops.items() if op in names) / rate
    worst = max(cycles, key=cycles.get)
    t_ops = cycles[worst] * x.numel() / (sms * sm_clock_hz) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes", cycles) if t_bytes >= t_ops else (t_ops, "operations", cycles)


def sm_clock_max_hz():
    out = subprocess.run(["nvidia-smi", f"--id={torch.cuda.current_device()}", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.strip()) * 1e6


def phase_kernel_quant8(dev):
    """quantize_int8's kernel against _quantize_int8_reference bit for bit
    (values and scales) at the train step's block input [8, 1024, 768] in
    bf16 and f32, at the q8 sync's 4 MiB bf16 bucket (2,097,152 elements,
    seeded as ``compressed_all_reduce`` seeds it), a ragged 1000-element
    and a 777-element tensor (the padding path), every element within one
    scale, unbiased over 200 seeds; then its time with the bound and the
    plain version at the block input and at the bucket."""
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.parallel.bucketing import _q8_bucket_seed

    gen = torch.Generator(device=dev).manual_seed(6)
    cases = {"block_input_bf16": ((TRAIN_B, TRAIN_S, 768), torch.bfloat16),
             "block_input_f32": ((TRAIN_B, TRAIN_S, 768), torch.float32),
             "q8_bucket_bf16": ((Q8_BUCKET_ELEMS,), torch.bfloat16),
             "ragged_1000": ((1000,), torch.float32), "padded_777": ((777,), torch.float32),
             "padded_777_bf16": ((777,), torch.bfloat16)}
    main = bucket = None
    for name, (shape, dtype) in cases.items():
        x = (torch.randn(*shape, generator=gen, device=dev) * 3).to(dtype)
        if name == "q8_bucket_bf16":
            # rank 0's seed of bucket 0 in the q8 sync, on the device
            seed = tq._wrap_i32(tq._seed_base(_q8_bucket_seed(x, 0), dev))
        else:
            seed = tq._leaf_seed(x)  # on the device, as on the main path
        qt = tq.quantize_int8(x, seed)
        torch.cuda.synchronize()
        ref_q, ref_s = tq._quantize_int8_reference(x, seed)
        equal = bool(torch.equal(qt.values, ref_q)) and bool(torch.equal(qt.scales, ref_s))
        back = (qt.values.float() * qt.scales).reshape(-1)[:x.numel()]
        scale = qt.scales.expand(-1, 512).reshape(-1)[:x.numel()]
        # one scale, plus the rounding of the f32 product q·scale (|q| <= 127: 2^-17 of 127·scale)
        within = bool(((back - x.float().reshape(-1)).abs() <= scale * (1 + 2 ** -16)).all())
        diff = (qt.values.float() - ref_q.float()).abs().max().item()
        emit({"phase": "kernel_quant8", "kernel": "quantize_int8", "case": name,
              "shape": list(shape), "dtype": str(dtype)[6:], "torch_equal": equal,
              "max_abs_err_values": diff, "within_one_scale": within, "ok": equal and within})
        check(equal and within, f"quantize_int8 disagrees with its plain version ({name}): "
                                f"torch.equal {equal}, within one scale {within}")
        if name == "block_input_bf16":
            main = (x, seed, diff)
        elif name == "q8_bucket_bf16":
            bucket = (x, seed)
    # unbiased over 200 seeds: the suite's constant 0.303 row (absmax 0.303,
    # so every y is exactly 127), and a row with one 1.0 that puts the 0.303
    # entries between quanta (y = 38.48), where the rounding is random
    x = torch.full((2, 512), 0.303, device=dev)
    x[1, 0] = 1.0
    acc = torch.zeros(2, 512, dtype=torch.float64, device=dev)
    for s in range(200):
        acc += tq.dequantize_int8(tq.quantize_int8(x, s)).double()
    scales = tq.quantize_int8(x, 0).scales
    bias = ((acc / 200 - x.double()).abs().amax(-1) / scales[:, 0]).tolist()
    emit({"phase": "kernel_quant8", "case": "unbiased_200_seeds", "rows": ["constant", "between_quanta"],
          "mean_abs_err_over_scale": bias, "limit": 0.2})
    check(max(bias) < 0.2, f"quantize_int8 rounding is biased: {bias} of a scale")

    from dsml_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                                     "bin", "cuobjdump")
    division = quant8_division(tool, _build)
    ops = quant8_operations(division)
    clock = sm_clock_max_hz()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    reps = 20
    timings = {}
    for label, (x, seed) in (("train_block_input", main[:2]), ("q8_bucket", bucket)):
        ms = kernel_event_ms(lambda: [tq.quantize_int8(x, seed) for _ in range(reps)],
                             "quantize_int8_kernel<", reps,
                             [(functools.partial(tq.quantize_int8, x, seed), reps)])
        bound_ms, bound_by, cycles = quant8_bound_ms(x, ops, clock, sms)
        timing = {"ms": statistics.median(ms), "wrapper_ms": cuda_ms(lambda: tq.quantize_int8(x, seed)),
                  "plain_ms": cuda_ms(lambda: tq._quantize_int8_reference(x, seed)),
                  "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        bytes_ms = (x.numel() * x.element_size() + x.numel() + x.numel() // 512 * 4) / PEAK_BYTES_PER_S * 1e3
        emit({"phase": "kernel_time", "kernel": "quantize_int8", "case": label,
              "shape": list(x.shape), "dtype": "bfloat16", **timing, "bytes_bound_ms": bytes_ms,
              "operations_per_element": sum(ops.values()), "by_opcode": ops,
              "division_from_sass": division, "sm_cycles_per_element_by_pipe": cycles,
              "sm_clock_max_hz": clock, "sms": sms,
              "library": "none: no single PyTorch call quantizes with stochastic rounding"})
        timings[label] = timing
    return main[2], timings["train_block_input"]


def wq_counts(tq, tpa):
    return {"qmm": tq.qmm_launches, **paged_counts(tpa)}


def phase_wq_slice(dev, card):
    """GPT-2-small bf16 through ContinuousBatcher(paged_kv="int4",
    weight_quant="int4") on the first 24 of the paged slice's 48 requests: launches of qmm
    (48 per chunk or tick) and of the paged kernel, completion, pages,
    tokens/s, TTFT, tick ms, the idle share of a steady tick and the twin's
    bytes; a 16-request int8 drain; f32 int4 greedy tokens against a dense
    model whose projections are the same codes dequantized."""
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.serving import ContinuousBatcher

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    model = gpt2_small(cfg, dev)
    rng = np.random.default_rng(2)
    lengths = rng.integers(64, 769, PAGED_REQUESTS)
    budgets = rng.integers(16, 129, PAGED_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64) for n in lengths]
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    srv = ContinuousBatcher(model, weight_quant="int4", **kw)
    per_call = 4 * cfg.n_layer  # qmm launches per chunk or tick: 4 projections per layer
    twin = [m for m in srv.model.modules() if isinstance(m, tq.QuantizedWeight)]
    dense_proj = sum(m.dense_bytes for m in twin)
    dense_model = sum(p.numel() * p.element_size() for p in model.parameters())
    drain(srv, prompts[:4], [8] * 4)  # warm-up
    srv.reset_latency_stats()

    # the main path, counted
    tq.qmm_launches = tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
    ticks0, pre0 = srv.n_plain_ticks, srv.n_prefill_dispatches
    drained = slice(0, WQ_INT4_REQUESTS)
    toks, wall, tick_ms = drain(srv, prompts[drained], budgets[drained])
    counts = wq_counts(tq, tpa)
    n_chunks, n_ticks = srv.n_prefill_dispatches - pre0, srv.n_plain_ticks - ticks0
    dispatches = n_chunks + n_ticks * srv.decode_quantum
    lat = srv.latency_stats()
    new_tokens = sum(len(t) for t in toks)
    check(counts["qmm"] == per_call * dispatches,
          f"the int4 drain launched qmm {counts['qmm']} times, expected {per_call} x {dispatches}")
    check(counts["paged_attn_pipelined"] == cfg.n_layer * dispatches,
          f"the int4 drain launched {counts}, expected {cfg.n_layer} x {dispatches} paged launches")
    check(all(len(t) == int(n) for t, n in zip(toks, budgets)), "a request did not complete its budget")
    check(srv.free_pages == srv.n_pages - 1, f"{srv.free_pages} pages free after the int4 drain")
    steady = steady_tick(srv, prompts)
    del srv

    # int8 weights at full width, 16 requests
    srv8 = ContinuousBatcher(model, weight_quant="int8", **kw)
    sub = slice(0, WQ_INT8_REQUESTS)
    q0, p0, t0 = tq.qmm_launches, srv8.n_prefill_dispatches, srv8.n_plain_ticks
    toks8, wall8, tick8 = drain(srv8, prompts[sub], budgets[sub])
    d8 = (srv8.n_prefill_dispatches - p0) + (srv8.n_plain_ticks - t0)
    check(tq.qmm_launches - q0 == per_call * d8 and all(len(t) == int(n) for t, n in
                                                        zip(toks8, budgets[sub]))
          and srv8.free_pages == srv8.n_pages - 1,
          f"the int8 drain: {tq.qmm_launches - q0} qmm launches for {d8} dispatches")
    int8_bytes = dict(srv8._wq_bytes)
    del srv8, model
    torch.cuda.empty_cache()

    # f32: the int4 twin against a dense model holding the same codes dequantized
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = gpt2_small(cfg32, dev)
    f32kw = dict(paged_kv="fp", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_F32_REQUESTS)
    srv_q = ContinuousBatcher(model32, weight_quant="int4", **f32kw)
    with torch.no_grad():
        params = dict(model32.named_parameters())
        for name, mod in srv_q.model.named_modules():
            if isinstance(mod, tq.QuantizedWeight):
                params[name].copy_(tq.dequantize_weight_blocks(mod))
    srv_d = ContinuousBatcher(model32, weight_quant=None, **f32kw)
    sub = slice(0, PAGED_F32_REQUESTS)
    runs = {}
    for key, s in (("int4_kernel", srv_q), ("dense_dequantized", srv_d)):
        runs[key], _, _ = drain(s, prompts[sub], budgets[sub])
    near_ties, mismatches = [], 0
    for i, (a, w) in enumerate(zip(runs["int4_kernel"], runs["dense_dequantized"])):
        diff = [j for j, (u, v) in enumerate(zip(a, w)) if u != v]
        if diff:
            m = first_divergence_margin(model32, prompts[i], w, diff[0])
            near_ties.append({"request": i, "step": diff[0], "margin": m})
            mismatches += m >= MARGIN
    del srv_q, srv_d, model32

    emit({"phase": "wq_slice", "model": "gpt2-small", "dtype": "bfloat16", "weight_quant": "int4",
          "paged_kv": "int4", "page_size": PAGE, "prefill_chunk": PAGED_CHUNK,
          "n_slots": PAGED_SLOTS, "requests": WQ_INT4_REQUESTS,
          "prompt_tokens": int(lengths[drained].sum()),
          "new_tokens": new_tokens, "launches": counts,
          "dispatches": {"prefill_chunks": n_chunks, "decode_ticks": n_ticks},
          "qmm_per_dispatch": counts["qmm"] / dispatches, "wall_s": wall,
          "tokens_per_s": new_tokens / wall, "ttft_p50_s": lat.get("ttft_p50_s"),
          "ttft_p99_s": lat.get("ttft_p99_s"), "e2e_p50_s": lat.get("e2e_p50_s"),
          "e2e_p99_s": lat.get("e2e_p99_s"), "decode_tick_ms_median": statistics.median(tick_ms),
          "decode_ticks": len(tick_ms), "steady_tick": steady,
          "twin_bytes": {"int4": dict(packed=sum(m.qw.nbytes for m in twin),
                                      scales=sum(m.qs.nbytes for m in twin)),
                         "int8": int8_bytes, "dense_projections_bf16": dense_proj,
                         "dense_model_resident_bf16": dense_model},
          "int8_drain": {"requests": WQ_INT8_REQUESTS, "dispatches": d8, "wall_s": wall8,
                         "tokens_per_s": sum(len(t) for t in toks8) / wall8,
                         "decode_tick_ms_median": statistics.median(tick8)},
          "f32_int4_vs_dense_dequantized": {"requests": PAGED_F32_REQUESTS,
                                            "tokens_equal": runs["int4_kernel"] == runs["dense_dequantized"],
                                            "near_ties": near_ties},
          "card": card})
    check(mismatches == 0, f"f32 int4 weights: {mismatches} requests diverge from the dense "
                           "dequantized model beyond the margin rule")
    return counts


def phase_serve_cli_wq(dev):
    """cli.serve_continuous with DSML_WEIGHT_QUANT=int4 in its environment."""
    from dsml_tpu_torch.cli import serve_continuous
    from dsml_tpu_torch.ops import quantization as tq

    tq.qmm_launches = 0
    os.environ["DSML_WEIGHT_QUANT"] = "int4"
    try:
        out = serve_continuous.main(["--model", "small", "--paged_kv", "int4", "--prefill_chunk", "64",
                                     "--requests", "16"])
    finally:
        del os.environ["DSML_WEIGHT_QUANT"]
    emit({"phase": "serve_cli", "entry": "DSML_WEIGHT_QUANT=int4 python -m "
          "dsml_tpu_torch.cli.serve_continuous", **out, "qmm_launches": tq.qmm_launches})
    check(out["weight_quant"] == "int4" and tq.qmm_launches > 0 and tq.qmm_launches % 48 == 0
          and out["free_pages"] == out["n_pages"] - 1,
          f"serve_continuous with int4 weights: {tq.qmm_launches} qmm launches, result {out}")


def phase_train_int8remat(tflash, dev, card):
    """The train step of phase_train with remat="int8": 12 quantize_int8
    launches per step, the step-0 loss equal to remat=False's, a falling
    loss, step ms, tokens/s, MFU, peak memory of the three remat modes;
    f32 gradients at batch 2 within 0.1 of remat=False's."""
    from dsml_tpu_torch.models.common import transformer_train_flops
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import quantization as tq

    base = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    cfg = dataclasses.replace(base, remat="int8")
    model = gpt2_small(cfg, dev)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    y = torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    with torch.no_grad():
        plain = gpt2_small(base, dev)
        loss_plain = plain.loss(x, y, attn_impl="flash").item()
        del plain
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, y, attn_impl="flash")
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(TRAIN_WARMUP)]
    loss0 = losses[0].item()
    torch.cuda.synchronize()
    # the main path, counted
    reset_counts(tflash)
    tq.quantize_int8_launches = 0
    t0 = time.perf_counter()
    losses += [step() for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    counts = {"quantize_int8": tq.quantize_int8_launches, **train_counts(tflash)}
    losses = torch.stack(losses).float().tolist()
    flops = transformer_train_flops(cfg, TRAIN_B * TRAIN_S, TRAIN_S)
    phase_train_trace(step, "int8_remat_train_step")

    # peak memory of one loss + backward under each remat mode, same weights
    del opt
    model.zero_grad(set_to_none=True)
    peak = {}
    for mode in (False, True, "int8"):
        model.config = dataclasses.replace(cfg, remat=mode)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        model.loss(x, y, attn_impl="flash").backward()
        torch.cuda.synchronize()
        peak[str(mode)] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                           "above_resident_gb": (torch.cuda.max_memory_allocated() - resident) / 1e9}
        model.zero_grad(set_to_none=True)
    model.config = cfg
    row = {"phase": "train_int8remat", "model": "gpt2-small", "dtype": "bfloat16", "remat": "int8",
           "batch": TRAIN_B, "seq": TRAIN_S, "attn_impl": "flash", "xent_chunk": 0,
           "optimizer": "AdamW(3e-4, weight_decay=0.01)", "steps": TRAIN_STEPS, "launches": counts,
           "loss_step0": loss0, "loss_step0_remat_false": loss_plain, "step_ms": step_ms,
           "tokens_per_s": TRAIN_B * TRAIN_S * 1e3 / step_ms, "model_flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
           "peak_memory_by_remat": peak, "losses": losses, "card": card}
    del model
    torch.cuda.empty_cache()
    check(counts["quantize_int8"] == cfg.n_layer * TRAIN_STEPS,
          f"int8 remat launched quantize_int8 {counts['quantize_int8']} times, expected "
          f"{cfg.n_layer} per step")
    check(bf16_step_counts_ok({k: n for k, n in counts.items() if k != "quantize_int8"},
                              2 * cfg.n_layer * TRAIN_STEPS, cfg.n_layer * TRAIN_STEPS),
          f"int8 remat launched {counts}: expected 24 forward (12 + the recompute) and 12 of each "
          "tensor-core backward kernel per step, no FMA backward")
    check(abs(loss0 - loss_plain) <= 1e-6 * abs(loss_plain),
          f"step-0 loss {loss0} under int8 remat, {loss_plain} without remat")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"int8 remat loss not falling: {losses}")

    # f32, batch 2: int8-remat gradients against remat=False's
    grads = {}
    for mode in (False, "int8"):
        m32 = gpt2_small(dataclasses.replace(base, dtype="float32", remat=mode), dev)
        m32.loss(x[:TRAIN_F32_B], y[:TRAIN_F32_B], attn_impl="flash").backward()
        grads[mode] = {n: p.grad for n, p in m32.named_parameters()}
        del m32
    worst, worst_name = 0.0, None
    for name, g in grads[False].items():
        rel = (grads["int8"][name] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
        if rel >= worst:
            worst, worst_name = rel, name
    row.update({"f32_grads_max_err_over_max_abs": worst, "f32_grads_worst_tensor": worst_name,
                "tol_f32_grads": TOL_INT8_REMAT_GRADS})
    emit(row)
    del grads
    torch.cuda.empty_cache()
    check(worst <= TOL_INT8_REMAT_GRADS,
          f"f32 int8-remat gradients {worst} of max |g| off remat=False's in {worst_name}")
    return counts


# ---- context parallelism: kernel 4 and the cp = 2 ring (port slice 6) -----------

STREAM_SOURCE = "dsml_tpu_torch/ops/csrc/flash_stream.cu"
# the cp = 2 ring's hop on GPT-2-small at 8 × 1024: q is a rank's 512 rows,
# the resident K/V half 256 rows; rank 1's forward half at hop 0 (q and k
# both start at global position 512, so SDPA's top-left causal mask is
# the same mask)
HOP_BH, HOP_SQ, HOP_SKV, HOP_START = B * H, TRAIN_S // 2, TRAIN_S // 4, TRAIN_S // 2
CP_STEPS, CP_WARMUP = 3, 1  # 5, 2 until PR 17 (the run's time)
CP_F32_B = 2
# bf16 losses of the cp = 2 step against the single-device step: the ring
# merges each layer's two halves in f32 and rounds once, the single-device
# kernel rounds its one output; a few bf16 ulps of the block outputs move a
# loss near 11 by about 1e-3 of itself (a dropped hop moves it by O(1))
TOL_CP_BF16_LOSS = 1e-2


def stream_bound_ms(q, k, causal, q_start, k_start):
    """Least time of one kernel-4 call: q, k and v read once, out and the
    f32 lse written once, the K/V copy written once; 2·d multiply-adds per
    kept score in each of q·kᵀ and p·v."""
    bh, s_q, d = q.shape
    s_kv = k.shape[1]
    elt = q.element_size()
    nbytes = bh * (2 * s_q * d + 4 * s_kv * d) * elt + bh * s_q * 4
    rows = q_start + np.arange(s_q) - k_start + 1
    kept = np.clip(rows, 0, s_kv).sum() if causal else s_q * s_kv
    return bound(nbytes, 4.0 * d * bh * float(kept), PEAK_FLOPS[q.dtype])


def phase_kernel_stream(tflash, dev):
    """Kernel 4 against _flash_stream_reference at the cp = 2 hop's shape
    and around it: bf16 and f32, pred true and false, causal with offsets,
    a ragged kv tail, head_dim 96 (padded to 128 for the math, the
    unpadded K/V copied). out and lse within the flash tolerances, the
    copied K/V bit-exact, out and lse bit-identical to kernel 1's on the
    same inputs, one launch a call. Then its times at the hop shape, bf16
    and f32."""
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [  # (bh, s_q, s_kv, d, q_start, k_start, causal, pred)
        (HOP_BH, HOP_SQ, HOP_SKV, D, HOP_START, HOP_START, True, True),
        (HOP_BH, HOP_SQ, HOP_SKV, D, HOP_START, HOP_START, True, False),
        (HOP_BH, HOP_SQ, HOP_SKV, D, 0, HOP_SKV, True, True),
        (HOP_BH, HOP_SQ, HOP_SKV, D, HOP_START, 0, False, True),
        (HOP_BH, 300, 200, D, 100, 0, True, True),
        (16, 300, 150, 96, 0, 0, True, True),
        (16, 256, 256, 128, 0, 0, True, True),
    ]
    main_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for bh, s_q, s_kv, d, q_start, k_start, causal, pred in cases:
            q = torch.randn(bh, s_q, d, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(bh, s_kv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
            k_dst, v_dst = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
            before = tflash.flash_stream_launches
            out, lse = tflash.flash_stream(q, k, v, k_dst, v_dst, pred, causal, q_start, k_start)
            torch.cuda.synchronize()
            launched = tflash.flash_stream_launches - before
            ref_k, ref_v = torch.empty_like(k), torch.empty_like(v)
            ref_out, ref_lse = tflash._flash_stream_reference(q, k, v, ref_k, ref_v, pred, causal,
                                                              q_start, k_start)
            err_out = (out.float() - ref_out.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            copied = bool(torch.equal(k_dst, k) and torch.equal(v_dst, v))
            if pred:
                k1_out, k1_lse = tflash.flash_fwd(q, k, v, causal, q_start, k_start)
                same_as_kernel1 = bool(torch.equal(out, k1_out) and torch.equal(lse, k1_lse))
            else:
                same_as_kernel1 = None
            tol = TOL[dtype]
            ok = (launched == 1 and copied and out.shape == q.shape and out.dtype == dtype
                  and bool(torch.isfinite(out).all()) and err_out <= tol["out"]
                  and err_lse <= tol["lse"] and same_as_kernel1 is not False)
            emit({"phase": "kernel_stream", "kernel": "flash_stream", "dtype": str(dtype)[6:],
                  "bh": bh, "s_q": s_q, "s_kv": s_kv, "d": d, "q_start": q_start,
                  "k_start": k_start, "causal": causal, "pred": pred, "launched": launched,
                  "max_abs_err_out": err_out, "max_abs_err_lse": err_lse, "tol_out": tol["out"],
                  "tol_lse": tol["lse"], "kv_copy_bit_exact": copied,
                  "bit_identical_to_flash_fwd": same_as_kernel1, "ok": ok})
            check(ok, f"flash_stream disagrees with its plain version or kernel 1 ({dtype}, "
                      f"bh={bh}, s_q={s_q}, s_kv={s_kv}, d={d}, q_start={q_start}, "
                      f"k_start={k_start}, causal={causal}, pred={pred})")
            if (dtype, s_q, s_kv, d, q_start, pred) == (torch.bfloat16, HOP_SQ, HOP_SKV, D,
                                                        HOP_START, True):
                main_err = err_out

    # times at the hop's shape, causal at rank 1's offsets: bf16 (the
    # tensor-core body) and f32 (the FMA body)
    args = (True, HOP_START, HOP_START)
    timings = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(HOP_BH, HOP_SQ, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(HOP_BH, HOP_SKV, D, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        k_dst, v_dst = torch.empty_like(k), torch.empty_like(v)
        kernel = functools.partial(tflash.flash_stream, q, k, v, k_dst, v_dst, True, *args)
        kernel1 = functools.partial(tflash.flash_fwd, q, k, v, *args)
        plain = functools.partial(tflash._flash_stream_reference, q, k, v, k_dst, v_dst, True, *args)
        q4 = q.view(B, H, HOP_SQ, D)
        k4, v4 = (t.view(B, H, HOP_SKV, D) for t in (k, v))

        def yardstick():
            F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
            k_dst.copy_(k)
            v_dst.copy_(v)

        bound_ms, bound_by = stream_bound_ms(q, k, *args)
        timings[dtype] = {"ms": device_ms(kernel, pattern="flash_stream_fwd_kernel<"),
                          "plain_ms": device_ms(plain), "bound_ms": bound_ms,
                          "bound_by": bound_by, "library_ms": device_ms(yardstick)}
        emit({"phase": "kernel_time", "kernel": "flash_stream",
              "shape": {"q": [HOP_BH, HOP_SQ, D], "kv": [HOP_BH, HOP_SKV, D]},
              "dtype": str(dtype)[6:], "causal": True, "q_start": HOP_START,
              "k_start": HOP_START,
              "flash_fwd_ms_same_inputs": device_ms(kernel1, pattern="flash_fwd_kernel<"),
              "library_note": "library_ms is a two-call yardstick: F.scaled_dot_product_attention "
              "(is_causal, the same mask here) plus copy_ of K and V; no single PyTorch call "
              "computes out, lse and the copy", **timings[dtype],
              "call_ms": {"flash_stream": cuda_ms(kernel), "flash_fwd": cuda_ms(kernel1),
                          "plain": cuda_ms(plain), "library": cuda_ms(yardstick)},
              "note": "ms, plain_ms, library_ms and flash_fwd_ms_same_inputs are profiler device "
              "time per call; call_ms are CUDA events around one call, host time included"})
    return main_err, timings[torch.bfloat16]


def phase_kernel_head_dim(tflash, dev):
    """flash_fwd and flash_bwd on CUDA tensors whose head_dim is neither 64
    nor 128 (zero-padded to the kernels' width, the true d^-½ as scale):
    against the plain versions, no ValueError."""
    gen = torch.Generator(device=dev).manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        for d in (8, 32, 96):
            q, k, v, do = (torch.randn(24, 200, d, generator=gen, device=dev).to(dtype)
                           for _ in range(4))
            out, lse = tflash.flash_fwd(q, k, v, True, 0, 0)
            grads = tflash.flash_bwd(q, k, v, out, lse, do, None, True, 0, 0)
            torch.cuda.synchronize()
            ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, True, 0, 0)
            ref_grads = tflash._flash_bwd_reference(q, k, v, out, lse, do, None, True, 0, 0)
            err_out = (out.float() - ref_out.float()).abs().max().item()
            err_lse = (lse - ref_lse).abs().max().item()
            rel = max((g.float() - w.float()).abs().max().item()
                      / max(w.float().abs().max().item(), 1e-30) for g, w in zip(grads, ref_grads))
            ok = (out.shape == q.shape and all(g.shape == q.shape for g in grads)
                  and err_out <= TOL[dtype]["out"] and err_lse <= TOL[dtype]["lse"]
                  and rel <= TOL_BWD[dtype])
            emit({"phase": "kernel_head_dim", "dtype": str(dtype)[6:], "d": d,
                  "max_abs_err_out": err_out, "max_abs_err_lse": err_lse,
                  "bwd_max_err_over_max_abs": rel, "ok": ok})
            check(ok, f"flash_fwd/flash_bwd at head_dim {d} ({dtype}) disagree with the plain "
                      "versions")


# ---- long context: the sequence-parallel paths' kernel shapes ---------------------------

# GPT-2-small's 8 × 1024 at sp = 2: the ring_flash hops a rank runs (s_local
# 512, b·h = 96) and ulysses_flash's head-sharded full sequence (6 of 12
# heads a rank); name -> (b·h, s_q, s_kv, q_start, k_start)
LC_SHAPES = {
    "ring_flash_hop_diagonal": (B * H, TRAIN_S // 2, TRAIN_S // 2, TRAIN_S // 2, TRAIN_S // 2),
    "ring_flash_hop_visible": (B * H, TRAIN_S // 2, TRAIN_S // 2, TRAIN_S // 2, 0),
    "ring_flash_hop_masked": (B * H, TRAIN_S // 2, TRAIN_S // 2, 0, TRAIN_S // 2),
    "ulysses_flash": (B * H // 2, TRAIN_S, TRAIN_S, 0, 0),
}


def _sdpa_mask(s_q, s_kv, q_start, k_start, dev):
    """The boolean SDPA mask (True = attend) of global positions, or None
    where every pair is kept."""
    keep = (q_start + torch.arange(s_q, device=dev))[:, None] >= (
        k_start + torch.arange(s_kv, device=dev))[None, :]
    return None if bool(keep.all()) else keep


def phase_kernel_long_context(tflash, dev):
    """Kernels 1–3 (bf16: the tensor-core bodies) at the long-context
    paths' shapes (:data:`LC_SHAPES`) against their plain versions: the
    ring_flash hops with their global offsets, the fully masked one (rank
    0's second hop: zero out, lse at the −1e20 floor, zero and finite
    gradients) included, and ulysses_flash's [b·h/2, 1024, 64]; the
    backward with an lse cotangent, as ring_flash's merge gives it. Then
    each one's device time beside its bound, its plain version and SDPA
    (with the mask of the global positions; none for the masked hop, where
    SDPA's all-masked rows are NaN; the backward's SDPA has no lse term).
    Returns {shape: {kernel: timing}}."""
    gen = torch.Generator(device=dev).manual_seed(19)
    dtype, tol, tol_bwd = torch.bfloat16, TOL[torch.bfloat16], TOL_BWD[torch.bfloat16]
    dq_name, dkv_name = BWD_KERNELS[dtype]
    timings = {}
    for name, (bh, s_q, s_kv, q_start, k_start) in LC_SHAPES.items():
        q, do = (torch.randn(bh, s_q, D, generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, s_kv, D, generator=gen, device=dev).to(dtype) for _ in range(2))
        g_lse = torch.randn(bh, s_q, generator=gen, device=dev)
        before = train_counts(tflash)
        out, lse = tflash.flash_fwd(q, k, v, True, q_start, k_start)
        grads = tflash.flash_bwd(q, k, v, out, lse, do, g_lse, True, q_start, k_start)
        torch.cuda.synchronize()
        launched = {key: n - before[key] for key, n in train_counts(tflash).items()}
        ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, True, q_start, k_start)
        ref_grads = tflash._flash_bwd_reference(q, k, v, out, lse, do, g_lse, True, q_start,
                                                k_start)
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        rel = max((g.float() - w.float()).abs().max().item() / max(w.float().abs().max().item(),
                                                                    1e-30)
                  for g, w in zip(grads, ref_grads))
        masked = name == "ring_flash_hop_masked"
        ok = (err_out <= tol["out"] and err_lse <= tol["lse"] and rel <= tol_bwd
              and all(bool(torch.isfinite(g).all()) for g in grads))
        if masked:  # zero weight in the merge, nothing back
            ok = ok and not out.any() and bool((lse <= -1e19).all()) and not any(
                g.any() for g in grads)
        emit({"phase": "kernel_long_context", "shape": name, "dtype": "bfloat16", "bh": bh,
              "s_q": s_q, "s_kv": s_kv, "d": D, "q_start": q_start, "k_start": k_start,
              "causal": True, "g_lse": True, "launched": launched, "max_abs_err_out": err_out,
              "max_abs_err_lse": err_lse, "bwd_max_err_over_max_abs": rel, "lse_max":
              lse.max().item(), "tol_out": tol["out"], "tol_lse": tol["lse"],
              "tol_bwd": tol_bwd, "ok": ok})
        check(launched == {"flash_fwd": 1, dq_name: 1, dkv_name: 1, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0},
              f"kernels at {name} launched {launched}, expected one each of kernels 1-3")
        check(ok, f"kernels 1-3 at {name} disagree with their plain versions (out {err_out}, "
                  f"lse {err_lse}, gradients {rel}{', not zero on the masked hop' if masked else ''})")

        # times: the forward, then the two backward kernels from one trace
        mask = _sdpa_mask(s_q, s_kv, q_start, k_start, dev)
        q4, k4, v4, do4 = (t.view(B, bh // B, -1, D).detach().requires_grad_()
                           for t in (q, k, v, do))

        def sdpa(backward, mask=mask, q4=q4, k4=k4, v4=v4, do4=do4):
            o = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
            if backward:
                torch.autograd.grad(o, (q4, k4, v4), do4)

        fwd_ms = device_ms(functools.partial(tflash.flash_fwd, q, k, v, True, q_start, k_start),
                           reps=10, pattern="flash_fwd_kernel<")
        fwd_bound, fwd_by = attention_bound_ms(bh, s_q, s_kv, D, dtype, True, q_start, k_start)
        fwd_lib = None if masked else device_ms(functools.partial(sdpa, False), reps=10)
        timings[name] = {"flash_fwd": {
            "ms": fwd_ms, "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": fwd_lib,
            "plain_ms": device_ms(functools.partial(tflash._flash_fwd_reference, q, k, v, True,
                                                    q_start, k_start), reps=10)}}
        bwd = device_ms_by(functools.partial(tflash.flash_bwd, q, k, v, out, lse, do, g_lse, True,
                                             q_start, k_start),
                           (f"{dq_name}_kernel<", f"{dkv_name}_kernel<"))
        plain_bwd = device_ms(functools.partial(tflash._flash_bwd_reference, q, k, v, out, lse,
                                                do, g_lse, True, q_start, k_start), reps=10)
        lib_bwd = None if masked else (device_ms(functools.partial(sdpa, True), reps=10) - fwd_lib)
        for kernel, products, n_out in ((dq_name, 3, 1), (dkv_name, 4, 2)):
            b_ms, b_by = backward_bound_ms(bh, s_q, s_kv, D, dtype, True, products, n_out,
                                           q_start, k_start)
            timings[name][kernel] = {"ms": bwd[f"{kernel}_kernel<"], "bound_ms": b_ms,
                                     "bound_by": b_by, "plain_ms": plain_bwd,
                                     "library_ms": lib_bwd}
        emit({"phase": "kernel_time", "path": "long_context", "shape_name": name,
              "shape": [bh, s_q, s_kv, D], "q_start": q_start, "k_start": k_start,
              "dtype": "bfloat16", "causal": True, "g_lse": True, **timings[name],
              "note": "profiler device ms a call; the backward's plain_ms and library_ms are "
              "whole backwards (SDPA forward+backward minus forward, no lse term); SDPA takes "
              "the boolean mask of the global positions; null where SDPA has no such call"})
        del q, k, v, do, out, lse, grads, ref_grads, q4, k4, v4, do4
    return timings


def rank_main(run, kind, rank, tmp):
    """One spawned rank: ``run(rank, tmp, res, stage)`` with the rank's traceback
    on stderr when it fails (torch's spawn reports only one rank's), and
    its stack on the parent's SIGTERM once the other rank failed."""
    import faulthandler
    import signal
    import traceback

    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    res = {"rank": rank}
    try:
        run(rank, tmp, res, lambda name: stage_note(kind, rank, res, name))
    except BaseException:
        print(f"chip_smoke: {kind} rank {rank} failed after {res.get('stage')}:\n"
              f"{traceback.format_exc()}", file=sys.stderr, flush=True)
        raise


def stage_note(kind, rank, res, name):
    res["stage"] = name
    print(f"chip_smoke: {kind} rank {rank}: {name} (t = {time.perf_counter() - _T0:.1f} s)",
          file=sys.stderr, flush=True)


def spawn_ranks(fn, kind):
    """Run ``fn`` on two spawned ranks (one card: they share it) and return
    each rank's JSON and the seconds the spawn took."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{kind}_") as tmp:
        t0 = time.perf_counter()
        mp.spawn(fn, args=(tmp,), nprocs=2, join=True)
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks, seconds


def spawn_programs(programs, kind, nprocs=2):
    """Run several rank programs one after another in the same ``nprocs``
    spawned processes (each joins and leaves its own process group, in a
    directory of its own), which saves each later program the processes'
    start-up: ``programs`` is {name: (rank function, extra arguments)}, as
    :func:`spawn_mesh` takes them. Returns ({name: each rank's JSON}, the
    seconds the spawn took)."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{kind}_") as tmp:
        t0 = time.perf_counter()
        mp.spawn(_run_programs, args=(tmp, programs), nprocs=nprocs, join=True)
        seconds = time.perf_counter() - t0
        out = {}
        for name in programs:
            out[name] = []
            for r in range(nprocs):
                with open(os.path.join(tmp, name, f"rank{r}.json")) as f:
                    out[name].append(json.load(f))
    return out, seconds


def _run_programs(rank, tmp, programs):
    for name, (fn, args) in programs.items():
        sub = os.path.join(tmp, name)
        os.makedirs(sub, exist_ok=True)
        fn(rank, sub, *args)
        gc.collect()
        torch.cuda.empty_cache()  # the next program starts from the card's memory, not this cache


def cp_rank(rank, tmp):
    """One rank of phase_cp_slice (spawned): GPT-2-small over a cp = 2 ring
    on cuda:{rank % device_count}. Writes its results to tmp/rank{rank}.json."""
    rank_main(cp_rank_run, "cp", rank, tmp)


def cp_rank_run(rank, tmp, res, stage):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel.hybrid import make_hybrid_train_step
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(dp=1, cp=2), rank, 2, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("cp")
    res["device"] = str(dev)
    stage("gloo all_reduce of a CUDA tensor")
    # gloo's all_reduce on CUDA tensors (the gradient sum)
    probe = torch.full((1000,), float(rank + 1), device=dev)
    dist.all_reduce(probe)
    res["gloo_cuda_all_reduce_ok"] = bool((probe == 3.0).all())
    rng = np.random.default_rng(2)
    x_all = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    y_all = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    cols = slice(rank * TRAIN_S // 2, (rank + 1) * TRAIN_S // 2)
    x, y = x_all[:, cols].to(dev), y_all[:, cols].to(dev)

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    # (a) loss and backward under each schedule: dma's losses bit-identical
    # to off's, kernel 4 launched n_layer × 2 directions × 1 hop per forward
    model = gpt2_small(cfg, dev)
    losses, grads, stream_counts = {}, {}, {}
    for mode in ("off", "dma", "sendahead"):
        stage(f"loss and backward under {mode}")
        os.environ["DSML_RING_FUSED"] = mode
        model.zero_grad(set_to_none=True)
        tflash.flash_stream_launches = 0
        loss = model.loss(x, y, attn_impl="ring2", sp_group=group)
        stream_counts[mode] = tflash.flash_stream_launches
        (loss / 2).backward()
        losses[mode] = loss.detach()
        grads[mode] = [p.grad.detach().clone() for p in model.parameters()]
    res["schedule_losses"] = {m: float(v) for m, v in losses.items()}
    res["dma_loss_bit_identical_to_off"] = bool(torch.equal(losses["dma"], losses["off"]))
    res["sendahead_loss_bit_identical_to_off"] = bool(torch.equal(losses["sendahead"], losses["off"]))
    res["schedule_grads_bit_identical"] = {m: all(torch.equal(a, b) for a, b in zip(grads[m], grads["off"]))
                                           for m in ("dma", "sendahead")}
    res["flash_stream_launches_per_forward"] = stream_counts
    del grads
    model.zero_grad(set_to_none=True)

    # ring_pass of one forward payload (a K/V half) and the copy out of the
    # slot, which is one device copy of the payload's bytes
    stage("ring_pass")
    gen = torch.Generator(device=dev).manual_seed(3)  # the same payload on both ranks
    half = torch.randn(2, TRAIN_B, H, TRAIN_S // 4, D, generator=gen, device=dev).to(torch.bfloat16)
    from dsml_tpu_torch.ops.collectives import ring_pass

    for _ in range(3):
        ring_pass((half[0], half[1]), group, +1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        ring_pass((half[0], half[1]), group, +1)
    torch.cuda.synchronize()
    res["ring_pass_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    res["ring_pass_bytes"] = 2 * half[0].numel() * half.element_size()
    scratch = torch.empty_like(half)
    res["copy_out_ms"] = cuda_ms(lambda: scratch.copy_(half))
    got = ring_pass((half[0] + rank, half[1] - rank), group, +1)
    res["ring_pass_values_ok"] = bool(torch.equal(got[0], half[0] + (1 - rank))
                                      and torch.equal(got[1], half[1] - (1 - rank)))

    # (b) f32, batch 2: the ring's loss and gradients against single-device
    # flash on the full sequence (on rank 0)
    stage("f32 ring loss and gradients")
    os.environ["DSML_RING_FUSED"] = "dma"
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = gpt2_small(cfg32, dev)
    loss32 = m32.loss(x[:CP_F32_B], y[:CP_F32_B], attn_impl="ring2", sp_group=group)
    (loss32 / 2).backward()
    flat = torch.cat([p.grad.reshape(-1) for p in m32.parameters()])
    dist.all_reduce(flat)
    ring_loss = loss32.detach().clone()
    dist.all_reduce(ring_loss)
    ring_loss /= 2
    if rank == 0:
        m32.zero_grad(set_to_none=True)
        full = m32.loss(x_all[:CP_F32_B].to(dev), y_all[:CP_F32_B].to(dev), attn_impl="flash")
        full.backward()
        full = full.detach()
        worst, worst_name, off = 0.0, None, 0
        for name, p in m32.named_parameters():
            g_ring = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            rel = (g_ring - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-30)
            if rel >= worst:
                worst, worst_name = rel, name
        res["f32"] = {"ring_loss": float(ring_loss), "single_loss": float(full),
                      "loss_rel_err": abs(float(ring_loss) - float(full)) / abs(float(full)),
                      "grads_max_err_over_max_abs": worst, "grads_worst_tensor": worst_name}
    del m32, flat
    torch.cuda.empty_cache()

    # (c) the main path: bf16 hybrid steps under dma, counted; rank 0 also
    # runs the single-device flash step from the same weights and batch
    stage("hybrid train steps")
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    # the model holds seed 0's weights (gpt2_small): init_hybrid would draw them again
    step = make_hybrid_train_step(model, opt, mesh)
    cp_losses = [float(step(x_all, y_all)) for _ in range(CP_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    tflash.flash_stream_launches = 0
    launches0 = {"flash_fwd": tflash.flash_fwd_launches, "dq": tflash.flash_bwd_dq_tc_launches,
                 "dkv": tflash.flash_bwd_dkv_tc_launches}
    t0 = time.perf_counter()
    cp_losses += [step(x_all, y_all) for _ in range(CP_STEPS)]
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) * 1e3 / CP_STEPS
    res["launches"] = {"flash_stream": tflash.flash_stream_launches,
                       "flash_fwd": tflash.flash_fwd_launches - launches0["flash_fwd"],
                       "flash_bwd_dq_tc": tflash.flash_bwd_dq_tc_launches - launches0["dq"],
                       "flash_bwd_dkv_tc": tflash.flash_bwd_dkv_tc_launches - launches0["dkv"]}
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["cp_losses"] = [float(v) for v in cp_losses]
    with torch.no_grad():
        res["weights_checksum"] = float(sum(p.float().sum() for p in model.parameters()))
    # where one step's time goes: rank 0's kernels from a profiler trace (one
    # profiling process on the card), rank 1 steps alongside untraced
    stage("traced step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        by_name = device_kernel_ms(lambda: step(x_all, y_all))
        res["trace"] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                        "device_busy_ms": sum(by_name.values()) if by_name else None,
                        "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}
    else:
        step(x_all, y_all)
        torch.cuda.synchronize()
    # the step's gradient sum alone: the ring all-reduce of one flat bf16
    # buffer of every parameter (the IPC transport), and beside it gloo's
    # all_reduce of the same buffer (through host memory), which the step
    # took before
    from dsml_tpu_torch.ops.collectives import ReduceOp, all_reduce

    flat = torch.zeros(sum(p.numel() for p in model.parameters()), dtype=torch.bfloat16,
                       device=dev)
    for name, fn in (("grad_all_reduce_ms", lambda: all_reduce(flat, group, ReduceOp.SUM, "ring")),
                     ("grad_all_reduce_gloo_ms", lambda: dist.all_reduce(flat))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) * 1e3 / 3
    del opt, step, model, flat
    torch.cuda.empty_cache()
    res["sp"] = sp_impl_steps(rank, tmp, stage, x_all, y_all, cfg)
    if rank == 0:
        stage("single-device train steps")
        single = gpt2_small(cfg, dev)
        sopt = torch.optim.AdamW(single.parameters(), lr=3e-4, weight_decay=0.01)
        xs, ys = x_all.to(dev), y_all.to(dev)
        single_losses = []
        for _ in range(CP_WARMUP + CP_STEPS):
            sopt.zero_grad(set_to_none=True)
            loss = single.loss(xs, ys, attn_impl="flash")
            loss.backward()
            sopt.step()
            single_losses.append(float(loss))
        res["single_losses"] = single_losses
        del single, sopt
    stage("close")
    mesh.close()
    dist.destroy_process_group()
    os.environ.pop("DSML_RING_FUSED", None)  # later programs of a shared spawn route as set
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


SP_IMPLS = ("ring", "ulysses", "ulysses_flash", "ring_flash")
SP_WARMUP, SP_STEPS = 1, 2


def sp_impl_steps(rank, tmp, stage, x_all, y_all, cfg):
    """GPT-2-small bf16 at sp = 2 (a second mesh on the cp ranks' process
    group) through each sequence impl of :data:`SP_IMPLS` from the same
    weights: SP_WARMUP + SP_STEPS hybrid steps on the cp slice's batch, the
    timed steps' ms, launches of kernels 1–3 and peak memory a rank."""
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel.hybrid import make_hybrid_train_step
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(dp=1, sp=2), rank, 2, os.path.join(tmp, "rendezvous"))
    dev = mesh.device
    out = {}
    for impl in SP_IMPLS:
        stage(f"sp = 2 steps through {impl}")
        model = gpt2_small(cfg, dev)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
        step = make_hybrid_train_step(model, opt, mesh, attn_impl=impl)
        losses = [float(step(x_all, y_all)) for _ in range(SP_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(tflash)
        t0 = time.perf_counter()
        losses += [step(x_all, y_all) for _ in range(SP_STEPS)]
        torch.cuda.synchronize()
        out[impl] = {"step_ms": (time.perf_counter() - t0) * 1e3 / SP_STEPS,
                     "launches": train_counts(tflash), "losses": [float(v) for v in losses],
                     "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        del model, opt, step, losses
        torch.cuda.empty_cache()
    mesh.close()
    return out


# kernel-1 calls a layer's forward under each sequence impl at sp = 2 (one
# flash call on the full sequence, or one a ring hop); the backward makes
# as many of each of kernels 2 and 3
SP_FLASH_CALLS = {"ring": 0, "ulysses": 0, "ulysses_flash": 1, "ring_flash": 2}


def phase_cp_slice(card, spawned=None):
    """GPT-2-small trained over a cp = 2 ring: two spawned ranks (on one
    card they share it, time-sliced), the hop through kernel 4 into the
    neighbour's CUDA-IPC-mapped slot. Checks per rank: gloo sums CUDA
    tensors; dma's loss bit-identical to off's; kernel 4 launched
    n_layer × 2 per forward; ring_pass moves the right values; f32 ring
    loss and gradients within tolerance of single-device flash; three
    bf16 steps (and more) tracking the single-device step; identical
    replicas. ``spawned`` as :func:`phase_allreduce` takes it. Returns rank
    0's launches on the counted steps."""
    ranks, seconds = spawned or spawn_ranks(cp_rank, "cp")
    n_layer = 12
    r0 = ranks[0]
    for r in ranks:
        emit({"phase": "cp_slice", "model": "gpt2-small", "dtype": "bfloat16", "cp": 2,
              "global_batch": [TRAIN_B, TRAIN_S], "per_rank": [TRAIN_B, TRAIN_S // 2],
              "optimizer": "AdamW(3e-4, weight_decay=0.01)", "fused": "dma", "steps": CP_STEPS,
              "seconds_with_spawn": seconds, "card": card, **r})
    for r in ranks:
        rk = r["rank"]
        check(r["gloo_cuda_all_reduce_ok"], f"rank {rk}: gloo all_reduce of a CUDA tensor")
        check(r["dma_loss_bit_identical_to_off"] and r["sendahead_loss_bit_identical_to_off"],
              f"rank {rk}: schedule losses differ: {r['schedule_losses']}")
        check(r["flash_stream_launches_per_forward"] == {"off": 0, "dma": 2 * n_layer,
                                                         "sendahead": 0},
              f"rank {rk}: kernel 4 launches per forward {r['flash_stream_launches_per_forward']}, "
              f"expected {2 * n_layer} under dma and none otherwise")
        check(r["ring_pass_values_ok"], f"rank {rk}: ring_pass delivered the wrong values")
        check(r["launches"]["flash_stream"] == 2 * n_layer * CP_STEPS,
              f"rank {rk}: the counted steps launched kernel 4 {r['launches']['flash_stream']} "
              f"times, expected {2 * n_layer * CP_STEPS}")
        check(all(np.isfinite(r["cp_losses"])), f"rank {rk}: cp losses {r['cp_losses']}")
    check(ranks[0]["cp_losses"] == ranks[1]["cp_losses"]
          and ranks[0]["weights_checksum"] == ranks[1]["weights_checksum"],
          "the two replicas diverged")
    f32 = r0["f32"]
    check(f32["loss_rel_err"] <= 1e-5 and f32["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
          f"f32 ring loss/gradients vs single-device flash: {f32}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["cp_losses"], r0["single_losses"]))
    emit({"phase": "cp_slice_tracking", "cp_losses": r0["cp_losses"],
          "single_losses": r0["single_losses"], "max_rel_diff": rel, "tol": TOL_CP_BF16_LOSS})
    check(rel <= TOL_CP_BF16_LOSS and r0["cp_losses"][-1] < r0["cp_losses"][0],
          f"cp = 2 bf16 steps do not track the single-device steps: {rel}")

    # sp = 2 through each sequence impl: the step-0 loss against the ring2
    # step's and one device's, from the same weights and batch
    n_layer = 12
    rows = {}
    for impl in SP_IMPLS:
        r = [rk["sp"][impl] for rk in ranks]
        loss0 = r[0]["losses"][0]
        rows[impl] = {"step_ms_a_rank": [x["step_ms"] for x in r], "losses": r[0]["losses"],
                      "launches_rank0": r[0]["launches"],
                      "peak_memory_gb": [x["peak_memory_gb"] for x in r],
                      "rel_to_ring2": abs(loss0 - r0["cp_losses"][0]) / abs(r0["cp_losses"][0]),
                      "rel_to_single": abs(loss0 - r0["single_losses"][0])
                      / abs(r0["single_losses"][0])}
        calls = SP_FLASH_CALLS[impl] * n_layer * SP_STEPS
        for x in r:
            check(bf16_step_counts_ok(x["launches"], calls, calls),
                  f"sp = 2 {impl}: kernels 1-3 launched {x['launches']}, expected {calls} each")
            check(x["losses"] == r[0]["losses"] and all(np.isfinite(x["losses"])),
                  f"sp = 2 {impl}: the ranks' losses differ or are not finite: {x['losses']}")
        check(rows[impl]["rel_to_ring2"] <= TOL_CP_BF16_LOSS
              and rows[impl]["rel_to_single"] <= TOL_CP_BF16_LOSS
              and r[0]["losses"][-1] < loss0,
              f"sp = 2 {impl}: step-0 loss {loss0} against ring2's {r0['cp_losses'][0]} and one "
              f"device's {r0['single_losses'][0]}: {rows[impl]}")
    emit({"phase": "sp_impls", "model": "gpt2-small", "dtype": "bfloat16", "sp": 2,
          "global_batch": [TRAIN_B, TRAIN_S], "per_rank": [TRAIN_B, TRAIN_S // 2],
          "warmup": SP_WARMUP, "steps": SP_STEPS, "tol": TOL_CP_BF16_LOSS, "card": card,
          "note": "ranks time-slice one card; the same spawn as cp_slice", "impls": rows})
    sp_launches = {k: sum(ranks[0]["sp"][impl]["launches"][k] for impl in SP_IMPLS)
                   for k in ranks[0]["sp"]["ring"]["launches"]}
    return r0["launches"], sp_launches


# ---- data parallelism: the all-reduce family and the dp train step ------------------------

ALLREDUCE_ALGS = ("ring", "ring2", "naive", "xla")
ALLREDUCE_REPS, ALLREDUCE_WARMUP = 3, 1  # cut from 10, 2 and then 5, 1 (the run's time)
DP_WARMUP, DP_STEPS = 1, 3  # the first step grows the IPC slots
DP_BUCKET_MB = 4.0
DP_F32_B = 2  # global rows of the f32 gradient check (one a rank)
# the compressed syncs of the dp step: (algorithm, error feedback)
DP_QUANT = (("q8", False), ("q8_ring2", False), ("q8_ring2", True))
# tests/test_bucketing.py::test_dp_step_quant_ring_matches_xla_trajectory
DP_QUANT_DEV = 0.06


def gpt2_small_n_params() -> int:
    """Elements of GPT-2-small's gradient (vocab 50257), from its shapes."""
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config

    return GPT2(GPT2Config.small(), device="meta").n_params()


def allreduce_schedule_bytes(alg, n_elems, itemsize, n=2):
    """Device-memory bytes one all-reduce of ``n_elems`` moves on one card
    holding all ``n`` ranks, as the schedule moves them. A scatter-reduce
    hop of a segment: written into the peer's slot (read + write), copied
    out of the slot (read + write), combined (two reads, one write): 7
    segment passes; an all-gather hop: 6 (the store in place of the
    combine). ring/ring2: (n - 1) hops of each kind per rank; naive: n - 1
    hops of the whole payload, each 6 passes, then the reduce (n reads,
    one write). The copy into the padded buffer is not counted."""
    k = 2 if alg == "ring2" else 1
    padded = -(-n_elems // (k * n)) * (k * n)
    if alg in ("ring", "ring2"):
        per_rank = (n - 1) * 13 * (padded // n)
    elif alg == "naive":
        per_rank = (n - 1) * 6 * n_elems + (n + 1) * n_elems
    else:
        return None  # gloo: through host memory, not an HBM schedule
    return n * per_rank * itemsize


def collective_times(fn, pg, reps=ALLREDUCE_REPS, warmup=ALLREDUCE_WARMUP):
    """Host ms of each of ``reps`` calls of ``fn`` after ``warmup``, every
    call started together on both ranks (barrier) and ended by a device
    synchronize: the time a caller waits for one collective."""
    import torch.distributed as dist

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier(group=pg)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def allreduce_rank(rank, tmp):
    rank_main(allreduce_rank_run, "allreduce", rank, tmp)


def allreduce_rank_run(rank, tmp, res, stage):
    import torch.distributed as dist

    from dsml_tpu_torch.ops import collectives as C
    from dsml_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("dp")
    res["device"] = str(dev)

    def ipc_hops():
        return sum(group.ipc().sent.values())

    n_grad = gpt2_small_n_params()
    res["rows"] = []
    for dtype in (torch.float32, torch.bfloat16):
        size = torch.tensor([], dtype=dtype).element_size()
        # 4 KiB: the latency floor; then the bucket size, a large payload, one buffer
        for label, n_elems in (("4KiB", (4 << 10) // size), ("4MiB", (4 << 20) // size),
                               ("64MiB", (64 << 20) // size), ("gpt2_small_grad", n_grad)):
            stage(f"{label} {dtype}")
            # both ranks draw both inputs: each checks the sum itself
            ins = [torch.randn(n_elems, generator=torch.Generator(device=dev).manual_seed(r),
                               device=dev).to(dtype) for r in range(2)]
            want = ins[0] + ins[1]
            x = ins[rank]
            outs = {}
            for alg in ALLREDUCE_ALGS:
                times = collective_times(lambda: C.all_reduce(x, group, C.ReduceOp.SUM, alg), group.pg)
                before = ipc_hops()
                outs[alg] = C.all_reduce(x, group, C.ReduceOp.SUM, alg)
                route = "ipc" if ipc_hops() > before else "gloo"
                # naive: one hop of the whole payload; xla: gloo's own schedule, not counted
                wire = {"naive": n_elems * size, "xla": None}.get(
                    alg, C.ring_wire_bytes(n_elems, 2, size, alg == "ring2"))
                sched = allreduce_schedule_bytes(alg, n_elems, size)
                res["rows"].append({
                    "algorithm": alg, "route": route, "payload": label, "dtype": str(dtype)[6:],
                    "bytes": n_elems * size, "median_ms": statistics.median(times),
                    "min_ms": min(times), "max_ms": max(times), "calls": len(times),
                    "wire_bytes_per_rank": wire,
                    "schedule_bound_ms": None if sched is None else sched / PEAK_BYTES_PER_S * 1e3,
                    # each rank's input read once and its output written once
                    "function_bound_ms": 2 * 2 * n_elems * size / PEAK_BYTES_PER_S * 1e3,
                    "bit_identical_to_a_plus_b": bool(torch.equal(outs[alg], want)),
                    "max_abs_err": (outs[alg].float() - want.float()).abs().max().item()})
            # gloo within one ulp of a + b in its type (8 significant bits in
            # bf16, 24 in f32)
            _, exp = torch.frexp(want.float())
            ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32),
                              exp - (8 if dtype == torch.bfloat16 else 24))
            res["rows"][-1]["within_one_ulp"] = bool(
                ((outs["xla"].float() - want.float()).abs() <= ulp).all())
            del ins, want, x, outs
            torch.cuda.empty_cache()
    res["ipc_slot_bytes"] = 4 * group.ipc().capacity  # 2 directions x 2 parities
    stage("int8 cases")
    res["int8"] = {}
    gen = torch.Generator(device=dev).manual_seed(5)
    a, b = (torch.randint(-3, 4, (1001,), generator=gen, device=dev, dtype=torch.int8)
            for _ in range(2))
    x = (a, b)[rank]
    wants = {"SUM": (a.int() + b.int()).to(torch.int8), "PROD": (a.int() * b.int()).to(torch.int8),
             "MIN": torch.minimum(a, b), "MAX": torch.maximum(a, b)}
    for op, want in wants.items():
        for alg in ("ring", "ring2", "naive"):
            got = C.all_reduce(x, group, C.ReduceOp[op], alg)
            res["int8"][f"{alg}/{op}"] = bool(got.dtype == torch.int8 and torch.equal(got, want))
    stage("close")
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_allreduce(card, spawned=None):
    """The all-reduce family on two spawned ranks sharing the card: ring,
    ring2 and naive through the CUDA IPC ring, xla through gloo (host
    memory), at 4 KiB, 4 MiB, 64 MiB and GPT-2-small's whole gradient, f32
    and bf16. Checks: the IPC results bit-identical to each other and to
    a + b (n = 2: addition commutes), gloo within one ulp, the routes,
    and int8 SUM, MIN, MAX and PROD through every IPC algorithm.
    ``spawned`` is (ranks, seconds) of a spawn shared with other programs
    (:func:`spawn_two_rank_programs`); None spawns the ranks here."""
    ranks, seconds = spawned or spawn_ranks(allreduce_rank, "allreduce")
    # one line per payload and type: every algorithm, rank 0's row with rank
    # 1's times beside it
    lines = {}
    for row0, row1 in zip(ranks[0]["rows"], ranks[1]["rows"]):
        line = lines.setdefault((row0["payload"], row0["dtype"]), {
            "phase": "allreduce", "payload": row0["payload"], "dtype": row0["dtype"],
            "bytes": row0["bytes"], "ranks": 2, "same_card": True, "card": card})
        line[row0["algorithm"]] = {
            **{k: v for k, v in row0.items() if k not in ("algorithm", "payload", "dtype", "bytes")},
            "rank1": {k: row1[k] for k in ("median_ms", "min_ms", "max_ms", "route",
                                           "bit_identical_to_a_plus_b")}}
    for line in lines.values():
        emit(line)
    emit({"phase": "allreduce_ranks", "devices": [r["device"] for r in ranks],
          "ipc_slot_bytes": [r["ipc_slot_bytes"] for r in ranks],
          "int8": [r["int8"] for r in ranks], "seconds_with_spawn": seconds})
    for r in ranks:
        rk = r["rank"]
        for row in r["rows"]:
            what = f"rank {rk}: {row['algorithm']} {row['payload']} {row['dtype']}"
            if row["algorithm"] == "xla":
                check(row["route"] == "gloo", f"{what} took route {row['route']}")
                check(row["within_one_ulp"], f"{what}: gloo beyond one ulp of a + b")
            else:
                check(row["route"] == "ipc", f"{what} did not go through the IPC ring")
                check(row["bit_identical_to_a_plus_b"], f"{what} differs from a + b")
        check(all(r["int8"].values()), f"rank {rk}: int8 cases {r['int8']}")


QUANT_ALGS = ("q8", "q8_ring", "q8_ring2", "q4_ring", "q4_ring2")
QUANT_PAYLOADS = (("4MiB", Q8_BUCKET_ELEMS), ("64MiB", (64 << 20) // 2))  # bf16 elements


def quant_wire_bytes(alg, n_elems, n=2):
    """Per-rank wire bytes of one quantized all-reduce (the JAX package's
    formulas), or the full-precision bf16 ring's."""
    from dsml_tpu_torch.ops import collectives as C
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.parallel.bucketing import QUANT_RING_ALGORITHMS

    if alg == "ring":
        return C.ring_wire_bytes(n_elems, n, 2)
    if alg == "q8":
        return tq.compressed_gather_wire_bytes(n_elems, n)
    scheme, bidir = QUANT_RING_ALGORITHMS[alg.removesuffix("_deterministic")]
    return tq.quantized_ring_wire_bytes(n_elems, n, scheme, bidir)


def quant_allreduce_rank(rank, tmp):
    rank_main(quant_allreduce_rank_run, "quant_allreduce", rank, tmp)


def quant_allreduce_rank_run(rank, tmp, res, stage):
    import hashlib

    import torch.distributed as dist

    from dsml_tpu_torch.ops import collectives as C
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.parallel.bucketing import QUANT_RING_ALGORITHMS, _q8_bucket_seed
    from dsml_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("dp")
    res["device"] = str(dev)

    def ipc_hops():
        return sum(group.ipc().sent.values())

    def caller(alg, x, seed):
        """SUM of x over the pair by ``alg``: the function the sync calls."""
        if alg == "ring":
            return lambda: C.all_reduce(x, group, C.ReduceOp.SUM, "ring")
        if alg == "q8":
            return lambda: tq.compressed_all_reduce(x, group, seed, mean=False)
        scheme, bidir = QUANT_RING_ALGORITHMS[alg.removesuffix("_deterministic")]
        stochastic = not alg.endswith("_deterministic")
        return lambda: tq.quantized_ring_all_reduce(x, group, scheme, bidir, mean=False,
                                                    stochastic=stochastic, seed=seed)

    res["rows"] = []
    for label, n_elems in (*QUANT_PAYLOADS, ("gpt2_small_grad", gpt2_small_n_params())):
        stage(f"{label} bf16")
        # both ranks draw both inputs: each holds the result against the exact sum
        ins = [torch.randn(n_elems, generator=torch.Generator(device=dev).manual_seed(r),
                           device=dev).to(torch.bfloat16) for r in range(2)]
        exact = ins[0].float() + ins[1].float()
        x = ins[rank]
        seed = _q8_bucket_seed(x, 0)  # the bucket seed the sync passes, on the device
        # per-hop error <= one quantum of the partial sums (absmax <= n·max|x|),
        # n - 1 hops and the gather's quantization: the JAX suite's mean bound
        # times n for the sum
        amax = max(float(t.float().abs().max()) for t in ins)
        for alg in ("ring", *QUANT_ALGS, "q8_ring_deterministic"):
            fn = caller(alg, x, seed)
            times = collective_times(fn, group.pg)
            before = ipc_hops()
            tq.quantize_int8_launches = 0
            out = fn()
            torch.cuda.synchronize()
            launches = tq.quantize_int8_launches
            route = "ipc" if ipc_hops() > before else "gloo"
            err = float((out.float() - exact).abs().max())
            qmax = 127 if alg.startswith("q8") else 7 if alg.startswith("q4") else None
            res["rows"].append({
                "algorithm": alg, "route": route, "payload": label, "dtype": "bfloat16",
                "elements": n_elems, "median_ms": statistics.median(times), "min_ms": min(times),
                "max_ms": max(times), "calls": len(times), "quantize_int8_launches_per_call": launches,
                "wire_bytes_per_rank": quant_wire_bytes(alg, n_elems),
                "ring_wire_bytes_per_rank": quant_wire_bytes("ring", n_elems),
                "max_abs_err": err, "max_err_over_max_abs_sum": err / float(exact.abs().max()),
                "err_bound": None if qmax is None else 2 * 2 * amax / qmax,
                "sha256": hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()})
        del ins, exact, x, out
        torch.cuda.empty_cache()
    res["ipc_slot_bytes"] = 4 * group.ipc().capacity
    stage("close")
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def spawn_two_rank_programs():
    """The two-rank programs of cp_slice, the collectives, dp_slice, the
    checkpoint phase, the vision phase and the obs phase in one spawn, cp first (in fresh
    processes) and obs last (it leaves obs enabled in the ranks): ({name:
    each rank's JSON}, the shared spawn's seconds)."""
    return spawn_programs({"cp": (cp_rank, ()), "allreduce": (allreduce_rank, ()),
                           "quant_allreduce": (quant_allreduce_rank, ()),
                           "dp": (dp_rank, ()), "ckpt_dp": (ckpt_dp_rank, ()),
                           "vision": (vision_rank, ()), "obs_dp": (obs_dp_rank, ())}, "dp")


def phase_quant_allreduce(card, spawned=None):
    """The compressed all-reduces on two spawned ranks sharing the card,
    bf16 SUM at 4 MiB, 64 MiB and GPT-2-small's whole gradient passed
    straight to the function: the q8 gather (kernel 8, then the int8 values
    and scales over the IPC ring), the stochastic int8/int4 ring family and
    the deterministic q8_ring, beside the full-precision ring. Checks per
    rank: every algorithm on the IPC route; one kernel-8 launch per q8 call
    and none otherwise; each result within the JAX suite's error bound of
    the exact f32 sum; both ranks' results bit-identical. ``spawned`` as
    :func:`phase_allreduce` takes it."""
    ranks, seconds = spawned or spawn_ranks(quant_allreduce_rank, "quant_allreduce")
    lines = {}
    for row0, row1 in zip(ranks[0]["rows"], ranks[1]["rows"]):
        line = lines.setdefault(row0["payload"], {
            "phase": "quant_allreduce", "payload": row0["payload"], "dtype": "bfloat16",
            "op": "SUM", "elements": row0["elements"], "ranks": 2, "same_card": True, "card": card})
        line[row0["algorithm"]] = {
            **{k: v for k, v in row0.items() if k not in ("algorithm", "payload", "dtype", "elements",
                                                          "sha256")},
            "ranks_bit_identical": row0["sha256"] == row1["sha256"],
            "rank1": {k: row1[k] for k in ("median_ms", "min_ms", "max_ms", "route")}}
    for line in lines.values():
        emit(line)
    emit({"phase": "quant_allreduce_ranks", "devices": [r["device"] for r in ranks],
          "ipc_slot_bytes": [r["ipc_slot_bytes"] for r in ranks], "seconds_with_spawn": seconds})
    for row0, row1 in zip(ranks[0]["rows"], ranks[1]["rows"]):
        what = f"{row0['algorithm']} {row0['payload']}"
        for rk, row in enumerate((row0, row1)):
            check(row["route"] == "ipc", f"rank {rk}: {what} did not go through the IPC ring")
            check(row["quantize_int8_launches_per_call"] == (row["algorithm"] == "q8"),
                  f"rank {rk}: {what} launched kernel 8 {row['quantize_int8_launches_per_call']} times")
            if row["err_bound"] is not None:
                check(row["max_abs_err"] < row["err_bound"],
                      f"rank {rk}: {what} error {row['max_abs_err']} over {row['err_bound']}")
        check(row0["sha256"] == row1["sha256"], f"{what}: the two ranks' results differ")


def dp_rank(rank, tmp):
    rank_main(dp_rank_run, "dp", rank, tmp)


def dp_rank_run(rank, tmp, res, stage):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.ops.collectives import ReduceOp
    from dsml_tpu_torch.parallel.bucketing import bucketed_all_reduce, plan_buckets
    from dsml_tpu_torch.parallel.dp import make_dp_train_step, named_params
    from dsml_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("dp")
    res["device"] = str(dev)
    rng = np.random.default_rng(2)
    x_all = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    y_all = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    model = gpt2_small(cfg, dev)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}

    def flash_loss(m):
        return lambda x, y: m.loss(x, y, attn_impl="flash")

    # (a) the main path: bf16 dp steps under each algorithm from the same
    # weights; ring's steps counted, timed and traced
    losses = {}
    for alg in ("ring", "ring2", "naive"):
        stage(f"dp steps under {alg}")
        model.load_state_dict(init_state)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
        step = make_dp_train_step(model, opt, mesh, alg, bucket_size_mb=DP_BUCKET_MB,
                                  loss_fn=flash_loss(model))
        out = [step(x_all, y_all) for _ in range(DP_WARMUP)]
        torch.cuda.synchronize()
        if alg == "ring":
            dist.barrier()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts(tflash)
            t0 = time.perf_counter()
            out += [step(x_all, y_all) for _ in range(DP_STEPS)]
            torch.cuda.synchronize()
            res["step_ms"] = (time.perf_counter() - t0) * 1e3 / DP_STEPS
            res["launches"] = train_counts(tflash)
            res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
            res["ipc_slot_bytes"] = 4 * group.ipc().capacity  # outside PyTorch's allocator
            named = named_params(model, opt)
            res["bucket_count"] = plan_buckets(dict(named), DP_BUCKET_MB).n_buckets
            res["grad_bytes"] = sum(p.numel() * p.element_size() for _, p in named)
            with torch.no_grad():
                res["weights_checksum"] = float(sum(p.float().sum() for p in model.parameters()))
            stage("traced step")
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            if rank == 0:
                by_name = device_kernel_ms(lambda: step(x_all, y_all))
                res["trace"] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                                "device_busy_ms": sum(by_name.values()) if by_name else None,
                                "top_kernels_ms": dict(sorted(by_name.items(),
                                                              key=lambda kv: -kv[1])[:8])}
            else:
                step(x_all, y_all)
                torch.cuda.synchronize()
            stage("the sync alone")
            grads = [p.grad for _, p in named]
            sync = {}
            for name, alg_, mb in (("ring_4MiB", "ring", DP_BUCKET_MB), ("ring_one_buffer", "ring", None),
                                   ("gloo_one_buffer", "xla", None)):
                times = collective_times(
                    lambda: bucketed_all_reduce(grads, group, ReduceOp.AVG, alg_, mb), group.pg,
                    reps=5, warmup=1)
                sync[name] = {"median_ms": statistics.median(times), "min_ms": min(times),
                              "max_ms": max(times)}
            res["sync_ms"] = sync
            res["ipc_slot_bytes_after_sync"] = 4 * group.ipc().capacity
            del grads
        else:
            out += [step(x_all, y_all) for _ in range(DP_STEPS)]
        losses[alg] = [float(v) for v in out]
        del opt, step
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    res["losses"] = losses

    # (a2) the compressed syncs from the same weights and batches: q8 (kernel
    # 8 quantizes every float bucket), q8_ring2, q8_ring2 with error feedback
    quant = {}
    for alg, ef in DP_QUANT:
        name = alg + ("_ef" if ef else "")
        stage(f"dp steps under {name}")
        model.load_state_dict(init_state)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
        step = make_dp_train_step(model, opt, mesh, alg, bucket_size_mb=DP_BUCKET_MB,
                                  error_feedback=ef, loss_fn=flash_loss(model))
        out = [step(x_all, y_all) for _ in range(DP_WARMUP)]
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(tflash)
        tq.quantize_int8_launches = 0
        t0 = time.perf_counter()
        out += [step(x_all, y_all) for _ in range(DP_STEPS)]
        torch.cuda.synchronize()
        row = {"step_ms": (time.perf_counter() - t0) * 1e3 / DP_STEPS,
               "launches": {**train_counts(tflash), "quantize_int8": tq.quantize_int8_launches},
               "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "ipc_slot_bytes": 4 * group.ipc().capacity,
               "wire_bytes_per_rank": step.quant_wire_bytes, "losses": [float(v) for v in out]}
        with torch.no_grad():
            row["weights_checksum"] = float(sum(p.float().sum() for p in model.parameters()))
        stage(f"the {name} sync alone")
        grads = [p.grad for _, p in named_params(model, opt)]
        times = collective_times(
            lambda: bucketed_all_reduce(grads, group, ReduceOp.AVG, alg, DP_BUCKET_MB,
                                        error_feedback=step.error_feedback), group.pg,
            reps=5, warmup=1)
        row["sync_ms"] = {"median_ms": statistics.median(times), "min_ms": min(times),
                          "max_ms": max(times)}
        quant[name] = row
        del opt, step, grads
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
    res["quant"] = quant
    del model
    torch.cuda.empty_cache()

    # (a3) the reference repo's own workload: the MNIST MLP Trainer, one
    # epoch at dp = 2, full precision and compressed with error feedback
    stage("MNIST trainer")
    from dsml_tpu_torch.models import MLP
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils.data import load_mnist

    data = load_mnist(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mnist"))
    res["mnist"] = {}
    for alg, ef in (("ring", False), ("q8_ring2", True)):
        dist.barrier()
        t0 = time.perf_counter()
        _, history, test_acc = Trainer(MLP(device=dev), TrainConfig(epochs=1, dp=2, algorithm=alg,
                                                                    error_feedback=ef),
                                       mesh=mesh).train(data)
        res["mnist"][alg + ("_ef" if ef else "")] = {
            "seconds": time.perf_counter() - t0, "avg_loss": history[0]["avg_loss"],
            "test_accuracy": test_acc, "n_train": data.n_train}

    # (b) f32: one dp step's synced gradients (SGD at lr 0 leaves them in
    # p.grad and the weights as they were), held on rank 0 against the
    # single-device flash gradients of the same global rows
    stage("f32 dp gradients")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = gpt2_small(cfg32, dev)
    sgd = torch.optim.SGD(m32.parameters(), lr=0.0)
    step32 = make_dp_train_step(m32, sgd, mesh, "ring", bucket_size_mb=DP_BUCKET_MB,
                                loss_fn=flash_loss(m32))
    dp_loss32 = float(step32(x_all[:DP_F32_B], y_all[:DP_F32_B]))
    dp_grads = {n: p.grad.detach().clone() for n, p in m32.named_parameters()}
    stage("close")
    mesh.close()
    dist.destroy_process_group()
    if rank == 0:
        stage("single-device f32 gradients")
        m32.zero_grad(set_to_none=True)
        full = m32.loss(x_all[:DP_F32_B].to(dev), y_all[:DP_F32_B].to(dev), attn_impl="flash")
        full.backward()
        full = full.detach()
        worst, worst_name = 0.0, None
        for name, p in m32.named_parameters():
            rel = (dp_grads[name] - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-30)
            if rel >= worst:
                worst, worst_name = rel, name
        res["f32"] = {"dp_loss": dp_loss32, "single_loss": float(full),
                      "loss_rel_err": abs(dp_loss32 - float(full)) / abs(float(full)),
                      "grads_max_err_over_max_abs": worst, "grads_worst_tensor": worst_name}
        del m32, dp_grads
        torch.cuda.empty_cache()
        stage("single-device bf16 steps")
        single = GPT2(cfg, device=dev)
        single.load_state_dict(init_state)
        sopt = torch.optim.AdamW(single.parameters(), lr=3e-4, weight_decay=0.01)
        xs, ys = x_all.to(dev), y_all.to(dev)
        single_losses = []
        for _ in range(DP_WARMUP + DP_STEPS):
            sopt.zero_grad(set_to_none=True)
            loss = single.loss(xs, ys, attn_impl="flash")
            loss.backward()
            sopt.step()
            single_losses.append(float(loss.detach()))
        res["single_losses"] = single_losses
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_dp_slice(card, spawned=None):
    """GPT-2-small bf16 trained data-parallel at dp = 2 (global batch 8 ×
    1024, 4 × 1024 a rank, flash attention, AdamW(3e-4, weight_decay=0.01))
    by ``make_dp_train_step`` with the ring and 4 MiB buckets, two spawned
    ranks sharing the card, the gradients through the CUDA IPC ring.
    Checks: kernels 1-3 launched n_layer times each per rank per step;
    ring, ring2 and naive losses bit-identical; identical replicas; an f32
    step's gradients within TOL_TRAIN_GRADS of single-device flash; the bf16
    steps tracking the single-device steps within TOL_CP_BF16_LOSS."""
    # ``spawned``: (programs' ranks, seconds) of spawn_two_rank_programs,
    # where the checkpoint phase's dp = 2 resume and the obs phase's dp = 2
    # q8 program ride too (read by phase_checkpoint and phase_obs); a run
    # of this phase alone spawns them here
    out, seconds = spawned or spawn_programs({"dp": (dp_rank, ()), "ckpt_dp": (ckpt_dp_rank, ()),
                                              "obs_dp": (obs_dp_rank, ())}, "dp")
    ranks = out["dp"]
    n_layer = 12
    r0 = ranks[0]
    busy = r0["trace"]["device_busy_ms"]
    # both ranks run the same kernels on the one card: twice rank 0's traced
    # busy time over the untraced step (the traced wall carries the profiler)
    r0["trace"]["card_busy_share"] = None if busy is None else 2 * busy / r0["step_ms"]
    for r in ranks:
        emit({"phase": "dp_slice", "model": "gpt2-small", "dtype": "bfloat16", "dp": 2,
              "global_batch": [TRAIN_B, TRAIN_S], "per_rank": [TRAIN_B // 2, TRAIN_S],
              "optimizer": "AdamW(3e-4, weight_decay=0.01)", "algorithm": "ring",
              "bucket_mb": DP_BUCKET_MB, "steps": DP_STEPS, "warmup": DP_WARMUP,
              "seconds_with_spawn": seconds, "card": card, **r})
    for r in ranks:
        rk = r["rank"]
        check(bf16_step_counts_ok(r["launches"], n_layer * DP_STEPS, n_layer * DP_STEPS),
              f"rank {rk}: flash launches over {DP_STEPS} dp steps: {r['launches']}")
        ls = r["losses"]
        check(ls["ring"] == ls["ring2"] == ls["naive"],
              f"rank {rk}: ring / ring2 / naive losses differ: {ls}")
        check(all(np.isfinite(ls["ring"])), f"rank {rk}: dp losses {ls['ring']}")
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and ranks[0]["weights_checksum"] == ranks[1]["weights_checksum"],
          "the two replicas diverged")
    f32 = r0["f32"]
    check(f32["loss_rel_err"] <= 1e-5 and f32["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
          f"f32 dp gradients vs single-device flash: {f32}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"]["ring"], r0["single_losses"]))
    emit({"phase": "dp_slice_tracking", "dp_losses": r0["losses"]["ring"],
          "single_losses": r0["single_losses"], "max_rel_diff": rel, "tol": TOL_CP_BF16_LOSS})
    check(rel <= TOL_CP_BF16_LOSS and r0["losses"]["ring"][-1] < r0["losses"]["ring"][0],
          f"dp = 2 bf16 steps do not track the single-device steps: {rel}")
    # the compressed syncs: kernel 8 once per float bucket per q8 step, kernels
    # 1-3 12 times a step, identical replicas, losses within the JAX suite's
    # quantized bar of the ring's
    ring = r0["losses"]["ring"]
    for name, row in r0["quant"].items():
        drift = max(abs(a - b) / max(abs(b), 1e-2) for a, b in zip(row["losses"], ring))
        emit({"phase": "dp_slice_quant", "algorithm": name, "bucket_mb": DP_BUCKET_MB,
              "float_buckets": r0["bucket_count"], "max_dev_from_ring": drift, "tol": DP_QUANT_DEV,
              "card": card, "ring_losses": ring,
              "ranks": [{"rank": r["rank"], **r["quant"][name]} for r in ranks]})
        for r in ranks:
            q = r["quant"][name]
            counts = {k: v for k, v in q["launches"].items() if k != "quantize_int8"}
            check(bf16_step_counts_ok(counts, n_layer * DP_STEPS, n_layer * DP_STEPS),
                  f"rank {r['rank']}: {name} flash launches {counts}")
            want = r["bucket_count"] * DP_STEPS if name == "q8" else 0
            check(q["launches"]["quantize_int8"] == want,
                  f"rank {r['rank']}: {name} launched kernel 8 {q['launches']['quantize_int8']} "
                  f"times in {DP_STEPS} steps, expected {want}")
            check(all(np.isfinite(q["losses"])), f"rank {r['rank']}: {name} losses {q['losses']}")
        check(ranks[0]["quant"][name]["losses"] == ranks[1]["quant"][name]["losses"]
              and ranks[0]["quant"][name]["weights_checksum"] == ranks[1]["quant"][name]["weights_checksum"],
              f"{name}: the two replicas diverged")
        check(drift < DP_QUANT_DEV, f"{name}: dp losses off the ring's by {drift}")
    emit({"phase": "dp_slice_mnist", "trainer": "MLP, 1 epoch, global batch 64, dp = 2",
          "card": card, "ranks": [{"rank": r["rank"], **r["mnist"]} for r in ranks]})
    for r in ranks:
        for name, m in r["mnist"].items():
            check(np.isfinite(m["avg_loss"]) and m["test_accuracy"] > 0.5,
                  f"rank {r['rank']}: the MNIST trainer under {name}: {m}")
    return (r0["launches"], r0["quant"]["q8"]["launches"]["quantize_int8"],
            (out["obs_dp"], seconds), (out["ckpt_dp"], seconds))


# ---- the vision family: the MNIST CNN and CIFAR ResNet-18 -------------------------

VISION_SYNTH_N = 2276  # CIFAR-shaped synthetic rows: 2048 to train on (8 batches of 256), 228 held out
VISION_BATCH = 256  # BASELINE config 4's global batch
VISION_EPOCHS = 3  # three plateau windows (one an epoch) close
VISION_WARMUP, VISION_TIMED = 2, 5  # timed ResNet-18 steps after a warm-up
VISION_SINGLE_TIMED = 10
VISION_MNIST_ARGS = ["--model", "cnn", "--epochs", "1", "--batch_size", "64", "--lr", "0.05",
                     "--optimizer", "momentum"]  # the JAX suite's tests/test_models.py:13-22
VISION_DIR = os.path.join("build", "vision")


def vision_args(*extra):
    """``cli.train_cifar_resnet``'s flags for the dp = 2 runs: the config-4
    defaults (batch 256, lr 0.1, momentum, ring, plateau) at patience 1 on
    the synthetic CIFAR-shaped set (no binaries in the repo)."""
    return ["--epochs", str(VISION_EPOCHS), "--synth_n", str(VISION_SYNTH_N),
            "--plateau_patience", "1", "--dp", "2", "--data_dir", os.path.join(VISION_DIR, "none"),
            *extra]


def vision_rank(rank, tmp):
    rank_main(vision_rank_run, "vision", rank, tmp)


def vision_rank_run(rank, tmp, res, stage):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.cli import train_cifar_resnet as cifar
    from dsml_tpu_torch.ops.collectives import ReduceOp
    from dsml_tpu_torch.parallel.bucketing import bucketed_all_reduce, default_bucket_mb
    from dsml_tpu_torch.parallel.dp import make_dp_train_step, named_params
    from dsml_tpu_torch.parallel.mesh import data_mesh
    from dsml_tpu_torch.trainer import Trainer

    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("dp")
    res["device"] = str(dev)
    data = cifar.cifar_data(cifar.CIFARConfig.parse_args(vision_args()))
    # (b) the entry point's rank path (its config, model and data on this
    # spawn's mesh) under ring, then naive from the same seed; cuDNN's
    # deterministic algorithms, so the two runs can agree bit for bit
    torch.backends.cudnn.deterministic = True
    res["trainer"] = {}
    for alg in ("ring", "naive"):
        stage(f"ResNet-18 Trainer under {alg}")
        cfg = cifar.CIFARConfig.parse_args(vision_args("--algorithm", alg))
        model = cifar.cifar_model(cfg, dev)
        trainer = Trainer(model, cfg, mesh=mesh)
        dist.barrier()
        t0 = time.perf_counter()
        _, history, acc = trainer.train(data)
        torch.cuda.synchronize()
        res["trainer"][alg] = {
            "seconds": time.perf_counter() - t0, "epoch_losses": [h["avg_loss"] for h in history],
            "train_accuracy": [h["train_accuracy"] for h in history], "test_accuracy": acc,
            "weights_sha256": _param_sha(model.parameters()),
            "plateau": {k: float(v) for k, v in trainer.plateau.state()._asdict().items()}}
        del model, trainer
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    # the dp step timed alone: a rank's step, the card's images/s, memory, the sync
    stage("timed dp steps")
    x_all = torch.from_numpy(data.train_x[:VISION_BATCH])
    y_all = torch.from_numpy(data.train_y[:VISION_BATCH])
    model = cifar.cifar_model(cfg, dev).init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = make_dp_train_step(model, opt, mesh, "ring")
    for _ in range(VISION_WARMUP):
        step(x_all, y_all)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(VISION_TIMED):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        step(x_all, y_all)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["step_ms"] = statistics.median(times)
    res["step_ms_all"] = times
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    grads = [p.grad for _, p in named_params(model, opt)]
    mb = default_bucket_mb()
    sync = collective_times(lambda: bucketed_all_reduce(grads, group, ReduceOp.AVG, "ring", mb),
                            group.pg, reps=5, warmup=1)
    res["sync_ms"] = {"bucket_mb": mb, "median_ms": statistics.median(sync), "min_ms": min(sync),
                      "max_ms": max(sync), "grad_bytes": sum(g.numel() * 4 for g in grads)}
    res["ipc_slot_bytes"] = 4 * group.ipc().capacity
    del model, opt, step, grads
    torch.cuda.empty_cache()
    # one ring step's synced f32 gradients (SGD at lr 0 leaves them in p.grad)
    stage("f32 dp gradients")
    model = cifar.cifar_model(cfg, dev).init(0)
    step = make_dp_train_step(model, torch.optim.SGD(model.parameters(), lr=0.0), mesh, "ring")
    dp_loss = float(step(x_all, y_all))
    dp_grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stage("close")
    mesh.close()
    dist.destroy_process_group()
    if rank == 0:
        # the plain single-device computation of the same per-rank batch
        # norm: each half of the batch normalised alone, the losses averaged
        stage("single-device f32 gradients")
        model.zero_grad(set_to_none=True)
        half = VISION_BATCH // 2
        xs, ys = x_all.to(dev), y_all.to(dev)
        loss = (model.loss(xs[:half], ys[:half]) + model.loss(xs[half:], ys[half:])) / 2
        loss.backward()
        worst, worst_name = 0.0, None
        for name, p in model.named_parameters():
            rel = (dp_grads[name] - p.grad).abs().max().item() / max(p.grad.abs().max().item(), 1e-30)
            if rel >= worst:
                worst, worst_name = rel, name
        res["f32"] = {"dp_loss": dp_loss, "single_loss": float(loss.detach()),
                      "loss_rel_err": abs(dp_loss - float(loss.detach())) / abs(float(loss.detach())),
                      "grads_max_err_over_max_abs": worst, "grads_worst_tensor": worst_name}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_vision(dev, card, spawned=None):
    """The vision family (BASELINE configs 3 and 4) through its entry points: (a)
    ``cli.train_mnist --model cnn`` on the repo's MNIST (one epoch, batch
    64, momentum, lr 0.05): holdout accuracy > 0.85, steps/s; (b) ResNet-18
    at full width, f32, dp = 2 on two spawned ranks sharing the card (the
    ring over the CUDA IPC transport): ``cli.train_cifar_resnet``'s config
    (batch 256, lr 0.1, momentum, plateau at patience 1) for 3 epochs of 8
    steps on the CIFAR-shaped synthetic set, under ring and naive (losses,
    weights and plateau state bit-identical), identical replicas, the
    loss falling, the first step's synced f32 gradients within
    TOL_TRAIN_GRADS of one device's plain computation of the same per-rank
    batch norm, a rank's step ms, images/s, peak memory and the sync's ms
    (cost: the ranks time-slice one card); (c) one single-device ResNet-18
    f32 train step at batch 256, timed, with its peak memory. No kernel of
    the port lies on this path (cuDNN convolutions, as the JAX package's
    XLA ones outside any Pallas kernel). ``spawned``: (the vision program's
    ranks, seconds) of spawn_two_rank_programs; a run alone spawns them."""
    from dsml_tpu_torch.cli import train_mnist
    from dsml_tpu_torch.cli.train_cifar_resnet import CIFARConfig, cifar_data, cifar_model
    from dsml_tpu_torch.parallel.dp import make_dp_train_step

    os.makedirs(VISION_DIR, exist_ok=True)
    # (a) the MNIST CNN through its entry point, on this process's card
    log_path = os.path.join(VISION_DIR, "mnist_cnn.jsonl")
    if os.path.exists(log_path):
        os.remove(log_path)
    t0 = time.perf_counter()
    acc = train_mnist.main(VISION_MNIST_ARGS + ["--log_metrics", log_path])
    seconds = time.perf_counter() - t0
    with open(log_path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    epoch, final = lines[0], lines[-1]
    steps = 40000 // 64  # the loader's 8000 training images, each with its 4 shifts
    emit({"phase": "vision_cnn", "entry_point": "cli.train_mnist " + " ".join(VISION_MNIST_ARGS),
          "model": "CNN (conv 32, conv 64, fc 128)", "steps": steps, "avg_loss": epoch["avg_loss"],
          "train_accuracy": epoch["train_accuracy"], "test_accuracy": acc, "holdout": 2000,
          "trainer_wall_s": final["wall_time_s"], "steps_per_s": steps / final["wall_time_s"],
          "seconds": seconds, "card": card,
          "note": "steps_per_s over the Trainer's wall: the epoch's steps and the training-set "
                  "and holdout evals; seconds: the entry point's call, the data load included"})
    check(acc > 0.85, f"the MNIST CNN's holdout accuracy {acc} is not above 0.85")
    # (c) one device, batch 256
    cfg = CIFARConfig.parse_args(vision_args())
    data = cifar_data(cfg)
    x, y = (torch.from_numpy(a[:VISION_BATCH]) for a in (data.train_x, data.train_y))
    model = cifar_model(cfg, dev).init(0)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = make_dp_train_step(model, opt)
    for _ in range(3):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for _ in range(VISION_SINGLE_TIMED):
        t0 = time.perf_counter()
        losses.append(step(x, y))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    single_ms = statistics.median(times)
    losses = [float(v) for v in losses]
    emit({"phase": "vision_resnet_single", "model": "ResNet-18 (11.17M parameters)", "dtype": "float32",
          "tf32": False, "batch": VISION_BATCH, "optimizer": "SGD(0.1, momentum=0.9)",
          "step_ms": single_ms, "step_ms_min": min(times), "step_ms_max": max(times),
          "images_per_s": VISION_BATCH / (single_ms / 1e3),
          "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "losses": losses,
          "card": card})
    check(all(np.isfinite(losses)), f"single-device ResNet-18 losses {losses}")
    del model, opt, step
    torch.cuda.empty_cache()
    # (b) dp = 2 on the two-rank spawn
    out, spawn_seconds = spawned or spawn_programs({"vision": (vision_rank, ())}, "vision")
    ranks = out if spawned else out["vision"]
    r0 = ranks[0]
    emit({"phase": "vision_resnet_dp", "model": "ResNet-18", "dtype": "float32", "tf32": False,
          "dp": 2, "global_batch": VISION_BATCH, "per_rank": VISION_BATCH // 2,
          "entry_point": "cli.train_cifar_resnet " + " ".join(vision_args()),
          "steps_per_epoch": 2048 // VISION_BATCH, "epochs": VISION_EPOCHS,
          "seconds_with_spawn": spawn_seconds, "card": card,
          "note": "cost, not a speed-up: the two ranks time-slice one card (beside the TinyLlama "
                  "entry points in the full run); images_per_s is the global batch over a rank's "
                  "step",
          "ranks": [{**{k: v for k, v in r.items() if k != "trainer"},
                     "images_per_s": VISION_BATCH / (r["step_ms"] / 1e3), "trainer": r["trainer"]}
                    for r in ranks]})
    for r in ranks:
        rk, t = r["rank"], r["trainer"]
        check(t["ring"]["epoch_losses"] == t["naive"]["epoch_losses"]
              and t["ring"]["weights_sha256"] == t["naive"]["weights_sha256"]
              and t["ring"]["plateau"] == t["naive"]["plateau"],
              f"rank {rk}: ring and naive ResNet-18 runs differ: {t}")
        losses = t["ring"]["epoch_losses"]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"rank {rk}: ResNet-18 epoch losses do not fall: {losses}")
    check(all(ranks[0]["trainer"][a][k] == ranks[1]["trainer"][a][k] for a in ("ring", "naive")
              for k in ("epoch_losses", "weights_sha256", "plateau", "test_accuracy")),
          "the two ResNet-18 replicas diverged")
    plateau = r0["trainer"]["ring"]["plateau"]
    check(plateau["count"] == 0 and np.isfinite(plateau["best_value"]),
          f"the plateau's windows did not close: {plateau}")
    f32 = r0["f32"]
    check(f32["loss_rel_err"] <= 1e-5 and f32["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
          f"f32 ResNet-18 dp gradients vs one device's per-rank batch norm: {f32}")
    return single_ms


# ---- Llama: TinyLlama-1.1B trained and served ------------------------------------

LLAMA_HEADS, LLAMA_KV_HEADS = 32, 4  # TinyLlama-1.1B: head_dim 64, 8 query heads a kv head
LLAMA_TRAIN_B, LLAMA_TRAIN_S = 2, 2048  # the JAX bench's llama1b row
LLAMA_TRAIN_WARMUP, LLAMA_TRAIN_STEPS = 2, 4
LLAMA_SPEC_WINDOW = 4
LLAMA_F32_REQUESTS = 8  # the f32 drains: the first 8 of the 48 (cut from 16: the run's time)
LLAMA_SERVE_REQUESTS = 24  # the bf16 drains: the first 24 of the 48 (cut from 48: the run's time)
# the JAX bench's Llama serving row (bench.py::_bench_serving_llama_kvquant), at full width
LLAMA_TICK_SLOTS, LLAMA_TICK_QUANTUM, LLAMA_TICK_PROMPT, LLAMA_TICK_NEW = 8, 8, 128, 64
LLAMA_TURBO, LLAMA_ADAPTIVE = 4, 32
LLAMA_LOSS_AT_INIT = float(np.log(32000))  # a uniform guess over the vocabulary


_LLAMA_DRAW: dict = {}  # the process of :func:`llama_weights_start`, once started


def llama_weights_path():
    from dsml_tpu_torch.ops import _build

    return str(_build.BUILD_DIR.parent / "llama" / "tinyllama_f32.pt")


def llama_weights_child(path):
    """TinyLlama-1.1B's f32 weights from seed 0 (``Llama.init``: the JAX
    init's numpy draws), saved to ``path`` (its own process, started with
    the kernels' build)."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig

    t0 = time.perf_counter()
    state = Llama(LlamaConfig.tinyllama_1b(), device="cpu").init(0).state_dict()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


def llama_weights_start():
    """Start :func:`llama_weights_child` as a process (the full run starts it
    before the build, whose nvcc processes leave cores idle); the first
    :func:`llama_weights` call waits for it and reads its file."""
    path = llama_weights_path()
    if os.path.exists(path):
        os.remove(path)
    root = os.path.dirname(os.path.abspath(__file__))
    _LLAMA_DRAW["proc"] = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.llama_weights_child({path!r})"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, **ONE_THREAD})
    return _LLAMA_DRAW["proc"]


@functools.lru_cache(maxsize=1)
def llama_weights():
    """TinyLlama-1.1B's f32 weights from seed 0 (``Llama.init``: the JAX
    init's numpy draws), drawn once on the host for every Llama phase: read
    from :func:`llama_weights_start`'s file when that process runs, else
    drawn here."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig

    proc = _LLAMA_DRAW.pop("proc", None)
    if proc is None:
        return Llama(LlamaConfig.tinyllama_1b(), device="cpu").init(0).state_dict()
    out, _ = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"the TinyLlama weights process failed:\n{out[-3000:]}")
    path = llama_weights_path()
    state = torch.load(path, weights_only=True)
    os.remove(path)
    return state


def llama_model(dev, **replace):
    """TinyLlama-1.1B on ``dev`` with ``replace`` applied to its config,
    holding :func:`llama_weights` (rounded to bf16 for a bf16 model)."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig

    model = Llama(dataclasses.replace(LlamaConfig.tinyllama_1b(), **replace), device=dev)
    model.load_state_dict(llama_weights())
    return model


def llama_cli_start():
    """Start the three Llama entry points as processes on the card (no
    ``--device``): ``train_gpt2`` trains TinyLlama-1.1B for 3 steps,
    ``serve_continuous`` serves the tiny Llama under turbo ticks and
    ``decode_speculative`` decodes TinyLlama-1.1B in f32. They run while
    this process builds its own TinyLlama weights (host work) and are
    waited for before any Llama phase is timed."""
    entries = {
        "train_gpt2": ["dsml_tpu_torch.cli.train_gpt2", "--family", "llama", "--model",
                       "tinyllama_1b", "--attn", "flash", "--dtype", "bfloat16", "--steps", "3",
                       "--batch_size", "2", "--grad_accum", "1", "--log_every", "1",
                       "--warmup_steps", "1"],
        "serve_continuous": ["dsml_tpu_torch.cli.serve_continuous", "--family", "llama",
                             "--turbo", "4"],
        "decode_speculative": ["dsml_tpu_torch.cli.decode_speculative", "--family", "llama",
                               "--model", "tinyllama_1b"],
    }
    root = os.path.dirname(os.path.abspath(__file__))
    return {name: subprocess.Popen([sys.executable, "-m", *args], cwd=root, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True,
                                   env={**os.environ, **ONE_THREAD})
            for name, args in entries.items()}


def phase_llama_cli(procs):
    """Wait for the entry points of :func:`llama_cli_start` and check each
    exit code and its closing log line."""
    want = {"train_gpt2": "dsml.gpt2: step 3: loss =",
            "serve_continuous": "dsml.serve: tokens/s: continuous",
            "decode_speculative": "tokens identical to greedy generate"}
    t_phase = time.perf_counter()
    row, failed = {"phase": "llama_cli"}, []
    for name, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        lines = [line for line in out.splitlines() if "dsml." in line]
        ok = proc.returncode == 0 and want[name] in out
        row[name] = {"exit_code": proc.returncode, "ok": ok, "log_tail": lines[-4:]}
        if not ok:
            failed.append(f"{name} (exit {proc.returncode}):\n{out[-3000:]}")
    row["seconds_waited"] = time.perf_counter() - t_phase
    emit(row)
    check(not failed, "a Llama entry point failed: " + "\n".join(failed))


def family_kernels(tflash, dev, path, heads, kv_heads, d, verify):
    """Kernels 1–3 at a Llama-family train shape, [2·heads, 2048, d] bf16
    causal, and kernels 5–6 at its serving shapes (16 slots, ``kv_heads``
    under ``heads`` query heads, head_dim ``d``, int4 pages, bf16 q: decode,
    with ``verify`` the W = 4 verify window, a 256-row chunk; f32 q at
    decode (and verify), the f32 drains' shape), each against its plain
    version; then kernel_time lines beside the bounds. ``path`` names the
    lines ("llama", "moe")."""
    from dsml_tpu_torch.ops import paged_attention as tpa

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    bh, s, dt = LLAMA_TRAIN_B * heads, LLAMA_TRAIN_S, torch.bfloat16
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device=dev).to(dt) for _ in range(4))
    tflash.flash_fwd_launches = 0
    out, lse = tflash.flash_fwd(q, k, v, True)
    torch.cuda.synchronize()
    ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, True)
    errs = {"out": (out.float() - ref_out.float()).abs().max().item(),
            "lse": (lse - ref_lse).abs().max().item()}
    ok = (tflash.flash_fwd_launches == 1 and bool(torch.isfinite(out).all())
          and errs["out"] <= TOL[dt]["out"] and errs["lse"] <= TOL[dt]["lse"])
    emit({"phase": f"{path}_kernel", "kernel": "flash_fwd", "shape": [bh, s, d],
          "dtype": "bfloat16", "causal": True, "max_abs_err": errs, "tol": TOL[dt], "ok": ok})
    check(ok, f"flash_fwd at the {path} train shape: {errs}")
    before = bwd_counts(tflash)
    got = tflash.flash_bwd(q, k, v, ref_out, ref_lse, do)
    torch.cuda.synchronize()
    launched = {name: n - before[name] for name, n in bwd_counts(tflash).items()}
    want = tflash._flash_bwd_reference(q, k, v, ref_out, ref_lse, do)
    bwd_errs, rel = {}, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        bwd_errs[name] = (g.float() - w.float()).abs().max().item()
        rel = max(rel, bwd_errs[name] / max(w.float().abs().max().item(), 1e-30))
    ok = (launched == {name: int(name in BWD_KERNELS[dt]) for name in launched}
          and all(bool(torch.isfinite(g).all()) for g in got) and rel <= TOL_BWD[dt])
    emit({"phase": f"{path}_kernel", "kernels": list(BWD_KERNELS[dt]), "shape": [bh, s, d],
          "dtype": "bfloat16", "causal": True, "launched": launched, "max_abs_err": bwd_errs,
          "max_err_over_max_abs": rel, "tol": TOL_BWD[dt], "ok": ok})
    check(ok, f"flash_bwd at the {path} train shape: launched {launched}, rel err {rel}")
    del got, want

    timing = {}
    q4, k4, v4 = (t.view(LLAMA_TRAIN_B, heads, s, d) for t in (q, k, v))
    fwd_bound, fwd_by = attention_bound_ms(bh, s, s, d, dt, True)
    timing["flash_fwd"] = {
        "ms": device_ms(functools.partial(tflash.flash_fwd, q, k, v, True), pattern="flash_fwd_kernel<"),
        "plain_ms": cuda_ms(functools.partial(tflash._flash_fwd_reference, q, k, v, True), reps=5,
                            warmup=1),
        "bound_ms": fwd_bound, "bound_by": fwd_by,
        "library_ms": device_ms(functools.partial(F.scaled_dot_product_attention, q4, k4, v4,
                                                  is_causal=True))}
    call = functools.partial(tflash.flash_bwd, q, k, v, ref_out, ref_lse, do)
    plain_bwd = cuda_ms(functools.partial(tflash._flash_bwd_reference, q, k, v, ref_out, ref_lse,
                                          do), reps=5, warmup=1)
    qg, kg, vg, dog = (t.view(LLAMA_TRAIN_B, heads, s, d).detach().requires_grad_()
                       for t in (q, k, v, do))

    def sdpa(backward):
        o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        if backward:
            torch.autograd.grad(o, (qg, kg, vg), dog)

    library_bwd = (device_ms(functools.partial(sdpa, True), reps=10)
                   - device_ms(functools.partial(sdpa, False), reps=10))
    for name, products, n_out in zip(BWD_KERNELS[dt], (3, 4), (1, 2)):
        bound_ms, bound_by = backward_bound_ms(bh, s, s, d, dt, True, products, n_out)
        timing[name] = {"ms": device_ms(call, reps=10, pattern=f"{name}_kernel<"),
                        "plain_ms": plain_bwd, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_bwd}
    emit({"phase": "kernel_time", "path": path, "shape": [bh, s, d], "dtype": "bfloat16",
          "causal": True, **timing, "note": "ms and library_ms profiler device time, plain_ms CUDA "
          "events (the plain versions' ~20 launches a call made whole profiler traces flaky); "
          "the backward's plain_ms and library_ms are whole backwards (dq, dk and dv), "
          "library_ms SDPA forward+backward minus forward"})
    del q, k, v, do, out, lse, ref_out, ref_lse, q4, k4, v4, qg, kg, vg, dog

    # kernels 5 and 6 at the serving shapes, through the kernel_paged checks
    rng = np.random.default_rng(12)
    n_pt = 2048 // PAGE
    depths = rng.integers(1, 2048, PAGED_SLOTS)
    decode_pos = (depths - 1)[:, None].copy()
    decode_pos[[5, 9]] = -1  # dead slots
    shapes = {f"{path}_decode": (PAGED_SLOTS, decode_pos)}
    verify_pos = rng.integers(0, 2044, PAGED_SLOTS)[:, None] + np.arange(LLAMA_SPEC_WINDOW)[None, :]
    if verify:
        shapes[f"{path}_verify"] = (PAGED_SLOTS, verify_pos)
    shapes[f"{path}_chunk"] = (1, (512 + np.arange(PAGED_CHUNK))[None, :])
    paged_err, paged_timing = 0.0, {}
    for shape, (b, positions) in shapes.items():
        for q_dtype in (torch.bfloat16, torch.float32):
            if shape.endswith("_chunk") and q_dtype == torch.float32:
                continue  # f32 drains prefill chunks too, but chunks are the bf16 path's shape
            args = paged_case(dev, rng, gen, b, heads, kv_heads, d, n_pt, positions, q_dtype,
                              "int4")
            err = paged_check(dev, tpa, shape, args, "int4", q_dtype, positions)
            if q_dtype == torch.bfloat16:
                paged_err = max(paged_err, err)
                call = (*args, "int4")
                per_kernel = paged_kernel_ms(tpa, call)
                bound_ms, bound_by = paged_bound_ms(*args)
                plain_ms = cuda_ms(lambda: tpa._paged_attention_reference(*call))
                for name in ("paged_attn", "paged_attn_pipelined"):
                    paged_timing.setdefault(name, {})[shape] = {
                        "ms": per_kernel[name], "call_device_ms": per_kernel[f"{name}_call"],
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None}
    emit({"phase": "kernel_time", "path": path, "kernels": ["paged_attn", "paged_attn_pipelined"],
          "shapes": {f"{path}_decode": "16 slots, depths 1-2047 (2 dead)",
                     **({f"{path}_verify": f"16 slots, W = {LLAMA_SPEC_WINDOW}"} if verify else {}),
                     f"{path}_chunk": f"{PAGED_CHUNK} rows from 512"},
          "hq": heads, "hkv": kv_heads, "hd": d, "page": PAGE, "q": "bfloat16",
          "codec": "int4", **paged_timing, "phase_seconds": time.perf_counter() - t_phase})
    return {"flash_err": errs["out"], "bwd_err": bwd_errs, "paged_err": paged_err,
            "timing": timing, "paged_timing": paged_timing}


def phase_llama_train(tflash, dev, card):
    """TinyLlama-1.1B bf16 at batch 2 × 2048 (the JAX bench's llama1b row:
    flash attention, the chunked loss of 8192 vocabulary rows through the
    untied lm_head, AdamW(3e-4, weight_decay=0.01), weights from seed 0)
    on one batch repeated: 22 launches of kernels 1–3 a step, step ms,
    tokens/s, MFU, peak memory, a first loss near ln 32000 that falls."""
    from dsml_tpu_torch.models.common import transformer_train_flops

    t_phase = time.perf_counter()
    model = llama_model(dev, dtype="bfloat16", xent_chunk=8192)
    cfg = model.config
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)), device=dev)
    y = torch.roll(x, -1, 1)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, y, attn_impl="flash")
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(LLAMA_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tflash)  # the main path, counted
    t0 = time.perf_counter()
    losses += [step() for _ in range(LLAMA_TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / LLAMA_TRAIN_STEPS
    counts = train_counts(tflash)
    peak = torch.cuda.max_memory_allocated()
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()  # weights, AdamW state, the batch
    losses = torch.stack(losses).float().tolist()
    tokens = LLAMA_TRAIN_B * LLAMA_TRAIN_S
    flops = transformer_train_flops(cfg, tokens, LLAMA_TRAIN_S, gated_mlp=True)
    emit({"phase": "llama_train", "model": "tinyllama-1.1b", "params": model.n_params(),
          "dtype": "bfloat16", "batch": LLAMA_TRAIN_B, "seq": LLAMA_TRAIN_S, "attn_impl": "flash",
          "xent_chunk": cfg.xent_chunk, "optimizer": "AdamW(3e-4, weight_decay=0.01)",
          "steps": LLAMA_TRAIN_STEPS, "launches": counts, "step_ms": step_ms,
          "tokens_per_s": tokens * 1e3 / step_ms, "model_flops_per_step": flops,
          "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "losses": losses,
          "loss_at_init": LLAMA_LOSS_AT_INIT, "card": card,
          "phase_seconds": time.perf_counter() - t_phase})
    want = cfg.n_layer * LLAMA_TRAIN_STEPS
    check(bf16_step_counts_ok(counts, want, want),
          f"Llama train steps launched {counts}, expected {want} of the forward and of each "
          f"tensor-core backward kernel ({cfg.n_layer} per step) and no FMA backward")
    check(all(np.isfinite(losses)) and abs(losses[0] - LLAMA_LOSS_AT_INIT) < 0.5
          and losses[-1] < losses[0],
          f"Llama train loss not finite, near ln 32000 at first and falling: {losses}")
    phase_train_trace(step, label="llama_train_step")
    del model, opt
    # the planner's activation measurement of this step, from shapes alone
    from dsml_tpu_torch.models.llama import Llama
    from dsml_tpu_torch.parallel.auto import measured_activation_bytes

    meta = Llama(cfg, device="meta")
    xm = torch.empty(LLAMA_TRAIN_B, LLAMA_TRAIN_S, dtype=torch.long, device="meta")
    t0 = time.perf_counter()
    act = measured_activation_bytes(lambda a, b: meta.loss(a, b, attn_impl="xla"), xm, xm)
    emit({"phase": "activation_measurement", "model": "tinyllama-1.1b", "dtype": "bfloat16",
          "batch": [LLAMA_TRAIN_B, LLAMA_TRAIN_S], "measured_activation_bytes": act,
          "measured_seconds": time.perf_counter() - t0,
          "step_peak_bytes": peak, "resident_bytes": resident,
          "peak_less_resident_bytes": peak - resident,
          "ratio": act / (peak - resident) if peak > resident else None,
          "note": "measured_activation_bytes: the bytes autograd saves for the backward on the "
                  "meta device, with plain attention (the flash kernel does not run on meta); "
                  "the peak: the flash step's max_memory_allocated",
          "card": card})
    return counts


def llama_prompts(rng, n):
    """``n`` prompts of 64–768 tokens that repeat a span of 16–63 random
    tokens (text that revisits earlier spans, where prompt lookup drafts),
    with budgets of 16–128 new tokens."""
    lengths = rng.integers(64, 769, n)
    budgets = rng.integers(16, 129, n)
    prompts = [np.resize(rng.integers(0, 32000, int(rng.integers(16, 64))), int(L)).astype(np.int64)
               for L in lengths]
    return prompts, budgets, lengths


def phase_llama_serve(dev, card):
    """TinyLlama-1.1B bf16 through ContinuousBatcher(paged_kv="int4",
    page_size=16, prefill_chunk=256, n_slots=16) on 24 greedy requests
    submitted at once, a plain drain and then a drain with the speculative
    tick (W = 4): tokens/s, verify ticks, acceptance and committed-token
    EWMAs, launches of the pipelined kernel (22 a chunk, tick or verify
    tick), every request complete, every page back, the idle share of one
    steady tick of each kind. Then the first 8 of the requests, 16 slots
    and their budgets at f32 through the single-buffer kernel, plain and
    speculative:
    equal tokens wherever the top-2 margin exceeds 1e-3. The drain refills
    slots while others verify, so it also holds the speculative tick's slot
    reuse (the per-slot acceptance reset, dummy windows on the scratch page,
    pages handed to a new request) to the plain tokens. The bf16 drains'
    tokens are recorded, not compared: bf16 rounding of a window of rows
    against one row flips near-ties, and a flipped token changes the rest
    of its request."""
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.serving import ContinuousBatcher

    t_phase = time.perf_counter()
    model = llama_model(dev, dtype="bfloat16")
    n_layer = model.config.n_layer
    prompts, budgets, lengths = llama_prompts(np.random.default_rng(2), PAGED_REQUESTS)
    # the drains serve the first LLAMA_SERVE_REQUESTS of the 48 (the run's time)
    prompts, budgets, lengths = (t[:LLAMA_SERVE_REQUESTS] for t in (prompts, budgets, lengths))
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    row = {"phase": "llama_serve", "model": "tinyllama-1.1b", "dtype": "bfloat16",
           "paged_kv": "int4", "page_size": PAGE, "prefill_chunk": PAGED_CHUNK,
           "n_slots": PAGED_SLOTS, "requests": LLAMA_SERVE_REQUESTS,
           "prompt_tokens": int(lengths.sum()), "card": card}
    counts = {"paged_attn": 0, "paged_attn_pipelined": 0}
    drains = {}
    for name, extra in (("plain", {}), ("speculative", dict(speculative_window=LLAMA_SPEC_WINDOW))):
        srv = ContinuousBatcher(model, **kw, **extra)
        drain(srv, prompts[:4], [8] * 4)  # warm-up: cuBLAS, the allocator
        srv.reset_latency_stats()
        plain0, spec0, pre0 = srv.n_plain_ticks, srv.n_spec_ticks, srv.n_prefill_dispatches
        tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0  # the main path, counted
        toks, wall, tick_ms = drain(srv, prompts, budgets)
        launched = paged_counts(tpa)
        for key in counts:
            counts[key] += launched[key]
        n_chunks = srv.n_prefill_dispatches - pre0
        n_ticks = (srv.n_plain_ticks - plain0) + (srv.n_spec_ticks - spec0)
        new_tokens = sum(len(t) for t in toks)
        lat = srv.latency_stats()
        check(launched == {"paged_attn": 0, "paged_attn_pipelined": n_layer * (n_chunks + n_ticks)},
              f"the Llama {name} drain launched {launched}, expected {n_layer} x "
              f"{n_chunks + n_ticks} pipelined launches")
        check(all(len(t) == int(n) for t, n in zip(toks, budgets)),
              f"a request of the Llama {name} drain did not complete its budget")
        check(srv.free_pages == srv.n_pages - 1, f"pages leaked by the Llama {name} drain")
        drains[name] = toks
        row[name] = {"launches": launched, "dispatches": {"prefill_chunks": n_chunks,
                                                          "decode_ticks": n_ticks},
                     "new_tokens": new_tokens, "wall_s": wall, "tokens_per_s": new_tokens / wall,
                     "ttft_p50_s": lat.get("ttft_p50_s"), "e2e_p50_s": lat.get("e2e_p50_s"),
                     "decode_tick_ms_median": statistics.median(tick_ms)}
        if extra:
            row[name].update(verify_ticks=n_ticks, accept_ewma=srv.accept_ewma,
                             commit_ewma=srv.commit_ewma, window_used=srv.spec_window_used,
                             predicted_tpot_s=srv.predicted_tpot_s())
        row[name]["steady_tick"] = steady_tick(srv, prompts)
        del srv
    row["bf16_tokens_equal"] = drains["plain"] == drains["speculative"]
    del model
    torch.cuda.empty_cache()

    # f32, single-buffer kernel: speculative against plain, the margin rule
    model32 = llama_model(dev)
    runs, f32_rows, before = {}, {}, paged_counts(tpa)
    f32_prompts, f32_budgets = prompts[:LLAMA_F32_REQUESTS], budgets[:LLAMA_F32_REQUESTS]
    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
    try:
        for name, extra in (("plain", {}), ("speculative", dict(speculative_window=LLAMA_SPEC_WINDOW))):
            srv = ContinuousBatcher(model32, **kw, **extra)
            runs[name], wall, _ = drain(srv, f32_prompts, f32_budgets)
            check(srv.free_pages == srv.n_pages - 1, "pages leaked by an f32 Llama drain")
            f32_rows[name] = {"wall_s": wall, "decode_ticks": srv.n_plain_ticks + srv.n_spec_ticks,
                              "prefill_chunks": srv.n_prefill_dispatches}
            del srv
    finally:
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
    f32_launches = {key: n - before[key] for key, n in paged_counts(tpa).items()}
    counts["paged_attn"] += f32_launches["paged_attn"]
    near_ties, mismatches = [], 0
    for i, (a, w) in enumerate(zip(runs["speculative"], runs["plain"])):
        diff = [j for j, (x, y) in enumerate(zip(a, w)) if x != y]
        if diff:
            m = first_divergence_margin(model32, f32_prompts[i], w, diff[0])
            near_ties.append({"request": i, "step": diff[0], "margin": m})
            mismatches += m >= MARGIN
    row["f32"] = {"requests": LLAMA_F32_REQUESTS, "n_slots": PAGED_SLOTS, **f32_rows,
                  "kernel": "paged_attn (single buffer)", "launches": f32_launches,
                  "tokens_equal": runs["speculative"] == runs["plain"], "near_ties": near_ties}
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    check(f32_launches["paged_attn"] > 0 and f32_launches["paged_attn_pipelined"] == 0,
          f"the f32 Llama drains launched {f32_launches}, expected the single-buffer kernel only")
    check(all(len(t) == int(n) for name in runs for t, n in zip(runs[name], f32_budgets)),
          "a request of an f32 Llama drain did not complete")
    check(mismatches == 0, f"f32 speculative tokens diverge from plain beyond the margin rule: "
                           f"{near_ties}")
    del model32
    torch.cuda.empty_cache()
    return counts


def phase_llama_ticks(dev, card):
    """The JAX bench's Llama serving row at full width: TinyLlama-1.1B
    bf16 with the dense int8 KV cache, 8 slots, decode_quantum 8, 128-token
    prompts and 64 new tokens each, drained under turbo_factor=4, then
    adaptive_quantum=32, then plain ticks: identical tokens in all three,
    tokens/s, tick counts and host syncs a decode tick. Then the adaptive
    tick's EOS branch: ``eos_id`` is the token the plain drain's greedy
    chains emit most, so requests end early and each adaptive tick reads
    its tokens back every ADAPTIVE_EOS_CHECK steps; its tokens are the
    plain ones cut after their first EOS, with the read-backs and the steps
    decoded past a stop counted."""
    from dsml_tpu_torch.serving import ContinuousBatcher
    from dsml_tpu_torch.serving.batcher import ADAPTIVE_EOS_CHECK

    t_phase = time.perf_counter()
    model = llama_model(dev, dtype="bfloat16", kv_quant=True)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 32000, LLAMA_TICK_PROMPT).astype(np.int64)
               for _ in range(LLAMA_TICK_SLOTS)]
    row = {"phase": "llama_ticks", "model": "tinyllama-1.1b", "dtype": "bfloat16",
           "kv_quant": "int8", "n_slots": LLAMA_TICK_SLOTS, "decode_quantum": LLAMA_TICK_QUANTUM,
           "prompt_tokens": LLAMA_TICK_PROMPT, "new_tokens": LLAMA_TICK_NEW, "card": card}
    counters = ("n_plain_ticks", "n_turbo_ticks", "n_adaptive_ticks", "n_adaptive_syncs",
                "n_adaptive_steps_dropped")

    def run(name, **extra):
        srv = ContinuousBatcher(model, n_slots=LLAMA_TICK_SLOTS, prompt_buckets=(LLAMA_TICK_PROMPT,),
                                decode_quantum=LLAMA_TICK_QUANTUM, **extra)
        drain(srv, prompts, [LLAMA_TICK_QUANTUM + 1] * LLAMA_TICK_SLOTS)  # warm-up: cuBLAS, the allocator
        before = {k: getattr(srv, k) for k in counters}
        toks, wall, tick_ms = drain(srv, prompts, [LLAMA_TICK_NEW] * LLAMA_TICK_SLOTS)
        ticks = {k: getattr(srv, k) - v for k, v in before.items()}
        n_ticks = ticks["n_plain_ticks"] + ticks["n_turbo_ticks"] + ticks["n_adaptive_ticks"]
        syncs = (ticks["n_plain_ticks"] + ticks["n_turbo_ticks"] + ticks["n_adaptive_syncs"])
        row[name] = {**ticks, "decode_ticks": n_ticks, "host_syncs_per_decode_tick": syncs / n_ticks,
                     "wall_s": wall, "tokens_per_s": sum(len(t) for t in toks) / wall,
                     "decode_tick_ms_median": statistics.median(tick_ms)}
        return toks

    tokens = {"turbo": run("turbo", turbo_factor=LLAMA_TURBO),
              "adaptive": run("adaptive", adaptive_quantum=LLAMA_ADAPTIVE), "plain": run("plain")}
    check(all(len(t) == LLAMA_TICK_NEW for toks in tokens.values() for t in toks),
          "a turbo, adaptive or plain tick request did not complete")
    row["tokens_identical"] = tokens["turbo"] == tokens["adaptive"] == tokens["plain"]
    # decoded tokens only: a first token (the prefill's) never reaches a tick
    freq = np.bincount(np.concatenate([t[1:] for t in tokens["plain"]]))
    eos = int(freq.argmax())
    want = [t[:t.index(eos) + 1] if eos in t else t for t in tokens["plain"]]
    got = run("adaptive_eos", adaptive_quantum=LLAMA_ADAPTIVE, eos_id=eos)
    eos_row = row["adaptive_eos"]
    eos_row.update(eos_id=eos, eos_check_steps=ADAPTIVE_EOS_CHECK,
                   requests_stopped_at_eos=sum(len(t) < LLAMA_TICK_NEW for t in want),
                   tokens_equal_plain_cut_at_eos=got == want)
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    check(row["tokens_identical"], "turbo, adaptive and plain ticks gave different tokens")
    check(row["turbo"]["n_turbo_ticks"] > 0 and row["adaptive"]["n_adaptive_ticks"] > 0,
          f"the turbo or adaptive ticks never engaged: {row}")
    check(eos_row["tokens_equal_plain_cut_at_eos"],
          f"the adaptive EOS drain's tokens are not the plain ones cut at eos_id {eos}")
    check(eos_row["requests_stopped_at_eos"] > 0
          and eos_row["n_adaptive_syncs"] > eos_row["n_adaptive_ticks"],
          f"the adaptive tick's EOS branch never engaged: {eos_row}")
    del model
    torch.cuda.empty_cache()


# ---- observability -------------------------------------------------------------------

# the drains off and on: the paged slice's first 16 (cut from 24: the run's time)
OBS_REQUESTS = 16  # every slot busy at once: the full-pool probe needs a full tick
# the speculative drain with obs on: the paged slice's first 8 (cut from 16)
OBS_SPEC_REQUESTS = 8
OBS_AB_TICKS = 60  # steady ticks, the registry switched off and on in turns
# obs off / on in turns (off, on, on, off twice), each from the same weights
OBS_TRAIN_TURNS = (False, True, True, False)
OBS_ENABLED_CALLS = 10_000  # calls of the enabled hooks timed
OBS_DP_WARMUP, OBS_DP_STEPS = 1, 3
OBS_BUNDLE_CALLS = 100_000  # calls of the disabled hook bundle timed (bench.py's count)
OBS_CHILD_TRAIN = 6400  # MNIST rows a forensic child trains on (100 steps of 64)
OBS_HANG_STALL_S = 2.5  # the stalled sync window; the deadline's floor is 1 s
OBS_HANG_AT = 60  # the update that stalls: 15 windows of 4 after the 5 the deadline needs


def obs_disabled_bundles(n=OBS_BUNDLE_CALLS):
    """Seconds a call of the hooks the port runs per serving tick and per
    hybrid train step with the registry disabled, as ``bench.py`` times
    the JAX package's (its ``obs_disabled_overhead_pct``): the tick's
    ``enabled`` gate, and its span, histogram, gauge, counter and
    flight-recorder writes as if ungated (each returns at its own check);
    the step's batch-signature lookup, its claim gate and its watermark."""
    from dsml_tpu_torch import obs
    from dsml_tpu_torch.obs.flight_recorder import FlightRecorder
    from dsml_tpu_torch.obs.memory import MemoryLedger

    reg = obs.Registry(enabled=False)
    c, g = reg.counter("obs_guard_total"), reg.gauge("obs_guard")
    h = reg.histogram("obs_guard_ms")
    rec, tracer, ledger = FlightRecorder(registry=reg), obs.SpanTracer(registry=reg), \
        MemoryLedger(registry=reg)
    t0 = time.perf_counter()
    for _ in range(n):
        if reg.enabled:  # the tick's one gate
            pass
        with tracer.span("decode_tick"):
            pass
        h.observe(0.5)
        g.set(0)
        c.inc(1)
        rec.record("serving_retire", rid=0)
    tick_s = (time.perf_counter() - t0) / n
    x = torch.zeros(TRAIN_B, TRAIN_S, dtype=torch.long)
    seen = {(tuple(x.shape), tuple(x.shape))}
    t0 = time.perf_counter()
    for _ in range(n):
        first = (tuple(x.shape), tuple(x.shape)) not in seen
        if first and ledger.enabled:
            pass
        ledger.note_step_peak()
    step_s = (time.perf_counter() - t0) / n
    return tick_s, step_s


def obs_enabled_tick_s(srv, reg, n=OBS_ENABLED_CALLS):
    """Seconds a tick's hooks take with the registry enabled: ``srv.step()``
    with its work (``_step_inner``) replaced by a 16-slot emission, on the
    registry and off; the difference is the hooks'."""
    srv._step_inner = lambda: {rid: [0] for rid in range(PAGED_SLOTS)}
    cost = {}
    for on in (True, False):
        (reg.enable if on else reg.disable)()
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step()
        cost[on] = (time.perf_counter() - t0) / n
    reg.disable()
    del srv._step_inner  # the method again
    return cost[True] - cost[False]


def obs_child(kind, out_dir):
    """A forensic run in its own process (``python3 -c "import chip_smoke;
    chip_smoke.obs_child(kind, dir)"``), bundles under ``out_dir``; prints
    one JSON line. sentinel: the MNIST Trainer on the card under
    DSML_SENTINELS=halt with a NaN in the loss from update 5; hang: the
    MNIST Trainer under DSML_HANGWATCH=1 with one sync window stalled;
    oom: an allocation beyond the card's memory."""
    from dsml_tpu_torch import obs
    from dsml_tpu_torch.models import MLP
    from dsml_tpu_torch.obs.memory import maybe_dump_oom
    from dsml_tpu_torch.obs.sentinels import SentinelTripped
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils.data import Dataset, load_mnist

    out = {"kind": kind}
    if kind == "oom":
        obs.enable()
        held = torch.ones(1 << 28, device="cuda")  # 1 GiB in use when it fails
        total = torch.cuda.get_device_properties(0).total_memory
        try:
            torch.empty(total + 1, dtype=torch.uint8, device="cuda")
        except torch.OutOfMemoryError as e:
            out["raised"] = type(e).__name__
            out["bundle"] = maybe_dump_oom(e)
        out["held_bytes"] = held.numel() * held.element_size()
    else:
        full = load_mnist(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "mnist"))
        data = Dataset(full.train_x[:OBS_CHILD_TRAIN], full.train_y[:OBS_CHILD_TRAIN],
                       full.test_x, full.test_y)
        model = MLP(device="cuda")
        loss, calls = model.loss, []

        def injected(x, y):
            calls.append(1)
            out_ = loss(x, y)
            if kind == "sentinel" and len(calls) >= 5:
                return out_ * float("nan")
            if kind == "hang" and len(calls) == OBS_HANG_AT:
                time.sleep(OBS_HANG_STALL_S)  # the window that wedges
            return out_

        model.loss = injected
        try:
            Trainer(model, TrainConfig(epochs=1, sync_every=4)).train(data)
            out["finished"] = True
        except SentinelTripped as e:
            out.update(sentinel=e.sentinel, message=str(e), bundle=e.bundle)
        counter = obs.get_registry().counter("hang_suspected_total", labels=("watcher",))
        out["hang_suspected_total"] = counter.value(watcher="train_sync_window")
        out["bundles"] = sorted(os.listdir(out_dir))
    print(json.dumps(out), flush=True)


def obs_children(card):
    """The three forensic runs at once, each a process on the card with
    its own postmortem directory; every bundle checked."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    envs = {"sentinel": {"DSML_SENTINELS": "halt"}, "hang": {"DSML_HANGWATCH": "1"}, "oom": {}}
    procs = {}
    for kind, extra in envs.items():
        out_dir = os.path.join(tmp, kind)
        os.makedirs(out_dir)
        env = {**os.environ, **extra, "DSML_POSTMORTEM_DIR": out_dir}
        procs[kind] = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.obs_child({kind!r}, {out_dir!r})"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    res = {}
    for kind, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"the {kind} child failed ({proc.returncode}): {stderr[-3000:]}")
        res[kind] = json.loads(stdout.strip().splitlines()[-1])

    def bundle_file(path, name):
        with open(os.path.join(path, name)) as f:
            return json.load(f)

    s = res["sentinel"]
    check(s.get("sentinel") == "nonfinite" and s.get("bundle") and os.path.isdir(s["bundle"]),
          f"the sentinel child did not halt with a bundle: {s}")
    fp = bundle_file(s["bundle"], "fingerprint.json")
    s["fingerprint_card"] = fp.get("card")
    s["fingerprint_devices"] = fp.get("devices")
    check(fp.get("card") == card and torch.cuda.get_device_name(0) in fp["devices"]["names"],
          f"the sentinel bundle's fingerprint does not name the card: {fp.get('card')}, "
          f"{fp.get('devices')}")
    h = res["hang"]
    hang_bundles = [b for b in h["bundles"] if "hang_train_sync_window" in b]
    check(h["hang_suspected_total"] == 1 and len(hang_bundles) == 1 and h.get("finished"),
          f"the hang child: {h}")
    o = res["oom"]
    check(o.get("raised") == "OutOfMemoryError" and o.get("bundle")
          and "resource_exhausted" in os.path.basename(o["bundle"]), f"the oom child: {o}")
    mem = bundle_file(o["bundle"], "memory.json")
    o["memory_measured"] = mem["measured"]
    check(mem["measured"].get("source") == "memory_stats"
          and mem["measured"]["bytes_in_use"] >= o["held_bytes"],
          f"the OOM bundle's memory.json holds no measured stats: {mem['measured']}")
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def obs_dp_rank(rank, tmp):
    rank_main(obs_dp_rank_run, "obs_dp", rank, tmp)


def obs_dp_rank_run(rank, tmp, res, stage):
    """GPT-2-small bf16 at dp = 2 under the q8 sync (4 MiB buckets) with
    obs on: the plan's gauges and counters against the plan and the wire
    bytes, kernel 8's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch import obs
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.parallel.bucketing import plan_buckets
    from dsml_tpu_torch.parallel.dp import make_dp_train_step, named_params
    from dsml_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"))
    obs.enable(forensics=False)
    rng = np.random.default_rng(2)
    x_all = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    y_all = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    model = gpt2_small(cfg, mesh.device)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    step = make_dp_train_step(model, opt, mesh, "q8", bucket_size_mb=DP_BUCKET_MB,
                              loss_fn=lambda x, y: model.loss(x, y, attn_impl="flash"))
    stage("q8 steps with obs on")
    losses = [step(x_all, y_all) for _ in range(OBS_DP_WARMUP)]
    torch.cuda.synchronize()
    tq.quantize_int8_launches = 0
    losses += [step(x_all, y_all) for _ in range(OBS_DP_STEPS)]
    torch.cuda.synchronize()
    reg = obs.get_registry()
    labels = {"algorithm": "q8", "axis": "dp"}
    res.update(
        launches_quantize_int8=tq.quantize_int8_launches,
        plan_buckets=plan_buckets(dict(named_params(model, opt)), DP_BUCKET_MB).n_buckets,
        collective_sync_buckets=reg.gauge("collective_sync_buckets",
                                          labels=("algorithm", "axis")).value(**labels),
        collective_sync_compiles_total=reg.counter("collective_sync_compiles_total",
                                                   labels=("algorithm", "axis")).value(**labels),
        collective_quant_bytes_total={
            s: reg.counter("collective_quant_bytes_total",
                           labels=("scheme", "algorithm", "axis")).value(scheme=s, **labels)
            for s in step.quant_wire_bytes},
        quant_wire_bytes=step.quant_wire_bytes, steps=OBS_DP_WARMUP + OBS_DP_STEPS,
        losses=[float(v) for v in losses])
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_obs(tflash, dev, card, obs_dp=None):
    """The observability core on the card, GPT-2-small at full width from
    seed 0: the paged serving drain (the first 16 requests) with obs off, then on (identical tokens;
    the tick's counters, the admission histogram, the retirements, the
    pool's gauges and ledger source, the memory pressure from
    torch.cuda.memory_stats; the decode_tick spans' Chrome trace under
    build/), a speculative drain's acceptance gauge; the hybrid train step
    with obs off and on in turns (equal losses; one watermark a step, equal
    to max_memory_allocated; one plan); dp = 2 under q8 (the plan's buckets,
    the wire bytes); the three forensic bundles; and the disabled hooks'
    cost against the tick and the step."""
    from dsml_tpu_torch import obs
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import _build
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.parallel.hybrid import make_hybrid_train_step
    from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec
    from dsml_tpu_torch.serving import ContinuousBatcher

    t_phase = time.perf_counter()
    gc.collect()  # no earlier phase's batcher may still feed the ledger
    reg, ledger, recorder, tracer = (obs.get_registry(), obs.get_memory_ledger(),
                                     obs.get_flight_recorder(), obs.get_tracer())
    total_memory = torch.cuda.get_device_properties(dev).total_memory

    def fresh(enabled):
        obs.disable()
        reg.reset()
        recorder.clear()
        tracer.reset()
        ledger.clear()
        if enabled:
            obs.enable(forensics=False)

    def value(kind, name, labels=(), **kw):
        return getattr(reg, kind)(name, labels=labels).value(**kw)

    serving_labels = {"replica": "0", "role": "decode"}
    labels2 = ("replica", "role")

    # (1) serving: the paged slice's first OBS_REQUESTS requests, obs off then on
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    model = gpt2_small(cfg, dev)
    rng = np.random.default_rng(2)
    lengths = rng.integers(64, 769, PAGED_REQUESTS)
    budgets = rng.integers(16, 129, PAGED_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64) for n in lengths]
    drained = (prompts[:OBS_REQUESTS], budgets[:OBS_REQUESTS])
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    fresh(False)
    srv = ContinuousBatcher(model, **kw)
    drain(srv, prompts[:4], [8] * 4)  # warm-up
    serving = {}
    probe = {}

    def full_pool_probe(s):
        # at the first full tick: scrape, then read the allocator's numbers
        if probe or s.n_active < s.n_slots:
            return
        text = reg.to_prometheus_text()
        stats = torch.cuda.memory_stats(dev)
        pool_bytes = sum(t.numel() * t.element_size() for layer in s._pool for t in layer.values())
        probe.update(
            gauges={k: value("gauge", f"serving_page_pool_{k}", labels2, **serving_labels)
                    for k in ("used", "free", "shared")},
            pool={"used": s.used_pages, "free": s.free_pages, "shared": s.shared_pages},
            kv_pages_source=sum(ledger.claimed()["kv_pages"].values()), pool_bytes=pool_bytes,
            memory_pressure=value("gauge", "serving_memory_pressure", labels2, **serving_labels),
            pressure_from_stats=stats["allocated_bytes.all.current"] / total_memory,
            hbm_source_memory_stats='hbm_source{source="memory_stats"} 1' in text)

    for on in (False, True):
        fresh(on)
        tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
        ticks0, pre0 = srv.n_plain_ticks, srv.n_prefill_dispatches
        toks, wall, tick_ms = drain(srv, *drained, probe=full_pool_probe if on else None)
        serving["on" if on else "off"] = {
            "toks": toks, "wall_s": wall, "tick_ms_median": statistics.median(tick_ms),
            "launches": paged_counts(tpa),
            "dispatches": (srv.n_prefill_dispatches - pre0) + (srv.n_plain_ticks - ticks0)}
    on_run, off_run = serving["on"], serving["off"]
    emitted = sum(len(t) for t in on_run["toks"])
    events = [e["kind"] for e in recorder.events()]
    trace_path = _build.BUILD_DIR.parent / "obs" / "decode_tick_trace.json"
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    tracer.save_chrome_trace(str(trace_path))
    ticks_traced = sum(e["ph"] == "B" and e["name"] == "decode_tick"
                       for e in tracer.chrome_trace()["traceEvents"])
    serving_row = {
        "tokens_identical": on_run["toks"] == off_run["toks"], "tokens_emitted": emitted,
        "serving_tokens_total": value("counter", "serving_tokens_total", labels2, **serving_labels),
        "serving_admission_ms_count": reg.histogram("serving_admission_ms", labels=labels2)
        .summary(**serving_labels)["count"],
        "serving_retire_events": events.count("serving_retire"),
        "decode_tick_spans": ticks_traced, "chrome_trace": str(trace_path),
        "tick_ms_median": {"off": off_run["tick_ms_median"], "on": on_run["tick_ms_median"]},
        "wall_s": {"off": off_run["wall_s"], "on": on_run["wall_s"]},
        "tokens_per_s": {"off": emitted / off_run["wall_s"], "on": emitted / on_run["wall_s"]},
        "launches": on_run["launches"], "full_pool_probe": probe}
    check(serving_row["tokens_identical"], "obs on changed the drain's tokens")
    check(on_run["launches"]["paged_attn_pipelined"] == cfg.n_layer * on_run["dispatches"],
          f"the obs-on drain launched {on_run['launches']}, expected {cfg.n_layer} x "
          f"{on_run['dispatches']} pipelined launches")
    check(serving_row["serving_tokens_total"] == emitted,
          f"serving_tokens_total {serving_row['serving_tokens_total']} != {emitted} emitted")
    check(serving_row["serving_admission_ms_count"] == OBS_REQUESTS
          and serving_row["serving_retire_events"] == OBS_REQUESTS,
          f"admissions / retirements recorded: {serving_row['serving_admission_ms_count']} / "
          f"{serving_row['serving_retire_events']}, expected {OBS_REQUESTS}")
    check(probe and probe["gauges"] == probe["pool"], f"pool gauges vs the pool: {probe}")
    check(probe["kv_pages_source"] == probe["pool_bytes"],
          f"kv_pages ledger source {probe['kv_pages_source']} != pool bytes {probe['pool_bytes']}")
    check(probe["hbm_source_memory_stats"]
          and probe["memory_pressure"] == probe["pressure_from_stats"],
          f"serving_memory_pressure vs torch.cuda.memory_stats: {probe}")

    # the hooks' cost a tick, A/B on one steady batch (every slot decoding,
    # no admission or retirement): the registry off and on tick by tick
    fresh(False)
    for prompt in prompts[:PAGED_SLOTS]:
        srv.submit(prompt[:64], OBS_AB_TICKS + 8)
    while srv.n_queued or srv.n_pending or srv.n_active < srv.n_slots:
        srv.step()
    ab = {False: [], True: []}
    for i in range(OBS_AB_TICKS):
        on = bool(i % 2)
        (reg.enable if on else reg.disable)()
        t = time.perf_counter()
        srv.step()
        ab[on].append((time.perf_counter() - t) * 1e3)
    reg.disable()
    srv.abandon()
    enabled_tick_s = obs_enabled_tick_s(srv, reg)
    serving_row["steady_tick_ab"] = {
        "ticks": OBS_AB_TICKS, "slots": PAGED_SLOTS, "off_ms_median": statistics.median(ab[False]),
        "on_ms_median": statistics.median(ab[True]), "off_ms_min": min(ab[False]),
        "on_ms_min": min(ab[True])}

    fresh(True)
    spec = ContinuousBatcher(model, speculative_window=LLAMA_SPEC_WINDOW, **kw)
    tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
    spec_toks, spec_wall, _ = drain(spec, prompts[:OBS_SPEC_REQUESTS], budgets[:OBS_SPEC_REQUESTS])
    spec_row = {"requests": OBS_SPEC_REQUESTS, "window": LLAMA_SPEC_WINDOW,
                "accept_ewma": spec.accept_ewma, "verify_ticks": spec.n_spec_ticks,
                "serving_spec_accept_rate": value("gauge", "serving_spec_accept_rate", labels2,
                                                  **serving_labels),
                "launches": paged_counts(tpa), "wall_s": spec_wall}
    check(spec.accept_ewma is not None
          and spec_row["serving_spec_accept_rate"] == spec.accept_ewma,
          f"serving_spec_accept_rate vs accept_ewma: {spec_row}")
    check(all(len(t) == int(n) for t, n in zip(spec_toks, budgets)), "a speculative request "
          "did not complete its budget")
    del srv, spec, model
    torch.cuda.empty_cache()

    # (2) the hybrid train step, obs off and on in turns from the same weights
    cfg_t = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    model = gpt2_small(cfg_t, dev)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    mesh = Mesh(MeshSpec(dp=1).resolved(1), 0, dev, {})
    xy_rng = np.random.default_rng(2)
    x = torch.as_tensor(xy_rng.integers(0, cfg_t.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    y = torch.as_tensor(xy_rng.integers(0, cfg_t.vocab_size, (TRAIN_B, TRAIN_S)), device=dev)
    turns = []
    for on in OBS_TRAIN_TURNS:
        fresh(on)
        model.load_state_dict(init_state)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
        step = make_hybrid_train_step(model, opt, mesh, attn_impl="flash", dp_sync="ring")
        losses = [step(x, y) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        reset_counts(tflash)
        marks, peaks = [], []
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            losses.append(step(x, y))
            if on:  # host-side reads: the watermark just landed, the allocator's peak
                marks.append(ledger.watermarks()[-1])
                peaks.append(torch.cuda.max_memory_allocated(dev))
        torch.cuda.synchronize()
        turn = {"obs": on, "step_ms": (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS,
                "losses": torch.stack(losses).float().tolist(), "launches": train_counts(tflash)}
        if on:
            turn.update(
                watermarks=len(ledger.watermarks()),
                watermark_sources=sorted({m["source"] for m in marks}),
                watermarks_equal_max_memory_allocated=[m["peak_bytes"] for m in marks] == peaks,
                collective_sync_compiles_total=value("counter", "collective_sync_compiles_total",
                                                     ("algorithm", "axis"), algorithm="ring",
                                                     axis="dp"),
                unattributed_bytes=ledger.unattributed_bytes(),
                claimed=ledger.claimed(), measured=ledger.measure())
            turn["measured"].pop("per_device", None)
        turns.append(turn)
        del opt, step
        torch.cuda.empty_cache()
    n = cfg_t.n_layer * TRAIN_STEPS
    for t in turns:
        check(bf16_step_counts_ok(t["launches"], n, n),
              f"hybrid steps (obs {t['obs']}) launched {t['launches']}")
        check(t["losses"] == turns[0]["losses"], "obs on changed the train step's losses")
        if t["obs"]:
            check(t["watermarks"] == TRAIN_WARMUP + TRAIN_STEPS
                  and t["watermark_sources"] == ["memory_stats"]
                  and t["watermarks_equal_max_memory_allocated"],
                  f"watermarks: {t['watermarks']} for {TRAIN_WARMUP + TRAIN_STEPS} steps, "
                  f"sources {t['watermark_sources']}, equal to max_memory_allocated: "
                  f"{t['watermarks_equal_max_memory_allocated']}")
            check(t["collective_sync_compiles_total"] == 1,
                  f"collective_sync_compiles_total {t['collective_sync_compiles_total']} != 1")
    del model, init_state
    torch.cuda.empty_cache()
    fresh(False)

    # (3) dp = 2 under q8, 4 MiB buckets: the ranks of phase_dp_slice's
    # spawn (``obs_dp``: (ranks, the spawn's seconds)), or a spawn of their own
    ranks, dp_seconds = obs_dp or spawn_ranks(obs_dp_rank, "obs_dp")
    for r in ranks:
        check(r["collective_sync_buckets"] == r["plan_buckets"]
              and r["collective_sync_compiles_total"] == 1,
              f"rank {r['rank']}: buckets {r['collective_sync_buckets']} vs plan "
              f"{r['plan_buckets']}, compiles {r['collective_sync_compiles_total']}")
        check(r["collective_quant_bytes_total"] == {s: r["steps"] * b for s, b in
                                                    r["quant_wire_bytes"].items()},
              f"rank {r['rank']}: wire bytes {r['collective_quant_bytes_total']} vs "
              f"{r['steps']} x {r['quant_wire_bytes']}")
        check(r["launches_quantize_int8"] == r["plan_buckets"] * OBS_DP_STEPS,
              f"rank {r['rank']}: kernel 8 launched {r['launches_quantize_int8']} times")

    # (4) the forensic bundles, (5) the disabled hooks' cost
    children = obs_children(card)
    tick_s, step_s = obs_disabled_bundles()
    fresh(True)  # the step's enabled hook: one watermark, a read of the allocator's statistics
    t0 = time.perf_counter()
    for _ in range(OBS_ENABLED_CALLS):
        ledger.note_step_peak()
    enabled_step_s = (time.perf_counter() - t0) / OBS_ENABLED_CALLS
    fresh(False)
    off_steps = [t["step_ms"] for t in turns if not t["obs"]]
    on_steps = [t["step_ms"] for t in turns if t["obs"]]
    tick_ms = off_run["tick_ms_median"]
    step_ms = statistics.median(off_steps)
    row = {"phase": "obs", "model": "gpt2-small", "card": card,
           "serving": serving_row, "speculative": spec_row,
           "train": {"batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
                     "warmup": TRAIN_WARMUP, "dp_sync": "ring", "turns": [
                         {k: v for k, v in t.items() if k != "losses"} for t in turns],
                     "step_ms": {"off": off_steps, "on": on_steps,
                                 "off_median": step_ms, "on_median": statistics.median(on_steps)},
                     "losses": turns[0]["losses"]},
           "dp2_q8": {"seconds_with_spawn": dp_seconds, "ranks": ranks},
           "forensics": children,
           "disabled": {"calls": OBS_BUNDLE_CALLS, "tick_bundle_ns": tick_s * 1e9,
                        "step_bundle_ns": step_s * 1e9, "tick_ms": tick_ms, "step_ms": step_ms,
                        "obs_disabled_overhead_pct": {"tick": 100 * tick_s / (tick_ms / 1e3),
                                                      "step": 100 * step_s / (step_ms / 1e3)},
                        "bar_pct": 1.0},
           "enabled": {"calls": OBS_ENABLED_CALLS, "tick_hooks_us": enabled_tick_s * 1e6,
                       "step_hooks_us": enabled_step_s * 1e6,
                       "overhead_pct": {"tick": 100 * enabled_tick_s / (tick_ms / 1e3),
                                        "step": 100 * enabled_step_s / (step_ms / 1e3)}},
           "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    obs.disable()
    return {"serving": on_run["launches"], "train": turns[1]["launches"]}


CKPT_STEPS = 5  # k: the steps before the async save, and again after it
CKPT_REQUESTS = 8  # greedy requests served from the checkpoint
CKPT_MLP = (64, 256, 8)  # the dp = 2 resume's MLP, on synthetic data
CKPT_DP_ROWS, CKPT_DP_EPOCHS = 2048, 4


def ckpt_dp_rank(rank, tmp):
    rank_main(ckpt_dp_rank_run, "ckpt_dp", rank, tmp)


def ckpt_dp_rank_run(rank, tmp, res, stage):
    """One rank of the dp = 2 resume: the MLP Trainer under q8_ring with
    error feedback, 4 epochs straight, then 2 epochs with a checkpoint and a
    resume to 4; the weights of both runs and the pieces this rank wrote."""
    import torch.distributed as dist

    from dsml_tpu_torch.checkpoint import native
    from dsml_tpu_torch.models import MLP
    from dsml_tpu_torch.parallel.mesh import data_mesh
    from dsml_tpu_torch.trainer import TrainConfig, Trainer
    from dsml_tpu_torch.utils.data import synthetic_classification

    mesh = data_mesh(2, rank, os.path.join(tmp, "rendezvous"))
    written = []
    real_snapshot = native.snapshot

    def spy(*args, **kwargs):
        snap = real_snapshot(*args, **kwargs)
        written.append(sorted(fn for fn, _ in snap.blobs))
        return snap

    native.snapshot = spy
    data = synthetic_classification(CKPT_DP_ROWS, features=CKPT_MLP[0], classes=CKPT_MLP[-1],
                                    seed=0)

    def run(epochs, checkpoint_dir="", resume=False):
        cfg = TrainConfig(epochs=epochs, batch_size=64, lr=0.05, optimizer="momentum",
                          algorithm="q8_ring", error_feedback=True, seed=3, resume=resume,
                          checkpoint_dir=checkpoint_dir)
        return Trainer(MLP(CKPT_MLP, device=mesh.device), cfg, mesh=mesh).train(data)[0]

    stage("straight run")
    straight = run(CKPT_DP_EPOCHS)
    stage("run with a checkpoint")
    ckdir = os.path.join(tmp, "killed")
    run(CKPT_DP_EPOCHS // 2, ckdir)
    res["written"] = list(written)
    stage("resume")
    resumed = run(CKPT_DP_EPOCHS, ckdir, resume=True)
    res["bit_identical"] = all(torch.equal(straight[k], resumed[k]) for k in straight)
    res["weights_checksum"] = float(sum(t.double().sum().item() for t in resumed.values()))
    native.snapshot = real_snapshot  # later programs of the spawn checkpoint unspied
    mesh.close()
    dist.destroy_process_group()
    if rank == 0:
        res["manifest"] = native.read_manifest(
            os.path.join(ckdir, native.step_dirname(CKPT_DP_EPOCHS // 2)))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_checkpoint(tflash, dev, card, ckpt_dp=None):
    """Checkpointing on the card. GPT-2-small bf16 trained as ``train_gpt2``
    steps it (``train_step``: flash attention, clip 1.0, AdamW on the
    warmup-cosine schedule) at batch 8 × 1024: k steps, an async save
    through ``CheckpointManager`` (the step loop pays the snapshot), k more
    steps while the commit runs. A fresh model and optimizer restored from
    step k equal the in-memory copy of step k bit for bit; the same k steps
    from the restored state and twice from the copy: the restored run's
    losses and weights differ from the copy's by no more than the copy's
    two runs differ. ``ContinuousBatcher.from_checkpoint`` serves step k
    through int4 pages, pipelined (kernel 6) and single-buffer (kernel 5):
    greedy tokens equal a batcher's on the in-memory weights. Then a dp = 2
    q8_ring + error-feedback MLP Trainer resumed from its checkpoint equals
    its straight run, each rank having written only its own residual rows.
    Kernels 1-3, 5 and 6 counted over the phase."""
    import copy
    import tempfile

    from dsml_tpu_torch import obs
    from dsml_tpu_torch.checkpoint import CheckpointManager
    from dsml_tpu_torch.checkpoint.optim_state import (load_optax_state, load_param_tree,
                                                       optax_state, param_tree)
    from dsml_tpu_torch.cli.train_gpt2 import OPT_STATE_KIND, train_step
    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.serving import ContinuousBatcher
    from dsml_tpu_torch.utils.schedules import make_schedule

    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    k = CKPT_STEPS
    rng = np.random.default_rng(5)
    batches = [tuple(torch.as_tensor(rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)),
                                     device=dev) for _ in range(2)) for _ in range(2 * k)]
    schedule = make_schedule("cosine", 3e-4, 2 * k, 1)

    def fresh():
        m = GPT2(cfg, device=dev)
        return m, torch.optim.AdamW(m.parameters(), lr=0.0, weight_decay=1e-4)

    def run(model, opt, first):
        """Steps first..first+k-1: (losses, wall ms per step)."""
        losses, ms = [], []
        for i in range(first, first + k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, schedule(i), *batches[i], clip_norm=1.0,
                                     attn_impl="flash"))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return torch.stack(losses).float().tolist(), ms

    def weights(model):
        return {n: t.clone() for n, t in model.state_dict().items()}

    def gap(run_a, run_b):
        (la, wa), (lb, wb) = run_a, run_b
        return max(max(abs(a - b) for a, b in zip(la, lb)),
                   max((wa[n].float() - wb[n].float()).abs().max().item() for n in wa))

    reg = obs.get_registry()
    was_on = reg.enabled
    reg.enable()  # the writer's checkpoint_commit event carries the commit's wall
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    row = {"phase": "checkpoint", "model": "gpt2-small", "dtype": "bfloat16",
           "batch": [TRAIN_B, TRAIN_S], "optimizer": "clip 1.0 + AdamW(cosine 3e-4, wd 1e-4)",
           "k": k, "card": card}
    try:
        # the main path, counted: train, save, restore, continue, serve
        reset_counts(tflash)
        tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
        model, opt = fresh()
        model.init(0)
        mgr = CheckpointManager(tmp)
        losses0, ms0 = run(model, opt, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(k, {"params": param_tree(model),
                     "opt_state": optax_state(opt, model, OPT_STATE_KIND, k)}, wait=False)
        stall_ms = (time.perf_counter() - t0) * 1e3
        mem_model = copy.deepcopy(model.state_dict())  # the in-memory copy of step k
        mem_opt = copy.deepcopy(opt.state_dict())
        _, ms1 = run(model, opt, k)  # overlapping the commit
        mgr.wait_until_finished()
        mgr.close()
        commits = [e for e in obs.get_flight_recorder().events()
                   if e["kind"] == "checkpoint_commit" and e["label"] == f"step {k}"]
        commit_ms = commits[-1]["ms"] if commits else None
        step_dir = os.path.join(tmp, f"step_{k:08d}")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        timing = {"snapshot_stall_ms": stall_ms, "commit_ms": commit_ms, "bytes_written": nbytes,
                    "snapshot_gb_per_s": nbytes / (stall_ms / 1e3) / 1e9,
                    "host_write_gb_per_s": None if not commit_ms else nbytes / (commit_ms / 1e3) / 1e9,
                    "step_ms": statistics.median(ms0),
                    "step_ms_during_commit": statistics.median(ms1)}
        check(commit_ms is not None and commits[-1]["ok"],
              f"no successful checkpoint_commit event for step {k}: {commits}")

        # restore into a fresh model and optimizer: bit for bit with the copy
        m2, o2 = fresh()
        t0 = time.perf_counter()
        mgr = CheckpointManager(tmp)
        state = mgr.restore(k, template={"params": param_tree(m2),
                                         "opt_state": optax_state(o2, m2, OPT_STATE_KIND, 0)})
        mgr.close()
        load_param_tree(m2, state["params"])
        count = load_optax_state(o2, m2, OPT_STATE_KIND, state["opt_state"])
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        del state
        got_opt = o2.state_dict()["state"]
        mismatched = [n for n, t in m2.state_dict().items() if not torch.equal(t, mem_model[n])]
        mismatched += [f"opt {i} {key}" for i, st in mem_opt["state"].items()
                       for key in ("exp_avg", "exp_avg_sq", "step")
                       if not torch.equal(got_opt[i][key], st[key])]
        check(count == k and not mismatched,
              f"the restored state differs from the in-memory copy of step {k}: count {count}, "
              f"{mismatched[:6]}")

        # the same k steps from the restored state and twice from the copy
        restored = run(m2, o2, k)[0], weights(m2)
        del m2, o2
        copies = []
        for _ in range(2):
            model.load_state_dict(mem_model)
            opt.load_state_dict(copy.deepcopy(mem_opt))
            copies.append((run(model, opt, k)[0], weights(model)))
        copy_gap = gap(*copies)
        restored_gap = min(gap(restored, c) for c in copies)
        row.update(timing, restore_ms=restore_ms, restored_bit_identical=not mismatched,
                   first_losses=losses0, continued_losses_restored=restored[0],
                   continued_losses_copy=copies[0][0], restored_vs_copy_gap=restored_gap,
                   copy_vs_copy_gap=copy_gap)
        check(all(np.isfinite(restored[0])), f"restored run's losses {restored[0]}")
        check(restored_gap <= copy_gap,
              f"the restored run differs from the in-memory copy's by {restored_gap}, "
              f"more than the copy's two runs differ ({copy_gap})")
        del restored, copies

        # serve step k from the checkpoint through both paged kernels
        kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
        lengths = rng.integers(64, 513, CKPT_REQUESTS)
        budgets = rng.integers(16, 49, CKPT_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64) for n in lengths]
        model.load_state_dict(mem_model)
        del opt
        want = drain(ContinuousBatcher(model, **kw), prompts, budgets)[0]
        srv = ContinuousBatcher.from_checkpoint(GPT2(cfg, device=dev), tmp, step=k, **kw)
        got = drain(srv, prompts, budgets)[0]
        os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
        try:
            got_single = drain(srv, prompts, budgets)[0]
        finally:
            del os.environ["DSML_PAGED_ATTN_PIPELINE"]
        counts = {**train_counts(tflash), **paged_counts(tpa)}
        row.update(served_requests=CKPT_REQUESTS, served_tokens_equal=got == want,
                   served_single_buffer_tokens_equal=got_single == want, launches=counts)
        check(got == want and got_single == want,
              "the tokens served from the checkpoint differ from the in-memory weights'")
        n_steps = 5 * k  # the first k, the k after the save, the restored k, the copy's 2 x k
        check(bf16_step_counts_ok(train_counts(tflash), cfg.n_layer * n_steps,
                                  cfg.n_layer * n_steps),
              f"the checkpoint phase's train steps launched {train_counts(tflash)}, expected "
              f"{cfg.n_layer * n_steps} of the forward and of each tensor-core backward kernel")
        check(counts["paged_attn"] > 0 and counts["paged_attn_pipelined"] > 0,
              f"the checkpoint phase's drains launched {paged_counts(tpa)}")
        del model, srv
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if not was_on:
            reg.disable()

    # dp = 2: the error-feedback residuals ride the checkpoint
    # the dp = 2 resume ran in dp_slice's spawn (``ckpt_dp``: (ranks, the
    # spawn's seconds)), or a spawn of its own in a run of this phase alone
    ranks, seconds = ckpt_dp or spawn_ranks(ckpt_dp_rank, "ckpt_dp")
    ef = [e for e in ranks[0]["manifest"]["leaves"] if e["path"].startswith("ef/")]
    ef_files = {p["file"] for e in ef for p in e["pieces"]}
    rest = {p["file"] for e in ranks[0]["manifest"]["leaves"] if "pieces" in e
            for p in e["pieces"]} - ef_files
    own_only = all(set(files) == ({f for f in ef_files if f.endswith(f"_P{r['rank']:03d}.bin")}
                                  | (rest if r["rank"] == 0 else set()))
                   for r in ranks for files in r["written"])
    row["dp2_resume"] = {"mlp": list(CKPT_MLP), "algorithm": "q8_ring", "error_feedback": True,
                         "epochs": [CKPT_DP_EPOCHS // 2, CKPT_DP_EPOCHS],
                         "bit_identical": [r["bit_identical"] for r in ranks],
                         "ef_leaves": [[e["path"], e["shape"], len(e["pieces"])] for e in ef],
                         "each_rank_wrote_its_own_rows": own_only,
                         "seconds_with_spawn": seconds}
    emit(row)
    check(all(r["bit_identical"] for r in ranks),
          "the resumed dp = 2 q8_ring + EF run differs from the straight run")
    check(ranks[0]["weights_checksum"] == ranks[1]["weights_checksum"],
          "the dp = 2 replicas diverged")
    check(len(ef) == 2 * (len(CKPT_MLP) - 1)
          and all(e["shape"][0] == 2 and len(e["pieces"]) == 2 for e in ef),
          f"the dp = 2 checkpoint's ef leaves: {row['dp2_resume']['ef_leaves']}")
    check(own_only and all(len(r["written"]) == CKPT_DP_EPOCHS // 2 for r in ranks),
          f"a rank wrote pieces that are not its own: {[r['written'] for r in ranks]}")
    return counts


# ---- model parallelism: tp, pp and ZeRO on process meshes (port slice 15) ---------

MP_TP_WARMUP, MP_TP_STEPS = 2, 3
MP_PP_B, MP_PP_S, MP_PP_MICRO = 8, 1024, 4
MP_PP_WARMUP, MP_PP_STEPS = 1, 2
MP_F32_LAYERS = 2  # the f32 gradient checks' depth (TinyLlama's and GPT-2-small's width)
MP_PP_F32_LAYERS = 4
MP_ZERO_BUCKET_MB = 4.0
MP_4RANK_STEPS = 2  # step 1, the checkpoint, step 2 (and step 2 again from the checkpoint)
# the planner's per-chip memory for GPT-2-small at fsdp: its 1.49 GB of
# training state needs two shards of the 1.2 GB state budget
MP_PLAN_HBM = 3e9
# TinyLlama's depth cut 22 -> 4 at pp = 2 x tp = 2 (cut from 8: the run's time)
MP_4RANK_LAYERS = 4
# bf16: losses of two schedules (or two ZeRO layouts) from the same weights
# agree within this share (f32 sums in another order under bf16 rounding)
MP_BF16_LOSS_RTOL = 2e-3
MP_LOSS_DRIFT = 0.05  # a later step's loss off the reference's (bf16 updates compound)


def _param_sha(params) -> str:
    """sha256 of the bytes of ``params`` (bf16 read as int16)."""
    import hashlib

    h = hashlib.sha256()
    for p in params:
        t = p.detach()
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _shard_grad_err(model, ref, coords, sizes, names=None):
    """max over this rank's parameters (those in ``names``, default all) of
    |grad − its slice of the single-device ``ref`` gradient| / max |ref
    gradient| (the dp_slice rule)."""
    from dsml_tpu_torch.models.common import shard_leaf
    from dsml_tpu_torch.parallel.hybrid import _global_name

    specs = ref.param_specs()
    full = dict(ref.named_parameters())
    worst = 0.0
    for name, p in model.named_parameters():
        if names is not None and name not in names:
            continue
        g_ref = full[_global_name(model, name)].grad
        want = shard_leaf(g_ref, specs[_global_name(model, name)], coords, sizes)
        scale = float(g_ref.abs().max()) or 1.0
        worst = max(worst, float((p.grad.float() - want.float()).abs().max()) / scale)
    return worst


def mp_tp_rank(rank, tmp, weights):
    rank_main(lambda r, t, res, stage: mp_tp_run(r, t, res, stage, weights), "tp", rank, tmp)


def mp_tp_run(rank, tmp, res, stage, weights):
    """TinyLlama-1.1B bf16 at tp = 2 (one rank)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel import tp as ttp
    from dsml_tpu_torch.parallel.hybrid import make_hybrid_train_step
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(tp=2), rank, 2, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("tp")
    res["device"] = str(dev)
    stage("weights")
    cfg = dataclasses.replace(LlamaConfig.tinyllama_1b(), dtype="bfloat16")
    model = Llama(cfg, device=dev, tp_group=group)
    model.load_full(torch.load(weights, mmap=True))
    res["local_heads"] = cfg.n_head // group.size
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)))
    y = torch.roll(x, -1, 1)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    step = make_hybrid_train_step(model, opt, mesh, attn_impl="flash")
    stage("tp steps")
    losses = [step(x, y) for _ in range(MP_TP_WARMUP)]
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(tflash)
    ttp.reset_stats()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(MP_TP_STEPS)]
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) * 1e3 / MP_TP_STEPS
    res["launches"] = train_counts(tflash)
    res["tp_all_reduces_per_step"] = ttp.STATS["all_reduce"] / MP_TP_STEPS
    res["tp_all_reduce_bytes_per_step"] = ttp.STATS["bytes"] / MP_TP_STEPS
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["ipc_slot_bytes"] = mesh.slot_bytes()
    res["losses"] = [float(v) for v in losses]
    specs = model.param_specs()
    res["replicated_sha"] = _param_sha(
        [p for n, p in model.named_parameters() if "tp" not in specs[n]])
    stage("tp all-reduce alone")
    buf = torch.randn(LLAMA_TRAIN_B, LLAMA_TRAIN_S, cfg.d_model, device=dev).to(torch.bfloat16)
    times = collective_times(lambda: ttp.tp_all_reduce(buf, group), group.pg)
    res["all_reduce_16MiB_ms"] = statistics.median(times)
    del model, opt, step
    torch.cuda.empty_cache()
    stage("f32 gradient check")
    cfg32 = dataclasses.replace(LlamaConfig.tinyllama_1b(), n_layer=MP_F32_LAYERS)
    ref = Llama(cfg32, device=dev).init(0)
    # the same seed's weights: init draws the whole model on every rank
    shard = Llama(cfg32, device=dev, tp_group=group).load_full(ref.state_dict())
    xd, yd = x.to(dev), y.to(dev)
    loss = shard.loss(xd, yd, attn_impl="flash")
    loss.backward()
    ref_loss = ref.loss(xd, yd, attn_impl="xla")
    ref_loss.backward()
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    res["f32"] = {"loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                  "grads_max_err_over_max_abs": _shard_grad_err(
                      shard, ref, {"tp": group.rank}, {"tp": group.size})}
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def mp_pp_rank(rank, tmp):
    rank_main(mp_pp_run, "pp", rank, tmp)


MP_SCHEDULES = {"gpipe": ("gpipe", 1), "1f1b": ("1f1b", 1), "interleaved": ("gpipe", 2)}


def mp_pp_run(rank, tmp, res, stage):
    """GPT-2-small bf16 at pp = 2 (one stage) under the three schedules."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.ops import quantization as tq
    from dsml_tpu_torch.parallel.hybrid import (hybrid_eval_loss, hybrid_model,
                                                make_hybrid_train_step)
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(pp=2), rank, 2, os.path.join(tmp, "rendezvous"))
    dev = mesh.device
    res["device"] = str(dev)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.integers(0, 50257, (MP_PP_B, MP_PP_S)))
    y = torch.as_tensor(rng.integers(0, 50257, (MP_PP_B, MP_PP_S)))
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    # the weights of seed 0, drawn once (each stage keeps its layers of them)
    full = gpt2_small(dataclasses.replace(cfg, dtype="float32"), "cpu").state_dict()
    res["schedules"] = {}
    for name, (schedule, v) in MP_SCHEDULES.items():
        stage(f"pp steps under {name}")
        model = hybrid_model(GPT2, dataclasses.replace(cfg, pp_interleave=v), mesh).load_full(full)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
        step = make_hybrid_train_step(model, opt, mesh, attn_impl="flash",
                                      n_microbatches=MP_PP_MICRO, schedule=schedule)
        losses = [step(x, y) for _ in range(MP_PP_WARMUP)]
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(tflash)
        t0 = time.perf_counter()
        losses += [step(x, y) for _ in range(MP_PP_STEPS)]
        torch.cuda.synchronize()
        res["schedules"][name] = {
            "step_ms": (time.perf_counter() - t0) * 1e3 / MP_PP_STEPS,
            "launches": train_counts(tflash), "layers": model.layer_ids,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "losses": [float(v) for v in losses]}
        del model, opt, step
        torch.cuda.empty_cache()
    res["ipc_slot_bytes"] = mesh.slot_bytes()
    stage("pp eval loss")
    model = hybrid_model(GPT2, cfg, mesh).load_full(full)
    reset_counts(tflash)  # the pp eval, counted
    ev = float(hybrid_eval_loss(model, mesh, "flash", x, y, n_microbatches=MP_PP_MICRO))
    res["eval"] = {"bf16": ev, "launches": train_counts(tflash)}
    del model
    single = GPT2(cfg, device=dev)
    single.load_state_dict(full)
    with torch.no_grad():
        res["eval"]["bf16_single_device"] = float(
            single.loss(x.to(dev), y.to(dev), attn_impl="flash"))
    del single
    torch.cuda.empty_cache()
    stage("int8 remat step")
    model = hybrid_model(GPT2, dataclasses.replace(cfg, remat="int8"), mesh).load_full(full)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    step = make_hybrid_train_step(model, opt, mesh, attn_impl="flash",
                                  n_microbatches=MP_PP_MICRO)
    tq.quantize_int8_launches = 0
    loss = float(step(x, y))
    res["int8_remat"] = {"loss": loss, "quantize_int8": tq.quantize_int8_launches}
    del model, opt, step
    torch.cuda.empty_cache()
    stage("f32 gradient check")
    cfg32 = dataclasses.replace(GPT2Config.small(), n_layer=MP_PP_F32_LAYERS, xent_chunk=0)
    ref = gpt2_small(cfg32, dev)
    xd, yd = x.to(dev), y.to(dev)
    ref_loss = ref.loss(xd, yd, attn_impl="xla")
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    res["f32"] = {}
    full32 = ref.state_dict()
    model = hybrid_model(GPT2, cfg32, mesh).load_full(full32)
    res["eval"]["f32"] = float(hybrid_eval_loss(model, mesh, "flash", x, y,
                                                n_microbatches=MP_PP_MICRO))
    res["eval"]["f32_single_device"] = ref_loss
    del model
    for name, (schedule, v) in MP_SCHEDULES.items():
        model = hybrid_model(GPT2, dataclasses.replace(cfg32, pp_interleave=v), mesh)
        model.load_full(full32)
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        loss = make_hybrid_train_step(model, opt, mesh, attn_impl="flash",
                                      n_microbatches=MP_PP_MICRO, schedule=schedule)(x, y)
        res["f32"][name] = {
            "loss_rel_err": abs(float(loss) - ref_loss) / abs(ref_loss),
            "grads_max_err_over_max_abs": _shard_grad_err(model, ref, {}, {})}
        del model, opt
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def mp_zero_rank(rank, tmp):
    rank_main(mp_zero_run, "fsdp", rank, tmp)


def _opt_bytes(opt) -> int:
    """Bytes of ``opt``'s moment tensors (its 0-d step counts left out)."""
    return sum(t.numel() * t.element_size() for st in opt.state.values()
               for t in st.values() if torch.is_tensor(t) and t.ndim)


def mp_zero_run(rank, tmp, res, stage):
    """GPT-2-small bf16 at fsdp = 2 (one rank): the dp = 2 ring step, the
    hybrid ZeRO-3 step and ZeRO-2 (full precision, int8 + error feedback)
    from the same weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel.dp import make_dp_train_step
    from dsml_tpu_torch.parallel.fsdp import init_zero2, make_zero2_train_step
    from dsml_tpu_torch.models.common import spec_dim
    from dsml_tpu_torch.parallel.auto import plan_mesh
    from dsml_tpu_torch.parallel.fsdp import Zero3
    from dsml_tpu_torch.parallel.hybrid import (hybrid_eval_loss, hybrid_model, init_hybrid,
                                                make_hybrid_train_step)
    from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh

    # the planner's mesh: GPT-2-small's state against a small per-chip budget
    plan = plan_mesh(n_devices=2, n_params=gpt2_small_n_params(), n_head=12,
                     hbm_bytes=MP_PLAN_HBM)
    res["plan"] = {"spec": plan.spec.sizes_dict(), "reasons": list(plan.reasons),
                   "hbm_source": plan.hbm_source}
    mesh = build_mesh(plan.spec, rank, 2, os.path.join(tmp, "rendezvous"))
    dev = mesh.device
    # the same two ranks as a dp = 2 mesh: the reference step's
    dp_mesh = Mesh(MeshSpec(dp=2).resolved(2), rank, dev, {"dp": mesh.group("fsdp")},
                   {**mesh.coords, "dp": rank, "fsdp": 0})
    res["device"] = str(dev)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    y = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)

    def adamw(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=0.01)

    def run(name, step, opt):
        stage(name)
        losses = [step(x, y) for _ in range(MP_PP_WARMUP)]
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(tflash)
        t0 = time.perf_counter()
        losses += [step(x, y) for _ in range(MP_PP_STEPS)]
        torch.cuda.synchronize()
        res[name] = {"step_ms": (time.perf_counter() - t0) * 1e3 / MP_PP_STEPS,
                     "launches": train_counts(tflash), "losses": [float(v) for v in losses],
                     "optimizer_state_bytes": _opt_bytes(opt),
                     "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}

    model = gpt2_small(cfg, dev)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        res["eval"] = {"bf16_single_device": float(
            model.loss(x.to(dev), y.to(dev), attn_impl="flash"))}
    opt = adamw(model.parameters())
    run("dp_ring", make_dp_train_step(model, opt, dp_mesh, "ring", bucket_size_mb=MP_ZERO_BUCKET_MB,
                                      loss_fn=lambda a, b: model.loss(a, b, attn_impl="flash")), opt)
    del model, opt
    model = hybrid_model(GPT2, cfg, mesh)
    model, opt = init_hybrid(model, adamw(model.parameters()), mesh, 0)
    res["eval"]["bf16"] = float(hybrid_eval_loss(model, mesh, "flash", x, y))
    run("zero3", make_hybrid_train_step(model, opt, mesh, attn_impl="flash"), opt)
    res["zero3"]["param_shard_bytes"] = sum(s.numel() * s.element_size()
                                            for s in model.fsdp.shards)
    del model, opt
    for name, quant, ef in (("zero2", None, False), ("zero2_int8_ef", "int8", True)):
        model = GPT2(cfg, device=dev)
        model.load_state_dict(init_state)
        state = init_zero2(model, adamw(model.parameters()), mesh, None,
                           bucket_size_mb=MP_ZERO_BUCKET_MB)
        run(name, make_zero2_train_step(model, state, mesh, bucket_size_mb=MP_ZERO_BUCKET_MB,
                                        quant=quant, error_feedback=ef, attn_impl="flash"),
            state.optimizer)
        res[name]["buckets"] = state.plan.n_buckets
        res[name]["weights_sha"] = _param_sha(model.parameters())
        del model, state
        torch.cuda.empty_cache()
    stage("f32 eval loss")
    cfg32 = dataclasses.replace(GPT2Config.small(), n_layer=MP_PP_F32_LAYERS, xent_chunk=0)
    ref = gpt2_small(cfg32, dev)
    model = hybrid_model(GPT2, cfg32, mesh).load_full(ref.state_dict())
    specs = model.param_specs(fsdp=2)
    model.fsdp = Zero3(model, mesh.group("fsdp"),  # init_hybrid's shards of these weights
                       {n: d for n, v in specs.items() if (d := spec_dim(v, "fsdp")) is not None})
    res["eval"]["f32"] = float(hybrid_eval_loss(model, mesh, "flash", x, y))
    with torch.no_grad():
        res["eval"]["f32_single_device"] = float(ref.loss(x.to(dev), y.to(dev), attn_impl="xla"))
    del model, ref
    res["ipc_slot_bytes"] = mesh.slot_bytes()
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def mp_4rank_rank(rank, tmp, weights):
    rank_main(lambda r, t, res, stage: mp_4rank_run(r, t, res, stage, weights), "pp_tp", rank, tmp)


def _state_sha(tree) -> str:
    """sha256 of every leaf of a ``mesh_state`` tree (a rank's blocks and
    the counts), in the tree's order."""
    from dsml_tpu_torch.checkpoint.native import MeshShard, tree_leaves_with_path

    return _param_sha([leaf.tensor if isinstance(leaf, MeshShard) else leaf
                       for _, leaf in tree_leaves_with_path(tree)])


def _owned_bytes(tree) -> int:
    """Bytes of the blocks of a ``mesh_state`` tree this rank writes."""
    from dsml_tpu_torch.checkpoint.native import MeshShard, tree_leaves_with_path

    return sum(leaf.tensor.numel() * leaf.tensor.element_size()
               for _, leaf in tree_leaves_with_path(tree)
               if isinstance(leaf, MeshShard) and leaf.owner)


def _cross_layout_restore(step_dir, cfg, rank):
    """The pp = 2 × tp = 2 checkpoint read by rank ``rank`` of other
    layouts of the same four ranks, with meshes of sizes and coordinates
    alone (a restore communicates nothing), on the host: at pp = 4 (the JAX
    restore accepts another pp of the stacked axis) the weights-only
    restore's every block equals the slice of that leaf reassembled whole
    from its pieces; at
    tp = 2 × dp = 2 (a layer list, not a stacked axis) the restore raises
    KeyError, as the JAX restore does."""
    import types

    from dsml_tpu_torch.checkpoint import native
    from dsml_tpu_torch.checkpoint.optim_state import mesh_state
    from dsml_tpu_torch.models.llama import Llama
    from dsml_tpu_torch.parallel.hybrid import hybrid_model
    from dsml_tpu_torch.parallel.mesh import Mesh, MeshSpec, rank_coords

    def layout(spec, device):
        spec = spec.resolved(4)
        coords = rank_coords(spec, rank)
        groups = {a: types.SimpleNamespace(size=n, rank=coords[a])
                  for a, n in spec.sizes_dict().items() if n > 1}
        mesh = Mesh(spec, rank, torch.device(device), groups, coords)
        model = hybrid_model(Llama, cfg, mesh)
        return mesh, model, torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)

    t0 = time.perf_counter()
    mesh, model, opt = layout(MeshSpec(pp=4), "cpu")
    template = {"params": mesh_state(model, opt, mesh, "clip_adamw", 0)["params"]}
    state = native.restore_tree(step_dir, template=template, partial=True)
    restore_ms = (time.perf_counter() - t0) * 1e3
    entries = {e["path"]: e for e in native.read_manifest(step_dir)["leaves"]}
    restored, bad = dict(native.tree_leaves_with_path(state)), []
    for path, leaf in native.tree_leaves_with_path(template):
        whole = native._assemble(step_dir, entries[path])
        want = whole[tuple(slice(a, b) for a, b in leaf.index)]
        got = restored[path]
        got = (got.view(torch.int16) if got.dtype == torch.bfloat16 else got).numpy()
        if not np.array_equal(got, want):
            bad.append(path)
    layers = model.layer_ids
    del model, opt, state, template
    mesh, model, opt = layout(MeshSpec(tp=2), "meta")
    try:
        native.restore_tree(step_dir, template=mesh_state(model, opt, mesh, "clip_adamw", 0))
        refused = None
    except KeyError as e:
        refused = str(e)[:120]
    return {"pp4": {"layers": layers, "params_restore_ms": restore_ms, "mismatched": bad},
            "tp2_dp2_refused": refused}


def mp_4rank_run(rank, tmp, res, stage, weights):
    """TinyLlama-1.1B bf16 at pp = 2 × tp = 2 (one of four ranks): step 1,
    a checkpoint of every rank's blocks, step 2; then fresh model and
    optimizer objects restored from the checkpoint take step 2 again (the
    same loss and every leaf's bytes), and the checkpoint is read at
    another layout (:func:`_cross_layout_restore`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.checkpoint.optim_state import load_mesh_state, mesh_state
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel.hybrid import _global_name, hybrid_model, make_hybrid_train_step
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from dsml_tpu_torch.utils.checkpoint import Checkpointer

    mesh = build_mesh(MeshSpec(pp=2, tp=2), rank, 4, os.path.join(tmp, "rendezvous"))
    dev = mesh.device
    res.update(device=str(dev), coords=mesh.coords)
    stage("weights")
    cfg = dataclasses.replace(LlamaConfig.tinyllama_1b(), dtype="bfloat16",
                              n_layer=MP_4RANK_LAYERS)

    def fresh():
        model = hybrid_model(Llama, cfg, mesh)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
        return model, opt, make_hybrid_train_step(model, opt, mesh, attn_impl="flash",
                                                  n_microbatches=2, schedule="1f1b")

    model, opt, step = fresh()
    model.load_full(torch.load(weights, mmap=True))  # the layers the cut model holds
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)))
    y = torch.roll(x, -1, 1)
    stage("pp x tp steps, a checkpoint after the first")
    reset_counts(tflash)
    ms, losses = [], []
    ckdir = os.path.join(tmp, "ckpt")
    ckpt = Checkpointer(ckdir, mesh=mesh)
    for i in range(MP_4RANK_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            state = mesh_state(model, opt, mesh, "clip_adamw", 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(1, **state, wait=False)  # the step loop pays the host snapshot
            stall_ms = (time.perf_counter() - t0) * 1e3
            ckpt.wait_until_finished()
            res["checkpoint"] = {"snapshot_stall_ms": stall_ms,
                                 "commit_ms": (time.perf_counter() - t0) * 1e3 - stall_ms,
                                 "bytes_this_rank": _owned_bytes(state)}
            del state
    ckpt.close()
    res["losses"] = losses
    res["step_ms"] = statistics.mean(ms)
    res["launches"] = train_counts(tflash)
    res["layers"] = model.layer_ids
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["ipc_slot_bytes"] = mesh.slot_bytes()
    specs = model.param_specs()
    named = list(model.named_parameters())
    # tp-replicated leaves: equal within a stage; non-layer leaves: equal
    # across the stages (each tp shard of wte/lm_head, and rms_f)
    res["tp_replicated_sha"] = _param_sha(
        [p for n, p in named if "tp" not in specs[_global_name(model, n)]])
    res["non_layer_sha"] = _param_sha([p for n, p in named if not n.startswith("layers.")])
    res["state_sha"] = _state_sha(mesh_state(model, opt, mesh, "clip_adamw", MP_4RANK_STEPS))
    del model, opt, step, named
    torch.cuda.empty_cache()
    stage("resume from the checkpoint: step 2 again")
    model, opt, step = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt = Checkpointer(ckdir, mesh=mesh)
    restored = ckpt.restore(1, template=mesh_state(model, opt, mesh, "clip_adamw", 0))
    ckpt.close()
    count = load_mesh_state(model, opt, mesh, "clip_adamw", restored)
    torch.cuda.synchronize()
    res["checkpoint"]["restore_ms"] = (time.perf_counter() - t0) * 1e3
    del restored
    reset_counts(tflash)  # the resumed step, counted
    resumed = float(step(x, y))
    res["resume"] = {"count": count, "loss": resumed, "launches": train_counts(tflash),
                     "state_sha": _state_sha(mesh_state(model, opt, mesh, "clip_adamw",
                                                        MP_4RANK_STEPS))}
    del model, opt, step
    torch.cuda.empty_cache()
    stage("the checkpoint at other layouts")
    res["cross_layout"] = _cross_layout_restore(
        os.path.join(ckdir, "step_00000001"), cfg, rank)
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


LC_LLAMA_WARMUP, LC_LLAMA_STEPS = 1, 2  # TinyLlama at cp = 2 x tp = 2
LC_2D_SHAPE = (B, H, TRAIN_S, D)  # attention_2d's global q/k/v: GPT-2-small's train attention


def lc_rank(rank, tmp, weights):
    rank_main(lambda r, t, res, stage: lc_run(r, t, res, stage, weights), "long_context", rank,
              tmp)


def _lc_llama(rank, mesh, res, stage, weights):
    """TinyLlama-1.1B bf16 at cp = 2 × tp = 2 (22 layers, 16 query and 2 kv
    heads a rank, the kv heads repeated to 16), the tp step's batch, ring2
    under DSML_RING_FUSED=dma: the steps' losses, ms, launches of kernels
    1–4; then a 2-layer f32 model at TinyLlama's width: the synced
    gradients (SGD at lr 0 leaves them) against one device's plain path."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel.hybrid import hybrid_model, make_hybrid_train_step

    dev = mesh.device
    os.environ["DSML_RING_FUSED"] = "dma"
    cfg = dataclasses.replace(LlamaConfig.tinyllama_1b(), dtype="bfloat16")
    model = hybrid_model(Llama, cfg, mesh)
    model.load_full(torch.load(weights, mmap=True))
    rng = np.random.default_rng(0)  # the tp = 2 step's batch
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)))
    y = torch.roll(x, -1, 1)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    step = make_hybrid_train_step(model, opt, mesh)  # ring2, the cp default
    stage("cp x tp TinyLlama steps")
    losses = [float(step(x, y)) for _ in range(LC_LLAMA_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(tflash)
    tflash.flash_stream_launches = 0
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(LC_LLAMA_STEPS)]
    torch.cuda.synchronize()
    res["llama"] = {"step_ms": (time.perf_counter() - t0) * 1e3 / LC_LLAMA_STEPS,
                    "losses": [float(v) for v in losses],
                    "launches": {**train_counts(tflash),
                                 "flash_stream": tflash.flash_stream_launches},
                    "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                    "ipc_slot_bytes": mesh.slot_bytes()}
    del model, opt, step
    torch.cuda.empty_cache()
    stage("cp x tp f32 gradient check")
    cfg32 = dataclasses.replace(LlamaConfig.tinyllama_1b(), n_layer=MP_F32_LAYERS)
    # the bf16 file's first layers in f32 (no host draw on four ranks at once)
    ref = Llama(cfg32, device=dev).load_full(torch.load(weights, mmap=True))
    shard = hybrid_model(Llama, cfg32, mesh).load_full(ref.state_dict())
    sgd = torch.optim.SGD(shard.parameters(), lr=0.0)
    loss = float(make_hybrid_train_step(shard, sgd, mesh)(x, y))
    ref_loss = ref.loss(x.to(dev), y.to(dev), attn_impl="xla")
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    res["llama_f32"] = {"loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                        "grads_max_err_over_max_abs": _shard_grad_err(
                            shard, ref, mesh.coords, mesh.shape)}
    del ref, shard, sgd
    torch.cuda.empty_cache()


def _lc_gpt2_cp_dp(rank, mesh, res, stage):
    """GPT-2-small bf16 at cp = 2 × dp = 2, one hybrid step (ring2 under
    dma) on the cp slice's batch: its loss, launches and ms; rank 0 also
    the single-device flash loss of the same weights and batch."""
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel.hybrid import make_hybrid_train_step

    dev = mesh.device
    rng = np.random.default_rng(2)  # the cp slice's batch
    x = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    y = torch.as_tensor(rng.integers(0, 50257, (TRAIN_B, TRAIN_S)))
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16", xent_chunk=0)
    model = gpt2_small(cfg, dev)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    step = make_hybrid_train_step(model, opt, mesh)
    stage("cp x dp GPT-2 step")
    reset_counts(tflash)
    tflash.flash_stream_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(step(x, y))
    res["gpt2_cp_dp"] = {"loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
                         "launches": {**train_counts(tflash),
                                      "flash_stream": tflash.flash_stream_launches}}
    del model, opt, step
    torch.cuda.empty_cache()
    if rank == 0:
        with torch.no_grad():
            single = gpt2_small(cfg, dev)
            res["gpt2_cp_dp"]["single_loss"] = float(single.loss(x.to(dev), y.to(dev),
                                                                 attn_impl="flash"))
        del single
        torch.cuda.empty_cache()


def _lc_attention_2d(rank, mesh, res, stage):
    """``attention_2d(flash=True)`` on sp = 2 (outer ring) × tp = 2 (inner
    all-to-all), bf16, causal: rank (o, i) holds sub-block o·2 + i of
    GPT-2-small's [8, 12, 1024, 64] train attention; its output block and
    the gradients of <out, do> against the f32 plain attention of the
    whole sequence on the same inputs; kernel launches."""
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.ops.attention import attention, attention_2d

    dev = mesh.device
    stage("attention_2d(flash=True)")
    gen = torch.Generator(device=dev).manual_seed(20)  # the same tensors on every rank
    q, k, v, do = (torch.randn(*LC_2D_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    block = mesh.coord("sp") * 2 + mesh.coord("tp")
    s = LC_2D_SHAPE[2] // 4
    rows = slice(block * s, (block + 1) * s)
    mine = [t[:, :, rows].detach().clone().requires_grad_() for t in (q, k, v)]
    reset_counts(tflash)
    out = attention_2d(*mine, mesh.group("tp"), mesh.group("sp"), True, flash=True)
    out.backward(do[:, :, rows])
    torch.cuda.synchronize()
    launches = train_counts(tflash)
    full = [t.float().requires_grad_() for t in (q, k, v)]
    want = attention(*full, causal=True)
    want.backward(do.float())
    err_out = (out.float() - want[:, :, rows]).abs().max().item()
    rel = max((m.grad.float() - f.grad[:, :, rows]).abs().max().item()
              / max(f.grad.abs().max().item(), 1e-30) for m, f in zip(mine, full))
    res["attention_2d"] = {"block": block, "max_abs_err_out": err_out,
                           "grads_max_err_over_max_abs": rel, "launches": launches,
                           "finite": bool(torch.isfinite(out).all())
                           and all(bool(torch.isfinite(m.grad).all()) for m in mine)}


def lc_run(rank, tmp, res, stage, weights):
    """The long-context paths on four ranks (one card: they time-slice
    it), each on its own mesh over one process group: TinyLlama at cp = 2
    × tp = 2 (:func:`_lc_llama`), GPT-2-small at cp = 2 × dp = 2
    (:func:`_lc_gpt2_cp_dp`), ``attention_2d(flash=True)`` on sp = 2 ×
    tp = 2 (:func:`_lc_attention_2d`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    rendezvous = os.path.join(tmp, "rendezvous")
    for spec, run in ((MeshSpec(cp=2, tp=2), lambda m: _lc_llama(rank, m, res, stage, weights)),
                      (MeshSpec(dp=2, cp=2), lambda m: _lc_gpt2_cp_dp(rank, m, res, stage)),
                      (MeshSpec(sp=2, tp=2), lambda m: _lc_attention_2d(rank, m, res, stage))):
        mesh = build_mesh(spec, rank, 4, rendezvous)
        res.setdefault("coords", {})[str(mesh.spec.sizes_dict())] = mesh.coords
        run(mesh)
        mesh.close()
    res["device"] = str(torch.cuda.current_device())
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def check_long_context(lc, tp_ranks, card):
    """The long-context 4-rank program's lines (see :func:`lc_run`), all
    emitted before any check. Returns rank 0's launches by path."""
    n_layer = 22
    tp_losses = tp_ranks[0]["losses"]
    llama, g, a2d = ([r[key] for r in lc] for key in ("llama", "gpt2_cp_dp", "attention_2d"))
    single = g[0]["single_loss"]
    emit({"phase": "long_context_cp_tp", "model": "tinyllama-1.1b", "dtype": "bfloat16",
          "cp": 2, "tp": 2, "attn_impl": "ring2", "fused": "dma",
          "batch": [LLAMA_TRAIN_B, LLAMA_TRAIN_S], "warmup": LC_LLAMA_WARMUP,
          "steps": LC_LLAMA_STEPS, "tp2_losses": tp_losses, "card": card,
          "note": "four ranks time-slice one card",
          "ranks": [{"rank": r["rank"], "coords": r["coords"], **r["llama"],
                     "f32": r["llama_f32"]} for r in lc]})
    emit({"phase": "long_context_cp_dp", "model": "gpt2-small", "dtype": "bfloat16", "cp": 2,
          "dp": 2, "attn_impl": "ring2", "fused": "dma", "global_batch": [TRAIN_B, TRAIN_S],
          "single_device_loss": single, "tol": TOL_CP_BF16_LOSS, "card": card,
          "ranks": [{"rank": r["rank"], **r["gpt2_cp_dp"]} for r in lc]})
    emit({"phase": "long_context_attention_2d", "shape": list(LC_2D_SHAPE), "dtype": "bfloat16",
          "outer": "sp = 2", "inner": "tp = 2", "flash": True, "causal": True,
          "tol_out": TOL[torch.bfloat16]["out"], "tol_grads": TOL_BWD[torch.bfloat16],
          "card": card, "ranks": a2d})
    for r, x in zip(lc, llama):
        cp = r["coords"][str({"pp": 1, "dp": 1, "fsdp": 1, "sp": 1, "cp": 2, "tp": 2})]["cp"]
        # dma: hop 0's two halves through kernel 4; hop 1 kept on cp rank 1
        # only (rank 0's visiting keys are all later), kernel 1 a half
        per = n_layer * LC_LLAMA_STEPS
        want = {"flash_stream": 2 * per, "flash_fwd": 2 * cp * per,
                "flash_bwd_dq_tc": 2 * (1 + cp) * per, "flash_bwd_dkv_tc": 2 * (1 + cp) * per,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        check(x["launches"] == want, f"cp x tp rank {r['rank']}: launches {x['launches']}, "
                                     f"expected {want}")
        # the tp = 2 step from the same weights, batch and optimizer: step 0
        # within the bf16 bound, the later steps within the drift bound
        check(x["losses"] == llama[0]["losses"] and all(np.isfinite(x["losses"]))
              and abs(x["losses"][0] - tp_losses[0]) <= MP_BF16_LOSS_RTOL * abs(tp_losses[0])
              and max(abs(a - b) for a, b in zip(x["losses"], tp_losses)) <= MP_LOSS_DRIFT,
              f"cp x tp rank {r['rank']}: losses {x['losses']} vs the tp = 2 step's {tp_losses}")
        f32 = r["llama_f32"]
        check(f32["loss_rel_err"] <= 1e-5 and f32["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
              f"cp x tp rank {r['rank']}: f32 gradients against one device's: {f32}")
    for x in g:
        check(x["loss"] == g[0]["loss"] and abs(x["loss"] - single) <= TOL_CP_BF16_LOSS * abs(single),
              f"cp x dp: loss {x['loss']} vs one device's {single}")
        check(x["launches"]["flash_stream"] == 2 * 12,
              f"cp x dp: kernel 4 launched {x['launches']['flash_stream']}, expected 24")
    for x in a2d:
        check(x["finite"] and x["max_abs_err_out"] <= TOL[torch.bfloat16]["out"]
              and x["grads_max_err_over_max_abs"] <= TOL_BWD[torch.bfloat16],
              f"attention_2d(flash=True) block {x['block']} against one device: {x}")
        check(bf16_step_counts_ok(x["launches"], 2, 2),
              f"attention_2d(flash=True): kernels 1-3 launched {x['launches']}, expected 2 each")
    r0 = lc[0]
    return {"cp_tp_llama": r0["llama"]["launches"], "cp_dp": r0["gpt2_cp_dp"]["launches"],
            "attention_2d": {**r0["attention_2d"]["launches"], "flash_stream": 0}}


PLAN_MODELS = ("tinyllama_1b", "llama2_7b", "mixtral_8x7b")
PLAN_DEVICES = (1, 2, 4, 8)


def phase_plan(card):
    """The mesh planner on the card: the per-chip memory ``plan_mesh``
    reads (provenance ``memory_stats``, the card's total memory) and its
    plans (spec, reasons, ``pp_interleave``) for TinyLlama-1.1B,
    Llama-2-7B and Mixtral-8x7B at their published widths, bf16 weights,
    2 sequences of their training length a device, on 1, 2, 4 and 8 cards."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.parallel import auto

    t_phase = time.perf_counter()
    hbm, detail = auto._device_hbm_bytes()
    plans = {}
    for name in PLAN_MODELS:
        cfg = getattr(LlamaConfig, name)()
        n_params = Llama(cfg, device="meta").n_params()
        for n in PLAN_DEVICES:
            plan = auto.plan_mesh(n_devices=n, n_params=n_params, n_head=cfg.n_head,
                                  seq_len=cfg.max_seq, d_model=cfg.d_model, n_layer=cfg.n_layer,
                                  batch_per_device=2)
            plans[f"{name}@{n}"] = {"n_params": n_params, "spec": {
                a: v for a, v in plan.spec.sizes_dict().items() if v > 1},
                "pp_interleave": plan.pp_interleave, "hbm_source": plan.hbm_source,
                "reasons": list(plan.reasons)}
    emit({"phase": "plan", "hbm_bytes": hbm, "hbm_detail": detail,
          "total_memory": torch.cuda.get_device_properties(0).total_memory, "plans": plans,
          "card": card, "phase_seconds": time.perf_counter() - t_phase})
    check(hbm == torch.cuda.get_device_properties(0).total_memory
          and all(p["hbm_source"] == "memory_stats" for p in plans.values()),
          f"plan_mesh read {hbm} bytes ({detail}), not the card's memory_stats")


def check_eval(who, ev):
    """The eval loss of a model-parallel mesh against the single-device
    eval loss of the same weights: 1e-5 relative in f32, the bf16 loss
    checks' share in bf16."""
    check(abs(ev["f32"] - ev["f32_single_device"]) <= 1e-5 * abs(ev["f32_single_device"])
          and abs(ev["bf16"] - ev["bf16_single_device"])
          <= MP_BF16_LOSS_RTOL * abs(ev["bf16_single_device"]),
          f"{who}: eval loss against the single-device eval loss: {ev}")


def spawn_mesh(fn, kind, nprocs, *args):
    """Run ``fn(rank, tmp, *args)`` on ``nprocs`` spawned ranks (one card:
    they share it); each rank's JSON and the seconds the spawn took."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{kind}_") as tmp:
        t0 = time.perf_counter()
        mp.spawn(fn, args=(tmp, *args), nprocs=nprocs, join=True)
        seconds = time.perf_counter() - t0
        ranks = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return ranks, seconds


def phase_model_parallel(tflash, dev, card, weights, serve=False):
    """(a) TinyLlama-1.1B bf16 at tp = 2, batch 2 × 2048, AdamW(3e-4,
    weight_decay=0.01): 22 launches of kernels 1–3 a step a rank over 16
    local heads, the step-0 loss against the single-device step's from the
    same weights, f32 gradients of a 2-layer model at TinyLlama's width
    against the single-device plain path's, identical replicated leaves,
    step ms, the tp all-reduces a step and their ms, peak memory and IPC
    slot bytes a rank. (b) GPT-2-small bf16 at pp = 2, 8 × 1024, 4
    microbatches under gpipe, 1f1b and the interleaved schedule (v = 2):
    losses that agree, 6 layers × 4 microbatches of launches a rank a step,
    step ms and peak memory per schedule, f32 gradients at 4 layers against
    the single-device plain path, one remat="int8" step through kernel 8.
    (c) GPT-2-small bf16 at fsdp = 2: the hybrid ZeRO-3 step and ZeRO-2 in 4
    MiB buckets (full precision, int8 + error feedback) against the dp = 2
    ring step from the same weights, optimizer-state bytes a rank, step ms.
    (d) TinyLlama-1.1B at pp = 2 × tp = 2 (four ranks; 8 of its 22 layers), 1F1B, ending with
    identical replicas; a checkpoint of every rank's blocks after step 1
    (snapshot stall, commit and restore ms, bytes a rank), from which fresh
    model and optimizer objects take step 2 again with the same loss and
    the same bytes in every leaf, and which ranks of a pp = 4 layout read
    back (a tp = 2 layout, a layer list, is refused, as in the JAX
    package). The pp ranks also take the eval loss (the pipelined forward,
    4 microbatches: 24 kernel-1 launches a rank), the fsdp ranks build
    their mesh from ``plan_mesh`` and take the eval loss of the gathered
    weights, each in bf16 and f32 against the single-device eval loss of
    the same weights. (e) The long-context program in the pp × tp ranks'
    spawn (:func:`lc_run`): TinyLlama-1.1B at cp = 2 × tp = 2 through
    ring2 (kernel 4) against the tp = 2 step-0 loss, with a 2-layer f32
    gradient check; GPT-2-small at cp = 2 × dp = 2; attention_2d(flash=
    True) on sp = 2 × tp = 2 (:func:`check_long_context`). Ranks time-slice
    the one card: the times are the cost of the collectives and the
    schedules, not a model-parallel speed-up. ``weights`` is the TinyLlama
    bf16 file the tp and pp × tp ranks map (:func:`tinyllama_bf16_weights`).
    The tp, pp and fsdp programs share one spawn of two ranks; with
    ``serve`` those ranks go on to the tp_serve program
    (:func:`tp_serve_run`, whose references run here first) last. The pp ×
    tp and long-context programs share a spawn of four ranks, run beside
    the two-rank spawn. Returns rank 0's launches per path, kernel
    8's launches, with ``serve`` the tp_serve references and (ranks,
    seconds of the shared spawn), rank 0's launches of the resumed
    step and the pp eval, and rank 0's launches on the long-context paths."""
    t_phase = time.perf_counter()
    serve_ref = tp_serve_reference(tflash, dev, weights) if serve else None
    # the single-device step-0 loss from the weights
    model = llama_model(dev, dtype="bfloat16", xent_chunk=8192)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, 32000, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)), device=dev)
    with torch.no_grad():
        single_loss = float(model.loss(x, torch.roll(x, -1, 1), attn_impl="flash"))
    del model
    torch.cuda.empty_cache()
    # the two-rank programs in one spawn: tp, pp, fsdp (then tp_serve, last:
    # the four-rank spawn below runs beside the others, not beside its
    # timed drains on a quick host)
    tp_programs = {"tp": (mp_tp_rank, (weights,)), "pp": (mp_pp_rank, ()),
                   "fsdp": (mp_zero_rank, ())}
    if serve:
        tp_programs["tp_serve"] = (tp_serve_rank, (weights, serve_ref["inputs"]))
    # the pp x tp program and the long-context program in a spawn of four
    # ranks, beside the two-rank spawn (every check is of values, which do
    # not depend on what shares the card; the times are its cost)
    four_out = {}

    def four_ranks():
        try:
            four_out["done"] = spawn_programs({"pp_tp": (mp_4rank_rank, (weights,)),
                                               "long_context": (lc_rank, (weights,))},
                                              "pp_tp", 4)
        except BaseException as e:  # noqa: BLE001 — raised in this thread below
            four_out["error"] = e

    beside = threading.Thread(target=four_ranks, name="chip_smoke_pp_tp")
    beside.start()
    try:
        tp_out, tp_seconds = spawn_programs(tp_programs, "tp")
    finally:
        beside.join()
    if "error" in four_out:
        raise four_out["error"]
    fours, four_seconds = four_out["done"]
    tp_ranks = tp_out["tp"]
    pp_ranks, zero_ranks, pp_seconds = tp_out["pp"], tp_out["fsdp"], tp_seconds
    zero_seconds = pp_seconds
    four, lc = fours["pp_tp"], fours["long_context"]
    note = ("ranks time-slice one card: the times are the cost of the collectives and the "
            "schedule, not a model-parallel speed-up")

    # (a) tp
    n_layer = 22
    for r in tp_ranks:  # the step's all-reduces at the measured 16 MiB time
        r["all_reduce_ms_per_step_est"] = (r["all_reduce_16MiB_ms"]
                                           * r["tp_all_reduce_bytes_per_step"] / (16 << 20))
    emit({"phase": "model_parallel_tp", "model": "tinyllama-1.1b", "dtype": "bfloat16", "tp": 2,
          "batch": [LLAMA_TRAIN_B, LLAMA_TRAIN_S], "optimizer": "AdamW(3e-4, weight_decay=0.01)",
          "steps": MP_TP_STEPS, "warmup": MP_TP_WARMUP, "single_device_step0_loss": single_loss,
          "seconds_with_spawn": tp_seconds, "card": card, "note": note, "ranks": tp_ranks})
    for r in tp_ranks:
        rk = r["rank"]
        check(bf16_step_counts_ok(r["launches"], n_layer * MP_TP_STEPS, n_layer * MP_TP_STEPS),
              f"tp rank {rk}: flash launches {r['launches']}, expected {n_layer} a step")
        check(abs(r["losses"][0] - single_loss) <= MP_BF16_LOSS_RTOL * abs(single_loss),
              f"tp rank {rk}: step-0 loss {r['losses'][0]} vs single-device {single_loss}")
        check(all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0],
              f"tp rank {rk}: losses {r['losses']}")
        check(r["f32"]["loss_rel_err"] <= 1e-5
              and r["f32"]["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
              f"tp rank {rk}: f32 gradients against the single-device plain path: {r['f32']}")
    check(tp_ranks[0]["losses"] == tp_ranks[1]["losses"]
          and tp_ranks[0]["replicated_sha"] == tp_ranks[1]["replicated_sha"],
          "tp ranks: losses or replicated leaves differ")

    # (b) pp
    emit({"phase": "model_parallel_pp", "model": "gpt2-small", "dtype": "bfloat16", "pp": 2,
          "batch": [MP_PP_B, MP_PP_S], "n_micro": MP_PP_MICRO, "steps": MP_PP_STEPS,
          "warmup": MP_PP_WARMUP, "seconds_with_spawn": pp_seconds, "card": card, "note": note,
          "ranks": pp_ranks})
    for r in pp_ranks:
        rk = r["rank"]
        per = 6 * MP_PP_MICRO * MP_PP_STEPS
        base = r["schedules"]["gpipe"]["losses"]
        for name, row in r["schedules"].items():
            check(bf16_step_counts_ok(row["launches"], per, per),
                  f"pp rank {rk} {name}: flash launches {row['launches']}, expected {per}")
            check(abs(row["losses"][0] - base[0]) <= MP_BF16_LOSS_RTOL * abs(base[0])
                  and max(abs(a - b) for a, b in zip(row["losses"], base)) <= MP_LOSS_DRIFT,
                  f"pp rank {rk}: {name} losses {row['losses']} vs gpipe {base}")
        for name, f32 in r["f32"].items():
            check(f32["loss_rel_err"] <= 1e-5 and f32["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
                  f"pp rank {rk} {name}: f32 gradients against the single-device plain path: {f32}")
        check(r["int8_remat"]["quantize_int8"] == 6 * MP_PP_MICRO
              and abs(r["int8_remat"]["loss"] - base[0]) <= MP_BF16_LOSS_RTOL * abs(base[0]),
              f"pp rank {rk}: int8 remat step {r['int8_remat']}")
        check_eval(f"pp rank {rk}", r["eval"])
        check(r["eval"]["launches"]["flash_fwd"] == 6 * MP_PP_MICRO
              and sum(r["eval"]["launches"].values()) == 6 * MP_PP_MICRO,
              f"pp rank {rk}: the pp eval launched {r['eval']['launches']}, expected "
              f"{6 * MP_PP_MICRO} of the flash forward and nothing else")
    check(all(pp_ranks[0]["schedules"][k]["losses"] == pp_ranks[1]["schedules"][k]["losses"]
              for k in MP_SCHEDULES), "pp ranks report different losses")

    # (c) ZeRO
    emit({"phase": "model_parallel_zero", "model": "gpt2-small", "dtype": "bfloat16", "fsdp": 2,
          "batch": [TRAIN_B, TRAIN_S], "bucket_mb": MP_ZERO_BUCKET_MB, "steps": MP_PP_STEPS,
          "warmup": MP_PP_WARMUP, "seconds_with_spawn": zero_seconds, "card": card, "note": note,
          "ranks": zero_ranks})
    for r in zero_ranks:
        rk, ref = r["rank"], r["dp_ring"]
        check(r["plan"]["spec"] == {"pp": 1, "dp": 1, "fsdp": 2, "sp": 1, "cp": 1, "tp": 1},
              f"fsdp rank {rk}: the planner's mesh {r['plan']}")
        check_eval(f"fsdp rank {rk}", r["eval"])
        for name in ("zero3", "zero2", "zero2_int8_ef"):
            row = r[name]
            check(bf16_step_counts_ok(row["launches"], 12 * MP_PP_STEPS, 12 * MP_PP_STEPS),
                  f"fsdp rank {rk} {name}: flash launches {row['launches']}")
            check(abs(row["losses"][0] - ref["losses"][0]) <= MP_BF16_LOSS_RTOL * abs(ref["losses"][0])
                  and max(abs(a - b) for a, b in zip(row["losses"], ref["losses"])) <= MP_LOSS_DRIFT,
                  f"fsdp rank {rk}: {name} losses {row['losses']} vs dp ring {ref['losses']}")
            share = row["optimizer_state_bytes"] / ref["optimizer_state_bytes"]
            check(0.45 <= share <= 0.55, f"fsdp rank {rk}: {name} optimizer state is {share} of dp's")
    for name in ("zero2", "zero2_int8_ef"):
        check(zero_ranks[0][name]["weights_sha"] == zero_ranks[1][name]["weights_sha"],
              f"{name}: the replicated parameters differ across ranks")

    # (d) pp x tp
    emit({"phase": "model_parallel_pp_tp", "model": "tinyllama-1.1b", "dtype": "bfloat16",
          "pp": 2, "tp": 2, "schedule": "1f1b", "n_micro": 2, "n_layer": MP_4RANK_LAYERS,
          "batch": [LLAMA_TRAIN_B, LLAMA_TRAIN_S], "steps": MP_4RANK_STEPS,
          "seconds_with_spawn": four_seconds, "card": card, "note": note, "ranks": four})
    for r in four:
        check(all(np.isfinite(r["losses"])) and r["losses"] == four[0]["losses"],
              f"pp x tp rank {r['rank']}: losses {r['losses']} vs rank 0's {four[0]['losses']}")
        res = r["resume"]
        check(res["count"] == 1 and res["loss"] == r["losses"][1]
              and res["state_sha"] == r["state_sha"],
              f"pp x tp rank {r['rank']}: step 2 resumed from the checkpoint (count "
              f"{res['count']}, loss {res['loss']}, state {res['state_sha'][:12]}) differs from "
              f"the straight step 2 (loss {r['losses'][1]}, state {r['state_sha'][:12]})")
        per = MP_4RANK_LAYERS // 2 * 2
        check(bf16_step_counts_ok(res["launches"], per, per),
              f"pp x tp rank {r['rank']}: the resumed step launched {res['launches']}, "
              f"expected {per}")
        cross = r["cross_layout"]
        check(not cross["pp4"]["mismatched"] and cross["tp2_dp2_refused"] is not None,
              f"pp x tp rank {r['rank']}: the checkpoint at other layouts: {cross}")
        per = MP_4RANK_LAYERS // 2 * 2 * MP_4RANK_STEPS
        check(bf16_step_counts_ok(r["launches"], per, per),
              f"pp x tp rank {r['rank']}: flash launches {r['launches']}, expected {per}")
        for s in four:
            if s["coords"]["pp"] == r["coords"]["pp"]:
                check(s["tp_replicated_sha"] == r["tp_replicated_sha"],
                      f"ranks {r['rank']} and {s['rank']}: tp-replicated leaves differ")
            if s["coords"]["tp"] == r["coords"]["tp"]:
                check(s["non_layer_sha"] == r["non_layer_sha"],
                      f"ranks {r['rank']} and {s['rank']}: non-layer leaves differ across stages")
    emit({"phase": "mp_checkpoint", "model": "tinyllama-1.1b", "n_layer": MP_4RANK_LAYERS,
          "dtype": "bfloat16", "pp": 2, "tp": 2, "optimizer": "AdamW(3e-4, weight_decay=0.01)",
          "note": "each rank writes and restores its own blocks of the JAX init_hybrid tree",
          "ranks": [{"rank": r["rank"], "coords": r["coords"], **r["checkpoint"],
                     "resumed_loss_equal": r["resume"]["loss"] == r["losses"][1],
                     "resumed_state_equal": r["resume"]["state_sha"] == r["state_sha"],
                     "cross_layout": r["cross_layout"]} for r in four], "card": card})
    # (e) the long-context paths
    lc_launches = check_long_context(lc, tp_ranks, card)
    emit({"phase": "model_parallel", "phase_seconds": time.perf_counter() - t_phase,
          "seconds": {"tp" + (" + tp_serve" if serve else ""): tp_seconds,
                      "pp + zero": pp_seconds, "pp_tp + long_context": four_seconds},
          "card": card})
    counts = {k: tp_ranks[0]["launches"][k] + pp_ranks[0]["schedules"]["gpipe"]["launches"][k]
              for k in tp_ranks[0]["launches"]}
    # the path of this slice: rank 0's resumed pp x tp step and pp eval
    resume_eval = {k: four[0]["resume"]["launches"][k] + pp_ranks[0]["eval"]["launches"][k]
                   for k in counts}
    served = (serve_ref, (tp_out["tp_serve"], tp_seconds)) if serve else None
    return counts, pp_ranks[0]["int8_remat"]["quantize_int8"], served, resume_eval, lc_launches


# ---- tensor-parallel serving: TinyLlama-1.1B at tp = 2 (port slice 17) -------------

TP_SERVE_B, TP_SERVE_PROMPT, TP_SERVE_NEW = 2, 512, 32  # generate_spmd's batch and lengths
# of llama_prompts: the bf16 and f32 drains (bf16 cut from 16: the run's time)
TP_SERVE_REQUESTS, TP_SERVE_F32_REQUESTS = 8, 4
TP_SERVE_HEADS, TP_SERVE_KV_HEADS = LLAMA_HEADS // 2, LLAMA_KV_HEADS // 2  # a rank's
TP_SERVE_STEADY_TICKS = 5
# the f32 drains' pages: unquantized, so that the tp ranks' f32 rounding
# (row-parallel partial sums, one all-reduce) cannot flip an int4 code; an
# int4 flip moves the logits by a quantum's share, not by rounding noise
# (the first chip run: request 2 parted at step 114 with a top-2 margin of
# 0.036), which no margin rule meant for f32 noise admits
TP_SERVE_F32_PAGES = "fp"


def with_tinyllama_weights(fn):
    """``fn(path)`` with the :func:`tinyllama_bf16_weights` file."""
    with tinyllama_bf16_weights() as path:
        return fn(path)


@contextlib.contextmanager
def tinyllama_bf16_weights():
    """TinyLlama-1.1B's weights (:func:`llama_weights`) rounded to bf16 in a
    file the spawned ranks map (``torch.load(mmap=True)``), deleted after."""
    import tempfile

    wdir = tempfile.mkdtemp(prefix="chip_smoke_tinyllama_")
    try:
        path = os.path.join(wdir, "tinyllama_bf16.pt")
        torch.save({k: v.to(torch.bfloat16) for k, v in llama_weights().items()}, path)
        yield path
    finally:
        shutil.rmtree(wdir, ignore_errors=True)


def tp_serve_inputs():
    """The generate prompt [2, 512] and the drains' requests (the first
    :data:`TP_SERVE_REQUESTS` of the Llama serving row's, ``llama_prompts``
    at seed 2)."""
    prompt = np.random.default_rng(17).integers(0, 32000, (TP_SERVE_B, TP_SERVE_PROMPT))
    prompts, budgets, _ = llama_prompts(np.random.default_rng(2), PAGED_REQUESTS)
    return (prompt, [p.tolist() for p in prompts[:TP_SERVE_REQUESTS]],
            [int(n) for n in budgets[:TP_SERVE_REQUESTS]])


def tp_serve_kernels(tflash, dev):
    """Kernel 1 at the tp prefill's shape [2·16, 512, 64] (bf16 and f32) and
    kernels 5 and 6 at a rank's decode and chunk shapes (16 query heads over
    2 kv heads, int4 pages; bf16 and f32 q at decode), each against its plain
    version; their times by CUDA events. Returns (max errors, times)."""
    from dsml_tpu_torch.ops import paged_attention as tpa

    gen = torch.Generator(device=dev).manual_seed(17)
    bh, s, d = TP_SERVE_B * TP_SERVE_HEADS, TP_SERVE_PROMPT, D
    errs, times = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(bh, s, d, generator=gen, device=dev).to(dt) for _ in range(3))
        out, lse = tflash.flash_fwd(q, k, v, True)
        torch.cuda.synchronize()
        ref_out, ref_lse = tflash._flash_fwd_reference(q, k, v, True)
        err = {"out": (out.float() - ref_out.float()).abs().max().item(),
               "lse": (lse - ref_lse).abs().max().item()}
        ok = (bool(torch.isfinite(out).all()) and err["out"] <= TOL[dt]["out"]
              and err["lse"] <= TOL[dt]["lse"])
        emit({"phase": "tp_serve_kernel", "kernel": "flash_fwd", "shape": [bh, s, d],
              "dtype": str(dt)[6:], "causal": True, "max_abs_err": err, "tol": TOL[dt], "ok": ok})
        check(ok, f"flash_fwd at the tp = 2 prefill shape ({dt}): {err}")
        errs[f"flash_fwd_{str(dt)[6:]}"] = err["out"]
        bound_ms, bound_by = attention_bound_ms(bh, s, s, d, dt, True)
        q4, k4, v4 = (t.view(TP_SERVE_B, TP_SERVE_HEADS, s, d) for t in (q, k, v))
        times[f"flash_fwd_{str(dt)[6:]}"] = {
            "ms": cuda_ms(functools.partial(tflash.flash_fwd, q, k, v, True)),
            "plain_ms": cuda_ms(functools.partial(tflash._flash_fwd_reference, q, k, v, True),
                                reps=5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": cuda_ms(functools.partial(F.scaled_dot_product_attention, q4, k4, v4,
                                                    is_causal=True))}
    rng = np.random.default_rng(17)
    n_pt = 2048 // PAGE
    decode_pos = (rng.integers(1, 1024, PAGED_SLOTS) - 1)[:, None]
    shapes = {"tp_decode": (PAGED_SLOTS, decode_pos),
              "tp_chunk": (1, (512 + np.arange(PAGED_CHUNK))[None, :])}
    for shape, (b, positions) in shapes.items():
        for q_dtype in (torch.bfloat16, torch.float32):
            if shape == "tp_chunk" and q_dtype == torch.float32:
                continue
            args = paged_case(dev, rng, gen, b, TP_SERVE_HEADS, TP_SERVE_KV_HEADS, D, n_pt,
                              positions, q_dtype, "int4")
            errs[f"paged_{shape}_{str(q_dtype)[6:]}"] = paged_check(dev, tpa, shape, args, "int4",
                                                                    q_dtype, positions)
            if q_dtype == torch.bfloat16:
                call = (*args, "int4")
                bound_ms, bound_by = paged_bound_ms(*args)
                plain_ms = cuda_ms(lambda: tpa._paged_attention_reference(*call))
                for name, pipe in (("paged_attn", False), ("paged_attn_pipelined", True)):
                    times.setdefault(name, {})[shape] = {
                        "ms": cuda_ms(lambda: tpa.paged_attention(*call, pipeline=pipe)),
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None}
    emit({"phase": "kernel_time", "path": "tp_serve", "hq": TP_SERVE_HEADS,
          "hkv": TP_SERVE_KV_HEADS, "hd": D, "page": PAGE, "codec": "int4", **times,
          "note": "CUDA events around one wrapper call (host time between launches included), "
                  "at a tp = 2 rank's shapes: flash [2·16, 512, 64] causal, paged decode "
                  "16 slots at depths 1-1023 and a 256-row chunk from 512"})
    return errs, times


def tp_serve_rank(rank, tmp, weights, inputs):
    rank_main(lambda r, t, res, stage: tp_serve_run(r, t, res, stage, weights, inputs),
              "tp_serve", rank, tmp)


def _logits_sha(logits) -> str:
    import hashlib

    return hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest()


def tp_serve_run(rank, tmp, res, stage, weights, inputs):
    """TinyLlama-1.1B at tp = 2 (one rank): ``generate_spmd`` and the int4
    paged batcher on a mesh, f32 (tokens for the margin rule) then bf16
    (times, launches, collectives)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.parallel import tp as ttp
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from dsml_tpu_torch.serving import ContinuousBatcher

    prompt, prompts, budgets = inputs
    prompts = [np.asarray(p, np.int64) for p in prompts]
    mesh = build_mesh(MeshSpec(tp=2), rank, 2, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("tp")
    res["device"] = str(dev)
    torch.cuda.reset_peak_memory_stats(dev)  # the process may have trained before (tp)
    state = torch.load(weights, mmap=True)
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    x = torch.as_tensor(prompt, device=dev)

    def shard(dtype):
        cfg = dataclasses.replace(LlamaConfig.tinyllama_1b(), dtype=dtype)
        return Llama(cfg, device=dev, tp_group=group).load_full(state)

    stage("f32 generate_spmd")
    model = shard("float32")
    res["local_heads"] = {"q": model.config.n_head // group.size,
                          "kv": model.config.n_kv_head // group.size}
    logits, cache = model.prefill(x)
    res["f32_cache_heads"] = cache[0]["k"].shape[1]
    res["f32_prefill_logits_sha"] = _logits_sha(logits)
    del logits, cache
    reset_counts(tflash)
    res["f32_tokens"] = model.generate_spmd(x, TP_SERVE_NEW, mesh).tolist()
    res["f32_generate_launches"] = train_counts(tflash)
    stage("f32 batcher")
    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"  # the single-buffer kernel (5)
    try:
        srv = ContinuousBatcher(model, mesh=mesh, **{**kw, "paged_kv": TP_SERVE_F32_PAGES})
        tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
        toks, wall, _ = drain(srv, prompts[:TP_SERVE_F32_REQUESTS], budgets[:TP_SERVE_F32_REQUESTS])
        res["f32_batcher"] = {"tokens": toks, "launches": paged_counts(tpa), "wall_s": wall,
                              "pool_heads": srv._pool[0]["k"].shape[1],
                              "pages_back": srv.free_pages == srv.n_pages - 1}
    finally:
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
    del srv, model
    torch.cuda.empty_cache()

    stage("bf16 generate_spmd")
    model = shard("bfloat16")
    model.generate_spmd(x, 4, mesh)  # warm-up: cuBLAS, the allocator, the IPC slots
    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(x)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    reset_counts(tflash)
    torch.cuda.synchronize()
    dist.barrier(group=group.pg)
    t0 = time.perf_counter()
    toks = model.generate_spmd(x, TP_SERVE_NEW, mesh)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = train_counts(tflash)
    _, cache = model.prefill(x)
    ttp.reset_stats()
    model.decode_step(cache, toks[:, 0], TP_SERVE_PROMPT)
    res["bf16_generate"] = {
        "tokens": toks.tolist(), "seconds": gen_s, "prefill_ms": statistics.median(prefill_ms),
        "decode_ms_per_step": (gen_s * 1e3 - statistics.median(prefill_ms)) / (TP_SERVE_NEW - 1),
        "tokens_per_s": TP_SERVE_B * TP_SERVE_NEW / gen_s, "launches": launches,
        "decode_step_collectives": dict(ttp.STATS)}
    del cache

    stage("bf16 batcher")
    srv = ContinuousBatcher(model, mesh=mesh, **kw)
    drain(srv, prompts[:4], [8] * 4)  # warm-up
    srv.reset_latency_stats()
    plain0, pre0 = srv.n_plain_ticks, srv.n_prefill_dispatches
    tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0  # the main path, counted
    ttp.reset_stats()
    toks, wall, tick_ms = drain(srv, prompts, budgets)
    stats = dict(ttp.STATS)
    lat = srv.latency_stats()
    n_ticks, n_chunks = srv.n_plain_ticks - plain0, srv.n_prefill_dispatches - pre0
    res["bf16_batcher"] = {
        "tokens": toks, "launches": paged_counts(tpa), "wall_s": wall,
        "new_tokens": sum(len(t) for t in toks), "tokens_per_s": sum(len(t) for t in toks) / wall,
        "decode_ticks": n_ticks, "prefill_chunks": n_chunks,
        "ttft_p50_s": lat.get("ttft_p50_s"), "e2e_p50_s": lat.get("e2e_p50_s"),
        "decode_tick_ms_median": statistics.median(tick_ms), "drain_collectives": stats,
        "complete": all(len(t) == n for t, n in zip(toks, budgets)),
        "pages_back": srv.free_pages == srv.n_pages - 1}
    stage("steady tick")
    for i in range(srv.n_slots):
        srv.submit(prompts[i % len(prompts)][:64], 64)
    while srv.n_queued or srv.n_pending or srv.n_active < srv.n_slots:
        srv.step()
    walls = []
    ttp.reset_stats()
    for _ in range(TP_SERVE_STEADY_TICKS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        srv.step()
        walls.append((time.perf_counter() - t) * 1e3)
    per_tick = {k: v / TP_SERVE_STEADY_TICKS for k, v in ttp.STATS.items()}
    busy, top = device_busy_ms(srv.step)
    srv.abandon()
    # the tick's collectives alone, at its payloads: the all-reduce of the
    # [16, 1, 2048] hidden states and the all-gather of [16, 16000] logits
    hidden = torch.randn(PAGED_SLOTS, 1, model.config.d_model, device=dev).to(torch.bfloat16)
    shard_logits = torch.randn(PAGED_SLOTS, model.config.vocab_size // 2,
                               device=dev).to(torch.bfloat16)
    ar_ms = statistics.median(collective_times(lambda: ttp.tp_all_reduce(hidden, group),
                                               group.pg))
    ag_ms = statistics.median(collective_times(
        lambda: ttp.all_gather_tp(shard_logits, group, dim=-1), group.pg))
    wall = statistics.median(walls)
    res["steady_tick"] = {
        "slots": srv.n_slots, "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": None if busy is None else 1 - busy / wall, "top_kernels_ms": top,
        "collectives": per_tick, "all_reduce_ms": ar_ms, "all_gather_ms": ag_ms,
        "collective_ms_est": per_tick["all_reduce"] * ar_ms + per_tick["all_gather"] * ag_ms,
        "pages_back": srv.free_pages == srv.n_pages - 1}
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["ipc_slot_bytes"] = mesh.slot_bytes()
    del srv, model
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def tp_serve_reference(tflash, dev, weights):
    """The tp_serve phase's work in this process before its ranks: kernels
    1, 5 and 6 at a rank's shapes, the inputs, and the single-device f32
    references from the same bf16-rounded weights (``generate`` at 2 × 512 +
    32 and the paged batcher on 4 requests over :data:`TP_SERVE_F32_PAGES`)."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.serving import ContinuousBatcher

    t0 = time.perf_counter()
    errs, times = tp_serve_kernels(tflash, dev)
    prompt, prompts, budgets = inputs = tp_serve_inputs()
    ref = Llama(LlamaConfig.tinyllama_1b(), device=dev)
    ref.load_state_dict(torch.load(weights, mmap=True))
    tokens = ref.generate(torch.as_tensor(prompt, device=dev), TP_SERVE_NEW).tolist()
    kw = dict(paged_kv=TP_SERVE_F32_PAGES, page_size=PAGE, prefill_chunk=PAGED_CHUNK,
              n_slots=PAGED_SLOTS)
    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
    try:
        srv = ContinuousBatcher(ref, **kw)
        drained, _, _ = drain(srv, [np.asarray(p, np.int64) for p in prompts[:TP_SERVE_F32_REQUESTS]],
                              budgets[:TP_SERVE_F32_REQUESTS])
        del srv
    finally:
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
    del ref
    torch.cuda.empty_cache()
    return {"errs": errs, "times": times, "inputs": inputs, "tokens": tokens, "drain": drained,
            "seconds": time.perf_counter() - t0}


def phase_tp_serve(tflash, dev, card, weights, ref=None, spawned=None):
    """TinyLlama-1.1B at full width and depth served at tp = 2 (two spawned
    ranks sharing the card, each holding 16 query and 2 kv heads of every
    layer, half the vocabulary and its KV shard). Kernels 1, 5 and 6 at a
    rank's shapes against their plain versions. The single-device f32
    references in this process: ``generate`` at 2 × 512 + 32 and the paged
    batcher on 4 requests over unquantized pages (:data:`TP_SERVE_F32_PAGES`).
    Per rank: ``generate_spmd`` and that batcher (16 slots, page 16, chunk
    256) at f32, whose tokens must equal the references' under the top-2
    margin rule, and both ranks' bit-identical; then bf16 for the times,
    the batcher over int4 pages: prefill ms, decode ms a step, tokens/s, the
    16-request drain's tokens/s and median tick, a steady tick's wall and
    device-busy ms, its tp collectives with their bytes and ms, peak memory
    and IPC slot bytes. Launches of kernel 1 (22 a generate: the 512-token
    prefill) and kernels 5 and 6 (22 a chunk or tick) counted on the path.
    ``ref`` is :func:`tp_serve_reference`'s and ``spawned`` (ranks, seconds)
    of a spawn shared with other programs (the full run's model-parallel
    tp ranks); None does either here. Returns the launches by kernel, the
    kernels' max errors, their times and rank 0's bf16 batcher figures."""
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig

    t_phase = time.perf_counter()
    ref = ref or tp_serve_reference(tflash, dev, weights)
    errs, times, inputs = ref["errs"], ref["times"], ref["inputs"]
    prompt, prompts, budgets = inputs
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    n_layer = LlamaConfig.tinyllama_1b().n_layer
    ranks, seconds = spawned or spawn_mesh(tp_serve_rank, "tp_serve", 2, weights, inputs)
    single = []  # the f32 model of the margin rule, built only at a divergence

    def mismatches(got, want, prompt_rows):
        near, bad = [], 0
        for i, (a, w) in enumerate(zip(got, want)):
            diff = [j for j, (u, v) in enumerate(zip(a, w)) if u != v]
            if diff:
                if not single:
                    single.append(Llama(LlamaConfig.tinyllama_1b(), device=dev))
                    single[0].load_state_dict(torch.load(weights, mmap=True))
                m = first_divergence_margin(single[0], np.asarray(prompt_rows[i], np.int64), w,
                                            diff[0])
                near.append({"row": i, "step": diff[0], "margin": m})
                bad += m >= MARGIN
        return near, bad

    r0 = ranks[0]
    ref_tokens, ref_drain = ref["tokens"], ref["drain"]
    gen_near, gen_bad = mismatches(r0["f32_tokens"], ref_tokens, prompt)
    drain_near, drain_bad = mismatches(r0["f32_batcher"]["tokens"], ref_drain, prompts)
    del single
    torch.cuda.empty_cache()
    identical = all(r[key] == r0[key] for r in ranks for key in (
        "f32_tokens", "f32_prefill_logits_sha")) and all(
        r["f32_batcher"]["tokens"] == r0["f32_batcher"]["tokens"]
        and r["bf16_generate"]["tokens"] == r0["bf16_generate"]["tokens"]
        and r["bf16_batcher"]["tokens"] == r0["bf16_batcher"]["tokens"] for r in ranks)
    row = {"phase": "tp_serve", "model": "tinyllama-1.1b", "tp": 2,
           "local_heads": r0["local_heads"], "generate": {
               "batch": TP_SERVE_B, "prompt": TP_SERVE_PROMPT, "new_tokens": TP_SERVE_NEW},
           "batcher": {**kw, "requests": TP_SERVE_REQUESTS,
                       "f32_requests": TP_SERVE_F32_REQUESTS, "f32_pages": TP_SERVE_F32_PAGES},
           "f32_generate_tokens_equal": r0["f32_tokens"] == ref_tokens,
           "f32_generate_near_ties": gen_near,
           "f32_batcher_tokens_equal": r0["f32_batcher"]["tokens"] == ref_drain,
           "f32_batcher_near_ties": drain_near,
           "ranks_tokens_and_logits_identical": identical, "kernel_max_abs_err": errs,
           "reference_seconds": ref["seconds"], "seconds_with_spawn": seconds,
           "spawn_shared": spawned is not None, "card": card,
           "note": "two ranks time-slice one card: the times are the cost of the tp "
                   "collectives and the host, not a tensor-parallel speed-up",
           "ranks": [{k: v for k, v in r.items() if k not in ("f32_tokens",)}
                     | {"f32_batcher": {k: v for k, v in r["f32_batcher"].items()
                                        if k != "tokens"},
                        "bf16_generate": {k: v for k, v in r["bf16_generate"].items()
                                          if k != "tokens"},
                        "bf16_batcher": {k: v for k, v in r["bf16_batcher"].items()
                                         if k != "tokens"}} for r in ranks],
           "phase_seconds": time.perf_counter() - t_phase}
    emit(row)
    check(identical, "tp_serve: the two ranks' tokens or logits differ")
    check(gen_bad == 0, f"tp_serve: f32 generate_spmd diverges from generate beyond the margin "
                        f"rule: {gen_near}")
    check(drain_bad == 0, f"tp_serve: the f32 tp batcher diverges from the single-device one "
                          f"beyond the margin rule: {drain_near}")
    for r in ranks:
        rk = r["rank"]
        check(r["f32_cache_heads"] == TP_SERVE_KV_HEADS
              and r["f32_batcher"]["pool_heads"] == TP_SERVE_KV_HEADS,
              f"tp_serve rank {rk}: cache/pool heads {r['f32_cache_heads']}, "
              f"{r['f32_batcher']['pool_heads']}")
        check(r["f32_generate_launches"]["flash_fwd"] == n_layer
              and r["bf16_generate"]["launches"]["flash_fwd"] == n_layer,
              f"tp_serve rank {rk}: flash_fwd launches {r['f32_generate_launches']}, "
              f"{r['bf16_generate']['launches']}; expected {n_layer} a generate")
        f32l, bfb = r["f32_batcher"]["launches"], r["bf16_batcher"]
        check(f32l["paged_attn"] > 0 and f32l["paged_attn_pipelined"] == 0,
              f"tp_serve rank {rk}: the f32 drain launched {f32l}")
        check(bfb["launches"] == {"paged_attn": 0, "paged_attn_pipelined": n_layer * (
            bfb["decode_ticks"] + bfb["prefill_chunks"])},
            f"tp_serve rank {rk}: the bf16 drain launched {bfb['launches']}, expected {n_layer} "
            f"x {bfb['decode_ticks'] + bfb['prefill_chunks']} pipelined launches")
        check(bfb["complete"] and bfb["pages_back"] and r["f32_batcher"]["pages_back"]
              and r["steady_tick"]["pages_back"], f"tp_serve rank {rk}: incomplete or leaked")
        st = r["bf16_generate"]["decode_step_collectives"]
        check(st["all_reduce"] == 1 + 2 * n_layer and st["all_gather"] == 1,
              f"tp_serve rank {rk}: a decode step's collectives {st}")
    return ({"flash_fwd": r0["bf16_generate"]["launches"]["flash_fwd"]
             + r0["f32_generate_launches"]["flash_fwd"],
             "paged_attn": r0["f32_batcher"]["launches"]["paged_attn"],
             "paged_attn_pipelined": r0["bf16_batcher"]["launches"]["paged_attn_pipelined"]},
            errs, times, {k: v for k, v in r0["bf16_batcher"].items() if k != "tokens"})


# ---- decode workers over several devices: TinyLlama-1.1B at tp = 2 behind the router ----

FLEET_TP_REQUESTS, FLEET_TP_NEW = 8, 32  # of llama_prompts (seed 2), every budget 32 tokens
FLEET_TP_SLOTS = 4  # a decode worker's slots
FLEET_TP_PREFIX = 256  # a registered prefix heading every other request
FLEET_TP_CHAOS_REQUESTS = 4  # legs (c) and (d): the first 4 of the 8 (the run's time)
FLEET_TP_PINGS = 20  # lockstep round trips timed a worker
FLEET_TP_DIR = os.path.join("build", "fleet_tp")  # the workers' rendezvous and shard files
FLEET_TP_DEVICES = ["cuda:0"] * 4  # two decode workers of two ranks, sharing the card


def fleet_tp_requests():
    """The phase's requests: the first 8 of the Llama serving row's prompts
    (``llama_prompts`` at seed 2), every odd one replaced by a 256-token
    prefix followed by 64–256 of that prompt's tokens."""
    prompts, _, _ = llama_prompts(np.random.default_rng(2), PAGED_REQUESTS)
    rng = np.random.default_rng(23)
    prefix = rng.integers(0, 32000, FLEET_TP_PREFIX).astype(np.int64)
    reqs = [np.concatenate([prefix, np.asarray(p[:int(rng.integers(64, 257))], np.int64)])
            if i % 2 else np.asarray(p, np.int64)
            for i, p in enumerate(prompts[:FLEET_TP_REQUESTS])]
    return prefix, reqs


def fleet_tp_kernel_time(dev):
    """Kernels 5 and 6 at a tp = 2 decode rank's tick (4 slots, 16 query
    heads over 2 kv heads, hd 64, depths 1-767): f32 q over fp pages (the
    f32 legs) and bf16 q over int4 pages (the timed leg), each against the
    plain version, then timed by profiler device time beside the bound and
    the plain version. Returns the largest error and the times."""
    from dsml_tpu_torch.ops import paged_attention as tpa

    rng = np.random.default_rng(24)
    gen = torch.Generator(device=dev).manual_seed(24)
    timing, errs = {}, []
    hq, hkv = LLAMA_HEADS // 2, LLAMA_KV_HEADS // 2
    for name, q_dtype, mode in (("tp_rank_f32_fp", torch.float32, None),
                                ("tp_rank_bf16_int4", torch.bfloat16, "int4")):
        positions = (rng.integers(1, 768, FLEET_TP_SLOTS) - 1)[:, None]
        args = paged_case(dev, rng, gen, FLEET_TP_SLOTS, hq, hkv, D, 2048 // PAGE, positions,
                          q_dtype, mode)
        errs.append(paged_check(dev, tpa, name, args, mode, q_dtype, positions))
        call = (*args, mode)
        per_kernel = paged_kernel_ms(tpa, call)
        bound_ms, bound_by = paged_bound_ms(*args)
        plain_ms = cuda_ms(lambda: tpa._paged_attention_reference(*call))
        timing[name] = {"shape": [FLEET_TP_SLOTS, hq, 1, D], "hkv": hkv, "q": str(q_dtype)[6:],
                        "codec": mode or "fp",
                        **{k: {"ms": per_kernel[k], "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by, "library_ms": None}
                           for k in ("paged_attn", "paged_attn_pipelined")}}
    emit({"phase": "kernel_time", "path": "D", "kernels": ["paged_attn", "paged_attn_pipelined"],
          **timing, "note": "profiler device time a call; plain_ms CUDA events around one call; "
                            "no PyTorch call reads a page table"})
    return max(errs), timing


def _rank_sum(workers, kernel):
    return sum(r.get(kernel, 0) for w in workers for r in w.rank_launches())


def _margin_mismatches(model, prompts, got, want):
    """Requests whose tokens differ from ``want`` at a step whose top-2
    margin (``model``'s plain prefill) is at least :data:`MARGIN`, and the
    near ties."""
    near, bad = [], 0
    for i, (a, w) in enumerate(zip(got, want)):
        diff = [j for j, (x, y) in enumerate(zip(a, w)) if x != y]
        if len(a) != len(w):
            bad += 1
        if diff:
            m = first_divergence_margin(model, prompts[i], w, diff[0])
            near.append({"request": i, "step": diff[0], "margin": m})
            bad += m >= MARGIN
    return near, bad


def _obs_roles(workers):
    """{(replica, role): tokens} of serving_tokens_total in each decode
    rank's own registry (gathered back through the pipes)."""
    out = {}
    for w in workers:
        for r, snap in enumerate(w.obs_snapshots()):
            for m in snap["metrics"]:
                if m["name"] == "serving_tokens_total":
                    key = f"{m['labels'].get('replica')}/{m['labels'].get('role')}/rank{r}"
                    out[key] = out.get(key, 0) + m["value"]
    return out


def phase_fleet_tp(dev, card, weights, tp_serve_bf16=None, kernels=None):
    """TinyLlama-1.1B (full width and depth, the bf16-rounded weights file
    of tp_serve) served by decode workers that span two devices each:
    ``build_fleet(n_prefill=1, n_decode=2, devices=["cuda:0"] * 4)``, two
    tp = 2 ``MeshDecodeWorker``s of two rank processes each sharing the
    card, the prefill worker in this process. (a) f32 over fp pages (the
    single-buffer kernel 5), obs on: 8 requests at 32 tokens with a
    registered 256-token prefix, greedy tokens against a single-device
    paged batcher on the same card under the top-2 margin rule; every
    decode rank's launches n_layer a tick, its metrics labelled by its
    worker. (b) The same processes rebuilt bf16 over int4 pages (kernel
    6): tokens/s, TTFT p50, decode gaps p99, the lockstep round trip, the
    launches by role. (c) f32 again through ``run_chaos_serving_fleet``
    with a decode worker killed mid-drain: requeued, its processes gone,
    tokens equal (a)'s. (d) ``DecodeFleet(devices=["cuda:0"] * 4,
    devices_per_replica=2)`` of tp = 2 replicas through
    ``run_chaos_serving`` with one killed: tokens equal one replica's
    alone. At the end no rank process is alive. ``kernels`` is
    :func:`fleet_tp_kernel_time`'s result (the full run takes it with the
    other kernel timings, early), None times them here. Returns the decode
    ranks' launches of the D: path (legs a and b) and this process's
    prefill launches, the kernels' error and times."""
    from dsml_tpu_torch import obs
    from dsml_tpu_torch.models.llama import Llama, LlamaConfig
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.runtime import chaos
    from dsml_tpu_torch.runtime.controller import DecodeFleet
    from dsml_tpu_torch.serving import (ContinuousBatcher, MeshDecodeWorker, PrefillWorker,
                                        Router, build_fleet)

    t_phase = time.perf_counter()
    kernel_err, kernel_times = kernels or fleet_tp_kernel_time(dev)
    prefix, reqs = fleet_tp_requests()
    n_layer = LlamaConfig.tinyllama_1b().n_layer
    os.makedirs(FLEET_TP_DIR, exist_ok=True)
    f32_kw = dict(paged_kv=TP_SERVE_F32_PAGES, page_size=PAGE, n_slots=FLEET_TP_SLOTS)
    bf16_kw = dict(paged_kv="int4", page_size=PAGE, n_slots=FLEET_TP_SLOTS)
    model32 = Llama(LlamaConfig.tinyllama_1b(), device=dev)
    model32.load_state_dict(torch.load(weights, mmap=True))
    row = {"phase": "fleet_tp", "model": "tinyllama-1.1b", "tp": 2, "n_prefill": 1, "n_decode": 2,
           "devices": FLEET_TP_DEVICES, "n_slots": FLEET_TP_SLOTS, "requests": FLEET_TP_REQUESTS,
           "new_tokens_each": FLEET_TP_NEW, "prefix": FLEET_TP_PREFIX, "card": card,
           "kernel_times": kernel_times, "kernel_max_abs_err": kernel_err}
    pids, everyone, starter = set(), [], None
    launches = {"decode": {"paged_attn": 0, "paged_attn_pipelined": 0},
                "prefill": {"paged_attn": 0, "paged_attn_pipelined": 0}}

    def counted(prefill_workers, by_role):
        count_launches_by_role(prefill_workers, "prefill", tpa, by_role)

    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
    try:
        # the single-device reference on the same card
        t0 = time.perf_counter()
        ref_srv = ContinuousBatcher(model32, prefill_chunk=PAGED_CHUNK, **f32_kw)
        ref_srv.register_prefix(prefix)
        ref_tokens, _, _ = drain(ref_srv, reqs, [FLEET_TP_NEW] * len(reqs))
        del ref_srv
        row["reference_s"] = time.perf_counter() - t0

        # (a) identity: f32 over fp pages, obs on
        obs.disable()
        obs.get_registry().reset()
        obs.enable(forensics=False)
        t0 = time.perf_counter()
        router = build_fleet(model32, n_prefill=1, n_decode=2, devices=FLEET_TP_DEVICES,
                             prefill_chunk=PAGED_CHUNK, workdir=FLEET_TP_DIR, **f32_kw)
        workers = list(router.decode_workers)
        everyone += workers
        pids |= {p for w in workers for p in w.pids}
        row["spawn_and_build_s"] = time.perf_counter() - t0
        router.register_prefix(prefix)
        for w in workers:
            w.reset_launches()
        by_role = {"prefill": [0, 0], "decode": [0, 0]}
        counted(router.prefill_workers, by_role)
        t0 = time.perf_counter()
        frids = [router.submit(p, FLEET_TP_NEW) for p in reqs]
        out = router.run()
        wall_a = time.perf_counter() - t0
        toks_a = [out[f] for f in frids]
        roles = _obs_roles(workers)
        ticks_a = [r["n_plain_ticks"] for w in workers for r in w.rank_ticks()]
        rank_a = [w.rank_launches() for w in workers]
        near_a, bad_a = _margin_mismatches(model32, reqs, toks_a, ref_tokens)
        launches["decode"]["paged_attn"] += _rank_sum(workers, "paged_attn")
        launches["prefill"]["paged_attn"] += by_role["prefill"][0]
        obs.disable()
        obs.get_registry().reset()
        row["a_identity"] = {
            "dtype": "float32", "pages": TP_SERVE_F32_PAGES, "wall_s": wall_a,
            "tokens_equal_single_device": toks_a == ref_tokens, "near_ties": near_a,
            "mesh_tp": [w.mesh.shape["tp"] for w in workers],
            "pool_heads": [w.pool_heads for w in workers],
            "rank_ticks": ticks_a, "rank_launches": [[{k: r[k] for k in (
                "paged_attn", "paged_attn_pipelined")} for r in ranks] for ranks in rank_a],
            "prefill_launches": by_role["prefill"], "obs_tokens_by_worker": roles}
        check(bad_a == 0, f"fleet_tp (a): the tp = 2 fleet's f32 tokens diverge from one "
                          f"device's beyond the margin rule: {near_a}")
        check(all(w.mesh.shape["tp"] == 2 and w.pool_heads == LLAMA_KV_HEADS // 2
                  for w in workers), f"fleet_tp (a): workers {row['a_identity']}")
        for w in workers:
            for r, (lc, tk) in enumerate(zip(w.rank_launches(), w.rank_ticks())):
                check(lc["paged_attn"] > 0 and lc["paged_attn"] == n_layer * tk["n_plain_ticks"]
                      and lc["paged_attn_pipelined"] == 0,
                      f"fleet_tp (a): decode worker {w.obs_replica} rank {r} launched {lc}, "
                      f"expected {n_layer} x {tk['n_plain_ticks']} ticks on kernel 5")
        check(all(roles.get(f"{i}/decode/rank{r}", 0) > 0 for i in range(2) for r in range(2)),
              f"fleet_tp (a): the decode ranks' own metrics by worker: {roles}")
        del router

        # (b) timed: the same processes rebuilt bf16 over int4 pages
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
        model16 = Llama(dataclasses.replace(LlamaConfig.tinyllama_1b(), dtype="bfloat16"),
                        device=dev)
        model16.load_state_dict(torch.load(weights, mmap=True))
        t0 = time.perf_counter()
        for w in workers:
            w.rebuild(model16, **bf16_kw)
        row["rebuild_bf16_s"] = time.perf_counter() - t0
        router = Router([PrefillWorker(model16, PAGED_CHUNK, paged_kv="int4", page_size=PAGE)],
                        workers)
        for p in reqs[:2]:  # warm-up: the allocator, cuBLAS at these batches
            router.submit(p, 4)
        router.run()
        router.reset_latency_stats()
        router.register_prefix(prefix)
        for w in workers:
            w.reset_launches()
        by_role = {"prefill": [0, 0], "decode": [0, 0]}
        counted(router.prefill_workers, by_role)
        ticks0 = [[r["n_plain_ticks"] for r in w.rank_ticks()] for w in workers]
        step_ms = []
        for w in workers:
            def timed(inner=w.step):
                t = time.perf_counter()
                got = inner()
                step_ms.append((time.perf_counter() - t) * 1e3)
                return got

            w.step = timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frids = [router.submit(p, FLEET_TP_NEW) for p in reqs]
        out = router.run()
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        for w in workers:
            del w.step
        pings = [w.ping() * 1e3 for w in workers for _ in range(FLEET_TP_PINGS)]
        toks_b = [out[f] for f in frids]
        ttft = [s[0] for s in router.latency_samples]
        gaps = router.decode_gaps()
        n_tok = sum(len(t) for t in toks_b)
        launches["decode"]["paged_attn_pipelined"] += _rank_sum(workers, "paged_attn_pipelined")
        launches["prefill"]["paged_attn_pipelined"] += by_role["prefill"][1]
        ticks_b = [[r["n_plain_ticks"] - t0_ for r, t0_ in zip(w.rank_ticks(), t0s)]
                   for w, t0s in zip(workers, ticks0)]
        row["b_timed"] = {
            "dtype": "bfloat16", "pages": "int4", "wall_s": wall_b, "new_tokens": n_tok,
            "tokens_per_s": n_tok / wall_b,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
            "decode_gap_p50_s": float(np.percentile(gaps, 50)) if gaps else None,
            "decode_gap_p99_s": float(np.percentile(gaps, 99)) if gaps else None,
            "decode_step_ms_p50": float(np.percentile(step_ms, 50)),
            "lockstep_round_trip_ms_p50": float(np.percentile(pings, 50)),
            "lockstep_round_trip_ms_p99": float(np.percentile(pings, 99)),
            "rank_ticks": ticks_b,
            "launches_by_role": {
                "prefill": {"paged_attn": by_role["prefill"][0],
                            "paged_attn_pipelined": by_role["prefill"][1]},
                "decode_ranks": [[{k: r[k] for k in ("paged_attn", "paged_attn_pipelined")}
                                  for r in w.rank_launches()] for w in workers]},
            "tp_serve_one_batcher": tp_serve_bf16,
            "note": "four rank processes and this one share one card: the cost of the lockstep "
                    "and the tp collectives, not a tensor-parallel speed-up"}
        check(all(len(t) == FLEET_TP_NEW for t in toks_b),
              "fleet_tp (b): a request did not complete its budget")
        check(by_role["prefill"][0] == 0 and by_role["prefill"][1] > 0,
              f"fleet_tp (b): the prefill worker launched {by_role['prefill']}")
        for w, tks in zip(workers, ticks_b):
            for r, (lc, tk) in enumerate(zip(w.rank_launches(), tks)):
                check(lc["paged_attn_pipelined"] > 0 and lc["paged_attn"] == 0
                      and lc["paged_attn_pipelined"] == n_layer * tk,
                      f"fleet_tp (b): decode worker {w.obs_replica} rank {r} launched {lc}, "
                      f"expected {n_layer} x {tk} ticks on kernel 6")
        del router, model16
        torch.cuda.empty_cache()

        # (c) chaos: f32 again, a decode worker killed mid-drain
        os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
        d_kw = dict(prefill_chunk=PAGED_CHUNK, **f32_kw)
        # (d)'s second replica starts now, beside (c) and (d)'s reference
        spare = {}

        def start_spare():
            try:
                spare["worker"] = MeshDecodeWorker(model32, FLEET_TP_DEVICES[:2],
                                                   workdir=FLEET_TP_DIR, **d_kw)
            except BaseException as e:  # noqa: BLE001 — raised in this thread by make_replica
                spare["error"] = e

        starter = threading.Thread(target=start_spare, name="fleet_tp_spare")
        starter.start()
        for w in workers:
            w.rebuild(model32, **f32_kw)
        router = Router([PrefillWorker(model32, PAGED_CHUNK, paged_kv=TP_SERVE_F32_PAGES,
                                       page_size=PAGE)], workers)
        router.register_prefix(prefix)
        victim = workers[-1]

        class WhenBusy:  # the kill lands once the victim decodes
            fired = None

            def get(self, tick):
                if self.fired is not None or not victim.n_active:
                    return None
                self.fired = tick
                return ("decode", None)

        kill = WhenBusy()
        sub = slice(0, FLEET_TP_CHAOS_REQUESTS)
        t0 = time.perf_counter()
        rep = chaos.run_chaos_serving_fleet(router, reqs[sub], FLEET_TP_NEW, kill)
        toks_c = [rep["results"][f] for f in sorted(rep["results"])]
        gone = [p for p in victim.pids if _pid_alive(p)]
        row["c_chaos"] = {"killed_at_tick": kill.fired, "wall_s": time.perf_counter() - t0,
                          **{k: v for k, v in rep.items() if k != "results"},
                          "tokens_equal_a": toks_c == toks_a[sub], "victim_pids_alive": gone}
        check(kill.fired is not None and rep["requeued_decode"] >= 1 and not gone
              and not victim.alive, f"fleet_tp (c): {row['c_chaos']}")
        check(toks_c == toks_a[sub], "fleet_tp (c): the f32 tokens after the kill differ from "
                                     "leg (a)'s")
        del router

        # (d) a DecodeFleet of tp = 2 replicas, one killed
        survivor = workers[0]
        t0 = time.perf_counter()
        survivor.rebuild(model32, **d_kw)
        want_d, _, _ = drain(survivor, reqs[sub], [FLEET_TP_NEW] * FLEET_TP_CHAOS_REQUESTS)
        made = []

        def make_replica(span):
            if made:  # the spare, started during (c)
                starter.join()
                if "error" in spare:
                    raise spare["error"]
                w = spare["worker"]
            else:
                w = survivor.rebuild(model32, **d_kw)
            made.append(w)
            pids.update(w.pids)
            return w

        fleet = DecodeFleet(make_replica, min_replicas=2, max_replicas=2,
                            scale_up_queue_depth=1 << 30, devices=FLEET_TP_DEVICES,
                            devices_per_replica=2)
        everyone += made
        rep_d = chaos.run_chaos_serving(fleet, reqs[sub], FLEET_TP_NEW, {3: None})
        toks_d = [rep_d["results"][f] for f in sorted(rep_d["results"])]
        killed = made[-1]
        requeued = [e.get("requeued", 0) for e in fleet.scale_events if e["reason"] == "killed"]
        row["d_decode_fleet"] = {
            "replicas": len(made), "ticks": rep_d["ticks"], "requeued": requeued,
            "tokens_equal_one_replica": toks_d == want_d,
            "tokens_equal_a": toks_d == toks_a[sub], "killed_pids_alive": [
                p for p in killed.pids if _pid_alive(p)],
            "pool_devices_after": len(fleet._device_pool), "wall_s": time.perf_counter() - t0}
        check(toks_d == want_d and all(len(t) == FLEET_TP_NEW for t in toks_d),
              f"fleet_tp (d): tokens lost or changed: {row['d_decode_fleet']}")
        check(sum(requeued) >= 1 and not killed.alive and not row["d_decode_fleet"][
            "killed_pids_alive"] and len(fleet._device_pool) == 2,
            f"fleet_tp (d): {row['d_decode_fleet']}")
    finally:
        os.environ.pop("DSML_PAGED_ATTN_PIPELINE", None)
        obs.disable()
        obs.get_registry().reset()
        if starter is not None:
            starter.join()
            everyone.append(spare.get("worker"))
        for w in everyone:
            if w is not None:
                pids.update(w.pids)
                w.close()
        shutil.rmtree(FLEET_TP_DIR, ignore_errors=True)
    alive = sorted(p for p in pids if _pid_alive(p))
    row.update({"rank_processes": len(pids), "rank_processes_alive_after": alive,
                "phase_seconds": time.perf_counter() - t_phase})
    emit(row)
    check(not alive, f"fleet_tp: rank processes still alive after the phase: {alive}")
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    return launches, kernel_err, kernel_times


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


# the train_gpt2 entry points run as processes, beside each other and the Llama
# ones: {name: (phase line, arguments, environment)}
MP_CLI_CKPT = os.path.join("build", "mp_cli_ckpt")  # the pp = 2 run's checkpoint directory
# the pp = 2 run first: its one-step resume starts as soon as it ends
TRAIN_CLI_RUNS = {
    "small_pp2_1f1b": ("mp_cli", ["--model", "small", "--pp", "2", "--schedule", "1f1b",
                                  "--n_micro", "4", "--attn", "flash", "--batch_size", "8",
                                  "--eval_every", "3", "--checkpoint_dir", MP_CLI_CKPT], {}),
    "cp2": ("cp_cli", ["--model", "small", "--cp", "2", "--batch_size", "8"],
            {"DSML_RING_FUSED": "dma"}),
    "dp2": ("dp_cli", ["--model", "small", "--dp", "2", "--attn", "flash", "--batch_size", "8"],
            {}),
    "tinyllama_tp2": ("mp_cli", ["--family", "llama", "--model", "tinyllama_1b", "--tp", "2",
                                 "--attn", "flash", "--batch_size", "2"], {}),
}
TRAIN_CLI_RESUMED = {"small_pp2_1f1b"}  # runs followed by a one-step resume from their checkpoint
# runs the full run starts beside the two-rank programs with the Llama entry
# points (their numpy draws are host work); the others start after them
TRAIN_CLI_EARLY = ["tinyllama_tp2"]
RESUME_MARK = "chip_smoke: resuming"


def train_cli_start(names):
    """Start the ``train_gpt2`` runs ``names`` of :data:`TRAIN_CLI_RUNS` on
    the card (bf16, 3 steps each) as processes: ``--model small --pp 2
    --schedule 1f1b`` with an eval and a checkpoint at step 3, then (in the
    same shell, as soon as it ends) its one-step resume; ``--cp 2`` on
    GPT-2-small under DSML_RING_FUSED=dma, ``--dp 2`` on GPT-2-small with
    flash attention and ``--family llama --model tinyllama_1b --tp 2``.
    Waited for by :func:`phase_train_cli_runs`."""
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(os.path.join(root, MP_CLI_CKPT), ignore_errors=True)  # no earlier run's

    def command(name, steps):
        return shlex.join([sys.executable, "-m", "dsml_tpu_torch.cli.train_gpt2",
                           *TRAIN_CLI_RUNS[name][1], "--dtype", "bfloat16", "--steps", str(steps),
                           "--grad_accum", "1", "--log_every", "1", "--warmup_steps", "1"])

    procs = {}
    for name in names:
        cmd = command(name, 3)
        if name in TRAIN_CLI_RESUMED:
            cmd += f" && echo {shlex.quote(RESUME_MARK)} && {command(name, 1)}"
        procs[name] = subprocess.Popen(
            ["bash", "-c", cmd], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, **ONE_THREAD, **TRAIN_CLI_RUNS[name][2]})
    return procs


def _cli_row(rc, out):
    losses = [float(m) for m in re.findall(r"step \d+: loss = ([-+0-9.eEnaif]+)", out)]
    evals = [float(m) for m in re.findall(r"step \d+: eval loss = ([-+0-9.eEnaif]+)", out)]
    return {"rc": rc, "losses": losses, "eval_losses": evals,
            "resumed": "resumed from checkpoint at step 3" in out,
            "last": [line for line in out.splitlines() if "dsml." in line][-3:]
            if rc == 0 else out[-2000:]}


def phase_train_cli_runs(procs):
    """The ``train_gpt2`` runs of :func:`train_cli_start`: each exits 0 and
    logs 3 steps of finite loss (the pp = 2 run an eval loss at step 3 too);
    the resume of a run of :data:`TRAIN_CLI_RESUMED` logs "resumed from
    checkpoint at step 3" and one finite loss; one line per phase name
    (cp_cli, dp_cli, mp_cli)."""
    t_phase = time.perf_counter()
    rows = {}
    try:
        for name, p in procs.items():
            out, _ = p.communicate(timeout=600)
            first, marked, resumed = out.partition(RESUME_MARK)
            rows[name] = _cli_row(p.returncode if not marked else 0, first)
            if name in TRAIN_CLI_RESUMED:
                rows[f"{name}_resumed"] = _cli_row(p.returncode if marked else None, resumed)
    finally:
        shutil.rmtree(os.path.join(os.path.dirname(os.path.abspath(__file__)), MP_CLI_CKPT),
                      ignore_errors=True)

    def phase_of(name):
        return TRAIN_CLI_RUNS[name.removesuffix("_resumed")][0]

    for phase in dict.fromkeys(phase_of(name) for name in rows):
        emit({"phase": phase, "entry": "python -m dsml_tpu_torch.cli.train_gpt2",
              "runs": {n: r for n, r in rows.items() if phase_of(n) == phase},
              "waited_seconds": time.perf_counter() - t_phase})
    for name, row in rows.items():
        steps = 1 if name.endswith("_resumed") else 3
        check(row["rc"] == 0 and len(row["losses"]) == steps and all(np.isfinite(row["losses"])),
              f"train_gpt2 {name}: {row}")
        if name in TRAIN_CLI_RESUMED:
            check(len(row["eval_losses"]) == 1 and np.isfinite(row["eval_losses"][0]),
                  f"train_gpt2 {name}: no finite eval loss at step 3: {row}")
            check(rows[f"{name}_resumed"]["resumed"],
                  f"train_gpt2 {name}: the one-step run did not resume from step 3: "
                  f"{rows[name + '_resumed']}")


# Mixtral-8x7B at its full widths, depth cut for one card and the run's time
MOE_LAYERS = 2  # of 32: 2.225B parameters (4.45 GB bf16); 32 layers are 31.7B (63 GB bf16)
MOE_HEADS, MOE_KV_HEADS, MOE_HD = 32, 8, 128
MOE_TRAIN_WARMUP, MOE_TRAIN_STEPS = 2, 4
MOE_F32_B, MOE_F32_S = 1, 1024  # the f32 gradient checks' batch
MOE_EP_WARMUP, MOE_EP_STEPS = 2, 3
MOE_REQUESTS, MOE_F32_REQUESTS = 16, 4


def moe_config(**replace):
    """``LlamaConfig.mixtral_8x7b()`` at depth :data:`MOE_LAYERS`, with
    ``replace`` applied."""
    from dsml_tpu_torch.models.llama import LlamaConfig

    return dataclasses.replace(LlamaConfig.mixtral_8x7b(), **{"n_layer": MOE_LAYERS, **replace})


def moe_weights_path():
    from dsml_tpu_torch.ops import _build

    return str(_build.BUILD_DIR.parent / "moe" / "mixtral_2l_bf16.pt")


def moe_weights_child(path):
    """The cut Mixtral's weights from seed 0 (``Llama.init``: the JAX init's
    numpy draws, rounded to bf16), saved to ``path`` (its own process, run
    beside the Llama entry points)."""
    from dsml_tpu_torch.models.llama import Llama

    t0 = time.perf_counter()
    model = Llama(moe_config(dtype="bfloat16"), device="cpu").init(0)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(model.state_dict(), path + ".tmp")
    os.replace(path + ".tmp", path)
    print(json.dumps({"seconds": time.perf_counter() - t0, "params": model.n_params()}), flush=True)


def moe_weights_start():
    """Start :func:`moe_weights_child` as a process (the one numpy draw of
    the phase: its ranks map the file it writes)."""
    path = moe_weights_path()
    if os.path.exists(path):
        os.remove(path)
    root = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen([sys.executable, "-c",
                             f"import chip_smoke; chip_smoke.moe_weights_child({path!r})"],
                            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, **ONE_THREAD})


def moe_weights_wait(proc):
    """Wait for :func:`moe_weights_start`'s process: {"seconds", "params",
    "waited_s"} of its draw."""
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    check(proc.returncode == 0, f"the Mixtral weights process failed:\n{out[-3000:]}")
    return {**json.loads(out.strip().splitlines()[-1]), "waited_s": time.perf_counter() - t0}


def moe_model(dev, weights, **replace):
    """The cut Mixtral on ``dev`` holding ``weights`` (cast to the config's type)."""
    from dsml_tpu_torch.models.llama import Llama

    model = Llama(moe_config(**replace), device=dev)
    model.load_full(weights)
    return model


def moe_train_flops(cfg, tokens, seq):
    """Active matmul FLOPs of one train step: ``transformer_train_flops``
    with each token through its top-k experts' two GELU matmuls, plus the
    gate (the capacity's padding rows not counted)."""
    from dsml_tpu_torch.models.common import transformer_train_flops

    active = dataclasses.replace(cfg, d_ff=cfg.d_ff * cfg.expert_top_k)
    return (transformer_train_flops(active, tokens, seq)
            + 3 * 2 * tokens * cfg.d_model * cfg.n_experts * cfg.n_layer)


def _grad_err(got, want, names):
    """max over ``names`` of |got − want| / max |want| (the dp_slice rule)."""
    worst = 0.0
    for n in names:
        scale = float(want[n].abs().max()) or 1.0
        worst = max(worst, float((got[n].float() - want[n].float()).abs().max()) / scale)
    return worst


def moe_ep_rank(rank, tmp, weights):
    rank_main(lambda r, t, res, stage: moe_ep_run(r, t, res, stage, weights), "ep", rank, tmp)


def moe_ep_run(rank, tmp, res, stage, weights):
    """The cut Mixtral bf16 at ep = tp = 2 (one rank): 4 of the 8 experts a
    layer, 16 of the 32 heads, half the vocabulary."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dsml_tpu_torch.models.llama import Llama
    from dsml_tpu_torch.ops import collectives as tcoll
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.parallel import tp as ttp
    from dsml_tpu_torch.parallel.hybrid import make_hybrid_train_step
    from dsml_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(tp=2), rank, 2, os.path.join(tmp, "rendezvous"))
    dev, group = mesh.device, mesh.group("tp")
    res["device"] = str(dev)
    stage("weights")
    full = torch.load(weights, mmap=True)
    cfg = moe_config(dtype="bfloat16", xent_chunk=8192)
    model = Llama(cfg, device=dev, tp_group=group)
    model.load_full(full)
    res["local_experts"] = cfg.n_experts // group.size
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)))
    y = torch.roll(x, -1, 1)
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    step = make_hybrid_train_step(model, opt, mesh, attn_impl="flash")
    stage("ep steps")
    losses = [step(x, y) for _ in range(MOE_EP_WARMUP)]
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(tflash)
    ttp.reset_stats()
    tcoll.reset_stats()
    t0 = time.perf_counter()
    losses += [step(x, y) for _ in range(MOE_EP_STEPS)]
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t0) * 1e3 / MOE_EP_STEPS
    res["launches"] = train_counts(tflash)
    res["all_to_all_per_step"] = tcoll.STATS["all_to_all"] / MOE_EP_STEPS
    res["all_to_all_bytes_per_step"] = tcoll.STATS["all_to_all_bytes"] / MOE_EP_STEPS
    res["tp_all_reduces_per_step"] = ttp.STATS["all_reduce"] / MOE_EP_STEPS
    res["tp_all_reduce_bytes_per_step"] = ttp.STATS["bytes"] / MOE_EP_STEPS
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    res["ipc_slot_bytes"] = mesh.slot_bytes()
    res["losses"] = [float(v) for v in losses]
    specs = model.param_specs()
    res["replicated_sha"] = _param_sha(
        [p for n, p in model.named_parameters() if "tp" not in specs[n]])
    stage("all_to_all alone")
    t = LLAMA_TRAIN_B * LLAMA_TRAIN_S
    capacity = int(cfg.capacity_factor * t * cfg.expert_top_k / cfg.n_experts) + 1
    dispatch = torch.randn(cfg.n_experts, capacity, cfg.d_model, device=dev).to(torch.bfloat16)
    back = torch.randn(2, t // 2, cfg.d_model, device=dev).to(torch.bfloat16)
    res["dispatch_shape"] = list(dispatch.shape)
    res["dispatch_ms"] = statistics.median(
        collective_times(lambda: tcoll.all_to_all(dispatch, group, 0, 1), group.pg))
    res["return_ms"] = statistics.median(
        collective_times(lambda: tcoll.all_to_all(back, group, 0, 0), group.pg))
    del model, opt, step, dispatch, back
    torch.cuda.empty_cache()
    stage("f32 gradient check")
    cfg32 = moe_config(n_layer=1)
    layer0 = {k: v for k, v in full.items() if not k.startswith("layers.") or
              k.startswith("layers.0.")}
    shard = Llama(cfg32, device=dev, tp_group=group).load_full(layer0)
    ref = Llama(cfg32, device=dev).load_full(layer0)
    xd, yd = x[:MOE_F32_B, :MOE_F32_S].to(dev), y[:MOE_F32_B, :MOE_F32_S].to(dev)
    loss = shard.loss(xd, yd, attn_impl="flash")
    loss.backward()
    ref_loss = ref.loss(xd, yd, attn_impl="xla")
    ref_loss.backward()
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    coords, sizes = {"tp": group.rank}, {"tp": group.size}
    experts = [n for n, _ in shard.named_parameters() if ".moe." in n]
    res["f32"] = {"layers": cfg32.n_layer, "batch": [MOE_F32_B, MOE_F32_S],
                  "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
                  "expert_grads_max_err_over_max_abs": _shard_grad_err(shard, ref, coords, sizes,
                                                                       experts),
                  "grads_max_err_over_max_abs": _shard_grad_err(shard, ref, coords, sizes)}
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def phase_moe(tflash, dev, card, draw, kernels):
    """Mixtral-8x7B (``LlamaConfig.mixtral_8x7b``) at its full widths — d
    4096, 32 query / 8 kv heads (head_dim 128), d_ff 14336, 8 experts top-2,
    capacity 1.25, vocab 32000 — at depth 2 of 32, weights from seed 0 (one
    numpy draw, :func:`moe_weights_start`'s process, whose ``draw`` record
    this phase reports, to a bf16 file every part maps):

    (a) ``kernels``: :func:`family_kernels` at its shapes — kernels 1–3 at
    [64, 2048, 128] bf16 and kernels 5–6 at its serving shapes (8 kv heads
    under 32, hd 128) against their plain versions, with times (run beside
    the other kernel phases: late in a full run the profiler lost events);
    (b) single-device bf16 training at 2 × 2048 (flash, the chunked
    loss through lm_head, AdamW(3e-4, 0.01)): 2 launches of kernels 1–3 a
    step, step ms, tokens/s, active MFU, peak memory, a first loss near ln
    32000 that falls, a traced step; an f32 check at 1 × 1024: the expert
    leaves' and wq's gradients through the kernels against the plain path;
    (c) ep = 2: two spawned ranks (tp = 2: 4 experts each) through
    ``make_hybrid_train_step``: the step-0 loss against (b)'s, 4
    all_to_all calls a MoE layer a step, their bytes and time alone,
    identical replicated leaves, step ms, peak memory, IPC slot bytes, and
    f32 gradients of a 1-layer cut against one device; (d) serving:
    ``ContinuousBatcher(paged_kv="int4")``, 16 slots, page 16, chunk 256,
    16 greedy requests of 64–768 tokens (the GPT-2 row's mix) through the
    pipelined kernel: tokens/s, TTFT, median tick, the idle share of a
    steady tick; then 4 requests at f32 through the single-buffer kernel
    against the gather path under the 1e-3 top-2 margin rule. The ranks
    time-slice the card: (c) measures the exchange's cost, not a speed-up.
    Returns the launches of kernels 1–3 (the bf16 train steps) and 5–6
    (the drains)."""
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.serving import ContinuousBatcher

    t_phase = time.perf_counter()
    cut = "depth 32 -> 2 layers: 2.225B parameters at full widths (32 layers are 31.7B)"
    weights = moe_weights_path()
    full = torch.load(weights, mmap=True)
    emit({"phase": "moe_weights", **draw, "bytes": os.path.getsize(weights), "cut": cut,
          "note": "the numpy draw of Llama.init(0), bf16, in its own process (the full run "
                  "starts it with the kernels' build; waited_s: how long it was waited for)"})

    # (b) single-device training, the main path counted
    model = moe_model(dev, full, dtype="bfloat16", xent_chunk=8192)
    cfg = model.config
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, weight_decay=0.01)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S)),
                        device=dev)
    y = torch.roll(x, -1, 1)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = model.loss(x, y, attn_impl="flash")
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step() for _ in range(MOE_TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(tflash)
    t0 = time.perf_counter()
    losses += [step() for _ in range(MOE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / MOE_TRAIN_STEPS
    train_launches = train_counts(tflash)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).float().tolist()
    tokens = LLAMA_TRAIN_B * LLAMA_TRAIN_S
    flops = moe_train_flops(cfg, tokens, LLAMA_TRAIN_S)
    capacity = int(cfg.capacity_factor * tokens * cfg.expert_top_k / cfg.n_experts) + 1
    # at d 4096 the initial logits are not near zero: an rms-normalised h against
    # lm_head rows of std 0.02 gives logits of variance 0.02²·d, and a uniform
    # guess's ln V rises by half of it (E[logsumexp] of Gaussian logits)
    loss_at_init = LLAMA_LOSS_AT_INIT + 0.02 ** 2 * cfg.d_model / 2
    emit({"phase": "moe_train", "model": "mixtral-8x7b", "cut": cut, "params": model.n_params(),
          "dtype": "bfloat16", "batch": LLAMA_TRAIN_B, "seq": LLAMA_TRAIN_S, "attn_impl": "flash",
          "xent_chunk": cfg.xent_chunk, "optimizer": "AdamW(3e-4, weight_decay=0.01)",
          "experts": cfg.n_experts, "top_k": cfg.expert_top_k, "capacity": capacity,
          "steps": MOE_TRAIN_STEPS, "launches": train_launches, "step_ms": step_ms,
          "tokens_per_s": tokens * 1e3 / step_ms, "active_flops_per_step": flops,
          "mfu_active": flops / (step_ms / 1e3) / PEAK_FLOPS[torch.bfloat16],
          "peak_memory_gb": peak, "losses": losses, "loss_at_init": loss_at_init,
          "card": card})
    want = cfg.n_layer * MOE_TRAIN_STEPS
    check(bf16_step_counts_ok(train_launches, want, want),
          f"Mixtral train steps launched {train_launches}, expected {want} of the forward and of "
          f"each tensor-core backward kernel and no FMA backward")
    check(all(np.isfinite(losses)) and abs(losses[0] - loss_at_init) < 0.5
          and losses[-1] < losses[0],
          f"Mixtral train loss not finite, near {loss_at_init} at first and falling: {losses}")
    phase_train_trace(step, label="moe_train_step")
    single_loss = losses[0]
    del model, opt
    torch.cuda.empty_cache()

    # the f32 gradient check: the kernels against the plain path, one device
    model = moe_model(dev, full)
    xs, ys = x[:MOE_F32_B, :MOE_F32_S], y[:MOE_F32_B, :MOE_F32_S]
    names = [n for n, _ in model.named_parameters() if ".moe." in n or n.endswith("attn.wq")]
    params = dict(model.named_parameters())
    model.loss(xs, ys, attn_impl="flash").backward()
    kernel_grads = {n: params[n].grad.clone() for n in names}
    model.zero_grad(set_to_none=True)
    model.loss(xs, ys, attn_impl="xla").backward()
    f32_err = _grad_err(kernel_grads, {n: params[n].grad for n in names}, names)
    emit({"phase": "moe_f32_grads", "batch": [MOE_F32_B, MOE_F32_S], "leaves": len(names),
          "max_err_over_max_abs": f32_err, "tol": TOL_TRAIN_GRADS})
    check(f32_err <= TOL_TRAIN_GRADS,
          f"Mixtral f32 expert and wq gradients through the kernels: {f32_err}")
    del model, params, kernel_grads
    torch.cuda.empty_cache()

    # (c) ep = 2
    ranks, ep_seconds = spawn_mesh(moe_ep_rank, "ep", 2, weights)
    t_a2a = sum(r["dispatch_ms"] + r["return_ms"] for r in ranks) / len(ranks)
    emit({"phase": "moe_ep", "model": "mixtral-8x7b", "cut": cut, "ep": 2, "dtype": "bfloat16",
          "batch": [LLAMA_TRAIN_B, LLAMA_TRAIN_S], "steps": MOE_EP_STEPS, "warmup": MOE_EP_WARMUP,
          "single_device_step0_loss": single_loss, "seconds_with_spawn": ep_seconds,
          "all_to_all_ms_per_step_est": 2 * cfg.n_layer * t_a2a,
          "exchange_share_est": 2 * cfg.n_layer * t_a2a / (sum(r["step_ms"] for r in ranks) / 2),
          "card": card, "ranks": ranks,
          "note": "ranks time-slice one card: the step is the exchange's cost, not a speed-up; "
                  "the all_to_all share estimates 2 dispatches and 2 returns a layer at the "
                  "times measured alone"})
    for r in ranks:
        rk = r["rank"]
        check(bf16_step_counts_ok(r["launches"], cfg.n_layer * MOE_EP_STEPS,
                                  cfg.n_layer * MOE_EP_STEPS),
              f"ep rank {rk}: flash launches {r['launches']}")
        check(r["all_to_all_per_step"] == 4 * cfg.n_layer,
              f"ep rank {rk}: {r['all_to_all_per_step']} all_to_all a step, expected "
              f"{4 * cfg.n_layer} (2 a MoE layer forward, 2 backward): the a2a branch")
        check(abs(r["losses"][0] - single_loss) <= MP_BF16_LOSS_RTOL * abs(single_loss),
              f"ep rank {rk}: step-0 loss {r['losses'][0]} vs single-device {single_loss}")
        check(all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0],
              f"ep rank {rk}: losses {r['losses']}")
        check(r["f32"]["loss_rel_err"] <= 1e-5
              and r["f32"]["grads_max_err_over_max_abs"] <= TOL_TRAIN_GRADS,
              f"ep rank {rk}: f32 gradients against one device: {r['f32']}")
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and ranks[0]["replicated_sha"] == ranks[1]["replicated_sha"],
          "ep ranks: losses or replicated leaves differ")

    # (d) serving: bf16 through the pipelined kernel, the main path counted
    model = moe_model(dev, full, dtype="bfloat16")
    rng = np.random.default_rng(2)
    lengths = rng.integers(64, 769, MOE_REQUESTS)
    budgets = rng.integers(16, 129, MOE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int64) for n in lengths]
    kw = dict(paged_kv="int4", page_size=PAGE, prefill_chunk=PAGED_CHUNK, n_slots=PAGED_SLOTS)
    srv = ContinuousBatcher(model, **kw)
    drain(srv, prompts[:4], [8] * 4)  # warm-up: cuBLAS, the allocator
    srv.reset_latency_stats()
    pre0, ticks0 = srv.n_prefill_dispatches, srv.n_plain_ticks
    tpa.paged_attn_launches = tpa.paged_attn_pipelined_launches = 0
    toks, wall, tick_ms = drain(srv, prompts, budgets)
    serve_launches = paged_counts(tpa)
    n_chunks, n_ticks = srv.n_prefill_dispatches - pre0, srv.n_plain_ticks - ticks0
    dispatches = n_chunks + n_ticks * srv.decode_quantum
    lat = srv.latency_stats()
    new_tokens = sum(len(t) for t in toks)
    row = {"phase": "moe_serve", "model": "mixtral-8x7b", "cut": cut, "dtype": "bfloat16",
           "paged_kv": "int4", "page_size": PAGE, "prefill_chunk": PAGED_CHUNK,
           "n_slots": PAGED_SLOTS, "requests": MOE_REQUESTS, "prompt_tokens": int(lengths.sum()),
           "launches": serve_launches, "dispatches": {"prefill_chunks": n_chunks,
                                                      "decode_ticks": n_ticks},
           "new_tokens": new_tokens, "wall_s": wall, "tokens_per_s": new_tokens / wall,
           "ttft_p50_s": lat.get("ttft_p50_s"), "e2e_p50_s": lat.get("e2e_p50_s"),
           "decode_tick_ms_median": statistics.median(tick_ms), "card": card}
    check(serve_launches == {"paged_attn": 0,
                             "paged_attn_pipelined": cfg.n_layer * dispatches},
          f"the Mixtral drain launched {serve_launches}, expected {cfg.n_layer} x {dispatches} "
          "pipelined launches")
    check(all(len(t) == int(n) for t, n in zip(toks, budgets)),
          "a request of the Mixtral drain did not complete its budget")
    check(srv.free_pages == srv.n_pages - 1, "pages leaked by the Mixtral drain")
    row["steady_tick"] = steady_tick(srv, prompts)
    del srv, model
    torch.cuda.empty_cache()

    # f32: the single-buffer kernel against the gather path, the margin rule
    model32 = moe_model(dev, full)
    runs, before = {}, paged_counts(tpa)
    f32_prompts, f32_budgets = prompts[:MOE_F32_REQUESTS], budgets[:MOE_F32_REQUESTS]
    os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"
    try:
        for name, impl in (("kernel", "pallas"), ("gather", "xla")):
            os.environ["DSML_PAGED_ATTN"] = impl
            srv = ContinuousBatcher(model32, **kw)
            runs[name], _, _ = drain(srv, f32_prompts, f32_budgets)
            check(srv.free_pages == srv.n_pages - 1, "pages leaked by an f32 Mixtral drain")
            del srv
    finally:
        del os.environ["DSML_PAGED_ATTN_PIPELINE"]
        del os.environ["DSML_PAGED_ATTN"]
    f32_launches = {key: n - before[key] for key, n in paged_counts(tpa).items()}
    near_ties, mismatches = [], 0
    for i, (a, w) in enumerate(zip(runs["kernel"], runs["gather"])):
        diff = [j for j, (p, q) in enumerate(zip(a, w)) if p != q]
        if diff:
            m = first_divergence_margin(model32, f32_prompts[i], w, diff[0])
            near_ties.append({"request": i, "step": diff[0], "margin": m})
            mismatches += m >= MARGIN
    row["f32"] = {"requests": MOE_F32_REQUESTS, "kernel": "paged_attn (single buffer)",
                  "launches": f32_launches, "tokens_equal": runs["kernel"] == runs["gather"],
                  "near_ties": near_ties}
    row["phase_seconds"] = time.perf_counter() - t_phase
    emit(row)
    check(f32_launches["paged_attn"] > 0 and f32_launches["paged_attn_pipelined"] == 0,
          f"the f32 Mixtral drains launched {f32_launches}, expected the single-buffer kernel only")
    check(all(len(t) == int(n) for t, n in zip(runs["kernel"], f32_budgets)),
          "a request of the f32 Mixtral drain did not complete")
    check(mismatches == 0, f"f32 Mixtral kernel tokens diverge from the gather path beyond the "
                           f"margin rule: {near_ties}")
    del model32, full
    torch.cuda.empty_cache()
    os.remove(weights)
    return {**train_launches, "paged_attn": f32_launches["paged_attn"],
            "paged_attn_pipelined": serve_launches["paged_attn_pipelined"],
            "flash_err": kernels["flash_err"], "bwd_err": kernels["bwd_err"],
            "paged_err": kernels["paged_err"], "timing": kernels["timing"],
            "paged_timing": kernels["paged_timing"]}


# ---------------------------------------------------------------------------
# elasticity and chaos (dsml_tpu_torch/runtime/controller.py, parallel/world.py)
# ---------------------------------------------------------------------------

CHAOS_SLOTS = 4  # rank slots (worker processes) sharing the card
CHAOS_BATCH = 8  # the global batch, of TRAIN_S tokens a row
CHAOS_STEPS, CHAOS_EVERY = 24, 4  # the scripted leg: steps, checkpoint cadence
CHAOS_LR = 3e-4  # Adam, as optax.adam(3e-4)
CHAOS_TORN_STEPS, CHAOS_TORN_EVERY, CHAOS_TORN_AT = 4, 2, 3  # cut from 8 and 5 (the run's time)
CHAOS_TORN_REASON = "training state not recoverable from survivors"  # the torn-leaf audit's
CHAOS_MID_STEPS, CHAOS_MID_AT, CHAOS_MID_RANK = 3, 2, 2  # the rank killed: 2 of the leg's 4
# slots started with the pool beside its four, which the torn and the mid-step
# legs take in the place of slots killed before them (no worker restored
# between legs)
CHAOS_SPARE_SLOTS = 3
CHAOS_DETECT_S = 30.0  # a rank killed inside a step must surface within this
CHAOS_SERVE_REQUESTS, CHAOS_SERVE_NEW, CHAOS_SERVE_KILL_TICK = 8, 32, 3
CHAOS_MIG_LAYERS = 2  # the migration smoke's depth (GPT-2-small's width)


def chaos_schedule():
    """The scripted leg's schedule: every kill hits a slot of the live
    mesh — 4 → 2 (8 rows do not divide by 3: one slot idles) → 2 → 1 → a
    replay back to 4 at the step-20 boundary."""
    from dsml_tpu_torch.runtime.chaos import ChaosEvent, ChaosSchedule

    return ChaosSchedule([ChaosEvent(6, "kill", (3,), inject=True), ChaosEvent(10, "kill", (1,)),
                          ChaosEvent(13, "kill", (0,)), ChaosEvent(17, "restore", ())])


def chaos_batches(vocab: int, n: int):
    """``provider(step) -> (x, y)``: a pure function of the step index."""
    rng = np.random.default_rng(22)
    data = rng.integers(0, vocab, (n, CHAOS_BATCH, TRAIN_S)).astype(np.int32)

    def provider(step):
        x = data[step - 1]
        return x, np.roll(x, -1, 1).astype(np.int32)

    return provider


def chaos_recovery_rows(report):
    keep = ("kind", "from_width", "to_width", "slots", "resume_step", "lost_steps",
            "recovery_ms", "pull_s", "push_s", "join_s", "restore_s", "bytes", "surfaced_s",
            "mid_step", "plan")
    return [{k: r[k] for k in keep if k in r} for r in report["recoveries"]]


class MidPrefillKill:
    """``kill_ticks`` of ``chaos.run_chaos_serving_fleet`` that fires at the
    first tick a prefill worker is inside a prompt (some chunks done, some
    not): that worker is killed, once."""

    def __init__(self, router):
        self.router, self.killed = router, None

    def get(self, tick, default=None):
        if self.killed is not None:
            return default
        mid = [i for i, pw in enumerate(self.router.prefill_workers)
               if pw._pending is not None and pw._pending[2] > 0]
        if not mid:
            return default
        pw = self.router.prefill_workers[mid[0]]
        self.killed = {"worker": mid[0], "frid": pw._pending[0].frid,
                       "at_row": int(pw._pending[2]), "tick": tick}
        return ("prefill", mid[0])


def chaos_serving(dev, paged):
    """Leg 4: a DecodeFleet of two f32 GPT-2-small paged int4 batchers (8
    slots each) serves 8 of paged_slice's requests (budgets cut to 32),
    the newest replica killed at tick 3; the survivor re-runs its requests,
    through the single-buffer kernel after the kill (the pipelined one
    before it). Tokens against one 8-slot batcher's, the margin rule."""
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.ops import paged_attention as tpa
    from dsml_tpu_torch.runtime.controller import DecodeFleet
    from dsml_tpu_torch.serving import ContinuousBatcher

    t_leg = time.perf_counter()
    cfg32 = dataclasses.replace(GPT2Config.small(), dtype="float32")
    model = gpt2_small(cfg32, dev)
    prompts = paged["prompts"][:CHAOS_SERVE_REQUESTS]
    budgets = [min(int(n), CHAOS_SERVE_NEW) for n in paged["budgets"][:CHAOS_SERVE_REQUESTS]]

    def batcher():
        return ContinuousBatcher(model, n_slots=8, paged_kv="int4", page_size=PAGE,
                                 prefill_chunk=PAGED_CHUNK)

    ref = batcher()
    ref_rids = [ref.submit(p, n) for p, n in zip(prompts, budgets)]
    ref_out = ref.run()
    want = [ref_out[r] for r in ref_rids]
    del ref
    for name in ("paged_attn", "paged_attn_pipelined"):
        setattr(tpa, f"{name}_launches", 0)
    tflash.flash_fwd_launches = 0
    fleet = DecodeFleet(batcher, min_replicas=2, max_replicas=2, scale_down_idle_ticks=10_000)
    t0 = time.perf_counter()
    frids = [fleet.submit(p, n) for p, n in zip(prompts, budgets)]
    tick, requeued = 0, None
    try:
        while fleet.outstanding:
            if tick == CHAOS_SERVE_KILL_TICK:
                requeued = fleet.kill_replica()
                os.environ["DSML_PAGED_ATTN_PIPELINE"] = "0"  # the re-runs: kernel 5
            fleet.tick()
            tick += 1
            check(tick < 10_000, "the chaos DecodeFleet did not drain")
    finally:
        os.environ.pop("DSML_PAGED_ATTN_PIPELINE", None)
    out = fleet.run(max_ticks=1)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": tflash.flash_fwd_launches, "paged_attn": tpa.paged_attn_launches,
                "paged_attn_pipelined": tpa.paged_attn_pipelined_launches}
    got = [out.get(f, []) for f in frids]
    near_ties, mismatches = [], 0
    for i, (a, w) in enumerate(zip(got, want)):
        diff = [j for j, (x, y) in enumerate(zip(a, w)) if x != y]
        if len(a) != len(w):
            mismatches += 1
            continue
        if diff:
            m = first_divergence_margin(model, prompts[i], w, diff[0])
            near_ties.append({"request": i, "step": diff[0], "margin": m})
            mismatches += m >= MARGIN
    row = {"requests": len(prompts), "budgets": budgets, "ticks": tick,
           "seconds": time.perf_counter() - t_leg,
           "requeued": requeued, "scale_events": fleet.scale_events, "wall_s": wall,
           "tokens": sum(len(t) for t in got), "tokens_equal": got == want,
           "near_ties": near_ties, "mismatches_beyond_margin": mismatches,
           "launches": launches}
    del fleet, model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def chaos_migration(dev, card, root, overrides, pool):
    """Leg 5: the two-host migration smoke (``chaos.run_migration_smoke``)
    at GPT-2-small's width, depth cut to 2, on the legs' pool: its shards
    over fsdp = 2 (tp = 2 does not divide the vocabulary)."""
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.runtime import chaos

    t0 = time.perf_counter()
    mig_cfg = dataclasses.replace(GPT2Config.small(), n_layer=CHAOS_MIG_LAYERS)
    mig = chaos.run_migration_smoke(tmp_dir=os.path.join(root, "migration"), device=str(dev),
                                    cfg=mig_cfg, pool=pool, planner_overrides=overrides,
                                    shard_axis="fsdp")
    violations = chaos.verify_migration(mig)
    leg = {**mig, "layers": CHAOS_MIG_LAYERS, "violations": violations,
           "seconds": time.perf_counter() - t0}
    emit({"phase": "chaos_migration", **leg, "card": card})
    check(not violations, f"chaos migration: {violations}")
    return leg


def phase_chaos_training(dev, card):
    """GPT-2-small (124M, bf16, full width and depth) trains on four rank
    slots sharing the card under ``ElasticController``
    (``runtime/controller.py``; ``parallel/world.py``'s worker pool, one
    long-lived process a slot; ``attn_impl="flash"``, global batch 8 ×
    1024, ``MeshSpec(dp=4)``, the ring sync over the CUDA IPC transport,
    Adam): (1) 24 steps under a scripted schedule of three kills and a
    restore, final parameters bit-identical to an uninterrupted 24-step
    run on the same world; (2) a torn dp = 2 × fsdp = 2 state (both fsdp-1
    slots killed before step 3 of 4) falls back to the step-2 checkpoint,
    the fallback's reason the torn-leaf audit, the state adopted bit for
    bit that checkpoint's; (3) a rank SIGKILLs itself
    inside a step, after its backward, before the gradient sync: the
    ``DeviceLost`` surfaces within 30 s and the step is retried; (4) a
    ``DecodeFleet`` replica killed mid-drain, zero tokens lost; (5) the
    two-host migration smoke at GPT-2-small's width, depth cut to 2 (its
    shard over fsdp = 2: tp = 2 does not divide the vocabulary).
    Kernel launches counted by leg (the ``"E:"`` paths); every number of
    the recoveries printed. The serving leg is :func:`chaos_serving`; this
    function runs legs 1, 5, 2 and 3 (the worker pool's), in that order,
    and returns them for :func:`phase_chaos`; leg 5 is
    :func:`chaos_migration`, on the same pool. The pool starts
    :data:`CHAOS_SPARE_SLOTS` slots beside the four, and legs 2 and 3 run on
    the first four live slots, so no worker is restored between legs. The
    full run drives it last, alone on the card."""
    import tempfile

    from dsml_tpu_torch.checkpoint import CheckpointManager
    from dsml_tpu_torch.models.gpt2 import GPT2Config
    from dsml_tpu_torch.parallel import elastic
    from dsml_tpu_torch.parallel.mesh import MeshSpec
    from dsml_tpu_torch.parallel.world import TrainRecipe, WorkerPool
    from dsml_tpu_torch.runtime import chaos
    from dsml_tpu_torch.runtime.controller import ControllerConfig, ElasticController

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(GPT2Config.small(), dtype="bfloat16")
    # seed 0's weights from the shared file (rounded to bf16 as init rounds them)
    recipe = TrainRecipe(cfg, lr=CHAOS_LR, attn_impl="flash", dp_sync="ring",
                         weights=os.environ.get(GPT2_WEIGHTS_ENV))
    overrides = chaos.default_planner_overrides(str(dev), CHAOS_SLOTS)
    provider = chaos_batches(cfg.vocab_size, CHAOS_STEPS)
    root = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    row = {"phase": "chaos", "model": "gpt2-small", "dtype": "bfloat16", "slots": CHAOS_SLOTS,
           "batch": CHAOS_BATCH, "seq": TRAIN_S, "attn_impl": "flash", "dp_sync": "ring",
           "optimizer": f"Adam({CHAOS_LR})", "planner_overrides": overrides,
           "disk_free_gb": shutil.disk_usage(root).free / 1e9, "card": card}
    legs, launches = {}, {}
    slots = list(range(CHAOS_SLOTS))
    t0 = time.perf_counter()
    pool = WorkerPool(CHAOS_SLOTS + CHAOS_SPARE_SLOTS, recipe, device=str(dev),
                      workdir=os.path.join(root, "pool"))
    row["pool_start_s"] = time.perf_counter() - t0
    row["spare_slots"] = CHAOS_SPARE_SLOTS

    def live_world():
        """The first four live slots: the spares stand in for slots killed
        by an earlier leg."""
        return [s for s in sorted(pool.slots) if pool.is_alive(s)][:CHAOS_SLOTS]
    try:
        # (1) the scripted schedule against an uninterrupted run
        t0 = time.perf_counter()
        pool.launches.clear()
        world = pool.form(slots, MeshSpec(dp=CHAOS_SLOTS), seed=0)
        ref_losses = [world.step(*provider(s)) for s in range(1, CHAOS_STEPS + 1)]
        ref_s = time.perf_counter() - t0
        host = world.state()
        ref_params = host.tree()["params"]
        host.remove()
        world.leave()
        fleet = chaos.VirtualFleet(slots, pool)
        ctl = ElasticController(
            pool, provider, os.path.join(root, "scripted"), fleet=fleet, slots=slots,
            spec=MeshSpec(dp=CHAOS_SLOTS),
            config=ControllerConfig(checkpoint_every=CHAOS_EVERY, growback="replay"),
            global_batch=CHAOS_BATCH, seed=0, planner_overrides=overrides)
        t1 = time.perf_counter()
        with ctl:
            rep = chaos.run_chaos_training(ctl, chaos_schedule(), CHAOS_STEPS)
            got = ctl.params
        ctl_s = time.perf_counter() - t1
        same = chaos._bit_identical(got, ref_params)
        del got, ref_params
        launches["E:scripted"] = dict(pool.launches)
        kinds = [r["kind"] for r in rep["recoveries"]]
        legs["scripted"] = {
            "steps_completed": rep["steps_completed"], "kinds": kinds,
            "recoveries": chaos_recovery_rows(rep), "redone_steps": rep["redone_steps"],
            "goodput": rep["goodput"], "recovery_p50_ms": rep.get("recovery_p50_ms"),
            "recovery_p99_ms": rep.get("recovery_p99_ms"), "bit_identical": same,
            "ref_losses": ref_losses, "losses": [ctl.losses[s] for s in sorted(ctl.losses)],
            "reference_s": ref_s, "controller_s": ctl_s, "wall_s": rep["wall_s"],
            "productive_s": rep["productive_s"], "lost_work_s": rep["lost_work_s"],
            "launches": launches["E:scripted"], "seconds": time.perf_counter() - t0}
        shutil.rmtree(os.path.join(root, "scripted"), ignore_errors=True)
        emit({"phase": "chaos_scripted", **legs["scripted"], "card": card})
        grow = [r for r in rep["recoveries"] if r["kind"] == "grow_replay"]
        check(rep["steps_completed"] == CHAOS_STEPS and kinds.count("reconfigure") == 3
              and len(grow) == 1 and grow[0]["to_width"] == CHAOS_SLOTS and same,
              f"chaos scripted: {rep['steps_completed']} steps, recoveries {kinds}, "
              f"bit-identical {same}")

        # (5) the migration smoke next, on slots 0-3 (it leaves slot 1 dead)
        legs["migration"] = chaos_migration(dev, card, root, overrides, pool)

        # (2) torn state: dp = 2 x fsdp = 2, both fsdp-1 slots killed
        t0 = time.perf_counter()
        pool.launches.clear()
        slots = live_world()
        torn_dir = os.path.join(root, "torn")
        adopted = {}

        def on_recover(rec):
            if rec["kind"] == "checkpoint_fallback":
                adopted["state"] = ctl2.host_state()

        fleet = chaos.VirtualFleet(slots, pool)
        ctl2 = ElasticController(
            pool, provider, torn_dir, fleet=fleet, slots=slots, spec=MeshSpec(dp=2, fsdp=2),
            config=ControllerConfig(checkpoint_every=CHAOS_TORN_EVERY, growback="keep"),
            global_batch=CHAOS_BATCH, seed=0, planner_overrides=overrides, on_recover=on_recover)
        torn_slots = [s for s in slots if ctl2.world.slots.index(s) % 2 == 1]  # fsdp coordinate 1
        with ctl2:  # a chaos event names indices into the fleet's slot list
            rep2 = chaos.run_chaos_training(
                ctl2, chaos.ChaosSchedule([chaos.ChaosEvent(
                    CHAOS_TORN_AT, "kill", tuple(slots.index(s) for s in torn_slots))]),
                CHAOS_TORN_STEPS)
        mgr = CheckpointManager(torn_dir, max_to_keep=None)
        ck = elastic._host_from_checkpoint(mgr, CHAOS_TORN_AT - 1, pool)
        ck_tree = ck.tree()
        ck.remove()
        mgr.close()
        state = adopted.get("state", {})
        torn_same = bool(state) and chaos._bit_identical(state, ck_tree)
        del ck_tree, adopted
        launches["E:torn"] = dict(pool.launches)
        fb = [r for r in rep2["recoveries"] if r["kind"] == "checkpoint_fallback"]
        legs["torn"] = {"steps_completed": rep2["steps_completed"], "slots": slots,
                        "killed": torn_slots,
                        "recoveries": chaos_recovery_rows(rep2),
                        "fallback_reason": fb[0].get("fallback_reason") if fb else None,
                        "adopted_equals_checkpoint": torn_same,
                        "launches": launches["E:torn"], "seconds": time.perf_counter() - t0}
        shutil.rmtree(torn_dir, ignore_errors=True)
        emit({"phase": "chaos_torn", **legs["torn"], "card": card})
        check(len(fb) == 1 and fb[0]["lost_steps"] == 0 and fb[0]["resume_step"] == CHAOS_TORN_AT
              and fb[0].get("fallback_reason", "").startswith(CHAOS_TORN_REASON)
              and rep2["steps_completed"] == CHAOS_TORN_STEPS and torn_same,
              f"chaos torn: {legs['torn']}")

        # (3) a rank SIGKILLs itself inside a step, before the gradient sync
        t0 = time.perf_counter()
        pool.launches.clear()
        slots = live_world()
        ctl3 = ElasticController(
            pool, provider, os.path.join(root, "mid"), slots=slots,
            spec=MeshSpec(dp=CHAOS_SLOTS), config=ControllerConfig(checkpoint_every=100),
            global_batch=CHAOS_BATCH, seed=0, planner_overrides=overrides)
        ctl3.kill_mid_step(CHAOS_MID_AT, slots[CHAOS_MID_RANK])
        with ctl3:
            rep3 = ctl3.run(CHAOS_MID_STEPS)
        launches["E:mid_step"] = dict(pool.launches)
        rec3 = rep3["recoveries"][0] if rep3["recoveries"] else {}
        legs["mid_step"] = {"steps_completed": rep3["steps_completed"], "slots": slots,
                            "killed": slots[CHAOS_MID_RANK],
                            "recoveries": chaos_recovery_rows(rep3),
                            "losses": [ctl3.losses[s] for s in sorted(ctl3.losses)],
                            "launches": launches["E:mid_step"],
                            "seconds": time.perf_counter() - t0}
        shutil.rmtree(os.path.join(root, "mid"), ignore_errors=True)
        emit({"phase": "chaos_mid_step", **legs["mid_step"], "card": card})
        check(rec3.get("mid_step") == CHAOS_MID_AT and rec3.get("surfaced_s", 1e9) < CHAOS_DETECT_S
              and rec3.get("resume_step") == CHAOS_MID_AT
              and rep3["steps_completed"] == CHAOS_MID_STEPS,
              f"chaos mid-step kill: {legs['mid_step']}")
    finally:
        pool.close()
        shutil.rmtree(root, ignore_errors=True)
    row["pool_legs_seconds"] = time.perf_counter() - t_phase
    return row, legs, launches


def phase_chaos(card, serve, training):
    """The chaos phase's line: the pool's legs (:func:`phase_chaos_training`)
    and the serving leg (:func:`chaos_serving`, with its seconds), the
    recoveries' p50 / p99, the launches by leg; the launch checks. Returns
    the launches by path."""
    row, legs, launches = training
    launches["E:serving"] = serve["launches"]
    legs["serving"] = serve
    emit({"phase": "chaos_serving", **serve, "card": card})
    check(serve["mismatches_beyond_margin"] == 0 and serve["requeued"]
          and serve["launches"]["paged_attn"] > 0 and serve["launches"]["paged_attn_pipelined"] > 0,
          f"chaos serving: {serve}")
    recov = [r["recovery_ms"] for leg in ("scripted", "torn", "mid_step")
             for r in legs[leg]["recoveries"]]
    row.update({"legs": {k: v.get("seconds") for k, v in legs.items()},
                "recovery_p50_ms": float(np.percentile(recov, 50)),
                "recovery_p99_ms": float(np.percentile(recov, 99)),
                "launches_by_path": launches})
    emit(row)
    for kernel in ("flash_fwd", "flash_bwd_dq_tc", "flash_bwd_dkv_tc"):
        check(all(launches[p].get(kernel, 0) > 0 for p in ("E:scripted", "E:torn", "E:mid_step")),
              f"chaos: {kernel} did not launch on every training leg: {launches}")
    return launches


def main() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: this smoke test needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dsml_tpu_torch.ops import _build
    from dsml_tpu_torch.ops import flash as tflash
    from dsml_tpu_torch.runtime import native
    from dsml_tpu_torch.utils.platform import card_name_and_power_limit, resolve_device

    dev = resolve_device("cuda:0")
    card = card_name_and_power_limit()
    only = sys.argv[1:]  # a debugging run of some phases: no result line
    if not only:
        # the numpy draws of TinyLlama's and the cut Mixtral's weights, each in a
        # process of its own, beside the build (its nvcc processes leave cores
        # idle); the Mixtral draw is waited for before the first timed phase
        draws = [llama_weights_start(), moe_weights_start()]
        atexit.register(lambda: [p.kill() for p in draws if p.poll() is None])
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0], **wire_toolchain()})

    t0 = time.perf_counter()
    reports = _build.build()
    reports_seconds = time.perf_counter() - t0
    native_built = time.perf_counter()
    native_lib = native.build()
    native.load()
    native_seconds = time.perf_counter() - native_built
    reports_seconds += native_seconds
    emit({"phase": "build", "sources": sorted(reports), "seconds": reports_seconds,
          "native": {"source": str(native.SOURCE.relative_to(Path.cwd())),
                     "library": native_lib.name, "seconds": native_seconds},
          "ptxas": {name: [line.strip() for line in log.splitlines()
                           if "registers" in line or "spill" in line]
                    for name, log in reports.items()},
          "spills": {name: {fn: props for fn, props in ptxas_report(log).items()
                            if props.get("spill_stores") or props.get("spill_loads")}
                     for name, log in reports.items()}})

    share_gpt2_small_weights()
    emit({"phase": "gpt2_weights", "seconds": time.perf_counter() - t0 - reports_seconds,
          "note": "GPT-2-small's f32 init from seed 0, drawn once and read by every phase and rank"})
    if only:
        phases = {"sass": lambda: phase_sass(_build, reports),
                  "kernel": lambda: phase_kernel(tflash, dev),
                  "kernel_bwd": lambda: phase_kernel_bwd(tflash, dev),
                  "kernel_paged": lambda: phase_kernel_paged(dev),
                  "paged_time": lambda: phase_paged_time(dev),
                  "kernel_qmm": lambda: phase_kernel_qmm(dev),
                  "qmm_time": lambda: qmm_time(dev),
                  "kernel_quant8": lambda: phase_kernel_quant8(dev),
                  "slice": lambda: phase_trace(*phase_slice(tflash, dev, card)[1:]),
                  "train": lambda: phase_train_trace(phase_train(tflash, dev, card)[2]),
                  "paged_slice": lambda: phase_paged_slice(dev, card),
                  "fleet": lambda: phase_fleet(dev, card, phase_paged_slice(dev, card)[2]),
                  "chaos": lambda: phase_chaos(card, chaos_serving(dev, phase_paged_slice(dev, card)[2]),
                                               phase_chaos_training(dev, card)),
                  "fleet_kernel": lambda: fleet_kernel_time(dev),
                  "wire": lambda: phase_wire(dev, card),
                  "wq_slice": lambda: phase_wq_slice(dev, card),
                  "serve_cli": lambda: (phase_serve_cli(dev), phase_serve_cli_wq(dev)),
                  "train_int8remat": lambda: phase_train_int8remat(tflash, dev, card),
                  "kernel_stream": lambda: phase_kernel_stream(tflash, dev),
                  "kernel_head_dim": lambda: phase_kernel_head_dim(tflash, dev),
                  "kernel_long_context": lambda: phase_kernel_long_context(tflash, dev),
                  "cp_slice": lambda: phase_cp_slice(card),
                  "cp_cli": lambda: phase_train_cli_runs(train_cli_start(["cp2"])),
                  "allreduce": lambda: phase_allreduce(card),
                  "quant_allreduce": lambda: phase_quant_allreduce(card),
                  "dp_slice": lambda: phase_dp_slice(card),
                  "dp_cli": lambda: phase_train_cli_runs(train_cli_start(["dp2"])),
                  "vision": lambda: phase_vision(dev, card),
                  "llama_cli": lambda: phase_llama_cli(llama_cli_start()),
                  "llama_kernel": lambda: family_kernels(tflash, dev, "llama", LLAMA_HEADS,
                                                         LLAMA_KV_HEADS, D, verify=True),
                  "llama_train": lambda: phase_llama_train(tflash, dev, card),
                  "llama_serve": lambda: phase_llama_serve(dev, card),
                  "llama_ticks": lambda: phase_llama_ticks(dev, card),
                  "obs": lambda: phase_obs(tflash, dev, card),
                  "checkpoint": lambda: phase_checkpoint(tflash, dev, card),
                  "plan": lambda: phase_plan(card),
                  "model_parallel": lambda: with_tinyllama_weights(
                      lambda w: phase_model_parallel(tflash, dev, card, w)),
                  "tp_serve": lambda: with_tinyllama_weights(
                      lambda w: phase_tp_serve(tflash, dev, card, w)),
                  "fleet_tp": lambda: with_tinyllama_weights(
                      lambda w: phase_fleet_tp(dev, card, w)),
                  "qmm_llama": lambda: qmm_llama(dev),
                  "elastic_kernel_time": lambda: elastic_kernel_time(tflash, dev),
                  "mp_cli": lambda: phase_train_cli_runs(
                      train_cli_start(["tinyllama_tp2", "small_pp2_1f1b"])),
                  "moe": lambda: phase_moe(
                      tflash, dev, card, moe_weights_wait(moe_weights_start()),
                      family_kernels(tflash, dev, "moe", MOE_HEADS, MOE_KV_HEADS, MOE_HD,
                                     verify=False))}
        for name in only:
            phases[name]()
        raise SystemExit(f"chip_smoke: ran only {only}; no result line")

    phase_sass(_build, reports)
    moe_draw = moe_weights_wait(draws[1])  # no timed phase beside a numpy draw
    main_err, timing = phase_kernel(tflash, dev)
    bwd_err, bwd_timing = phase_kernel_bwd(tflash, dev)
    paged_err, paged_timing = phase_kernel_paged(dev)
    qmm_err = phase_kernel_qmm(dev)
    qmm_timing = qmm_time(dev)
    qmm_llama_err, qmm_llama_timing = qmm_llama(dev)
    quant8_err, quant8_timing = phase_kernel_quant8(dev)
    stream_err, stream_timing = phase_kernel_stream(tflash, dev)
    phase_kernel_head_dim(tflash, dev)
    phase_kernel_long_context(tflash, dev)
    elastic_timing = elastic_kernel_time(tflash, dev)
    fleet_tp_kernels = fleet_tp_kernel_time(dev)
    # with the other kernel phases: late in a full run the profiler's traces
    # lost events twice in this phase (never in its own run)
    llama_kernels = family_kernels(tflash, dev, "llama", LLAMA_HEADS, LLAMA_KV_HEADS, D,
                                   verify=True)
    moe_kernels = family_kernels(tflash, dev, "moe", MOE_HEADS, MOE_KV_HEADS, MOE_HD, verify=False)
    launches, model, prompt = phase_slice(tflash, dev, card)
    phase_trace(model, prompt)
    del model
    phase_cli(tflash)
    train_launches, f32_launches, step = phase_train(tflash, dev, card)
    phase_train_trace(step)
    del step
    torch.cuda.empty_cache()
    phase_train_cli(tflash)
    torch.cuda.empty_cache()
    paged_launches, single_launches, paged_row = phase_paged_slice(dev, card)
    torch.cuda.empty_cache()
    fleet_launches, fleet_err = phase_fleet(dev, card, paged_row)
    torch.cuda.empty_cache()
    # elasticity and chaos, the serving leg: a DecodeFleet replica killed
    chaos_serve = chaos_serving(dev, paged_row)
    del paged_row
    torch.cuda.empty_cache()
    phase_wire(dev, card)
    torch.cuda.empty_cache()
    wq_launches = phase_wq_slice(dev, card)
    torch.cuda.empty_cache()
    remat_launches = phase_train_int8remat(tflash, dev, card)
    torch.cuda.empty_cache()
    # the entry points run as processes: the TinyLlama-1.1B ones (each first
    # draws 1.1B weights on the host) beside the two-rank programs, the
    # GPT-2-small train_gpt2 runs after them, while this process runs the
    # serve_continuous entry point in process and reads TinyLlama's weights
    # (drawn beside the build); every Llama phase is timed after them all
    procs = llama_cli_start()
    cli_procs = train_cli_start(TRAIN_CLI_EARLY)
    atexit.register(lambda: [p.kill() for p in (*procs.values(), *cli_procs.values())
                             if p.poll() is None])
    two_rank, two_seconds = spawn_two_rank_programs()  # one spawn: six programs
    cp_launches, sp_launches = phase_cp_slice(card, (two_rank["cp"], two_seconds))
    phase_allreduce(card, (two_rank["allreduce"], two_seconds))
    phase_quant_allreduce(card, (two_rank["quant_allreduce"], two_seconds))
    _, q8_launches, obs_dp, ckpt_dp = phase_dp_slice(card, (two_rank, two_seconds))
    torch.cuda.empty_cache()
    cli_procs.update(train_cli_start([n for n in TRAIN_CLI_RUNS if n not in TRAIN_CLI_EARLY]))
    try:
        phase_serve_cli(dev)
        phase_serve_cli_wq(dev)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        llama_weights()
        emit({"phase": "llama_weights", "seconds": time.perf_counter() - t0,
              "note": "TinyLlama-1.1B's f32 init from seed 0, drawn in its own process beside "
                      "the build: seconds is the wait and the read of its file"})
        phase_llama_cli(procs)
        phase_train_cli_runs(cli_procs)
    except BaseException:
        for p in (*procs.values(), *cli_procs.values()):
            if p.poll() is None:
                p.kill()
                p.communicate()
        raise
    llama_train_launches = phase_llama_train(tflash, dev, card)
    torch.cuda.empty_cache()
    llama_paged_launches = phase_llama_serve(dev, card)
    phase_llama_ticks(dev, card)
    torch.cuda.empty_cache()
    # expert parallelism: the cut Mixtral trained on one card and at ep = 2, then served
    moe = phase_moe(tflash, dev, card, moe_draw, moe_kernels)
    torch.cuda.empty_cache()
    # the observability core on the serving and training paths (its launches
    # are in its own line: the kernels line reads the paths above)
    phase_obs(tflash, dev, card, obs_dp)
    torch.cuda.empty_cache()
    ckpt_launches = phase_checkpoint(tflash, dev, card, ckpt_dp)
    torch.cuda.empty_cache()
    # the vision family: the MNIST CNN and single-device ResNet-18 here, on a
    # card no side process uses; ResNet-18 at dp = 2 rode the two-rank spawn
    phase_vision(dev, card, (two_rank["vision"], two_seconds))
    torch.cuda.empty_cache()
    # the mesh planner on the card; model parallelism: tp, pp (three
    # schedules, the eval), ZeRO-3/ZeRO-2 on the planner's mesh and pp x tp
    # (its checkpoint and resume); then tensor-parallel serving, from the
    # same TinyLlama weights file
    phase_plan(card)
    with tinyllama_bf16_weights() as weights:
        # the tp ranks serve too (tp_serve), after their training program
        mp_launches, mp_quant8, (serve_ref, serve_spawned), resume_eval, lc_launches = (
            phase_model_parallel(tflash, dev, card, weights, serve=True))
        torch.cuda.empty_cache()
        tp_launches, tp_errs, _, tp_bf16 = phase_tp_serve(tflash, dev, card, weights, serve_ref,
                                                          serve_spawned)
        torch.cuda.empty_cache()
        # decode workers over two devices each behind the router, from the
        # same weights file
        fleet_tp_launches, fleet_tp_err, fleet_tp_times = phase_fleet_tp(
            dev, card, weights, tp_bf16, fleet_tp_kernels)
    tp_paged_err = max(v for k, v in tp_errs.items() if k.startswith("paged_"))
    torch.cuda.empty_cache()
    # elasticity and chaos, the worker pool's legs (GPT-2-small on four rank
    # slots under the controller's kill/restore schedules, the migration
    # smoke): alone on the card, after every timed phase
    chaos_launches = phase_chaos(card, chaos_serve, phase_chaos_training(dev, card))

    # the backward's two routes: bf16 (tensor cores) with launches from the
    # bf16 train steps, f32 (FMAs) with launches from phase_train's f32
    # gradient check; times at [96, 1024, 64] causal in each route's type
    # the Llama paths add their launches: kernels 1-3 from the TinyLlama
    # train steps, kernels 5-6 from the Llama drains (bf16 pipelined, f32
    # single-buffer); each path counted from 0 around itself; the
    # model-parallel path adds rank 0's kernels 1-3 of the TinyLlama tp = 2
    # steps and of the GPT-2-small pp = 2 gpipe steps, and kernel 8 of its
    # pp int8-remat step
    bwd_rows = []
    for dtype, source, counts in ((torch.bfloat16, BWD_TC_SOURCE, train_launches),
                                  (torch.float32, BWD_FMA_SOURCE, f32_launches)):
        dq_name, dkv_name = BWD_KERNELS[dtype]
        err = bwd_err[dtype]
        llama = llama_train_launches if dtype == torch.bfloat16 else {dq_name: 0, dkv_name: 0}
        mp = mp_launches if dtype == torch.bfloat16 else {dq_name: 0, dkv_name: 0}
        mx = moe if dtype == torch.bfloat16 else {dq_name: 0, dkv_name: 0}
        ra = resume_eval if dtype == torch.bfloat16 else {dq_name: 0, dkv_name: 0}
        # the long-context paths (bf16): sp = 2's impls, cp x tp, cp x dp, attention_2d
        lcp = ({"sp_impls": sp_launches, **lc_launches} if dtype == torch.bfloat16 else
               {p: {dq_name: 0, dkv_name: 0} for p in ("sp_impls", *lc_launches)})
        # the chaos legs (bf16: the tensor-core route), each counted from 0 around itself
        ep = {p: {k: v.get(k, 0) for k in (dq_name, dkv_name)} for p, v in chaos_launches.items()}
        lcp.update(ep)
        bwd_rows += [
            {"name": dq_name, "route": "cuda", "source": source, "replaces": "dsml_tpu/ops/flash.py:481",
             "launches": counts[dq_name] + llama[dq_name] + ckpt_launches[dq_name] + mp[dq_name]
             + mx[dq_name] + ra[dq_name] + sum(v[dq_name] for v in lcp.values()),
             "launches_by_path": {"train": counts[dq_name], "llama_train": llama[dq_name],
                                  "checkpoint": ckpt_launches[dq_name],
                                  "model_parallel": mp[dq_name], "moe": mx[dq_name],
                                  "mp_resume_eval": ra[dq_name],
                                  **{p: v[dq_name] for p, v in lcp.items()}},
             "max_abs_err": err["dq"], **bwd_timing[dq_name],
             **({"path_timing": {"E": elastic_timing[dq_name]}}
                if dtype == torch.bfloat16 else {})},
            {"name": dkv_name, "route": "cuda", "source": source, "replaces": "dsml_tpu/ops/flash.py:526",
             "launches": counts[dkv_name] + llama[dkv_name] + ckpt_launches[dkv_name] + mp[dkv_name]
             + mx[dkv_name] + ra[dkv_name] + sum(v[dkv_name] for v in lcp.values()),
             "launches_by_path": {"train": counts[dkv_name], "llama_train": llama[dkv_name],
                                  "checkpoint": ckpt_launches[dkv_name],
                                  "model_parallel": mp[dkv_name], "moe": mx[dkv_name],
                                  "mp_resume_eval": ra[dkv_name],
                                  **{p: v[dkv_name] for p, v in lcp.items()}},
             "max_abs_err": max(err["dk"], err["dv"]), **bwd_timing[dkv_name],
             **({"path_timing": {"E": elastic_timing[dkv_name]}}
                if dtype == torch.bfloat16 else {})}]
    emit({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": "dsml_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "dsml_tpu/ops/flash.py:198",
         "launches": launches + llama_train_launches["flash_fwd"] + ckpt_launches["flash_fwd"]
         + mp_launches["flash_fwd"] + moe["flash_fwd"] + tp_launches["flash_fwd"]
         + resume_eval["flash_fwd"] + sp_launches["flash_fwd"]
         + sum(v["flash_fwd"] for v in lc_launches.values())
         + sum(v.get("flash_fwd", 0) for v in chaos_launches.values()),
         "launches_by_path": {"slice": launches, "llama_train": llama_train_launches["flash_fwd"],
                              "checkpoint": ckpt_launches["flash_fwd"],
                              "model_parallel": mp_launches["flash_fwd"], "moe": moe["flash_fwd"],
                              "tp_serve": tp_launches["flash_fwd"],
                              "mp_resume_eval": resume_eval["flash_fwd"],
                              "sp_impls": sp_launches["flash_fwd"],
                              **{p: v["flash_fwd"] for p, v in lc_launches.items()},
                              **{p: v.get("flash_fwd", 0) for p, v in chaos_launches.items()}},
         "max_abs_err": main_err, **timing, "path_timing": {"E": elastic_timing["flash_fwd"]}},
        *bwd_rows,
        # times at the decode tick's shape (the chunk's are in the kernel_time line);
        # launches from the paged slice's two drains, one per kernel
        {"name": "paged_attn", "route": "cuda", "source": PAGED_SOURCE,
         "replaces": "dsml_tpu/ops/paged_attention.py:169",
         "launches": single_launches["paged_attn"] + llama_paged_launches["paged_attn"]
         + ckpt_launches["paged_attn"] + moe["paged_attn"] + tp_launches["paged_attn"]
         + fleet_launches["paged_attn"] + chaos_launches["E:serving"]["paged_attn"]
         + fleet_tp_launches["decode"]["paged_attn"] + fleet_tp_launches["prefill"]["paged_attn"],
         "launches_by_path": {"paged_slice": single_launches["paged_attn"],
                              "D:decode_ranks": fleet_tp_launches["decode"]["paged_attn"],
                              "D:prefill": fleet_tp_launches["prefill"]["paged_attn"],
                              "fleet": fleet_launches["paged_attn"],
                              "E:serving": chaos_launches["E:serving"]["paged_attn"],
                              "llama_serve": llama_paged_launches["paged_attn"],
                              "checkpoint": ckpt_launches["paged_attn"], "moe": moe["paged_attn"],
                              "tp_serve": tp_launches["paged_attn"]},
         "max_abs_err": max(paged_err, llama_kernels["paged_err"], moe["paged_err"], tp_paged_err,
                            fleet_err, fleet_tp_err),
         **paged_timing["paged_attn"]["decode"],
         "path_timing": {"D": fleet_tp_times["tp_rank_f32_fp"]["paged_attn"]}},
        {"name": "paged_attn_pipelined", "route": "cuda", "source": PAGED_SOURCE,
         "replaces": "dsml_tpu/ops/paged_attention.py:259",
         "launches": paged_launches["paged_attn_pipelined"]
         + llama_paged_launches["paged_attn_pipelined"] + ckpt_launches["paged_attn_pipelined"]
         + moe["paged_attn_pipelined"] + tp_launches["paged_attn_pipelined"]
         + fleet_launches["paged_attn_pipelined"]
         + chaos_launches["E:serving"]["paged_attn_pipelined"]
         + fleet_tp_launches["decode"]["paged_attn_pipelined"]
         + fleet_tp_launches["prefill"]["paged_attn_pipelined"],
         "launches_by_path": {"paged_slice": paged_launches["paged_attn_pipelined"],
                              "D:decode_ranks": fleet_tp_launches["decode"]["paged_attn_pipelined"],
                              "D:prefill": fleet_tp_launches["prefill"]["paged_attn_pipelined"],
                              "fleet": fleet_launches["paged_attn_pipelined"],
                              "E:serving": chaos_launches["E:serving"]["paged_attn_pipelined"],
                              "llama_serve": llama_paged_launches["paged_attn_pipelined"],
                              "checkpoint": ckpt_launches["paged_attn_pipelined"],
                              "moe": moe["paged_attn_pipelined"],
                              "tp_serve": tp_launches["paged_attn_pipelined"]},
         "max_abs_err": max(paged_err, llama_kernels["paged_err"], moe["paged_err"], tp_paged_err,
                            fleet_err, fleet_tp_err),
         **paged_timing["paged_attn_pipelined"]["decode"],
         "path_timing": {"D": fleet_tp_times["tp_rank_bf16_int4"]["paged_attn_pipelined"]}},
        # times at the decode tick's shape of wqkv (16 rows, int4, bf16 x; the
        # other projections and the chunk are in the kernel_time line);
        # launches from the wq slice's int4 drain
        {"name": "qmm", "route": "cuda", "source": QMM_SOURCE,
         "replaces": "dsml_tpu/ops/quantization.py:531", "launches": wq_launches["qmm"],
         "max_abs_err": qmm_err, **{k: qmm_timing[k] for k in KERNEL_TIMES},
         "path_timing": {"L": {**qmm_llama_timing["int4"]["decode"]["wqkv"],
                               "max_err_over_max_abs": qmm_llama_err}}},
        # times at the train step's block input [8, 1024, 768] bf16 (the q8
        # bucket's are in its kernel_time line); kernel 8 runs on two paths:
        # launches from the int8-remat train steps and from rank 0's q8 dp
        # steps, each counted from 0 around its path
        {"name": "quantize_int8", "route": "cuda", "source": QUANT8_SOURCE,
         "replaces": "dsml_tpu/ops/quantization.py:141",
         "launches": remat_launches["quantize_int8"] + q8_launches + mp_quant8,
         "launches_by_path": {"train_int8remat": remat_launches["quantize_int8"],
                              "dp_slice_q8": q8_launches, "model_parallel_pp_int8": mp_quant8},
         "max_abs_err": quant8_err, **{k: quant8_timing[k] for k in KERNEL_TIMES}},
        # times at the cp = 2 hop's shape (q [96, 512, 64], K/V half [96, 256,
        # 64], bf16; library_ms the two-call yardstick SDPA + copy_); launches
        # from rank 0 of the cp = 2 slice's counted train steps and of the
        # long-context program's cp x tp TinyLlama steps and cp x dp step
        {"name": "flash_stream", "route": "cuda", "source": STREAM_SOURCE,
         "replaces": "dsml_tpu/ops/flash.py:306",
         "launches": cp_launches["flash_stream"] + sum(v["flash_stream"]
                                                       for v in lc_launches.values()),
         "launches_by_path": {"cp_slice": cp_launches["flash_stream"],
                              **{p: v["flash_stream"] for p, v in lc_launches.items()}},
         "max_abs_err": stream_err, **{k: stream_timing[k] for k in KERNEL_TIMES}},
    ]})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    print(f"chip_smoke: done (t = {time.perf_counter() - _T0:.1f} s)", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
