#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (one nvcc a source, all started
together) and prints what ptxas reports for each (registers, shared
memory, spills), holds each kernel
against its plain PyTorch version at the serving shapes (the BiLSTM
scan also at the full forward's 625 rows and at the enrollment net's
two shapes, the int8 ring step over w + 3 chained calls from one
state, the ring attention step also at an odd K width, the flat
LayerNorms' kernel at the serving geometries against the eager chain it
replaced and the plain row norm), loads the
checkpoints (checkpoints/tsh_r5_5k_best.npz, embed_r5_5k_best.npz) and
drives each path through the entry points a user calls, with every
launch count set to 0 just before the path and read just after:
  * `EmbedNet`, the enrollment net, on a 5 s binaural enrollment
    (batch 2) on the GPU against the CPU: 6 BiLSTM launches a call;
  * `StreamingEngine` with the int8 K/V ring, eager: 4 streams in
    float32 on the GPU against the same engine on the CPU, then 64
    streams in bf16;
  * `StreamingEngine` with the float K/V ring (the default precision),
    eager: 4 streams in float32 on the GPU against the CPU, 64 streams
    with a float32 ring, with a bf16 ring under bf16 compute, and with
    a bf16 ring under float32 compute;
  * `Net.predict` / `Net.forward`, the full-utterance forward: the
    streamed (CUDA-graph) engine output equals the full forward on the
    card, and the GPU full forward equals the CPU one;
  * `local_attention_step_ring_int8`, the op entry of the int8 ring
    attention kernel, on the head-major serving rows;
  * the CUDA-graph engine (the default on the card) against the eager
    engine, 64 streams at each ring (bf16 + int8, float32, bf16, float32
    over bf16), bit for bit over w + 3 steps, through the all-primed
    and the masked graphs (unprimed slots, an `add_stream` between
    replays, an inactive slot);
  * look once, then hear: the d-vectors `EmbedNet` made on the card
    attached to the 64-stream bf16 + int8 graph engine;
  * `step_pipelined` + `drain` against `step` on that engine.
Then it times each kernel, its plain version and, where one exists,
the one PyTorch call that computes the same function, with CUDA events
(the flat norms at a flagship step's four shapes and the default Net's
rows, beside the eager chain they replaced and `F.layer_norm`; the
BiLSTM scan and cuDNN's LSTM at 64 and 625 rows, at the
enrollment shapes and at the eval's batch of 4 x 5 s), beside the floor of that timing (one launch of a
one-element `add_`); the engine step at each ring, eager and as a
CUDA graph (`benchmark_device`, `benchmark`, call to synchronize),
each with a profile of its device ops, which must hold 3 BiLSTM scans,
3 ring steps and 12 flat norms (6 at a float ring) a step and no other
kernel of the port (the int8 path
must launch no `ring_advance_pos`: the ring step advances its cursor
itself; the graph's replays must bump no launch counter); one
full forward; and `EmbedNet` on 5 s. Last, the eval paths:
  * the two-stage eval CLI (`ts_hear_test.run`) over the first 64
    scenes of the 5k synthetic test split, oracle and two-stage, each
    row held to the JAX package's CSV (docs/results_r5, `eval_check`);
  * the serving-precision study (`kv_quality.run`): those 64 scenes as
    64 streams of one graph engine at f32, bf16 and bf16 + int8, the
    int8 serving form within 0.3 dB of float32;
Then training, every LSTM recurrence on the port's training kernels
(the state-saving forward and the backward of `csrc/bilstm_scan.cu`):
  * both kernels against their plain versions at the committed
    training configs' four scan shapes and a tail shape, in the models'
    layouts (random inputs made on the card), the forward also against
    a float64 run;
  * one `TSETask` and one `EmbedTask` loss-and-backward from the
    committed checkpoints on a 2 x 1 s batch of the synthetic train
    split, on the card against the CPU, with the launch counts a step
    implies (a forward and a backward of each scan);
  * the trainer CLI (`trainer.run`) on both committed training configs
    at their full width and batch of 8 x 5 s, for 3 training batches
    and 1 validation batch; the best checkpoint loads strictly into a
    fresh model and has the committed checkpoint's keys and shapes;
  * times: 10 steps of a seeded random TSE model on one fixed 8 x 5 s
    batch (the loss must fall) and 4 of `EmbedTask`, each with a
    profile (no cuDNN RNN kernel, the port's kernels as counted) and the
    same step with every block checkpointed, and both training kernels
    at the four shapes beside their plain versions and cuDNN's
    `nn.LSTM` forward + backward.
Then `corpus_phases`: on a LibriSpeech-format corpus generated in a
temporary directory, the d-vector precompute (the `dvector_embeddings`
CLI with EmbedNet from the committed npz and from a reference-format
Lightning checkpoint, over the corpus and utterances of 2, 15 and 35 s:
6 BiLSTM launches an utterance, card against CPU, B2 at the 35 s
utterance's scans against its plain version; a configs/tsh.json training
step on the d-vectors written; the eval from a reference-format
checkpoint, card against CPU; `--embed_from_wav` refused without
resemblyzer), the reference configs (configs/tsh.json,
configs/embed.json) through the trainer CLI, the render rate of their
dataset, the same TSE epoch with `--prerender` (rendering the cache,
then reading it; a cached validation batch equal to a fresh render; the
cache's read rate through the loader), moving sources (the native
renderer's known-delay case, a batch of `CIPIC_MOTION` items over an IR
set made here, `MixLibriSpeechMotion` over SOFA files where h5py
imports, TSE training steps on the batch), `SeparationTask` (the offline
separator with 2-source PIT) on the card against the CPU and through the
CLI, and the loss registry on the card.
Then the reference's default `Net()` (6 blocks, H=128, no attention,
seeded weights: `default_net_phase`), on the H=128 kernels of
`csrc/bilstm_scan.cu`: both held to their plain versions, the engine
on the GPU against the CPU, as a CUDA graph against eager, the full
forward against the CPU and the streamed engine, and each timed; then
the same `Net` in training (`default_net_training_phase`): the H=128
backward against its plain version at every tile, one `TSETask` step
on the card against the CPU's float64 through the H=128 training
forward and backward, and the step at 8 x 5 s timed with and without
every block checkpointed.
The rest of the JAX package, each through its entry point: the motion
renderer's build (after the kernels'); `MultiDeviceEngine`, two graph
engines of 32 streams on the one card against one of 64, and
`profiling` (a latency histogram, CUDA-event step time, a FLOP count, a
trace), after the graph phases; the trainer CLI in an NCCL process group
of one against the plain run, and DDP's steps against the unwrapped
model's, after "path: trainer CLI"; and,
after `corpus_phases`, `convert` (random reference state_dicts into
`Net` / `EmbedNet`, the card against the CPU) and `stream_demo` with the
committed checkpoints.
Inference phases run under `torch.no_grad()`, the training phases with
gradients. Then the loaders' fork server and resource tracker are
stopped and reaped, and no child process of this script may be left.

Every phase prints its elapsed seconds and has a time limit; a failed
phase prints its traceback and exits 1 before the result. The last
three lines are the card's name and power limit (nvidia-smi), one JSON
object with each kernel's numbers, and the result object. Exits 1 at
once without a CUDA device or without the package beside this file.
Imports nothing of JAX.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "tsh_r5_5k_best.npz")
EMBED_CKPT = os.path.join(ROOT, "checkpoints", "embed_r5_5k_best.npz")
STREAMS = 64
PATH_STEPS = 60
TIMED_STEPS = 50
CHUNK_MS = 8.0                # 128 samples at 16 kHz
# H100 SXM published peaks (NVIDIA data sheet, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # TF32 on the tensor cores, dense
# tolerances (kernel vs its plain version, same inputs, on the card)
TOL_LSTM = 2e-5               # float32, the JAX Pallas-vs-scan bound
# float32 over the enrollment net's 1,248-step inter-time scans: the cell
# state carries each step's rounding (the kernel's fast exp and divide,
# the plain version's own) through the whole chain, so the difference
# grows with T: 0.7-2.3e-5 seen at 1,248 steps where 97 steps see
# 1-2e-6; both versions are also held to a float64 run of the recurrence
TOL_LSTM_LONG = 1e-4
TOL_RING_F32 = (2e-5, 2e-6)   # rtol, atol: JAX Pallas-vs-XLA bound
TOL_RING_BF16 = 2e-2          # atol: one bf16 rounding of |out| <~ 4
# GPU vs CPU engine, float32, each step from the same state: the output
# (of its peak) and the float state (of max(1, its peak)) differ only by
# the order of float32 sums; an int8 ring entry whose k/scale lies near
# a .5 rounding boundary may flip by one, in at most 1 of 1000 written
TOL_PATH = 1e-4
TOL_STATE = 1e-4
# ring attention kernel vs its plain version: float32 over a float ring
# atol 1e-4 (the JAX package's Pallas-step bound at the flagship
# shapes, tests/test_serve.py), float32 over an int8 ring rtol/atol
# 2e-5 (tests/test_attention.py), a bf16 q or ring atol 2e-2 (one bf16
# rounding of |out| up to ~4)
TOL_ATTN_F32 = 1e-4
TOL_ATTN_INT8 = 2e-5
TOL_ATTN_BF16 = 2e-2
# streamed engine vs full forward on the card, float32: atol 1e-4 (the
# JAX package's bound for the same relation, tests/test_serve.py)
TOL_STREAMED = 1e-4
FLOAT_PATH_STEPS = 12         # the f32-compute + bf16-ring path
GRAPH_STEPS = 53              # w + 3: the graph engines through the wrap
ENROLL_SECONDS = 5.0          # enrollment: 1251 frames, F = 65
ENROLL_BATCH = 2
# EmbedNet GPU vs CPU, float32 (TF32 off): of the d-vectors' peak; the
# same arithmetic in another summation order through 1,248-step
# recurrences and T x T softmaxes
TOL_ENROLL = 1e-4
OP_RING_STEPS = 12            # the op-level int8 ring path
FULL_SECONDS = 5.0
FULL_REPS = 10                # timed calls of the full forward
# training: the committed training configs' scan shapes, (T, D, rows):
# TSE intra [97, 2, 8 x 625 frames] and inter [625, 1, 8 x 97 bins]
# (from a carried state), EmbedNet intra [62, 2, 8 x 1251] and inter
# [1248, 2, 8 x 65]
TRAIN_SCANS = {"tse_intra": (97, 2, 5000), "tse_inter": (625, 1, 776),
               "embed_intra": (62, 2, 10008),
               "embed_inter": (1248, 2, 520)}
# and a row count that no tile of the training kernels divides, both
# directions from a carried state: the last block's tail rows
TRAIN_TAIL = (97, 2, 1037)
# training kernels vs their plain versions on the same inputs, of each
# output's peak (gradients scale with the incoming gradient; the cell
# state with the chain): float32 in another order, as B2 (TOL_LSTM up
# to 97 steps, TOL_LSTM_LONG beyond)
# one training step on the card vs the CPU, TF32 off: the loss 1e-4
# relative to the CPU's float32 run; every gradient within 1e-3 of
# max(its peak, 1e-3 of the model's largest peak) of the CPU's float64
# run of the same step (the card measured up to 5.2e-4 from float64, so
# 1e-3 leaves room both ways). A 3-block network of 62- to 1,248-step
# recurrences, T x T softmaxes and PReLUs in float32; the floor is for
# tensors whose true gradient is 0 (the K LayerNorm's shift, which
# softmax ignores). The CPU's own float32 run is logged beside it as a
# witness only: EmbedNet's attention PReLU slopes are sums with heavy
# cancellation and lie up to 1.8e-3 of their peak from float64 there
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
# SEP_GRAD_NOTE. The offline separator's gradient (6 blocks, seeded random
# init, 2 x 1 s of the corpus' first two validation items) is not
# defined to TOL_TRAIN_GRAD at float32's resolution: float64 on the input
# times (1 + SEP_PERTURB N(0, 1)), ~8 of float32's units in the last
# place, moves 48 of the 540 tensors by more than TOL_TRAIN_GRAD of
# max(peak, floor), up to 3.2e-2 (attention PReLU slopes, biases, norms
# and projections of blocks 0-3), and the CPU's float32 run misses 47,
# up to 3.0e-2. Which tensors, and how far, a float32 run lands depends
# on its rounding: in four runs of this phase on one card the card's
# float32 lay either near float64 (7 tensors beyond TOL_TRAIN_GRAD, at
# most 1.8e-3) or near the CPU's float32 (up to 3.0e-2). So the check
# names no tensor: every gradient must lie within SEP_GRAD_CAP of
# float64, and at most SEP_MAX_UNRESOLVED beyond TOL_TRAIN_GRAD; the
# log gives both float32 witnesses beside the card. A wiring fault
# (a layout, a direction, a missing term) moves most tensors by O(1);
# the kernels themselves are held to their plain versions at these
# shapes in "bilstm_scan training kernels vs plain"
SEP_GRAD_CAP = 0.1
SEP_MAX_UNRESOLVED = 64
SEP_PERTURB = 1e-6
TRAIN_CHECK_SECONDS = 1.0
TRAIN_CHECK_BATCH = 2
TRAIN_FRAC = 0.005            # 3 of the 640 training batches, 1 val batch
TRAIN_STEPS = 10              # steps on one fixed batch, seeded init
# the reference configs' path: a LibriSpeech-format corpus of 8 speakers
# x 3 utterances of 6 s per split, and scene specs for 3 training batches
# of 8 and 1 validation batch of 10 (the configs' batch sizes)
CORPUS_SPEAKERS = 8
CORPUS_UTTS = 3
CORPUS_SECONDS = 6.0
CORPUS_SCENES = {"train-clean-360": 24, "dev-clean": 10, "test-clean": 10}
# the d-vector precompute ("path: d-vector precompute"): the port's
# dvector_embeddings CLI (embednet backend, configs/embed_synthetic_5k.json)
# over the corpus's utterances and one more split of utterances across
# LibriSpeech's range of lengths (DV_SPLIT, speaker DV_SPEAKER)
DV_SPLIT = "test-other"
DV_SPEAKER = "4000"
DV_SECONDS = (2.0, 15.0, 35.0)
# the card against the CPU's run of the same CLI on the same files. The
# CPU's EmbedNet takes about a second per second of audio on the card's
# host (this phase logs its runs' times), minutes for the CLI's 75
# utterances, and grows faster than the audio (its T x T attention), so
# the CPU runs it on the utterances of the lengths below (seconds), one
# process of DV_CPU_THREADS threads per checkpoint, beside the phase's work
# on the card; the longest utterance is held instead to EmbedNet on the
# card with every scan on B2's plain version
DV_CPU = {"npz": (2.0, 15.0), "reference": (2.0, CORPUS_SECONDS)}
DV_CPU_THREADS = 4
DV_LIMIT = 70                 # the phase's watchdog, seconds
# ts_hear_test from a reference-format checkpoint, card against CPU
DV_EVAL_SCENES = 4
# the loader's render rate: RATE_ROUNDS batches per worker, the rate
# taken from the end of the second round to the end of the last
RATE_ROUNDS = 7
# every LossFn name on the card vs the CPU, float32 (TF32 off): of
# max(1, |CPU value|); CDPAM relative
TOL_LOSSES = 1e-4
# the eval phases: the first 64 scenes of the 5k test split, rendered by
# 8 workers, as the eval CLI does by default
TSH_5K = os.path.join(ROOT, "configs", "tsh_synthetic_5k.json")
EMBED_5K = os.path.join(ROOT, "configs", "embed_synthetic_5k.json")
EVAL_SCENES = 64
EVAL_WORKERS = 8
# bf16 + int8 serving against float32, SI-SNRi over the 64 streams: the
# limit the serving precision is held to (PERF.md)
KV_COST_DB = 0.3
# two graph engines on the one card, 32 streams each, against one
# 64-stream graph engine: the float32 ring of the output's peak
# (TOL_PATH: the same kernels on half the rows); with an int8 ring one
# step from the same state of the peak (TOL_PATH at float32 compute,
# TOL_SPLIT_BF16 at bf16). A GEMM over 32 rows rounds apart from one over
# 64, and the int8 ring and the carried state compound it: free-running
# over 53 steps the split reached 1.413e-3 of the peak (RMS 4.083e-4 of
# the output's) at float32 + int8 and 7.060e-2 (RMS 8.593e-2) at bf16 +
# int8, the same in six runs on an H100 80GB HBM3 at 700 W. Free-running,
# the split is held to TOL_SPLIT_FREE: (max of the peak, RMS of the
# output's), set from those readings, so a fault in how a split engine
# carries its state shows, which one step from a shared state cannot see
TOL_SPLIT_BF16 = 5e-2
TOL_SPLIT_FREE = {"float32 + int8 K/V": (3e-3, 1e-3),
                  "bf16 + int8 K/V": (1e-1, 1.2e-1)}
PROFILE_STEPS = 100           # LatencyRecorder over graph-engine steps
# the converter: a random reference state_dict through the port's model on
# the card against the CPU, float32 (TF32 off), of the output's peak
TOL_CONVERT = 1e-4
CONVERT_SECONDS = 1.0
# moving sources: an IR set made here (MOTION_DIRS directions in the
# horizontal plane and two elevations, MOTION_IR taps), a batch of the
# configs' 8 training items rendered through it, and MOTION_STEPS TSE
# training steps of configs/tsh.json's model on them
MOTION_DIRS = 24
MOTION_IR = 64
MOTION_STEPS = 3
# an NCCL group of one against the plain trainer CLI run, of max(1, |v|):
# the training metrics (the same 3 steps on the same batches); the
# validation metrics of the model after them, whose SI-SNR at ~-40 dB
# moves by 1.1e-5 between two runs of one unchanged CLI epoch (the
# `--prerender` runs' val/si_snr_i, an H100 80GB HBM3 at 700 W)
TOL_DDP = 1e-5
TOL_DDP_VAL = 1e-4
DDP_STEPS = 6                 # DDP against the unwrapped model, one batch
# DDP's reduced gradients against the unwrapped model's, of max(peak,
# floor) per tensor: a sum over one rank is exact, so only the card's own
# spread between two backward passes (atomics) is left
TOL_DDP_GRAD = 1e-4
# the reference's default Net (`Net()`: chunk 160 + pad 120, F=141, 6
# blocks, H=128, no attention), seeded random weights: the 64-stream
# engine over DEFAULT_STEPS 10 ms steps, the full forward on the CPU
# against the card over DEFAULT_CPU_SECONDS and timed over
# DEFAULT_FULL_SECONDS
DEFAULT_STREAMS = 64
DEFAULT_STEPS = 12
DEFAULT_CHUNK_MS = 10.0       # 160 samples at 16 kHz
DEFAULT_CPU_SECONDS = 2.0
DEFAULT_FULL_SECONDS = 5.0
# its scans at H=128: B2 [141, 2, rows] at the step's 64 streams, the
# full forward's 500 frames of 5 s and a row count no tile divides; the
# training forward (T, D, N, from a carried state) at the full forward's
# inter-time scan and over both directions
H128_SCANS = {"serving": 64, "full_forward": 500, "tail": 13}
H128_TRAIN = {"full_forward_inter": (500, 1, 141, True),
              "both_directions": (141, 2, 64, False),
              "eval_inter": (500, 1, 564, True)}
# the default Net in training (`default_net_training_phase`): the model
# built by TSETask from configs/tsh_synthetic_5k.json with the `Net`
# class defaults as its model_params; one step on the card against the
# CPU over DEFAULT_TRAIN_CHECK (rows, seconds), DEFAULT_TRAIN_STEPS timed
# steps at the config's 8 x 5 s, with and without every block
# checkpointed; the H=128 backward against its plain version (T, D, N,
# from a carried state) at that step's two scans, a row count no tile
# divides and scans of 1-3 steps
DEFAULT_NET_PARAMS = dict(embed_dim=256, stft_chunk_size=160,
                          stft_pad_size=120, num_ch=2, D=64, L=0, I=1, J=1,
                          B=6, H=128, use_attn=False, lookahead=True,
                          local_atten_len=100, chunk_causal=False)
DEFAULT_TRAIN_CHECK = (2, 0.5)
DEFAULT_TRAIN_STEPS = 3
H128_BWD_SCANS = {"train_intra": (141, 2, 4000, False),
                  "train_inter": (500, 1, 1128, True),
                  "tail": (141, 2, 13, True), "T=1": (1, 2, 9, True),
                  "T=2": (2, 1, 17, False), "T=3": (3, 2, 5, True)}
# counter name -> the kernel's name in a profiler trace (or the parts
# that name must all hold: the H=128 kernels' names carry their tile)
TRACE_NAMES = {
    "bilstm_scan": "bilstm_scan_kernel<64, false>",
    "bilstm_scan_h128": ("bilstm_h128_mma_kernel<", ", false>"),
    "bilstm_scan_fwd_train_h128": ("bilstm_h128_mma_kernel<", ", true>"),
    "bilstm_scan_bwd_train_h128": "bilstm_h128_bwd_kernel<",
    "bilstm_scan_fwd_train": "bilstm_train_fwd_kernel",
    "bilstm_scan_bwd": "bilstm_train_bwd_kernel",
    "ring_int8_step": "ring_int8_step_kernel<__nv_bfloat16>",
    "attn_step_f32": "attn_step_kernel<float, float>",
    "attn_step_bf16": "attn_step_kernel<__nv_bfloat16, __nv_bfloat16>",
    "attn_step_f32_bf16kv": "attn_step_kernel<float, __nv_bfloat16>",
    "flat_norm": "flat_norm_kernel<"}
PORT_KERNELS = ("bilstm_scan_kernel", "bilstm_train_fwd_kernel",
                "bilstm_train_bwd_kernel", "bilstm_h128_mma_kernel",
                "bilstm_h128_bwd_kernel",
                "ring_int8_step_kernel", "attn_step_kernel",
                "flat_norm_kernel")
# flat-norm launches (csrc/flat_norm.cu) a streaming step: the flagship's
# 3 blocks x (intra, inter), with the int8 ring also x (the Q/K/V launch,
# the attention output's norm); the default Net's 6 blocks x (intra,
# inter)
FLAT_NORMS = dict(int8=12, float_ring=6, default_net=12)
# the flagship's fused Q/K/V projection y [64, F, C] and its blocks'
# widths (F=97, 4 heads, e=6, v dim 16), and the row norms of a step
FLAT_QKV = dict(f=97, nh=4, dims=(6, 6, 16))
FLAT_ROWS = {"intra/inter bf16": (STREAMS * 97, 64, "bf16"),
             "attn out bf16": (STREAMS, 97 * 64, "bf16"),
             "default Net f32": (STREAMS * 141, 64, "f32")}
TOL_FLAT_F32 = 2e-5           # atol: the two sums' order, |out| <~ 5
TOL_FLAT_BF16 = (2 ** -7, 1e-2)   # rtol, atol: one bf16 step of the output
# traces of a profile at most: eager-engine traces holding 29 of 10
# steps' 30 B2 launches came back in two runs of this script, and on
# some hosts every trace of a profile lacks the same one record (11 of a
# step's 12 H=128 forwards, 59 of 60 B2 at H=128 in 10 graph replays)
TRACE_TRIES = 3
# records of a kernel the tracer may lose from the fullest of those
# traces, where the launches are proven without it (the wrappers'
# counters, or a graph held bit for bit to the eager engine): a tenth of
# the launches, at least one
TRACE_LOSS = 10
# head-major rows of the float ring at 64 streams (64 x 4 heads); odd_dk
# a K width whose rows start 1- or 2-byte aligned
ATTN = dict(rows=STREAMS * 4, w1=49, dk=97 * 6, dv=97 * 16, odd_dk=525)


def traced(name: str, counter: str) -> bool:
    """Whether a profiler event of this name is a launch of the kernel
    whose wrapper counts `counter` (TRACE_NAMES)."""
    parts = TRACE_NAMES[counter]
    return all(p in name for p in ((parts,) if isinstance(parts, str)
                                   else parts))


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, limit_s: int, fn, grad: bool = False):
    """Run one phase under a watchdog, with autograd on only for a
    training phase (`grad`); exit 1 on any failure."""
    import torch
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(limit_s, exit=True)
    try:
        with torch.set_grad_enabled(grad):
            out = fn()
    except Exception:
        traceback.print_exc()
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        sys.exit(1)
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"[{name}] ok, {time.perf_counter() - t0:.1f} s")
    return out


def profile_steps(eng, xs, torch, expect, absent=(),
                  counters=None, replays=None) -> dict:
    """Where a step's device time goes: kernel time by name and the
    device's busy share, from a torch.profiler trace of len(xs) steps.
    Fails unless each kernel of the port in `expect` ({counter name:
    launches per step}) ran exactly that often and no other kernel of the
    port ran, or if a kernel whose name holds one of `absent` ran. The
    tracer can drop a kernel's record: a trace short of a kernel's
    launches (and holding no launch too many) is logged and taken again,
    TRACE_TRIES traces in all. `counters` (reset, read) of the kernel
    wrappers, for an eager engine: every trace's steps must have
    launched exactly `expect`, so a short trace is shown to have lost
    records, not launches. `replays`, for a graph engine: what showed
    that its graph launches `expect` a replay (a graph replays every node
    it captured). Where one of the two proves the launches and every
    trace is short, the fullest is kept if it lacks at most a
    TRACE_LOSS-th of each kernel's records (at least one) and holds each
    kernel; its losses come back as `trace_records_lost`."""
    from torch.profiler import ProfilerActivity, profile
    n = len(xs)
    want = {k: per_step * n for k, per_step in expect.items()}
    best = None
    for attempt in range(1, TRACE_TRIES + 1):
        if counters:
            counters[0]()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in xs:
                eng.step(x)
            torch.cuda.synchronize()
        if counters:
            launched = {k: counters[1]()[k] for k in expect}
            if launched != want:
                raise AssertionError(f"launched {launched} in {n} steps, "
                                     f"want {want}")
        kern = [ev for ev in prof.events()
                if ev.device_type == torch.autograd.DeviceType.CUDA]
        if not kern:
            raise AssertionError("profiler: no device events recorded")
        ran = {k: sum(traced(ev.name, k) for ev in kern) for k in expect}
        other = sum(any(p in ev.name for p in PORT_KERNELS)
                    for ev in kern) - sum(ran.values())
        if other or any(ran[k] > want[k] for k in want):
            raise AssertionError(f"profiler: {ran} and {other} other "
                                 f"kernels of the port in {n} steps, "
                                 f"want {want} and none")
        if best is None or sum(ran.values()) > sum(best[1].values()):
            best = (kern, ran)
        if ran == want:
            break
        log(f"  profiler, trace {attempt} of {TRACE_TRIES}: {ran} in {n} "
            f"steps, want {want}: kernel records missing"
            + (" (the wrappers counted every launch)" if counters else ""))
    else:
        kern, ran = best
        lost = {k: want[k] - ran[k] for k in want}
        proof = ("the wrappers counted every launch of every trace"
                 if counters else replays)
        if not proof or any(v > max(1, want[k] // TRACE_LOSS) or not ran[k]
                            for k, v in lost.items()):
            raise AssertionError(f"profiler: all {TRACE_TRIES} traces short "
                                 f"of {want}, the fullest by {lost}"
                                 + ("" if proof else ", launches unproven"))
        log(f"  profiler: the tracer lost {lost} of {want} records in every "
            f"trace; kept the fullest, as {proof}")
    log(f"  profiler: {', '.join(f'{v} {k}' for k, v in expect.items())} a "
        f"step and no other kernel of the port")
    by_name: dict = {}
    for ev in kern:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us()
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in kern)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    log(f"  profiler, {n} steps: {len(kern) / n:.0f} device ops per step, "
        f"device busy {busy / n / 1e3:.3f} of {window / n / 1e3:.3f} ms "
        f"per step (share {busy / window:.3f})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"    {us / n:9.1f} us/step  {name[:100]}")
    for bad in absent:
        hits = [name for name in by_name if bad in name]
        if hits:
            raise AssertionError(f"{hits[0]} ran on this path")
        log(f"  no {bad} among the {len(by_name)} kernels of the trace")
    return dict(device_ops_per_step=len(kern) / n,
                device_busy_ms=busy / n / 1e3, busy_share=busy / window,
                trace_records_lost={k: want[k] - ran[k] for k in want})


def attn_bound(b, w1, dk, dv, q_bytes, kv_bytes, scaled):
    """(bound ms, bound_by, MB) of one ring attention step: every input
    read once and the output written once, against the float32 FMA
    rate for the scores, softmax and weighted sum."""
    nbytes = (q_bytes * b * (2 * dk + 2 * dv) + kv_bytes * b * w1 * (dk + dv)
              + (2 * 4 * b * w1 if scaled else 0))
    flops = 2 * b * (w1 + 1) * (dk + dv) + 5 * b * (w1 + 1)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e6)


def drop_from_page_cache(paths) -> float:
    """Write each file back and drop its pages from the page cache
    (posix_fadvise DONTNEED), so the next read goes to storage; returns
    the share of the files' pages still resident after (mincore): 0
    where the drop took, up to 1 on a file system that lives in memory
    (tmpfs), where no read can reach storage."""
    import ctypes
    import mmap
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    resident = total = 0
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            size = os.fstat(fd).st_size
            pages = -(-size // mmap.PAGESIZE)
            addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED,
                             fd, 0)
            if addr is None or addr == ctypes.c_void_p(-1).value:
                raise OSError(ctypes.get_errno(), f"mmap {path}")
            try:
                vec = (ctypes.c_ubyte * pages)()
                if libc.mincore(ctypes.c_void_p(addr), size, vec) != 0:
                    raise OSError(ctypes.get_errno(), f"mincore {path}")
                resident += sum(b & 1 for b in vec)
            finally:
                libc.munmap(ctypes.c_void_p(addr), size)
        finally:
            os.close(fd)
        total += pages
    return resident / total


def child_pids() -> list:
    """The processes whose parent is this one (Linux /proc)."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except (OSError, ValueError):
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            out.append(int(d))
    return out


def dvector_phase(torch, smi, root, ref_config, res, reset_counts,
                  read_counts, expect_counts):
    """The reference pipeline's order on the card: the corpus, then its
    d-vectors, then training on them. `root` holds the corpus that
    "data: LibriSpeech-format corpus" wrote; `ref_config(which)` is
    corpus_phases' (a configs/{which}.json re-pointed at it).
      * the port's dvector_embeddings CLI, `--backend embednet`, from a
        run dir whose best.ckpt is checkpoints/embed_r5_5k_best.npz, over
        the corpus's 72 utterances of 6 s and a split DV_SPLIT of
        utterances of DV_SECONDS: 6 B2 launches an utterance and no other
        kernel; the same from a reference-format Lightning best.ckpt
        (`reference_embed`, converted on load); each against the CPU's run
        of the CLI on the utterances of DV_CPU, and the longest against
        the same EmbedNet on the card with B2 swapped for its plain
        version, to TOL_ENROLL of the peak;
      * B2 at the longest utterance's six scans against its plain version
        (TOL_LSTM_LONG beyond 97 steps), block 0's two timed beside the
        bound and cuDNN's nn.LSTM;
      * one `Trainer.train_step` of configs/tsh.json with its embed_dir at
        the d-vectors just written: every item's embedding_gt is the
        CLI's for its enrollment utterance, the loss finite;
      * `ts_hear_test.run` from a reference-format Lightning best.ckpt of
        `reference_tse`, oracle, on DV_EVAL_SCENES scenes of the test
        split (whose d-vectors the CLI wrote), the card's CSV held to the
        CPU's;
      * `--embed_from_wav` raises resemblyzer's ImportError before any
        work where resemblyzer is absent."""
    import importlib.util
    import shutil
    from lookoncetohear_tpu_torch import eval_check, ts_hear_test
    from lookoncetohear_tpu_torch import utils as port_utils
    from lookoncetohear_tpu_torch.data import audio_io
    from lookoncetohear_tpu_torch.data.loader import collate
    from lookoncetohear_tpu_torch.data.prep import dvector_embeddings as dv
    from lookoncetohear_tpu_torch.data.prep.synth_corpus import (BASE,
                                                                 SPLITS, SR,
                                                                 voice)
    from lookoncetohear_tpu_torch.ops import bilstm_scan as scan_ops
    from lookoncetohear_tpu_torch.ops.bilstm_scan import (
        bilstm_scan_cuda, bilstm_scan_reference)
    from lookoncetohear_tpu_torch.ops.lstm import bidir_scan_inputs
    from lookoncetohear_tpu_torch.timing import device_ms, wall_ms
    from lookoncetohear_tpu_torch.train.trainer import (Trainer, build_task,
                                                        to_device)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    base = os.path.join(root, "dvector")
    scaper = os.path.join(root, BASE, "librispeech_scaper_fmt")
    # the CLI's root: the corpus's splits and DV_SPLIT
    src = os.path.join(base, "scaper_fmt")
    os.makedirs(os.path.join(src, DV_SPLIT, DV_SPEAKER))
    for split in SPLITS:
        os.symlink(os.path.join(scaper, split), os.path.join(src, split))
    # (split, speaker, file) of an utterance of each length
    by_len = {secs: (DV_SPLIT, DV_SPEAKER, f"{DV_SPEAKER}-0-{u}.wav")
              for u, secs in enumerate(DV_SECONDS)}
    for u, (secs, rel) in enumerate(by_len.items()):
        audio_io.write_wav(os.path.join(src, *rel),
                           voice(110 + 9 * u, 3.5, int(secs * SR)), SR)
    utts = [(split, spk, f) for split in sorted(os.listdir(src))
            for spk in sorted(os.listdir(os.path.join(src, split)))
            for f in sorted(os.listdir(os.path.join(src, split, spk)))]
    by_len[CORPUS_SECONDS] = next(u for u in utts if u[0] in SPLITS)
    longest = max(DV_SECONDS)
    audio_s = ((len(utts) - len(DV_SECONDS)) * CORPUS_SECONDS
               + sum(DV_SECONDS))

    # the two checkpoints: the committed npz under the trainer's name, and
    # a reference-format Lightning file (keys under model.)
    runs = {"npz": os.path.join(base, "run_npz"),
            "reference": os.path.join(base, "run_reference")}
    for d in runs.values():
        os.makedirs(d)
    shutil.copy(EMBED_CKPT, os.path.join(runs["npz"], "best.ckpt"))
    ref = reference_embed(np.random.default_rng(18))
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in ref.items()},
                "epoch": 0}, os.path.join(runs["reference"], "best.ckpt"))

    def cli(which, root_dir, out, device=None):
        return ["--backend", "embednet", "--embednet_config", EMBED_5K,
                "--embednet_run_dir", runs[which], "--root_dir", root_dir,
                "--output_dir", out] + (["--device", device] if device else [])

    # the CPU's runs of the CLI, started first: each on its own root of
    # links to the utterances of DV_CPU
    env = dict(os.environ, OMP_NUM_THREADS=str(DV_CPU_THREADS),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs, done, cpu_s = {}, {}, {}
    pool = ThreadPoolExecutor(len(DV_CPU))

    def finish(pr):
        """The process's output and the time it ended."""
        return pr.communicate()[0], time.perf_counter()
    try:
        t_cpu = time.perf_counter()
        for which, lens in DV_CPU.items():
            sub = os.path.join(base, f"cpu_src_{which}")
            for secs in lens:
                split, spk, name = by_len[secs]
                os.makedirs(os.path.join(sub, split, spk), exist_ok=True)
                os.symlink(os.path.join(src, split, spk, name),
                           os.path.join(sub, split, spk, name))
            procs[which] = subprocess.Popen(
                [sys.executable, "-m",
                 "lookoncetohear_tpu_torch.data.prep.dvector_embeddings",
                 *cli(which, sub, os.path.join(base, f"cpu_{which}"), "cpu")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            done[which] = pool.submit(finish, procs[which])

        # the CLI on the card over every utterance, from each checkpoint
        card, secs_cli = {}, {}
        for which in runs:
            out = card[which] = os.path.join(base, f"card_{which}")
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dv.main(cli(which, src, out))
            torch.cuda.synchronize()
            secs_cli[which] = time.perf_counter() - t0
            expect_counts(read_counts(), {"bilstm_scan": 6 * len(utts)},
                          f"d-vector CLI ({which})")
            for split, spk, f in utts:
                v = np.load(os.path.join(out, split, f"{spk}.npz"))[f]
                pt = torch.load(os.path.join(out, split, f"{spk}.pt"),
                                weights_only=False)[f]
                if not (v.shape == (256,) and v.dtype == np.float32
                        and np.isfinite(v).all() and np.array_equal(pt, v)):
                    raise AssertionError(f"{which}: {split}/{spk}/{f}: "
                                         f"{v.shape} {v.dtype}")
        log(f"  CLI on the card, {len(utts)} utterances ({audio_s:.0f} s of "
            f"audio: {len(utts) - len(DV_SECONDS)} of {CORPUS_SECONDS:g} s, "
            "and "
            f"{', '.join(f'{s:g}' for s in DV_SECONDS)} s): "
            + "; ".join(f"from {w} {secs_cli[w]:.2f} s, "
                        f"{len(utts) / secs_cli[w]:.1f} utterances/s, "
                        f"{secs_cli[w] * 1e3 / audio_s:.2f} ms per second of "
                        "audio" for w in runs)
            + f" (call to synchronize: the model's load, file reads and "
            f"copies included); launches: bilstm_scan 6 an utterance, no "
            f"other kernel [{smi}]")

        # EmbedNet alone on the card: its time, the longest utterance
        # through the plain scans, and that utterance's six scans
        def enrollment(u):
            a, file_sr = audio_io.read_audio(os.path.join(src, *u))
            a = audio_io.resample(a.mean(0), file_sr, SR)
            return torch.from_numpy(np.stack([a, a])[None]).to(dev)
        x = enrollment(by_len[longest])
        per_s, errs_plain = {}, {}
        with port_utils.full_float32():
            for which in ("reference", "npz"):
                model = ts_hear_test.load_model(port_utils.Params(EMBED_5K),
                                                runs[which], None, dev)
                scan_ops.bilstm_scan_cuda = bilstm_scan_reference
                try:
                    want = model(x)[0].cpu().numpy()
                finally:
                    scan_ops.bilstm_scan_cuda = bilstm_scan_cuda
                split, spk, name = by_len[longest]
                got = np.load(os.path.join(card[which], split,
                                           f"{spk}.npz"))[name]
                peak = float(np.abs(want).max())
                errs_plain[which] = float(np.abs(got - want).max()) / peak
                if not (peak > 0 and errs_plain[which] <= TOL_ENROLL):
                    raise AssertionError(
                        f"{which}, {longest:g} s: the CLI's d-vector vs "
                        f"EmbedNet on the plain scans {errs_plain[which]} of "
                        "the peak")
            # the committed checkpoint's model from here on
            for secs, xs in ((CORPUS_SECONDS,
                              enrollment(by_len[CORPUS_SECONDS])),
                             (longest, x)):
                model(xs)
                per_s[secs] = wall_ms(lambda i: model(xs), 3) / secs
            seen = []
            hooks = [m.register_forward_hook(
                         lambda mod, args, out: seen.append((mod, args[0])))
                     for blk in model.net.trunk.blocks
                     for m in (blk.intra_rnn, blk.inter_rnn)]
            model(x)
            for h in hooks:
                h.remove()
        log(f"  the {longest:g} s utterance on the card, the CLI's d-vector "
            "against EmbedNet with every scan on B2's plain version (on the "
            "card), max|kernel - plain| / peak: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs_plain.items())
            + f" (tolerance {TOL_ENROLL})")
        errs, rows = [], {}
        lstm = torch.nn.LSTM(64, 64, batch_first=True,
                             bidirectional=True).to(dev)
        for i, (mod, a) in enumerate(seen):
            what = f"block {i // 2} {('intra', 'inter')[i % 2]}"
            xp, w_hh = (t.contiguous() for t in bidir_scan_inputs(
                mod.params(), mod.params("_l0_reverse"), a))
            t_, _, bb, g4 = xp.shape
            h = g4 // 4
            got = bilstm_scan_cuda(xp, w_hh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = bilstm_scan_reference(xp, w_hh)
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            tol = TOL_LSTM if t_ <= 97 else TOL_LSTM_LONG
            peak = plain[1].abs().max().item()
            e_ys = (got[0] - plain[0]).abs().max().item()
            e_c = (got[1] - plain[1]).abs().max().item()
            msg = (f"  B2 at the {longest:g} s utterance, {what}, xp {list(xp.shape)}: "
                   f"max|kernel - plain| ys {e_ys:.3e}, c_t {e_c:.3e} "
                   f"(tolerance {tol}, c_t x max(1, peak |c| {peak:.3g}))")
            if i < 2:
                exact = bilstm_scan_reference(xp, w_hh, torch.float64)
                msg += "; from float64: kernel ys {:.3e} c_t {:.3e}, plain " \
                    "ys {:.3e} c_t {:.3e}".format(*(
                        (v[j].double() - exact[j]).abs().max().item()
                        for v in (got, plain) for j in (0, 1)))
            log(msg)
            if not (e_ys <= tol and e_c <= tol * max(1.0, peak)):
                raise AssertionError(f"bilstm_scan differs at {what}: ys "
                                     f"{e_ys}, c_t {e_c}")
            errs.append(max(e_ys, e_c))
            if i >= 2:
                continue
            for _ in range(3):
                bilstm_scan_cuda(xp, w_hh)
            k_ms = device_ms(lambda i: bilstm_scan_cuda(xp, w_hh), 20)
            x_in = torch.randn((bb, t_, 64), device=dev)
            for _ in range(3):
                lstm(x_in)
            l_ms = device_ms(lambda i: lstm(x_in), 10)
            nbytes = 4 * (xp.numel() + w_hh.numel() + t_ * 2 * bb * h
                          + 2 * bb * h)
            flops = t_ * 2 * bb * (2 * h * 4 * h + 4 * h)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
            rows[("intra", "inter")[i]] = row = dict(
                shape=list(xp.shape), ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=errs[-1])
            log(f"  B2 {list(xp.shape)}: kernel {k_ms * 1e3:.1f} us "
                f"({k_ms * 1e3 / t_:.3f} us a step), bound "
                f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP f32; kernel "
                f"{k_ms / row['bound_ms']:.1f}x), plain {p_ms * 1e3:.1f} us, "
                f"cuDNN nn.LSTM(64, 64, bidirectional) {l_ms * 1e3:.1f} us "
                f"[{smi}]")
        log(f"  EmbedNet alone, call to synchronize (median of 3): "
            + ", ".join(f"{v:.2f} ms per second of audio at {k:g} s"
                        for k, v in per_s.items()) + f" [{smi}]")

        # one training step of configs/tsh.json on the written d-vectors
        _, hp = ref_config("tsh")
        args = dict(hp.train_data_args, embed_dir=os.path.join(
            card["npz"], "train-clean-360"))
        ds = port_utils.import_attr(hp.train_dataset)(**args)
        items = [ds[i] for i in range(hp.batch_size)]
        for inputs, targets in items:
            name = os.path.basename(inputs["enrollments_clean_path"][0])
            want = np.load(os.path.join(args["embed_dir"],
                                        name.split("-")[0] + ".npz"))[name]
            if not np.array_equal(targets["embedding_gt"][0], want):
                raise AssertionError(f"embedding_gt of {name} is not the "
                                     "CLI's d-vector")
        task = build_task(hp)
        with tempfile.TemporaryDirectory(prefix="port_dvec_") as tmp_run, \
                port_utils.full_float32(), torch.enable_grad():
            tr = Trainer(task, tmp_run, epochs=1, device=dev)
            batch = to_device(task.device_batch(collate(items), train=True),
                              dev)
            reset_counts()
            loss = tr.train_step(batch, 0)["loss"].item()
            counts = read_counts()
        expect_counts(counts, {"bilstm_scan_fwd_train": 6,
                               "bilstm_scan_bwd": 6}, "tsh.json step")
        if not np.isfinite(loss):
            raise AssertionError(f"tsh.json step on the d-vectors: {loss}")
        log(f"  configs/tsh.json, one train_step at {len(items)} x 5 s on the "
            f"CLI's d-vectors: loss {loss:.4f}; every embedding_gt is the "
            f"CLI's d-vector of its enrollment utterance; launches 6 + 6")

        # the eval from a reference-format checkpoint, card against CPU
        with open(os.path.join(ROOT, "configs", "tsh.json")) as f:
            cfg = json.load(f)
        cfg["test_data_args"] = dict(hp.test_data_args, embed_dir=os.path.join(
            card["npz"], "test-clean"), jams_dir=os.path.join(base, "jams"))
        os.makedirs(cfg["test_data_args"]["jams_dir"])
        for d in sorted(os.listdir(hp.test_data_args["jams_dir"]))[
                :DV_EVAL_SCENES]:
            os.symlink(os.path.join(hp.test_data_args["jams_dir"], d),
                       os.path.join(cfg["test_data_args"]["jams_dir"], d))
        eval_cfg = os.path.join(base, "tsh_eval.json")
        with open(eval_cfg, "w") as f:
            json.dump(cfg, f)
        sd = reference_tse(np.random.default_rng(19))
        csvs, eval_s = [], {}
        for d in ("cuda", "cpu"):
            run_dir = os.path.join(base, f"eval_{d}")
            os.makedirs(run_dir)
            torch.save({"state_dict": {k: torch.from_numpy(v)
                                       for k, v in sd.items()}},
                       os.path.join(run_dir, "best.ckpt"))
            reset_counts()
            t0 = time.perf_counter()
            ts_hear_test.run(ts_hear_test.parse_args(
                ["--config", eval_cfg, "--run_dir", run_dir, "--enroll_config",
                 "", "--enroll_run_dir", "", "--num_workers", "0",
                 "--device", d]))
            eval_s[d] = time.perf_counter() - t0
            if d == "cuda":
                expect_counts(read_counts(), {"bilstm_scan": 3,
                                              "bilstm_scan_fwd_train": 3},
                              "eval from a reference checkpoint")
            csvs.append(eval_check.read_csv(
                os.path.join(run_dir, "results_test_clean.csv")))
        tol = {"si_snr_i": 1e-3, "output_sisnr": 1e-3, "embedding_sim": 1e-5}
        cmp = eval_check.compare(*csvs, tol=tol)
        if cmp["rows"] != DV_EVAL_SCENES or cmp["failures"]:
            raise AssertionError(eval_check.report(cmp))
        log(f"  ts_hear_test from a reference-format Lightning best.ckpt "
            f"({len(sd)} tensors, converted on load), oracle, "
            f"{DV_EVAL_SCENES} test scenes: card {eval_s['cuda']:.1f} s, CPU "
            f"{eval_s['cpu']:.1f} s; every CSV row within {tol}; largest "
            f"deviations {cmp['max_dev']}")

        # --embed_from_wav without resemblyzer
        if importlib.util.find_spec("resemblyzer") is None:
            run_dir = os.path.join(base, "eval_embed_from_wav")
            t0 = time.perf_counter()
            try:
                ts_hear_test.run(ts_hear_test.parse_args(
                    ["--config", eval_cfg, "--run_dir", run_dir,
                     "--enroll_config", EMBED_5K, "--enroll_run_dir",
                     runs["npz"], "--num_workers", "0", "--embed_from_wav"]))
            except ImportError as e:
                if "resemblyzer" not in str(e) or os.path.exists(run_dir):
                    raise
                log(f"  --embed_from_wav: ImportError after "
                    f"{time.perf_counter() - t0:.3f} s, before any work: {e}")
            else:
                raise AssertionError("--embed_from_wav ran without "
                                     "resemblyzer")
        else:
            log("  --embed_from_wav: resemblyzer is installed on this host; "
                "its refusal is not checked")

        # the CPU's runs: every embedding they made, against the card's
        errs_cpu = {}
        for which, pr in procs.items():
            # raise before the watchdog ends the script, so that the
            # finally below stops the process
            out, t_end = done[which].result(timeout=max(
                1.0, DV_LIMIT - 5 - (time.perf_counter() - t_start)))
            cpu_s[which] = t_end - t_cpu
            if pr.returncode:
                raise AssertionError(f"CPU CLI ({which}): rc "
                                     f"{pr.returncode}: {out}")
            cpu_dir = os.path.join(base, f"cpu_{which}")
            for secs in DV_CPU[which]:
                split, spk, name = by_len[secs]
                want = np.load(os.path.join(cpu_dir, split, f"{spk}.npz"))[name]
                got = np.load(os.path.join(card[which], split,
                                           f"{spk}.npz"))[name]
                peak = float(np.abs(want).max())
                err = float(np.abs(got - want).max())
                errs_cpu[f"{which} {secs:g} s"] = err / peak
                if not (peak > 0 and err <= TOL_ENROLL * peak):
                    raise AssertionError(f"{which}, {secs:g} s: card vs CPU "
                                         f"{err} (peak {peak})")
        log("  card vs the CPU's run of the CLI, max|card - CPU| / peak: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs_cpu.items())
            + f" (tolerance {TOL_ENROLL}); the CPU's runs, "
            f"{DV_CPU_THREADS} threads each, beside the card's work: "
            + ", ".join(f"{w} {sum(DV_CPU[w]):g} s of audio in "
                        f"{cpu_s[w]:.1f} s" for w in DV_CPU))
    finally:
        for pr in procs.values():
            if pr.poll() is None:
                pr.kill()
        pool.shutdown()
    res["dvector"] = dict(
        utterances=len(utts), audio_s=audio_s, cli_s=secs_cli,
        ms_per_audio_s=per_s, cpu_rel_err=errs_cpu, cpu_cli_s=cpu_s,
        plain_scans_rel_err=errs_plain, eval_s=eval_s,
        bilstm_scan_longest=rows)


def corpus_phases(torch, smi, res, reset_counts, read_counts, expect_counts,
                  launch_counts, step_ms):
    """The reference configs' training path on a LibriSpeech-format
    corpus made here (the corpora are not in the repository):
      * "data: LibriSpeech-format corpus": `data/prep/synth_corpus.py`
        writes, in a temporary directory laid out as configs/tsh.json
        expects, CORPUS_SPEAKERS speakers x CORPUS_UTTS utterances of
        CORPUS_SECONDS s per split, WHAM!-style noise, d-vectors and every
        CATT room's BRIRs (wav: nothing needs h5py or soundfile); the
        port's generate_jams CLI, run from that directory, writes each
        split's scene specs (one process a split, all at once);
      * "path: d-vector precompute" (`dvector_phase`): the port's
        dvector_embeddings CLI over that corpus and a split of longer
        utterances, on the card against the CPU, then a training step and
        the eval on the d-vectors it wrote;
      * "path: trainer CLI, reference configs": configs/tsh.json and
        configs/embed.json with only the data directories re-pointed and
        hrtf_type CATTRIR (MultiCh reads SOFA, which needs h5py), one
        epoch of 3 training batches of 8 x 5 s and 1 validation batch,
        with the configs' workers; metrics finite, checkpoints that load
        strictly with the committed checkpoints' keys and shapes, the
        pl_logger's tables, and the launches 3 steps and 1 validation
        batch imply;
      * "data: render rate": scenes a second rendered by one process and
        through the configured loader, beside what a training step
        consumes;
      * "path: SeparationTask": one loss-and-backward of the offline
        separator (defaults, 2 channels) on 2 x 1 s separation items on
        the card against the CPU's float32 loss and float64 gradients,
        then 3 training steps at 8 x 5 s from SpeechSeparationDataset
        through the trainer CLI;
      * "losses on the card": every LossFn name but cdpam, and CDPAM from
        a seeded .npz, on the card against the CPU."""
    from lookoncetohear_tpu_torch import trainer as cli
    from lookoncetohear_tpu_torch import utils as port_utils
    from lookoncetohear_tpu_torch.data.loader import batches, collate
    from lookoncetohear_tpu_torch.data.prep.synth_corpus import (SPLITS,
                                                                write_corpus)
    from lookoncetohear_tpu_torch.losses import CDPAM, LossFn
    from lookoncetohear_tpu_torch.models.net import EmbedNet, Net
    from lookoncetohear_tpu_torch.train.trainer import (Trainer, build_task,
                                                        to_device)
    from lookoncetohear_tpu_torch.weights import load_checkpoint, load_npz
    tmp = tempfile.TemporaryDirectory(prefix="port_corpus_")
    root = tmp.name
    dev = torch.device("cuda")

    def corpus():
        c = write_corpus(root, CORPUS_SPEAKERS, CORPUS_UTTS, CORPUS_SECONDS)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "lookoncetohear_tpu_torch.data.prep.generate_jams", "--only",
             split, "--num", str(CORPUS_SCENES[split])], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for split in SPLITS]
        for split, pr in zip(SPLITS, procs):
            out = pr.communicate(timeout=25)[0]
            n = len(os.listdir(c[split]["jams"])) \
                if os.path.isdir(c[split]["jams"]) else 0
            if pr.returncode or n != CORPUS_SCENES[split]:
                raise AssertionError(f"generate_jams {split}: rc "
                                     f"{pr.returncode}, {n} scenes: {out}")
        n_files = sum(len(f) for _, _, f in os.walk(root))
        log(f"  {root}: {len(SPLITS)} splits x {CORPUS_SPEAKERS} speakers x "
            f"{CORPUS_UTTS} utterances of {CORPUS_SECONDS:g} s, noise, "
            f"d-vectors, {len(os.listdir(c['catt']))} CATT rooms; scene "
            f"specs {CORPUS_SCENES}; {n_files} files")
        return c
    c = phase("data: LibriSpeech-format corpus", 15, corpus)

    def ref_config(which):
        """configs/{which}.json with the data directories under the
        corpus and the CATT BRIRs, written beside it; (path, Params)."""
        with open(os.path.join(ROOT, "configs", f"{which}.json")) as f:
            cfg = json.load(f)
        for dset in ("train", "val", "test"):
            a = cfg[f"{dset}_data_args"]
            for k in ("fg_dir", "bg_dir", "jams_dir", "embed_dir"):
                a[k] = os.path.join(root, a[k])
            a.update(hrtf_type="CATTRIR", hrtf_list=c["catt"])
        path = os.path.join(root, f"{which}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        return path, port_utils.Params(path)

    phase("path: d-vector precompute", DV_LIMIT, lambda: dvector_phase(
        torch, smi, root, ref_config, res, reset_counts, read_counts,
        expect_counts))

    cli_secs: dict = {}

    def run_cli(name, cfg, hp, want, run_dir, extra=()):
        """The trainer CLI for one epoch: returns the launch counts read
        after it (its seconds into cli_secs[name]); fails unless the
        kernels launched `want`, the metrics are finite and the
        checkpoints are there."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.run(["--config", cfg, "--run_dir", run_dir, "--epochs", "1",
                 *extra])
        torch.cuda.synchronize()
        secs = cli_secs[name] = time.perf_counter() - t0
        counts = read_counts()
        expect_counts(counts, want, f"{name} trainer CLI")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        nums = [v for r in recs for v in r.values() if isinstance(v, float)]
        if not (len(recs) == 1 and recs[0]["step"] == 3
                and np.isfinite(nums).all()):
            raise AssertionError(f"{name}: metrics {recs}")
        for fn in ("last.ckpt", "best.ckpt", "ckpt_meta.json"):
            if not os.path.exists(os.path.join(run_dir, fn)):
                raise AssertionError(f"{name}: no {fn}")
        workers = min(hp.num_workers, os.cpu_count())
        log(f"  {name}: {secs:.1f} s for 3 training batches of "
            f"{hp.batch_size} x 5 s + 1 validation batch of "
            f"{hp.eval_batch_size}, rendered by {workers} "
            f"workers, checkpoints included; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{smi}]; "
            + ", ".join(f"{k} {v:.4f}" for k, v in recs[0].items()
                        if "/" in k)
            + "; launches: " + ", ".join(f"{k} {counts[k]}" for k in want))
        return counts

    def reference_cli():
        train = {"bilstm_scan_fwd_train": 18, "bilstm_scan_bwd": 18}
        for name, which, ckpt, model_cls, val in (
                # validation keeps no graph: B2 for every BiLSTM, the
                # training forward for the separator's inter-time LSTM;
                # EmbedTask's table logger runs the net a second time
                ("TSETask", "tsh", CKPT, Net,
                 {"bilstm_scan": 3, "bilstm_scan_fwd_train": 3}),
                ("EmbedTask", "embed", EMBED_CKPT, EmbedNet,
                 {"bilstm_scan": 12})):
            cfg, hp = ref_config(which)
            want = dict(train)
            for k, v in val.items():
                want[k] = want.get(k, 0) + v
            run_dir = os.path.join(root, f"run_{which}")
            counts = run_cli(name, cfg, hp, want, run_dir)
            if name == "TSETask":
                # this slice's main path: the kernels line reports its
                # launches of the training kernels
                for k in train:
                    launch_counts[k] = counts[k]
            best = os.path.join(run_dir, "best.ckpt")
            got, ref = load_npz(best), load_npz(ckpt)
            if {k: v.shape for k, v in got.items()} != \
                    {k: v.shape for k, v in ref.items()}:
                raise AssertionError(f"{name}: best.ckpt keys/shapes "
                                     f"differ from {ckpt}")
            mp = hp.pl_module_args["model_params"]
            load_checkpoint(model_cls(**mp, device="cpu"), best)
            tables = sorted(os.listdir(os.path.join(run_dir, "embeddings")))
            want_tables = ["val_epoch0.csv"] + (
                ["val_gt_epoch0.csv"] if name == "EmbedTask" else [])
            if tables != want_tables:
                raise AssertionError(f"{name}: tables {tables}")
            rows = []
            for t in tables:
                with open(os.path.join(run_dir, "embeddings", t)) as f:
                    lines = f.read().splitlines()
                rows.append(len(lines) - 1)
                if rows[-1] != hp.eval_batch_size or \
                        len(lines[1].split(",")) != 257:
                    raise AssertionError(f"{name}: {t} has {rows[-1]} rows")
            log(f"    best.ckpt: {len(got)} tensors, keys and shapes of "
                f"{ckpt.split('/')[-1]}, loads strictly; pl_logger: "
                + ", ".join(f"{t} ({r} rows)" for t, r in zip(tables, rows)))
    phase("path: trainer CLI, reference configs", 80, reference_cli,
          grad=True)

    def render_rate():
        """Items a second: one process over the training split once; then
        RATE_ROUNDS batches per worker of the configs' size through the
        configured number of loader workers (the split's indices over
        again: a training item draws anew each time). The workers start
        together and take their batches in turn, so the first round ends
        after their start; the loader's rate is taken from the end of the
        second round to the end of the last, when every worker has been
        rendering throughout."""
        _, hp = ref_config("tsh")
        ds = port_utils.import_attr(hp.train_dataset)(**hp.train_data_args)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        one = len(ds) / (time.perf_counter() - t0)
        workers = min(hp.num_workers, os.cpu_count())
        bs = hp.batch_size
        n_batches = RATE_ROUNDS * workers
        order = [[(k * bs + j) % len(ds) for j in range(bs)]
                 for k in range(n_batches)]
        t0 = time.perf_counter()
        arrived = []
        for _ in batches(ds, num_workers=workers, batch_sampler=order):
            arrived.append(time.perf_counter())
        if len(arrived) != n_batches:
            raise AssertionError(f"loader: {len(arrived)} of {n_batches} "
                                 "batches")
        t_a, t_b = arrived[2 * workers - 1], arrived[-1]
        rate = (n_batches - 2 * workers) * bs / (t_b - t_a)
        used = {k: bs / (v / 1e3) for k, v in step_ms.items()}
        log(f"  MixLibriSpeechNoisyEnroll train items (two 5 s scenes "
            f"each, CATT BRIRs of RT60 + 50 ms): {one:.1f} / s in one "
            f"process over {len(ds)}; through the loader's {workers} "
            f"workers the first batch of {bs} in {arrived[0] - t0:.1f} s "
            f"(the workers' start), then {rate:.1f} / s over rounds 3-"
            f"{RATE_ROUNDS} ({n_batches - 2 * workers} batches in "
            f"{t_b - t_a:.1f} s; {n_batches * bs / (t_b - arrived[0]):.1f}"
            f" / s counted from the first batch); a training step at {bs} "
            "items consumes "
            + ", ".join(f"{v:.1f} / s ({k})" for k, v in used.items())
            + f" [{smi}]")
    phase("data: render rate", 50, render_rate)

    def loader_rate(ds, bs, workers):
        """Items a second through `batches` with `workers` workers,
        RATE_ROUNDS batches of `bs` a worker (the split's indices over
        again), taken from the end of the second round to the end of the
        last; and the first batch's wait."""
        n_batches = RATE_ROUNDS * workers
        order = [[(k * bs + j) % len(ds) for j in range(bs)]
                 for k in range(n_batches)]
        t0 = time.perf_counter()
        arrived = []
        for _ in batches(ds, num_workers=workers, batch_sampler=order):
            arrived.append(time.perf_counter())
        if len(arrived) != n_batches:
            raise AssertionError(f"loader: {len(arrived)} of {n_batches} "
                                 "batches")
        t_a, t_b = arrived[2 * workers - 1], arrived[-1]
        return (n_batches - 2 * workers) * bs / (t_b - t_a), arrived[0] - t0

    def prerender_cli():
        """configs/tsh.json through the trainer CLI with `--prerender`
        (as "path: trainer CLI, reference configs", one epoch of 3
        training batches and 1 validation batch): the first run renders
        the train and val splits into the cache with the configs'
        workers, a second run in a fresh run dir reads them; each
        launches what the uncached run did. A cached validation batch
        equals a fresh render of the same indices, bit for bit (the
        validation items depend on their index alone; training items draw
        from the global random streams, so the cache freezes one render
        of each). Then the cache's read rate through the configs'
        loader workers."""
        import logging

        from lookoncetohear_tpu_torch.data.prep.prerender import (
            DEVICE_KEYS_IN, DEVICE_KEYS_TGT, PrerenderedDataset)
        cfg, hp = ref_config("tsh")
        want = {"bilstm_scan_fwd_train": 21, "bilstm_scan_bwd": 18,
                "bilstm_scan": 3}
        cache = os.path.join(root, "prerendered")
        renders = []

        class Renders(logging.Handler):
            def emit(self, record):
                if record.getMessage().startswith("prerender "):
                    renders.append(record.getMessage())
        # the CLI logs each split's render time at INFO: only here
        saved = logging.root.handlers[:], logging.root.level
        logging.root.handlers[:] = [Renders()]
        logging.root.setLevel(logging.INFO)
        try:
            run_cli("TSETask, --prerender (renders)", cfg, hp, want,
                    os.path.join(root, "run_cached1"),
                    ["--prerender", cache])
            rendered = list(renders)
            run_cli("TSETask, --prerender (reads)", cfg, hp, want,
                    os.path.join(root, "run_cached2"),
                    ["--prerender", cache])
        finally:
            logging.root.handlers[:], level = saved
            logging.root.setLevel(level)
        if len(rendered) != 2 or len(renders) != 4:
            raise AssertionError(f"renders: {renders}")
        n = {sp: len(os.listdir(os.path.join(cache, sp)))
             for sp in ("train", "val")}
        if n != {"train": CORPUS_SCENES["train-clean-360"],
                 "val": CORPUS_SCENES["dev-clean"]}:
            raise AssertionError(f"cache holds {n}")
        # a cached validation batch == a fresh render
        val = port_utils.import_attr(hp.val_dataset)(**hp.val_data_args)
        cached = PrerenderedDataset(os.path.join(cache, "val"))
        task = build_task(hp)
        idx = range(hp.eval_batch_size)
        fresh = [val[i] for i in idx]
        for i in idx:
            inp, tgt = cached[i]
            for keys, got, ref in ((DEVICE_KEYS_IN, inp, fresh[i][0]),
                                   (DEVICE_KEYS_TGT, tgt, fresh[i][1])):
                for k in keys:
                    if k in ref and not np.array_equal(got[k],
                                                       np.asarray(ref[k])):
                        raise AssertionError(f"cached val item {i}: {k}")
        db_c = task.device_batch(collate([cached[i] for i in idx]))
        db_f = task.device_batch(collate(fresh))
        if sorted(db_c) != sorted(db_f) or not all(
                np.array_equal(db_c[k], db_f[k]) for k in db_f):
            raise AssertionError("a cached batch differs from a fresh one")
        workers = min(hp.num_workers, os.cpu_count())
        train = PrerenderedDataset(os.path.join(cache, "train"))
        rate, first = loader_rate(train, hp.batch_size, workers)
        # each shard once from storage: in one process through the
        # dataset, then its bytes by `workers` threads at once
        shards = [os.path.join(train.root, f) for f in train.files]
        mb = sum(os.path.getsize(f) for f in shards) / 1e6
        left = drop_from_page_cache(shards)
        t0 = time.perf_counter()
        for i in range(len(train)):
            train[i]
        one_s = time.perf_counter() - t0
        left = max(left, drop_from_page_cache(shards))

        def read(path):
            with open(path, "rb") as f:
                return len(f.read())
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as ex:
            got = sum(ex.map(read, shards))
        par_s = time.perf_counter() - t0
        if got != round(mb * 1e6):
            raise AssertionError(f"read {got} bytes of {mb * 1e6:.0f}")
        n_sh = len(shards)
        log(f"  render: {'; '.join(rendered)}; a cached validation batch "
            f"of {hp.eval_batch_size} == a fresh render, bit for bit "
            f"({len(db_f)} device-batch arrays); the train cache, {n_sh} "
            f"shards, {mb:.1f} MB, each read once after dropping it from "
            f"the page cache ({left:.3f} of its pages still resident): "
            f"{n_sh / one_s:.1f} items/s, {mb / one_s:.1f} MB/s in one "
            f"process through PrerenderedDataset; {n_sh / par_s:.1f} "
            f"items/s, {mb / par_s:.1f} MB/s by {workers} threads (bytes "
            f"only); through {workers} loader workers from the page cache "
            f"(each shard read {RATE_ROUNDS * workers * hp.batch_size / n_sh:.0f} "
            f"times): {rate:.1f} items/s over rounds 3-"
            f"{RATE_ROUNDS}, first batch after {first:.1f} s; epoch of 3 + "
            f"1 batches: {cli_secs['TSETask, --prerender (renders)']:.1f} s "
            f"rendering the cache, "
            f"{cli_secs['TSETask, --prerender (reads)']:.1f} s reading it, "
            f"{cli_secs['TSETask']:.1f} s uncached (\"path: trainer CLI, "
            f"reference configs\") [{smi}]")
    phase("path: trainer CLI, --prerender", 84, prerender_cli, grad=True)

    def moving_sources():
        """The native renderer on the card's host: the known-delay case
        of tests/test_motion.py (direction 3 of a delta IR set delays left
        by 3 and right by 6 samples), then a batch of the configs' 8
        training items of MixLibriSpeechNoisyEnroll with CIPIC_MOTION
        (arcs of each source, a face-to-face enrollment) over an IR set
        made here, handed to the simulator with set_hrtf_arrays (the
        card's host may lack h5py); the render rate in one process; and
        MOTION_STEPS TSE training steps of configs/tsh.json's model on
        that batch. Where h5py imports, MixLibriSpeechMotion also runs
        over SOFA files of the same IR set."""
        from lookoncetohear_tpu_torch.data import motion
        from lookoncetohear_tpu_torch.data.datasets import \
            MixLibriSpeechNoisyEnroll
        sr = 16000
        delta = np.zeros((8, 2, 32), np.float32)
        pos = np.zeros((8, 3), np.float32)
        for m in range(8):
            delta[m, 0, m] = delta[m, 1, 2 * m] = 1.0
            az = -np.pi / 2 + np.pi * m / 7
            pos[m] = [np.cos(az), np.sin(az), 0.0]
        sim = motion.MotionSimulator(sr)
        sim.set_hrtf_arrays(delta, pos)
        a = np.random.default_rng(1).standard_normal(sr // 2).astype(
            np.float32)
        sim.add_source(a, np.tile(pos[3], (21, 1)))
        out = sim.simulate()
        d_err = max(np.abs(out[0, 0, 3:] - a[:-3]).max(),
                    np.abs(out[0, 1, 6:] - a[:-6]).max())
        if not d_err <= 1e-5:
            raise AssertionError(f"known delay: {d_err}")
        # the IR set: MOTION_DIRS azimuths at elevations 0 and 30 degrees,
        # an interaural delay and level from the azimuth, a decaying tail
        g = np.random.default_rng(2)
        az = np.repeat(np.linspace(-180, 180, MOTION_DIRS, endpoint=False),
                       2)
        el = np.tile([0.0, 30.0], MOTION_DIRS)
        irs = np.zeros((2 * MOTION_DIRS, 2, MOTION_IR), np.float32)
        for m in range(2 * MOTION_DIRS):
            lag = int(round(8 * np.sin(np.deg2rad(az[m]))))
            irs[m, 0, 8 + lag] = 1.0 - 0.3 * np.sin(np.deg2rad(az[m]))
            irs[m, 1, 8 - lag] = 1.0 + 0.3 * np.sin(np.deg2rad(az[m]))
            irs[m, :, 17:] = 0.05 * g.standard_normal((2, MOTION_IR - 17)) \
                * np.exp(-np.arange(MOTION_IR - 17) / 12.0)
        cart = np.stack([np.cos(np.deg2rad(el)) * np.cos(np.deg2rad(az)),
                         np.cos(np.deg2rad(el)) * np.sin(np.deg2rad(az)),
                         np.sin(np.deg2rad(el))], 1).astype(np.float32)
        mdir = os.path.join(root, "motion_hrtf")
        os.makedirs(mdir, exist_ok=True)
        names = ["subject_0.sofa", "subject_1.sofa"]
        listfile = os.path.join(mdir, "list.txt")
        with open(listfile, "w") as f:
            f.write("\n".join(names))
        _, hp = ref_config("tsh")
        args = dict(hp.train_data_args, hrtf_type="CIPIC_MOTION",
                    hrtf_list=listfile, use_motion=True)
        ds = MixLibriSpeechNoisyEnroll(**args)
        rsim = ds.simulator._simulator
        rsim.set_hrtf = lambda path: rsim.set_hrtf_arrays(irs, cart)
        bs = hp.batch_size
        t0 = time.perf_counter()
        items = [ds[i] for i in range(bs)]
        rate = bs / (time.perf_counter() - t0)
        vel = np.array([float(i[0]["tgt_ang_vel"]) for i in items])
        mix = np.stack([i[0]["mixture"] for i in items])
        if not (mix.shape == (bs, 2, 5 * sr) and np.isfinite(mix).all()
                and np.isfinite(vel).all() and np.abs(vel).max() > 0):
            raise AssertionError(f"motion items: {mix.shape}, {vel}")
        sofa = "not run: no h5py on this host"
        try:
            import h5py
        except ImportError:
            h5py = None
        if h5py is not None:
            for n_ in names:
                with h5py.File(os.path.join(mdir, n_), "w") as f:
                    f.create_dataset("Data.IR", data=irs)
                    f.create_dataset("Data.SamplingRate",
                                     data=np.array([float(sr)]))
                    d = f.create_dataset("SourcePosition", data=np.stack(
                        [az, el, np.ones_like(az)], 1))
                    d.attrs["Type"] = "spherical"
            from lookoncetohear_tpu_torch.data.dataset_variants import \
                MixLibriSpeechMotion
            mds = MixLibriSpeechMotion(**dict(
                hp.val_data_args, hrtf_list=listfile,
                hrtf_type="CIPIC_MOTION"))
            m_items = [mds[i] for i in range(2)]
            if not all(np.isfinite(i[0]["mixture"]).all()
                       and i[0]["mixture"].shape == (2, 5 * sr)
                       for i in m_items):
                raise AssertionError("MixLibriSpeechMotion items")
            sofa = (f"ran: MixLibriSpeechMotion over {len(names)} SOFA files, "
                    f"{len(m_items)} validation items finite")
        # training steps of tsh.json's model on the moving-source batch
        task = build_task(hp)
        with tempfile.TemporaryDirectory(prefix="port_motion_") as tmp_run, \
                port_utils.full_float32():
            tr = Trainer(task, tmp_run, epochs=1, device=dev)
            batch = to_device(task.device_batch(collate(items), train=True),
                              dev)
            reset_counts()
            ms, losses = [], []
            for _ in range(MOTION_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(tr.train_step(batch, 0)["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
        expect_counts(counts, {"bilstm_scan_fwd_train": 6 * MOTION_STEPS,
                               "bilstm_scan_bwd": 6 * MOTION_STEPS},
                      "moving-source training steps")
        if not np.isfinite(losses).all():
            raise AssertionError(f"losses {losses}")
        log(f"  known delay (3 / 6 samples) on this host: max err "
            f"{d_err:.1e}; MixLibriSpeechNoisyEnroll with CIPIC_MOTION, "
            f"{2 * MOTION_DIRS} directions x {MOTION_IR} taps through "
            f"set_hrtf_arrays: {bs} train items (two 5 s scenes each, "
            f"moving sources) at {rate:.2f} items/s in one process, "
            f"target angular velocities {np.round(vel, 1).tolist()} deg/s; "
            f"SOFA path {sofa}; {MOTION_STEPS} TSE steps of tsh.json's "
            f"model at {bs} x 5 s: losses "
            f"{[round(v, 4) for v in losses]}, "
            f"{np.median(ms[1:]):.1f} ms a step after the first; launches "
            + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
            + f" [{smi}]")
    phase("path: moving sources", 8, moving_sources, grad=True)

    def separation():
        cfg, hp = ref_config("tsh")
        sep = {"pl_module": "lookoncetohear_tpu.train.tasks.SeparationTask",
               "pl_module_args": {
                   "model": "src.models.tfgridnet_orig.tfgridnet.Net",
                   "model_params": {"num_ch": 2}, "lr": 5e-4,
                   "scheduler": hp.pl_module_args["scheduler"],
                   "scheduler_params": hp.pl_module_args["scheduler_params"]},
               "epochs": 1, "batch_size": hp.batch_size,
               "eval_batch_size": hp.eval_batch_size,
               "num_workers": hp.num_workers}
        for dset in ("train", "val", "test"):
            sep[f"{dset}_dataset"] = \
                "src.datasets.SpeechSeparationDataset.SpeechSeparationDataset"
            sep[f"{dset}_data_args"] = getattr(hp, f"{dset}_data_args")
        sep_cfg = os.path.join(root, "separation.json")
        with open(sep_cfg, "w") as f:
            json.dump(sep, f)
        shp = port_utils.Params(sep_cfg)
        per_step = {"bilstm_scan_fwd_train": 12, "bilstm_scan_bwd": 12}
        # one step on the card against the CPU, as "path: train step GPU
        # vs CPU" holds the other tasks
        ds = port_utils.import_attr(shp.val_dataset)(**shp.val_data_args)
        host = collate([ds[i] for i in range(TRAIN_CHECK_BATCH)])
        n = int(TRAIN_CHECK_SECONDS * 16000)
        host = ({"mixture": host[0]["mixture"][..., :n]},
                {k: host[1][k][..., :n] for k in ("target1", "target2")})
        out = {}
        for d, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                      ("cpu64", torch.float64),
                      ("perturbed", torch.float64)):
            task = build_task(shp)
            dev_ = d if d == "cuda" else "cpu"
            model = task.model.to(dev_, dt)
            batch = {k: v.to(dt) for k, v in to_device(
                task.device_batch(host, train=True), dev_).items()}
            if d == "perturbed":
                # SEP_GRAD_NOTE's witness: float64 on a nearby input
                gen = torch.Generator().manual_seed(0)
                noise = torch.randn(batch["mixture"].shape, dtype=dt,
                                    generator=gen)
                batch["mixture"] = batch["mixture"] * (1 + SEP_PERTURB
                                                       * noise)
            reset_counts()
            with port_utils.full_float32():
                loss, _ = task.loss_and_metrics(batch, 0)
                loss.backward()
            if d == "cuda":
                torch.cuda.synchronize()
                counts = read_counts()
            out[d] = (loss.item(), {k: p.grad.cpu().double() for k, p in
                                    model.named_parameters()})
        expect_counts(counts, per_step, "SeparationTask step")
        (l_gpu, g_gpu), (l_cpu, g_cpu), (l_64, g_64) = \
            out["cuda"], out["cpu"], out["cpu64"]
        if not (np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= TOL_TRAIN_LOSS
                * max(1.0, abs(l_cpu))):
            raise AssertionError(f"SeparationTask: loss {l_gpu} vs {l_cpu}")
        floor = 1e-3 * max(g.abs().max().item() for g in g_64.values())

        def spread(grads):
            """Per tensor, |grads - float64| / max(peak, floor)."""
            return {k: (grads[k] - g).abs().max().item()
                    / max(g.abs().max().item(), floor)
                    for k, g in g_64.items()}
        gpu, cpu, moved = spread(g_gpu), spread(g_cpu), \
            spread(out["perturbed"][1])

        def beyond(d):
            return (sum(v > TOL_TRAIN_GRAD for v in d.values()),
                    max(d.values()))
        bad = [k for k, g in g_gpu.items() if not torch.isfinite(g).all()]
        n_gpu, max_gpu = beyond(gpu)
        if bad or max_gpu > SEP_GRAD_CAP or n_gpu > SEP_MAX_UNRESOLVED:
            raise AssertionError(
                f"SeparationTask: {n_gpu} gradients beyond {TOL_TRAIN_GRAD} "
                f"of max(peak, floor) from float64 (at most "
                f"{SEP_MAX_UNRESOLVED}), at most {max_gpu:.3e} (limit "
                f"{SEP_GRAD_CAP}); not finite: {bad}; worst: "
                + ", ".join(f"{k} {v:.3e}" for k, v in sorted(
                    gpu.items(), key=lambda kv: -kv[1])[:8]))
        worst = sorted(gpu, key=gpu.get, reverse=True)[:3]
        (n_cpu, max_cpu), (n_moved, max_moved) = beyond(cpu), beyond(moved)
        log(f"  SeparationTask, OfflineSeparatorNet(num_ch=2), "
            f"{TRAIN_CHECK_BATCH} x {TRAIN_CHECK_SECONDS:g} s: loss GPU "
            f"{l_gpu:.6f} CPU {l_cpu:.6f} float64 {l_64:.6f}; of "
            f"{len(g_64)} gradients, beyond {TOL_TRAIN_GRAD} of max(peak, "
            f"floor) from float64 (count, largest): the card {n_gpu}, "
            f"{max_gpu:.3e} (at most {SEP_MAX_UNRESOLVED}, {SEP_GRAD_CAP}); "
            f"the CPU's float32 {n_cpu}, {max_cpu:.3e}; float64 on the "
            f"input times (1 + {SEP_PERTURB:g} N(0, 1)) {n_moved}, "
            f"{max_moved:.3e}; the card's worst: "
            + ", ".join(f"{k} {gpu[k]:.3e} (CPU float32 {cpu[k]:.3e})"
                        for k in worst)
            + "; launches: " + ", ".join(f"{k} {counts[k]}"
                                         for k in per_step))
        # 3 steps at 8 x 5 s through the CLI; validation keeps no graph
        want = {k: 3 * v for k, v in per_step.items()}
        want["bilstm_scan"] = 12
        run_cli("SeparationTask", sep_cfg, shp, want,
                os.path.join(root, "run_separation"))
        # the step's own time: 3 steps on one batch of 8 x 5 s, the first
        # apart (a seeded model, as the CLI builds it)
        task = build_task(shp)
        train = port_utils.import_attr(shp.train_dataset)(
            **shp.train_data_args)
        host = collate([train[i] for i in range(shp.batch_size)])
        with tempfile.TemporaryDirectory(prefix="port_sep_") as tmp_run, \
                port_utils.full_float32():
            tr = Trainer(task, tmp_run, epochs=1, device=dev)
            batch = to_device(task.device_batch(host, train=True), dev)
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_step(batch, 0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        gib, total = 2 ** 30, torch.cuda.get_device_properties(0).total_memory
        log(f"  SeparationTask step, {shp.batch_size} x 5 s: "
            f"{np.median(ms[1:]):.1f} ms from call to synchronize (median "
            f"of 2 after the first, {ms[0]:.1f} ms first), peak allocated "
            f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB, reserved "
            f"{torch.cuda.max_memory_reserved() / gib:.2f} GiB of the "
            f"card's {total / gib:.2f} GiB [{smi}]")
    phase("path: SeparationTask", 105, separation, grad=True)

    def losses_card():
        g = np.random.default_rng(5)
        est, gt, noise = (g.standard_normal((2, 2, 16000)).astype(np.float32)
                          for _ in range(3))
        cases = [(n, (est, gt), {}) for n in ("sisdr", "snr", "sdsdr",
                                               "snr_sdsdr", "fused", "mel",
                                               "l1_mel")]
        cases += [("sisdr_with_sum", (est, gt),
                   dict(noise_estimate=noise, mixture=est + noise)),
                  ("pit_sisdr", (None, None),
                   dict(est1=est, est2=noise, gt1=gt, gt2=est + noise))]
        msg = []
        for name, args, kw in cases:
            vals = []
            for d in ("cuda", "cpu"):
                t = lambda a: None if a is None else \
                    torch.from_numpy(a).to(d)  # noqa: E731
                v = LossFn(name)(*map(t, args),
                                 **{k: t(a) for k, a in kw.items()})
                vals.append((v[0] if isinstance(v, tuple) else v).item())
            err = abs(vals[0] - vals[1])
            if not (np.isfinite(vals[0]) and err <= TOL_LOSSES
                    * max(1.0, abs(vals[1]))):
                raise AssertionError(f"LossFn({name}): GPU {vals[0]} CPU "
                                     f"{vals[1]}")
            msg.append(f"{name} {vals[0]:.5g} ({err:.1e})")
        path = os.path.join(root, "cdpam.npz")
        CDPAM(seed=0).save(path)
        fn = CDPAM(weights=path)
        x, y = (torch.from_numpy(a.reshape(4, -1)) for a in (est, gt))
        d_gpu = fn(x.to(dev), y.to(dev)).item()
        d_cpu = fn(x, y).item()
        if not abs(d_gpu - d_cpu) <= TOL_LOSSES * max(abs(d_cpu), 1e-6):
            raise AssertionError(f"CDPAM: GPU {d_gpu} CPU {d_cpu}")
        log(f"  2 x 2 x 1 s, GPU (|GPU - CPU|, tolerance {TOL_LOSSES} of "
            f"max(1, |CPU|)): {', '.join(msg)}; CDPAM from a seeded .npz "
            f"{d_gpu:.6g} (CPU {d_cpu:.6g}, tolerance {TOL_LOSSES} "
            "relative)")
    phase("losses on the card", 10, losses_card)
    tmp.cleanup()


def default_net_phase(torch, smi, res, launch_counts, reset_counts,
                      read_counts, expect_counts):
    """The reference's default `Net` (`Net()`: chunk 160 + pad 120, F =
    141 bins, 6 blocks, H = 128, no attention) on the card, its weights
    a seeded init of the port (no checkpoint has this shape); every
    LSTM recurrence on the H = 128 kernels of `csrc/bilstm_scan.cu`:
      * what ptxas reported for them, and each tile's (R rows, clusters
        of C CTAs) build and the clusters the card holds at once;
      * B2 at H = 128 against its plain version at the 64-stream step's
        [141, 2, 64, 512], the full forward's [141, 2, 500, 512] and a
        tail [141, 2, 13, 512] (TOL_LSTM); the training forward at the
        full forward's and the eval's inter-time scans (N=141 and 564,
        T=500, D=1) from (h0, c0) and both directions (N=64, T=141, D=2)
        from zero, each saving every c and every step's gates and
        neither (the same y and c_T bit for bit), at TOL_LSTM_LONG of
        the peak (over 97 steps); each
        through its wrapper and through its C entry at every tile (R, C)
        the wrapper can pick;
      * 4 streams in float32, the GPU engine against the CPU engine,
        each step from the same state, TOL_PATH of the peak;
      * 64 streams, the CUDA-graph engine against the eager one at
        float32 and bf16, output and every state leaf bit for bit after
        every step, through the masked graph (no slot primed at step 0,
        an `add_stream` at step 4, slot 9 removed from step 7); the
        eager steps launch 6 B2 a step and no other kernel of the port;
      * the full forward (`Net.forward`) on the GPU against the CPU over
        DEFAULT_CPU_SECONDS (6 + 6 launches a call, nothing else), and
        the streamed graph engine against the full forward on the card;
      * times by CUDA events: each kernel, its plain version and cuDNN's
        `nn.LSTM(hidden_size=128)` over the same rows and steps (input
        width 64), beside two bounds: float32 FMAs at 67 TFLOP/s and the
        kernels' own three TF32 products at 495 TFLOP/s (the kernels line
        takes the latter, the operations they run); the engine step at
        float32 and bf16, graph and eager (RTF of the 10 ms chunk), the
        graph step's profile; the full
        forward over DEFAULT_FULL_SECONDS."""
    import ctypes
    from lookoncetohear_tpu_torch import _build
    from lookoncetohear_tpu_torch.models.net import Net
    from lookoncetohear_tpu_torch.ops.bilstm_scan import (
        H128_TILE_COST, bilstm_scan_cuda, bilstm_scan_reference,
        bilstm_scan_train_cuda, bilstm_train_reference, tile_h128)
    from lookoncetohear_tpu_torch.serve.engine import (WARMUP_STEPS,
                                                       StreamingEngine)
    from lookoncetohear_tpu_torch.timing import device_ms, wall_ms
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    lib = _build.load_library()

    def rnd(*shape, k=0.5):
        return torch.randn(shape, generator=g, device=dev) * k

    # the build: what ptxas said of each H=128 kernel (its entry line,
    # then its properties, stack and spills, registers)
    lines = _build.last_build.get("ptxas", [])
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "bilstm_h128" in line:
            for shown in lines[i:i + 4]:
                log(f"  {shown}")
    for kname, train in (("B2", 0), ("training forward", 1)):
        for r, cl in H128_TILE_COST:
            out = (ctypes.c_int * 6)()
            _build.check(lib.bilstm_h128_info(r, cl, train, out),
                         "bilstm_h128_info")
            log(f"  H=128 {kname}, tile of {r} rows over {cl} CTAs: "
                f"{out[0]} threads, {out[2]} registers, {out[3]} B spilled, "
                f"{out[1]} B shared memory, {out[4]} clusters at once, "
                f"{out[5]} CTAs an SM")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = (lambda v: None if v is None else v.data_ptr())  # noqa: E731

    # the kernels against their plain versions
    errs = {"bilstm_scan_h128": 0.0, "bilstm_scan_fwd_train_h128": 0.0}
    scans = {}
    for key, b in H128_SCANS.items():
        xp, w_hh = rnd(141, 2, b, 512), rnd(2, 128, 512, k=0.2)
        runs = [bilstm_scan_cuda(xp, w_hh)]
        for tile in H128_TILE_COST:
            out = (torch.empty_like(runs[0][0]), torch.empty_like(runs[0][1]))
            _build.check(lib.bilstm_scan_h128_f32(
                ptr(xp), ptr(w_hh), ptr(out[0]), ptr(out[1]), 141, b, *tile,
                stream), "bilstm_scan_h128_f32")
            runs.append(out)
        rys, rc = bilstm_scan_reference(xp, w_hh)
        torch.cuda.synchronize()
        err = max(max((ys - rys).abs().max().item(),
                      (c_t - rc).abs().max().item()) for ys, c_t in runs)
        log(f"  B2 at H=128 {list(xp.shape)}, tile "
            f"{tile_h128(b, 2, dev, 'b2')} and through the C entry at every "
            f"tile: max|kernel - plain| = {err:.3e} (tolerance {TOL_LSTM})")
        if not err <= TOL_LSTM:
            raise AssertionError(f"B2 at H=128 differs: {err}")
        errs["bilstm_scan_h128"] = max(errs["bilstm_scan_h128"], err)
        scans[key] = (xp, w_hh)
    for key, (t_, nd, n, carried) in H128_TRAIN.items():
        xp, w_hh = rnd(n, t_, nd * 512), rnd(nd, 128, 512, k=0.2)
        h0, c0 = (rnd(nd, n, 128), rnd(nd, n, 128)) if carried \
            else (None, None)
        got = bilstm_scan_train_cuda(xp, w_hh, h0, c0, save_gates=True)
        lean = bilstm_scan_train_cuda(xp, w_hh, h0, c0, save_cs=False)
        runs = [got]
        for tile in H128_TILE_COST:
            out = tuple(torch.empty_like(v) for v in got)
            _build.check(lib.bilstm_train_fwd_h128_f32(
                ptr(xp), ptr(w_hh), ptr(h0), ptr(c0), ptr(out[0]),
                ptr(out[2]), ptr(out[3]), ptr(out[1]), t_, nd, n, *tile,
                stream), "bilstm_train_fwd_h128_f32")
            runs.append(out)
        want = bilstm_train_reference(xp, w_hh, torch.float32, h0, c0,
                                      with_cs=True, with_gates=True)
        torch.cuda.synchronize()
        err = max((a - e).abs().max().item() / max(1.0, e.abs().max().item())
                  for run in runs for a, e in zip(run, want))
        log(f"  training forward at H=128 (T={t_}, D={nd}, N={n}"
            f"{', from h0/c0' if carried else ''}), tile "
            f"{tile_h128(n, nd, dev, 'fwd')} and through the C entry at "
            f"every tile: max|kernel - plain| / max(1, peak) over y, c_T, "
            f"cs and the gates = {err:.3e} (tolerance {TOL_LSTM_LONG}); "
            f"without cs and the gates y and c_T bit for bit")
        if not (err <= TOL_LSTM_LONG and lean[2] is None
                and torch.equal(lean[0], got[0])
                and torch.equal(lean[1], got[1])):
            raise AssertionError(f"training forward at H=128 differs: {err}")
        errs["bilstm_scan_fwd_train_h128"] = max(
            errs["bilstm_scan_fwd_train_h128"], err)
        scans[key] = (xp, w_hh, h0, c0)
    for k, v in errs.items():
        res[k] = dict(max_abs_err=v)

    # the model: a seeded init, the same weights on the card and the CPU
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(14)
        net_cpu = Net(device="cpu").eval()
    sd = net_cpu.state_dict()
    net_gpu = Net()
    net_gpu.load_state_dict(sd)
    net_gpu.eval()
    c = net_gpu.stft_chunk_size
    if (c, net_gpu.nfft, net_gpu.tfgridnet.n_freqs,
            net_gpu.tfgridnet.n_layers, net_gpu.tfgridnet.lstm_hidden_units,
            net_gpu.tfgridnet.use_attn) != (160, 280, 141, 6, 128, False):
        raise AssertionError("Net() is not the reference's default Net")
    rng = np.random.default_rng(14)
    emb = rng.standard_normal((DEFAULT_STREAMS, 256)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)

    def audio(n_streams, n_samples, seed):
        """Binaural audio: a tone per stream plus noise, the right ear a
        few samples late."""
        gg = np.random.default_rng(seed)
        t = np.arange(n_samples) / 16000.0
        src = np.sin(2 * np.pi * gg.uniform(120, 400, (n_streams, 1)) * t)
        x = np.stack([src, np.roll(src, 3, axis=-1)], axis=1) * 0.3
        return (x + 0.05 * gg.standard_normal(x.shape)).astype(np.float32)

    def chunks(n_streams, n_steps, seed):
        x = audio(n_streams, n_steps * c, seed)
        return x.reshape(n_streams, 2, n_steps, c).transpose(2, 0, 1, 3)

    def leaves(eng):
        yield "input_tail", eng.input_tail
        for k in ("conv_buf", "deconv_buf", "istft_buf"):
            yield k, eng.state[k]
        for i, blk in enumerate(eng.state["blocks"]):
            for k in sorted(blk):
                yield f"blocks.{i}.{k}", blk[k]

    # 4 streams, GPU engine vs CPU engine, each step from the same state
    n, steps = 4, 6
    engines = [StreamingEngine(net_cpu, sd, max_streams=n, device=d,
                               cuda_graph=False) for d in ("cuda", "cpu")]
    for eng in engines:
        for s in range(n):
            eng.add_stream(s, emb[s])
    worst = 0.0
    reset_counts()
    for x in chunks(n, steps, 1):
        for (_, gl), (_, cl) in zip(*map(leaves, engines)):
            gl.copy_(cl)
        y_gpu, y_cpu = (eng.step(x).float().cpu().numpy() for eng in engines)
        peak = float(np.abs(y_cpu).max())
        err = float(np.abs(y_gpu - y_cpu).max())
        if not (np.isfinite(y_gpu).all() and err <= TOL_PATH * max(peak,
                                                                   1e-3)):
            raise AssertionError(f"GPU vs CPU engine: {err} (peak {peak})")
        worst = max(worst, err / max(peak, 1e-3))
        for (name, gl), (_, cl) in zip(*map(leaves, engines)):
            if float((gl.cpu() - cl).abs().max()) > TOL_STATE * max(
                    1.0, float(cl.abs().max())):
                raise AssertionError(f"{name}: GPU state differs")
    expect_counts(read_counts(), {
        "bilstm_scan_h128": 6 * steps,
        "flat_norm": FLAT_NORMS["default_net"] * steps},
        "default Net, GPU engine")
    if peak == 0.0:
        raise AssertionError("engine output is all zeros")
    log(f"  4 streams x {steps} steps, float32, each step from the same "
        f"state: max|GPU - CPU| / peak = {worst:.3e} (tolerance "
        f"{TOL_PATH}); state within {TOL_STATE}; launches: "
        f"bilstm_scan_h128 {6 * steps} (6 blocks a step), flat_norm "
        f"{FLAT_NORMS['default_net'] * steps}, nothing else")
    del engines

    # 64 streams: the graph engine against the eager engine, bit for bit
    xs = torch.from_numpy(chunks(DEFAULT_STREAMS, DEFAULT_STEPS, 2)).to(dev)
    graphs = {}
    for label, dtype in (("float32", torch.float32),
                         ("bf16", torch.bfloat16)):
        engs = [StreamingEngine(net_gpu, sd, max_streams=DEFAULT_STREAMS,
                                dtype=dtype, cuda_graph=gr)
                for gr in (False, True)]
        for eng in engs:
            for s in range(DEFAULT_STREAMS):
                eng.add_stream(s, emb[s])
        x = xs.to(dtype)
        reset_counts()
        for i in range(DEFAULT_STEPS):
            for eng in engs:
                if i == 4:
                    eng.add_stream(5, emb[6])
                if i == 7:
                    eng.remove_stream(9)
            y_e, y_g = (eng.step(x[i]) for eng in engs)
            if not (torch.isfinite(y_g).all() and torch.equal(y_g, y_e)):
                err = (y_g.float() - y_e.float()).abs().max().item()
                raise AssertionError(f"{label} step {i}: graph output "
                                     f"differs from eager by up to {err}")
            for (name, e), (_, gl) in zip(*map(leaves, engs)):
                if not torch.equal(gl, e):
                    raise AssertionError(f"{label} step {i}: graph state "
                                         f"{name} differs from eager")
        counts = read_counts()
        per_call = 6 * (DEFAULT_STEPS + 2 * (WARMUP_STEPS + 1))
        expect_counts(counts, {"bilstm_scan_h128": per_call,
                               "flat_norm": per_call * 2}, label)
        if set(engs[1]._graphs) != {False, True}:
            raise AssertionError("the graph engine did not capture both "
                                 "graphs")
        if y_e[:, 0].abs().max().item() == 0.0:
            raise AssertionError("engine output is all zeros")
        engs[1].add_stream(9, emb[9])
        engs[1].step(x[0])
        graphs[label] = (engs[0], engs[1], x)
        log(f"  {DEFAULT_STREAMS} streams x {DEFAULT_STEPS} steps, {label}: "
            f"output and every state leaf of the graph engine bit-identical "
            f"to the eager engine's after every step; launches: "
            f"bilstm_scan_h128 {counts['bilstm_scan_h128']} = 6 x "
            f"({DEFAULT_STEPS} eager steps + 2 graphs x ({WARMUP_STEPS} "
            f"warm-up steps + 1 capture)), flat_norm twice that, nothing "
            f"else")

    # the full forward, GPU against CPU, and the streamed engine against it
    e1 = torch.from_numpy(emb[:1, None])
    x_cpu = torch.from_numpy(audio(1, int(DEFAULT_CPU_SECONDS * 16000), 3))
    reset_counts()
    y_gpu = net_gpu(x_cpu.to(dev), e1.to(dev))
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(counts, {"bilstm_scan_h128": 6,
                           "bilstm_scan_fwd_train_h128": 6}, "full forward")
    launch_counts["bilstm_scan_fwd_train_h128"] = counts[
        "bilstm_scan_fwd_train_h128"]
    y_cpu = net_cpu(x_cpu, e1)
    peak = float(y_cpu.abs().max())
    err = float((y_gpu.cpu() - y_cpu).abs().max())
    if not (tuple(y_gpu.shape) == (1, 2, x_cpu.shape[-1])
            and torch.isfinite(y_gpu).all() and peak > 0
            and err <= TOL_PATH * peak):
        raise AssertionError(f"full forward GPU vs CPU: {err} (peak {peak})")
    n, n_chunks = 2, 12
    x = audio(n, n_chunks * c, 4)
    eng = StreamingEngine(net_gpu, sd, max_streams=n)
    for s in range(n):
        eng.add_stream(s, emb[s])
    streamed = torch.cat([eng.step(x[..., i * c:(i + 1) * c])
                          for i in range(n_chunks)], -1).cpu()
    full, _ = net_gpu.predict(torch.from_numpy(x).to(dev),
                              torch.from_numpy(emb[:n]).to(dev),
                              net_gpu.init_state(n), pad=False)
    m = (n_chunks - 1) * c
    err_s = float((streamed[..., c:] - full.cpu()[..., :m]).abs().max())
    if not err_s <= TOL_STREAMED:
        raise AssertionError(f"streamed vs full forward: {err_s}")
    log(f"  full forward 1 x {DEFAULT_CPU_SECONDS:g} s: max|GPU - CPU| / "
        f"peak = {err / peak:.3e} (tolerance {TOL_PATH}); launches: "
        f"bilstm_scan_h128 6, bilstm_scan_fwd_train_h128 6, nothing else; "
        f"{n} streams x {n_chunks} chunks through the graph engine: "
        f"max|engine chunk k - full chunk k-1| = {err_s:.3e} (atol "
        f"{TOL_STREAMED})")

    # times: the kernels beside their plain versions and cuDNN
    def bound(nbytes, flops):
        """(ms, what bounds it) of the kernels' own operations, three TF32
        products on the tensor cores, and the float32 FMA bound (ms)."""
        t_bytes = nbytes / PEAK_BYTES_S
        t_ops = 3 * flops / PEAK_TF32_FLOPS
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations",
                max(t_bytes, flops / PEAK_F32_FLOPS) * 1e3)
    step_flops = 2 * 128 * 512 + 512          # a row and direction a step
    for key in H128_SCANS:
        xp, w_hh = scans[key]
        b = xp.shape[2]
        for _ in range(3):
            bilstm_scan_cuda(xp, w_hh)
        k_ms = device_ms(lambda i: bilstm_scan_cuda(xp, w_hh), 30)
        p_ms = wall_ms(lambda i: bilstm_scan_reference(xp, w_hh), 3)
        lstm = torch.nn.LSTM(64, 128, batch_first=True,
                             bidirectional=True).to(dev)
        x_in = rnd(b, 141, 64)
        for _ in range(3):
            lstm(x_in)
        l_ms = device_ms(lambda i: lstm(x_in), 30)
        b_ms, by, f32_ms = bound(4 * (xp.numel() + w_hh.numel()
                                      + 141 * 2 * b * 128 + 2 * b * 128),
                                 141 * 2 * b * step_flops)
        row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                   bound_by=by, bound_f32_ms=f32_ms,
                   tile=list(tile_h128(b, 2, dev, "b2")))
        res[f"bilstm_scan_h128_{key}"] = row
        if key == "serving":
            res["bilstm_scan_h128"].update(row)
        log(f"  B2 at H=128 {list(xp.shape)}, tile {row['tile']}: kernel "
            f"{k_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({by}, three "
            f"TF32 products; float32 FMAs {f32_ms * 1e3:.2f} us), plain "
            f"{p_ms * 1e3:.1f} us, "
            f"cuDNN nn.LSTM(64, 128, bidirectional) {l_ms * 1e3:.1f} us "
            f"[{smi}]")
    for key, (t_, nd, n, carried) in H128_TRAIN.items():
        xp, w_hh, h0, c0 = scans[key]
        fwd = lambda i: bilstm_scan_train_cuda(  # noqa: E731
            xp, w_hh, h0, c0, save_cs=False)
        for _ in range(3):
            fwd(0)
        k_ms = device_ms(fwd, 20)
        p_ms = wall_ms(lambda i: bilstm_train_reference(
            xp, w_hh, torch.float32, h0, c0), 2)
        lstm = torch.nn.LSTM(64, 128, batch_first=True,
                             bidirectional=nd == 2).to(dev)
        x_in = rnd(n, t_, 64)
        hc = (h0, c0) if carried else None
        for _ in range(3):
            lstm(x_in, hc)
        l_ms = device_ms(lambda i: lstm(x_in, hc), 20)
        states = (2 if carried else 0) * nd * n * 128
        b_ms, by, f32_ms = bound(4 * (xp.numel() + w_hh.numel() + states
                                      + t_ * nd * n * 128 + nd * n * 128),
                                 t_ * nd * n * step_flops)
        row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                   bound_by=by, bound_f32_ms=f32_ms,
                   tile=list(tile_h128(n, nd, dev, "fwd")))
        res[f"bilstm_scan_fwd_train_h128_{key}"] = row
        if key == "full_forward_inter":
            res["bilstm_scan_fwd_train_h128"].update(row)
        log(f"  training forward at H=128 (T={t_}, D={nd}, N={n}), no cs, "
            f"tile {row['tile']}: kernel {k_ms * 1e3:.1f} us, bound "
            f"{b_ms * 1e3:.2f} us ({by}, three TF32 products; float32 FMAs "
            f"{f32_ms * 1e3:.2f} us), "
            f"plain {p_ms * 1e3:.1f} us, cuDNN nn.LSTM(64, 128"
            f"{', bidirectional' if nd == 2 else ''}) {l_ms * 1e3:.1f} us "
            f"[{smi}]")

    # times: the engine step, graph and eager, and the full forward
    res["default_net"] = {}
    for label, (eager, graph, x) in graphs.items():
        for i in range(5):
            eager.step(x[i]), graph.step(x[i])
        reset_counts()
        e_ms = wall_ms(lambda i: eager.step(x[i % DEFAULT_STEPS]), 20)
        counts = read_counts()
        expect_counts(counts, {"bilstm_scan_h128": 6 * 20,
                               "flat_norm": FLAT_NORMS["default_net"] * 20},
                      f"default Net {label}, 20 eager steps")
        if label == "float32":
            launch_counts["bilstm_scan_h128"] = counts["bilstm_scan_h128"]
        g_ms = wall_ms(lambda i: graph.step(x[i % DEFAULT_STEPS]), 50)
        out = dict(eager_step_ms=e_ms, eager_rtf=e_ms / DEFAULT_CHUNK_MS,
                   graph_step_ms=g_ms, graph_rtf=g_ms / DEFAULT_CHUNK_MS)
        out.update(graph.benchmark_device(n_short=50, n_long=250,
                                          repeats=3))
        reset_counts()
        out.update(profile_steps(
            graph, x[:10], torch, {"bilstm_scan_h128": 6,
                                   "flat_norm": FLAT_NORMS["default_net"]},
            replays="the graph's every step matched the eager engine's, "
                    "6 B2 and 12 flat_norm launches a step, bit for bit"))
        expect_counts(read_counts(), {}, f"default Net {label} replays")
        res["default_net"][label] = out
        log(f"  default Net, {DEFAULT_STREAMS} streams, {label}: CUDA graph "
            f"{g_ms:.3f} ms from call to synchronize (RTF "
            f"{g_ms / DEFAULT_CHUNK_MS:.4f} of the {DEFAULT_CHUNK_MS:g} ms "
            f"chunk), benchmark_device {out['device_best_ms']:.3f} ms best "
            f"(RTF {out['rtf']:.4f}); eager {e_ms:.3f} ms (RTF "
            f"{e_ms / DEFAULT_CHUNK_MS:.4f}) [{smi}]")
    x5 = torch.from_numpy(audio(1, int(DEFAULT_FULL_SECONDS * 16000),
                                5)).to(dev)
    e5 = torch.from_numpy(emb[:1, None]).to(dev)
    net_gpu(x5, e5)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(5)]
    for start, end in ev:
        torch.cuda.synchronize()
        start.record()
        net_gpu(x5, e5)
        end.record()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in ev]
    res["default_net"]["full_forward"] = dict(
        seconds=DEFAULT_FULL_SECONDS, ms=float(np.median(ms)),
        ms_min=min(ms), ms_max=max(ms))
    log(f"  default Net.forward, 1 x {DEFAULT_FULL_SECONDS:g} s, float32: "
        f"{np.median(ms):.2f} ms by CUDA events (median of {len(ms)}, "
        f"{min(ms):.2f}-{max(ms):.2f}) [{smi}]")


class StepOnce:
    """A training step in the shape `profile_steps` drives."""

    def __init__(self, trainer, batch):
        self.trainer, self.batch = trainer, batch

    def step(self, _):
        self.trainer.train_step(self.batch, 0)


def default_net_training_phase(torch, smi, res, launch_counts,
                               reset_counts, read_counts, expect_counts):
    """The reference's default `Net` in training: `TSETask` with the `Net`
    class defaults (DEFAULT_NET_PARAMS: 6 blocks, H = 128, no attention)
    and everything else from configs/tsh_synthetic_5k.json, seeded
    weights; every gradient of an LSTM through the H = 128 backward of
    `csrc/bilstm_scan.cu`:
      * what ptxas reported for the backward, and each of its tiles (R
        rows over clusters of 8 CTAs);
      * the training forward's saved gates and cell states against the
        plain forward, and the backward (which reads those gates) against
        its plain version, at the training step's scans at 8 x 5 s, (141,
        2, 4000) and (500, 1, 1128) from (h0, c0), a row count no tile
        divides and scans of 1-3 steps, through its wrapper and its C
        entry at every tile: gates, cs, dxp, dh0, dc0 within TOL_LSTM of
        max(1, peak) up to 141 steps, TOL_LSTM_LONG at 500;
      * times by CUDA events at the two training scans: the backward and
        the training forward (with the gates, as a step runs it, and
        without) beside the plain backward and cuDNN's `nn.LSTM(64,
        128)` forward and forward + backward (bidirectional at the intra
        scan), and B2 at the eval's [141, 2, 2000] beside cuDNN's
        forward; bounds as in `default_net_phase`, for the work each
        kernel now does (the backward reads gates, cs, dy and the states
        and writes dxp, one product; the forward also writes the gates),
        and the forward + backward pair's bound beside that of the
        design that recomputed the gates (the forward writing no gates,
        the backward reading xp and y, two products);
      * one step (loss and backward) on the card against the CPU over
        DEFAULT_TRAIN_CHECK (2 x 0.5 s of the synthetic train split), TF32
        off: the loss within TOL_TRAIN_LOSS of the CPU's float32 run,
        every gradient within TOL_TRAIN_GRAD of max(peak, floor) of its
        float64 run; 6 + 6 training forwards and 6 + 6 backwards at
        H = 128 and no other kernel of the port;
      * `Trainer.train_step` (loss, backward, clip, Adam) at the config's
        8 x 5 s: ms a step (median after the first), peak GB and a
        profile (busy share), keeping every activation and with every
        block checkpointed (`Net(remat=True)`'s switch); a step that runs
        out of memory is recorded with the size at which it did."""
    import ctypes
    from lookoncetohear_tpu_torch import _build
    from lookoncetohear_tpu_torch import utils as port_utils
    from lookoncetohear_tpu_torch.data.loader import collate
    from lookoncetohear_tpu_torch.ops.bilstm_scan import (
        H128_BWD_TILE_COST, bilstm_scan_cuda, bilstm_scan_train_cuda,
        bilstm_train_bwd_h128_cuda, bilstm_train_gates_backward_reference,
        bilstm_train_reference, tile_h128)
    from lookoncetohear_tpu_torch.timing import device_ms, wall_ms
    from lookoncetohear_tpu_torch.train.trainer import (Trainer, build_task,
                                                        to_device)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    lib = _build.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    ptr = (lambda v: None if v is None else v.data_ptr())  # noqa: E731

    def rnd(*shape, k=0.5):
        return torch.randn(shape, generator=g, device=dev) * k

    lines = _build.last_build.get("ptxas", [])
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "bilstm_h128_bwd" in line:
            for shown in lines[i:i + 4]:
                log(f"  {shown}")
    for tile in H128_BWD_TILE_COST:
        out = (ctypes.c_int * 6)()
        _build.check(lib.bilstm_h128_info(*tile, 2, out), "bilstm_h128_info")
        log(f"  H=128 backward, tile of {tile[0]} rows over {tile[1]} CTAs: "
            f"{out[0]} threads, {out[2]} registers, {out[3]} B spilled, "
            f"{out[1]} B shared memory, {out[4]} clusters at once, "
            f"{out[5]} CTAs an SM")

    # the backward against its plain version
    worst, scans = 0.0, {}
    for key, (t_, nd, n, carried) in H128_BWD_SCANS.items():
        xp, w_hh = rnd(n, t_, nd * 512), rnd(nd, 128, 512, k=0.2)
        h0, c0 = (rnd(nd, n, 128), rnd(nd, n, 128)) if carried \
            else (None, None)
        dy, dct = rnd(n, t_, nd * 128, k=1.0), rnd(nd, n, 128, k=1.0)
        y, _, cs, gates = bilstm_scan_train_cuda(xp, w_hh, h0, c0,
                                                 save_gates=True)
        tol = TOL_LSTM if t_ <= 141 else TOL_LSTM_LONG

        def of_peak(got, want):
            return max((a - e).abs().max().item()
                       / max(1.0, e.abs().max().item())
                       for a, e in zip(got, want))
        fwd_err = of_peak((cs, gates), bilstm_train_reference(
            xp, w_hh, torch.float32, h0, c0, with_cs=True,
            with_gates=True)[2:])
        args = (gates, w_hh, c0, cs, dy, dct)
        want = bilstm_train_gates_backward_reference(*args)
        runs = [bilstm_train_bwd_h128_cuda(*args)]
        for tile in H128_BWD_TILE_COST:
            out = tuple(torch.empty_like(e) for e in want)
            _build.check(lib.bilstm_train_bwd_h128_f32(
                *map(ptr, (*args, *out)), t_, nd, n, *tile, stream),
                "bilstm_train_bwd_h128_f32")
            runs.append(out)
        torch.cuda.synchronize()
        err = max(of_peak(run, want) for run in runs)
        log(f"  backward at H=128 {key} (T={t_}, D={nd}, N={n}"
            f"{', from h0/c0' if carried else ''}), tile "
            f"{tile_h128(n, nd, dev, 'bwd')} and through the C entry at "
            f"every tile: max|kernel - plain| / max(1, peak) over dxp, dh0, "
            f"dc0 = {err:.3e}; the forward's saved cs and gates against the "
            f"plain forward {fwd_err:.3e} (tolerance {tol})")
        if not (err <= tol and fwd_err <= tol and all(
                torch.isfinite(a).all() for run in runs for a in run)):
            raise AssertionError(f"backward at H=128 {key} differs: {err}, "
                                 f"the forward's gates {fwd_err}")
        worst = max(worst, err)
        if key.startswith("train"):
            scans[key] = (xp, h0, args)
    res["bilstm_scan_bwd_train_h128"] = dict(max_abs_err=worst)

    # times: the kernels beside the plain backward and cuDNN
    for key, (xp, h0, args) in scans.items():
        gates, w_hh, c0, cs, dy, dct = args
        n, t_, dg = xp.shape
        nd = dg // 512
        bwd = lambda i: bilstm_train_bwd_h128_cuda(*args)  # noqa: E731
        fwd = lambda i: bilstm_scan_train_cuda(  # noqa: E731
            xp, w_hh, h0, c0, save_gates=True)
        fwd_lean = lambda i: bilstm_scan_train_cuda(  # noqa: E731
            xp, w_hh, h0, c0)
        for _ in range(2):
            bwd(0), fwd(0), fwd_lean(0)
        b_ms, f_ms = device_ms(bwd, 5), device_ms(fwd, 5)
        fl_ms = device_ms(fwd_lean, 5)
        p_ms = wall_ms(lambda i: bilstm_train_gates_backward_reference(
            *args), 2)
        lstm = torch.nn.LSTM(64, 128, batch_first=True,
                             bidirectional=nd == 2).to(dev)
        x_in = rnd(n, t_, 64).requires_grad_()
        gy = rnd(n, t_, nd * 128, k=1.0)
        hc = None if h0 is None else (h0, c0)
        lf = lambda i: lstm(x_in, hc)  # noqa: E731
        lfb = lambda i: lstm(x_in, hc)[0].backward(gy)  # noqa: E731
        for _ in range(2):
            lfb(0)
        lf_ms, lfb_ms = device_ms(lf, 5), device_ms(lfb, 5)
        del lstm, x_in, gy
        n_state = nd * n * 128
        seq = t_ * n_state
        states = 0 if h0 is None else n_state        # h0 or c0
        product = t_ * nd * n * 2 * 128 * 512      # one, a row and step

        def bound(floats, products, ew=0):
            """(ms, what bounds it, float32 FMA ms) of moving `floats`
            floats and doing `products` recurrent products as three TF32
            products (and `ew` elementwise operations)."""
            t_bytes = 4 * floats / PEAK_BYTES_S
            t_ops = 3 * products * product / PEAK_TF32_FLOPS
            return (max(t_bytes, t_ops) * 1e3,
                    "bytes" if t_bytes >= t_ops else "operations",
                    max(t_bytes, (products * product + ew)
                        / PEAK_F32_FLOPS) * 1e3)
        # each input read once, each output written once. The backward
        # reads the gates, cs, dy, W_hh, c0 and dc_T and writes dxp, dh0
        # and dc0: one product a row, direction and step (+ the cell's
        # elementwise work). The forward reads xp, W_hh, h0 and c0 and
        # writes y, cs, the gates and c_T. The design that recomputed the
        # gates: the forward wrote no gates, the backward read xp, y and h0
        # besides, two products.
        w_f = w_hh.numel()
        b_bytes = 4 * seq + seq + seq + w_f + states + n_state \
            + 4 * seq + 2 * n_state
        f_bytes = 4 * seq + w_f + 2 * states + seq + seq + 4 * seq + n_state
        b_ms_, by, b_f32 = bound(b_bytes, 1, t_ * n_state * 16)
        fb_ms, fby, _ = bound(f_bytes, 1)
        pair_ms = bound(b_bytes + f_bytes, 2)[0]
        old_pair_ms = bound((b_bytes + seq + states) + (f_bytes - 4 * seq),
                            3)[0]
        row = dict(ms=b_ms, plain_ms=p_ms, library_ms=lfb_ms,
                   bound_ms=b_ms_, bound_by=by, bound_f32_ms=b_f32,
                   tile=list(tile_h128(n, nd, dev, "bwd")), fwd_ms=f_ms,
                   fwd_no_gates_ms=fl_ms, fwd_bound_ms=fb_ms,
                   fwd_bound_by=fby, pair_bound_ms=pair_ms,
                   pair_bound_recompute_ms=old_pair_ms,
                   fwd_tile=list(tile_h128(n, nd, dev, "fwd")),
                   fwd_library_ms=lf_ms)
        res[f"bilstm_scan_bwd_train_h128_{key}"] = row
        if key == "train_intra":
            res["bilstm_scan_bwd_train_h128"].update(row)
        log(f"  backward at H=128 (T={t_}, D={nd}, N={n}), tile "
            f"{row['tile']}: kernel {b_ms * 1e3:.1f} us, bound "
            f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}, "
            f"{4 * b_bytes / 1e9:.2f} GB, one product as three TF32 "
            f"products; float32 FMAs {row['bound_f32_ms'] * 1e3:.1f} us), "
            f"plain {p_ms * 1e3:.1f} us, cuDNN nn.LSTM(64, 128"
            f"{', bidirectional' if nd == 2 else ''}) forward + backward "
            f"{lfb_ms * 1e3:.1f} us; the training forward (cs and gates "
            f"saved), tile {row['fwd_tile']}: {f_ms * 1e3:.1f} us (without "
            f"the gates {fl_ms * 1e3:.1f} us), bound {fb_ms * 1e3:.1f} us "
            f"({fby}, {4 * f_bytes / 1e9:.2f} GB), cuDNN forward "
            f"{lf_ms * 1e3:.1f} us; the pair's bound {pair_ms * 1e3:.1f} us "
            f"(recomputing the gates: {old_pair_ms * 1e3:.1f} us) [{smi}]")
    del scans, args, gates
    with torch.no_grad():
        xp, w_hh = rnd(141, 2, 2000, 512), rnd(2, 128, 512, k=0.2)
        lstm = torch.nn.LSTM(64, 128, batch_first=True,
                             bidirectional=True).to(dev)
        x_in = rnd(2000, 141, 64)
        for _ in range(2):
            bilstm_scan_cuda(xp, w_hh), lstm(x_in)
        b2_ms = device_ms(lambda i: bilstm_scan_cuda(xp, w_hh), 10)
        l_ms = device_ms(lambda i: lstm(x_in), 10)
        res["bilstm_scan_h128_eval"] = dict(ms=b2_ms, library_ms=l_ms)
        log(f"  B2 at H=128 [141, 2, 2000, 512] (the eval's batch of 4 x "
            f"5 s): kernel {b2_ms * 1e3:.1f} us, cuDNN nn.LSTM(64, 128, "
            f"bidirectional) forward {l_ms * 1e3:.1f} us [{smi}]")
        del xp, w_hh, lstm, x_in
    torch.cuda.empty_cache()

    # one step on the card against the CPU
    hp = port_utils.Params(TSH_5K)
    hp.pl_module_args = dict(hp.pl_module_args,
                             model_params=DEFAULT_NET_PARAMS)

    def host_batch(n, seconds):
        args = dict(hp.train_data_args, duration=seconds)
        ds = port_utils.import_attr(hp.train_dataset)(**args)
        return collate([ds[i] for i in range(n)])

    per_step = {"bilstm_scan_fwd_train_h128": 12,
                "bilstm_scan_bwd_train_h128": 12}
    host = host_batch(*DEFAULT_TRAIN_CHECK)
    out = {}
    for d, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                  ("cpu64", torch.float64)):
        task = build_task(hp, seed=16)
        model = task.model.to("cuda" if d == "cuda" else "cpu", dt)
        if (model.tfgridnet.n_freqs, model.tfgridnet.n_layers,
                model.tfgridnet.lstm_hidden_units, model.tfgridnet.use_attn,
                model.tfgridnet.remat) != (141, 6, 128, False, False):
            raise AssertionError("the model is not the default Net")
        batch = {k: v.to(dt) if v.is_floating_point() else v
                 for k, v in to_device(task.device_batch(host, train=True),
                                       "cuda" if d == "cuda" else "cpu"
                                       ).items()}
        reset_counts()
        with port_utils.full_float32():
            loss, _ = task.loss_and_metrics(batch, 0)
            loss.backward()
        if d == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
        out[d] = (loss.item(), {k: p.grad.cpu().double() for k, p in
                                model.named_parameters()})
        del task, model, batch, loss
    expect_counts(counts, per_step, "default Net training step")
    launch_counts["bilstm_scan_bwd_train_h128"] = counts[
        "bilstm_scan_bwd_train_h128"]
    (l_gpu, g_gpu), (l_cpu, _), (l_64, g_64) = (out[k] for k in (
        "cuda", "cpu", "cpu64"))
    if not (np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= TOL_TRAIN_LOSS * max(
            1.0, abs(l_cpu))):
        raise AssertionError(f"default Net: loss {l_gpu} vs {l_cpu}")
    floor = 1e-3 * max(v.abs().max().item() for v in g_64.values())
    dev_worst, worst_name = 0.0, ""
    for k, v in g_64.items():
        ref = max(v.abs().max().item(), floor)
        err = (g_gpu[k] - v).abs().max().item() / ref
        if not (torch.isfinite(g_gpu[k]).all() and err <= TOL_TRAIN_GRAD):
            raise AssertionError(f"default Net: grad {k} lies {err:.3e} of "
                                 f"max(peak, floor) from float64")
        if err >= dev_worst:
            dev_worst, worst_name = err, k
    log(f"  default Net TSETask, seeded, {DEFAULT_TRAIN_CHECK[0]} x "
        f"{DEFAULT_TRAIN_CHECK[1]:g} s: loss GPU {l_gpu:.6f} CPU "
        f"{l_cpu:.6f} float64 {l_64:.6f}; {len(g_64)} gradients, worst "
        f"|GPU - float64| / max(peak, floor) {dev_worst:.3e} ({worst_name}; "
        f"tolerance {TOL_TRAIN_GRAD}); launches: "
        + ", ".join(f"{k} {counts[k]}" for k in per_step)
        + ", no other kernel of the port")
    del out, g_gpu, g_64

    # the step at the config's batch of 8 x 5 s, with and without remat
    host = host_batch(hp.batch_size, hp.train_data_args["duration"])
    task = build_task(hp, seed=16)
    rows = {}
    with tempfile.TemporaryDirectory(prefix="port_default_") as tmp, \
            port_utils.full_float32():
        tr = Trainer(task, tmp, epochs=1, device=dev)
        batch = to_device(task.device_batch(host, train=True), dev)
        for remat in (False, True):
            task.model.tfgridnet.remat = remat
            label = "every block checkpointed" if remat else \
                "every activation kept"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # what earlier phases still hold counts in the peak: logged
            held_gb = torch.cuda.memory_allocated() / 1e9
            ms, losses = [], []
            try:
                for _ in range(DEFAULT_TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = tr.train_step(batch, 0)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(m["loss"].item())
            except torch.cuda.OutOfMemoryError as e:
                gb = torch.cuda.max_memory_allocated() / 1e9
                rows["remat" if remat else "plain"] = dict(
                    out_of_memory=True, peak_gb=gb, held_gb=held_gb,
                    error=str(e).splitlines()[0][:200])
                log(f"  default Net train_step, {hp.batch_size} x "
                    f"{hp.train_data_args['duration']:g} s, {label}: out of "
                    f"memory with {gb:.2f} GB allocated at its peak ("
                    f"{held_gb:.2f} GB held before the step): "
                    f"{str(e).splitlines()[0][:160]} [{smi}]")
                tr.opt.zero_grad(set_to_none=True)
                continue
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            if not np.isfinite(losses).all():
                raise AssertionError(f"default Net: losses {losses}")
            want = {"bilstm_scan_fwd_train_h128": 24 if remat else 12,
                    "bilstm_scan_bwd_train_h128": 12}
            prof = profile_steps(StepOnce(tr, batch), [None], torch, want,
                                 absent=("RNN", "rnn", "LSTM", "lstm_cell"),
                                 counters=(reset_counts, read_counts))
            rows["remat" if remat else "plain"] = dict(
                ms=float(np.median(ms[1:])), first_ms=ms[0], peak_gb=peak_gb,
                held_gb=held_gb, losses=losses, **prof)
            log(f"  default Net train_step, {hp.batch_size} x "
                f"{hp.train_data_args['duration']:g} s, {label}: "
                f"{np.median(ms[1:]):.1f} ms a step from call to synchronize "
                f"(median of {len(ms) - 1} after the first, {ms[0]:.1f} ms "
                f"first), peak {peak_gb:.2f} GB allocated ({held_gb:.2f} GB "
                f"held before the step), busy share "
                f"{prof['busy_share']:.3f}; loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f} [{smi}]")
        task.model.tfgridnet.remat = False
        del tr, batch
    if "ms" not in rows.get("remat", {}):
        raise AssertionError("the checkpointed step at 8 x 5 s did not run")
    res["default_net"]["train_step"] = rows
    del task
    torch.cuda.empty_cache()


def reference_tse(g, D=64, M=2, H=64, F=97, nh=4, S=2, E=256,
                  n_layers=3):
    """A random state_dict in the reference streaming TSE model's key
    layout (`model.tfgridnet.*`), at the flagship geometry."""
    e_dim, vd = int(np.ceil(512 / F)), D // nh

    def r(*shape):
        return (0.1 * g.standard_normal(shape)).astype(np.float32)
    p = "model.tfgridnet."
    sd = {p + "conv.0.weight": r(D, 2 * M, 3, 3), p + "conv.0.bias": r(D),
          p + "deconv.weight": r(D, S * 2, 3, 3), p + "deconv.bias": r(S * 2),
          p + "embed_to_feats_proj.0.weight": r(D * F, E),
          p + "embed_to_feats_proj.0.bias": r(D * F),
          p + "embed_to_feats_proj.1.weight": 1 + r(D * F),
          p + "embed_to_feats_proj.1.bias": r(D * F)}
    for i in range(n_layers):
        b = f"{p}blocks.{i}"
        for nm in ("intra_norm", "inter_norm"):
            sd[f"{b}.{nm}.norm.weight"] = 1 + r(D)
            sd[f"{b}.{nm}.norm.bias"] = r(D)
        sd.update({f"{b}.intra_linear.weight": r(D, 2 * H),
                   f"{b}.intra_linear.bias": r(D),
                   f"{b}.inter_linear.weight": r(D, H),
                   f"{b}.inter_linear.bias": r(D)})
        for rnn, sfxs in (("intra_rnn", ("", "_reverse")), ("inter_rnn",
                                                            ("",))):
            for sfx in sfxs:
                sd.update({f"{b}.{rnn}.weight_ih_l0{sfx}": r(4 * H, D),
                           f"{b}.{rnn}.weight_hh_l0{sfx}": r(4 * H, H),
                           f"{b}.{rnn}.bias_ih_l0{sfx}": r(4 * H),
                           f"{b}.{rnn}.bias_hh_l0{sfx}": r(4 * H)})
        for nm, w in (("attn_conv_Q", e_dim * nh), ("attn_conv_K", e_dim * nh),
                      ("attn_conv_V", vd * nh), ("attn_concat_proj", D)):
            sd.update({f"{b}.{nm}.0.weight": r(w, D), f"{b}.{nm}.0.bias": r(w),
                       f"{b}.{nm}.1.weight": 0.25 + r(1),
                       f"{b}.{nm}.3.norm.weight": 1 + r(F * w // (
                           nh if nm != "attn_concat_proj" else 1)),
                       f"{b}.{nm}.3.norm.bias": r(F * w // (
                           nh if nm != "attn_concat_proj" else 1))})
    return sd


def reference_embed(g, D=64, M=2, H=64, E=256, F=65, nh=4, n_layers=3):
    """A random state_dict in the reference enrollment net's key layout
    (`model.*`, espnet's TF-GridNet), at configs/embed_synthetic_5k.json's
    geometry (n_fft 128: F = 65)."""
    e_dim, vd = int(np.ceil(512 / F)), D // nh

    def r(*shape):
        return (0.1 * g.standard_normal(shape)).astype(np.float32)
    sd = {"model.conv.0.weight": r(D, 2 * M, 3, 3), "model.conv.0.bias": r(D),
          "model.conv.1.weight": 1 + r(D), "model.conv.1.bias": r(D),
          "model.embed_proj.0.weight": r(E, F * D),
          "model.embed_proj.0.bias": r(E),
          "model.embed_proj.1.weight": 1 + r(E),
          "model.embed_proj.1.bias": r(E)}
    for i in range(n_layers):
        b = f"model.blocks.{i}"
        for rnn in ("intra_rnn", "inter_rnn"):
            for sfx in ("", "_reverse"):
                sd.update({f"{b}.{rnn}.weight_ih_l0{sfx}": r(4 * H, D * 4),
                           f"{b}.{rnn}.weight_hh_l0{sfx}": r(4 * H, H),
                           f"{b}.{rnn}.bias_ih_l0{sfx}": r(4 * H),
                           f"{b}.{rnn}.bias_hh_l0{sfx}": r(4 * H)})
        for lin in ("intra_linear", "inter_linear"):
            sd[f"{b}.{lin}.weight"] = r(2 * H, D, 4)
            sd[f"{b}.{lin}.bias"] = r(D)
        for nm in ("intra_norm", "inter_norm"):
            sd[f"{b}.{nm}.gamma"] = 1 + r(1, D, 1, 1)
            sd[f"{b}.{nm}.beta"] = r(1, D, 1, 1)
        heads = [(f"attn_conv_{q}_{h}", w) for h in range(nh)
                 for q, w in (("Q", e_dim), ("K", e_dim), ("V", vd))]
        for nm, w in heads + [("attn_concat_proj", D)]:
            sd.update({f"{b}.{nm}.0.weight": r(w, D, 1, 1),
                       f"{b}.{nm}.0.bias": r(w),
                       f"{b}.{nm}.1.weight": 0.25 + r(1),
                       f"{b}.{nm}.2.gamma": 1 + r(1, w, 1, F),
                       f"{b}.{nm}.2.beta": r(1, w, 1, F)})
    return sd


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from lookoncetohear_tpu_torch import _build
        from lookoncetohear_tpu_torch.entry import FLAGSHIP
        from lookoncetohear_tpu_torch.models.net import EmbedNet, Net
        from lookoncetohear_tpu_torch.ops.attention import \
            local_attention_step_ring_int8
        from lookoncetohear_tpu_torch.ops.attn_step import (
            VARIANTS, attention_step_cuda, attention_step_reference)
        from lookoncetohear_tpu_torch.ops.bilstm_scan import (
            TRAIN_TILE_COST, bilstm_scan_bwd_cuda, bilstm_scan_cuda,
            bilstm_scan_h128_cuda, bilstm_scan_reference,
            bilstm_scan_train_cuda, bilstm_train_backward_reference,
            bilstm_train_bwd_h128_cuda, bilstm_train_fwd_h128_cuda,
            bilstm_train_reference, scan_weight_grad, tile_rows)
        from lookoncetohear_tpu_torch.ops.lstm import bidir_scan_inputs
        from lookoncetohear_tpu_torch.ops.norms import (
            flat_head_layer_norm, flat_layer_norm, flat_layer_norm_reference,
            flat_norm_cuda, flat_qkv_layer_norm, head_segment_matrix)
        from lookoncetohear_tpu_torch.ops.ring_step import (
            arrival_counter, ring_attend_int8_step_cuda,
            ring_attend_int8_step_reference)
        from lookoncetohear_tpu_torch.serve.engine import (
            WARMUP_STEPS, MultiDeviceEngine, StreamingEngine)
        from lookoncetohear_tpu_torch.timing import (
            attn_inputs as ring_attn_inputs, device_ms, wall_ms)
        from lookoncetohear_tpu_torch.weights import (
            load_checkpoint, load_npz, params_from_jax)
    except ImportError:
        traceback.print_exc()
        print("chip_smoke: the lookoncetohear_tpu_torch package must sit "
              "beside this script", file=sys.stderr)
        return 1
    # full float32 for the float32 comparisons (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    attn_names = list(VARIANTS.values())
    res: dict = {k: {} for k in ["bilstm_scan", "bilstm_scan_fwd_train",
                                 "bilstm_scan_bwd", "ring_int8_step"]
                 + attn_names}
    launch_counts: dict = {}

    def gpu(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

    def reset_counts():
        bilstm_scan_cuda.launches = 0
        bilstm_scan_train_cuda.launches = 0
        bilstm_scan_bwd_cuda.launches = 0
        bilstm_scan_h128_cuda.launches = 0
        bilstm_train_fwd_h128_cuda.launches = 0
        bilstm_train_bwd_h128_cuda.launches = 0
        ring_attend_int8_step_cuda.launches = 0
        attention_step_cuda.launches = 0
        flat_norm_cuda.launches = 0
        for k in attn_names:
            attention_step_cuda.variant_launches[k] = 0

    def read_counts():
        return dict(bilstm_scan=bilstm_scan_cuda.launches,
                    bilstm_scan_fwd_train=bilstm_scan_train_cuda.launches,
                    bilstm_scan_bwd=bilstm_scan_bwd_cuda.launches,
                    bilstm_scan_h128=bilstm_scan_h128_cuda.launches,
                    bilstm_scan_fwd_train_h128=(
                        bilstm_train_fwd_h128_cuda.launches),
                    bilstm_scan_bwd_train_h128=(
                        bilstm_train_bwd_h128_cuda.launches),
                    ring_int8_step=ring_attend_int8_step_cuda.launches,
                    flat_norm=flat_norm_cuda.launches,
                    **attention_step_cuda.variant_launches)

    def flat_norms(kv_dtype):
        return FLAT_NORMS["int8" if kv_dtype == torch.int8 else "float_ring"]

    def expect_counts(got, want, what):
        """Every kernel in `want` launched exactly that often, every
        other kernel not at all."""
        for k, v in got.items():
            if v != want.get(k, 0):
                raise AssertionError(f"{what}: {k} launched {v} times, "
                                     f"want {want.get(k, 0)}")

    # ---- 1. device ----------------------------------------------------
    def device():
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        log(f"device: {torch.cuda.get_device_name(0)}; count "
            f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
            f"{torch.__version__}, CUDA {torch.version.cuda}")
        return smi
    smi = phase("device", 10, device)

    # ---- 2. build: one nvcc a csrc/*.cu, started together --------------
    def build():
        lib = _build.load_library()
        b = _build.last_build
        log(f"build: {b['seconds']:.1f} s, cached={b['cached']}: "
            f"{b.get('command', b['path'])}")
        for line in b["ptxas"]:
            log(f"  {line}")
        # each tile of the training kernels: what ptxas does not print
        # (its registers and spills are in the lines above)
        import ctypes
        for kname, tiles in TRAIN_TILE_COST.items():
            for r in tiles:
                out = (ctypes.c_int * 5)()
                _build.check(lib.bilstm_train_info(r, kname == "bwd", out),
                             "bilstm_train_info")
                log(f"  bilstm_train_{kname} tile of {r} rows: {out[0]} "
                    f"threads, {out[1]} B dynamic shared memory, {out[4]} "
                    "blocks per SM")
    phase("build", 30, build)

    def build_motion():
        """The moving-source renderer, compiled from
        native/motion_simulator/moving_sources.cpp into the package's
        _build/ directory with its Makefile's flags."""
        from lookoncetohear_tpu_torch.data import motion
        path = motion.build_native()
        b = motion.last_build
        log(f"  {path}: {b['seconds']:.1f} s, cached={b['cached']}: "
            f"{b.get('command', '')}")
    phase("build: motion simulator", 12, build_motion)

    # ---- 3. BiLSTM kernel vs plain ------------------------------------
    def lstm_check():
        errs = []
        # the serving batch, a ragged one, the full forward's 625 rows
        for b in (64, 12, 625):
            xp = gpu((rng.standard_normal((97, 2, b, 256)) * 0.5)
                     .astype(np.float32))
            w_hh = gpu((rng.standard_normal((2, 64, 256)) * 0.3)
                       .astype(np.float32))
            ys, c_t = bilstm_scan_cuda(xp, w_hh)
            rys, rc = bilstm_scan_reference(xp, w_hh)
            torch.cuda.synchronize()
            err = max((ys - rys).abs().max().item(),
                      (c_t - rc).abs().max().item())
            log(f"  B={b}: max|kernel - plain| = {err:.3e} "
                f"(tolerance {TOL_LSTM})")
            if not err <= TOL_LSTM:
                raise AssertionError(f"bilstm_scan differs: {err}")
            errs.append(err)
        res["bilstm_scan"]["max_abs_err"] = max(errs)
    phase("bilstm_scan vs plain", 10, lstm_check)

    # ---- 4. int8 ring step kernel vs plain ------------------------------
    b, f, nh, e, vd, wp, w = STREAMS, 97, 4, 6, 16, 56, 50
    dk, dv = f * nh * e, f * nh * vd

    # made on the card from a seed: the chained check below draws ~200
    # frames and 4 rings of 30 MB, which host-side generation and copies
    # made take up to a minute on a busy host
    gen = torch.Generator(device=dev).manual_seed(1)

    def frame_inputs(dtype):
        return {k: torch.randn(shape, generator=gen, device=dev).to(dtype)
                for k, shape in (("q", (b, dk)), ("kt", (b, dk)),
                                 ("vt", (b, dv)))}

    def ring_inputs(dtype):
        def scales():
            return torch.rand((b, wp, nh), generator=gen,
                              device=dev) * 1.9e-2 + 1e-3

        def int8(d):
            return torch.randint(-127, 128, (b, wp, d), generator=gen,
                                 device=dev, dtype=torch.int8)
        return dict(**frame_inputs(dtype), kb=int8(dk), ks=scales(),
                    vb=int8(dv), vs=scales())

    def ring_check():
        """w + 3 chained calls of the kernel and of its plain version,
        each on its own copy of one state, fresh q/k_t/v_t per call;
        after every call the ring, scales and cursor are bit-exact, out
        within tolerance, and the kernel's arrival counter is 0."""
        errs = []
        for dtype, pos in ((torch.float32, 0), (torch.float32, 7),
                           (torch.float32, 49), (torch.bfloat16, 7)):
            a = ring_inputs(dtype)
            states = [{k: v.clone() for k, v in a.items()} for _ in "ab"]
            ps = [torch.tensor(pos, dtype=torch.int32, device=dev)
                  for _ in "ab"]
            worst = 0.0
            for call in range(w + 3):
                fresh = frame_inputs(dtype)
                for st in states:
                    st.update(fresh)
                o1, o2 = (step(r["q"], r["kt"], r["vt"], r["kb"], r["ks"],
                               r["vb"], r["vs"], p, f=f, n_head=nh, w=w)
                          for step, r, p in zip(
                              (ring_attend_int8_step_cuda,
                               ring_attend_int8_step_reference), states, ps))
                torch.cuda.synchronize()
                r1, r2 = states
                for k in ("kb", "vb", "ks", "vs"):
                    if not torch.equal(r1[k], r2[k]):
                        raise AssertionError(f"ring {k} not bit-exact, pos="
                                             f"{pos}, call {call}")
                want = (pos + call + 1) % w
                if int(ps[0]) != want or int(ps[1]) != want:
                    raise AssertionError(f"cursor {int(ps[0])} vs "
                                         f"{int(ps[1])}, want {want}")
                if int(arrival_counter(ps[0])) != 0:
                    raise AssertionError("arrival counter not reset")
                err = (o1.float() - o2.float()).abs().max().item()
                if dtype == torch.float32:
                    torch.testing.assert_close(o1, o2, rtol=TOL_RING_F32[0],
                                               atol=TOL_RING_F32[1])
                elif not err <= TOL_RING_BF16:
                    raise AssertionError(f"bf16 ring out differs: {err}")
                worst = max(worst, err)
            tol = (f"rtol {TOL_RING_F32[0]}, atol {TOL_RING_F32[1]}"
                   if dtype == torch.float32 else f"atol {TOL_RING_BF16}")
            log(f"  {str(dtype)[6:]} from pos={pos}, {w + 3} chained calls: "
                f"ring + scales + cursor bit-exact and arrival counter 0 "
                f"after each; max|out diff| = {worst:.3e} ({tol})")
            errs.append(worst)
        res["ring_int8_step"]["max_abs_err"] = max(errs)
    phase("ring_int8_step vs plain", 10, ring_check)

    # ---- 5. ring attention kernel (B3, B4) vs plain ---------------------
    def attn_inputs(rows, qdt, kvdt, seed, dk=ATTN["dk"]):
        """q/k_t/v_t and a ring of ATTN's widths (K rows dk wide), made
        on the card from a seed; an int8 ring gets per-(row, slot)
        scales."""
        a = ring_attn_inputs(torch.Generator(device=dev).manual_seed(seed),
                             rows, ATTN["w1"], dk, ATTN["dv"], qdt, kvdt)
        return a[:5], ({} if a[5] is None else
                       dict(k_scale=a[5], v_scale=a[6]))

    def attn_check():
        for i, ((qdt, kvdt), name) in enumerate(VARIANTS.items()):
            errs = []
            # the serving rows and a ragged count, at the serving Dk and
            # at an odd one (K rows 1- or 2-byte aligned)
            for adk in (ATTN["dk"], ATTN["odd_dk"]):
                for rows in (ATTN["rows"], 5):
                    a, sc = attn_inputs(rows, qdt, kvdt,
                                        100 + 10 * i + rows + adk, adk)
                    got = attention_step_cuda(*a, **sc)
                    want = attention_step_reference(*a, **sc)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    if qdt == kvdt == torch.float32:
                        ok, tol = err <= TOL_ATTN_F32, f"atol {TOL_ATTN_F32}"
                    elif qdt == torch.float32 and kvdt == torch.int8:
                        torch.testing.assert_close(got, want,
                                                   rtol=TOL_ATTN_INT8,
                                                   atol=TOL_ATTN_INT8)
                        ok, tol = True, f"rtol/atol {TOL_ATTN_INT8}"
                    else:
                        ok, tol = (err <= TOL_ATTN_BF16,
                                   f"atol {TOL_ATTN_BF16}")
                    if not (ok and got.dtype == qdt
                            and tuple(got.shape) == (rows, ATTN["dv"])):
                        raise AssertionError(
                            f"{name} rows={rows} Dk={adk}: {err}")
                    log(f"  {name} rows={rows} x {ATTN['w1']} slots, Dk "
                        f"{adk}: max|kernel - plain| = {err:.3e} ({tol})")
                    errs.append(err)
            res[name]["max_abs_err"] = max(errs)
    phase("attn_step vs plain", 10, attn_check)

    # ---- 5b. the flat LayerNorms vs plain -------------------------------
    def flat_qkv_inputs(b, dtype, seed):
        """The flagship's fused Q/K/V projection y [b, 97, 112] before its
        PReLUs, and each block's (dim, alpha, scale, bias, eps), made on
        the card from a seed."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        f, nh = FLAT_QKV["f"], FLAT_QKV["nh"]

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        y = (randn(b, f, nh * sum(FLAT_QKV["dims"])) * 0.7 + 0.1).to(dtype)
        parts = [(dim, (torch.rand(1, generator=gen, device=dev) * 0.4)
                  .to(dtype), (1 + 0.3 * randn(f * dim)).to(dtype),
                  (0.2 * randn(f * dim)).to(dtype), 1e-5)
                 for dim in FLAT_QKV["dims"]]
        return y, parts

    flat_segs = [torch.from_numpy(head_segment_matrix(
        FLAT_QKV["f"] * FLAT_QKV["nh"] * dim, FLAT_QKV["nh"], dim)).to(dev)
        for dim in FLAT_QKV["dims"]]

    def flat_qkv_plain(y, parts):
        """The eager chain the kernel replaced, on the card: one PReLU
        over y with the three slopes, each block's slice copied, its
        affine expanded over the heads, `flat_head_layer_norm` against
        the segment matrices (made once, as the model's buffers were)."""
        f, nh = FLAT_QKV["f"], FLAT_QKV["nh"]
        alpha = torch.cat([a.expand(nh * dim) for dim, a, *_ in parts])
        yp = torch.where(y >= 0, y, alpha * y)
        outs, col = [], 0
        for (dim, _, sc, bi, eps), seg in zip(parts, flat_segs):
            outs.append(flat_head_layer_norm(
                yp[..., col:col + nh * dim].reshape(y.shape[0], -1), seg,
                float(f * dim),
                sc.reshape(f, 1, dim).expand(f, nh, dim).reshape(-1),
                bi.reshape(f, 1, dim).expand(f, nh, dim).reshape(-1), eps))
            col += nh * dim
        return outs

    def flat_row_inputs(rows, d, dtype, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(rows, d, generator=gen, device=dev) * 1.3 - 0.4
        sc = 1 + 0.3 * torch.randn(d, generator=gen, device=dev)
        bi = 0.2 * torch.randn(d, generator=gen, device=dev)
        return x.to(dtype), sc.to(dtype), bi.to(dtype)

    def flat_err(got, want):
        """max|got - want| and whether it is within the dtype's bound."""
        d = (got.float() - want.float()).abs()
        if want.dtype == torch.bfloat16:
            rtol, atol = TOL_FLAT_BF16
            ok = bool((d <= atol + rtol * want.float().abs()).all())
        else:
            ok = bool((d <= TOL_FLAT_F32).all())
        return d.max().item(), ok

    def flat_check():
        """The Q/K/V launch (bf16 and float32, 64 and 3 streams) against
        the eager chain it replaced, and the row norms at a step's
        shapes, at 3 rows and at a width 16 bytes do not divide against
        `flat_layer_norm_reference`, all on the card; one launch a call."""
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            for b in (STREAMS, 3):
                y, parts = flat_qkv_inputs(b, dtype, b)
                reset_counts()
                got = flat_qkv_layer_norm(y, FLAT_QKV["nh"], parts)
                torch.cuda.synchronize()
                expect_counts(read_counts(), {"flat_norm": 1}, "Q/K/V")
                for blk, g_, w_ in zip("QKV", got, flat_qkv_plain(y, parts)):
                    err, ok = flat_err(g_, w_)
                    if not (ok and g_.dtype == dtype
                            and g_.shape == w_.shape):
                        raise AssertionError(f"{blk} {dtype} B={b}: {err}")
                    errs.append(err)
                log(f"  Q/K/V of y {list(y.shape)} {str(dtype)[6:]}: one "
                    f"launch; max|kernel - plain| {max(errs[-3:]):.3e}")
        rows = [*FLAT_ROWS.values(), (3, 97 * 64, "f32"), (3, 64, "bf16"),
                (5, 10, "f32")]
        for n, d, dt in rows:
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            x, sc, bi = flat_row_inputs(n, d, dtype, n + d)
            reset_counts()
            got = flat_layer_norm(x, sc, bi, 1e-5)
            torch.cuda.synchronize()
            expect_counts(read_counts(), {"flat_norm": 1}, "row norm")
            err, ok = flat_err(got, flat_layer_norm_reference(x, sc, bi,
                                                              1e-5))
            if not ok:
                raise AssertionError(f"row norm [{n}, {d}] {dt}: {err}")
            errs.append(err)
            log(f"  row norm [{n}, {d}] {dt}: max|kernel - plain| "
                f"{err:.3e}")
        res["flat_norm"] = dict(max_abs_err=max(errs))
        log(f"  tolerances: float32 atol {TOL_FLAT_F32}, bf16 rtol/atol "
            f"{TOL_FLAT_BF16}")
    phase("flat_norm vs plain", 10, flat_check)

    # ---- 6. the paths ---------------------------------------------------
    def load():
        sd = params_from_jax(load_npz(CKPT))
        net = Net(**FLAGSHIP, device="cpu")
        net.load_state_dict(sd)
        log(f"  {CKPT}: {len(sd)} tensors, "
            f"{sum(v.numel() for v in sd.values())} params")
        return sd, net
    sd, net = phase("load checkpoint", 10, load)

    # ---- the enrollment net ------------------------------------------------
    enroll: dict = {}

    def enroll_check():
        """EmbedNet from its checkpoint on the card against the same net
        on the CPU, one seeded 5 s binaural enrollment (a tone per item
        plus noise, made on the card); 6 BiLSTM launches a call (3
        blocks x intra and inter), nothing else. The inputs of those
        six LSTMs are kept for the kernel check at their shapes."""
        gen = torch.Generator(device=dev).manual_seed(5)
        n = int(ENROLL_SECONDS * 16000)
        t = torch.arange(n, device=dev) / 16000.0
        f0 = torch.rand((ENROLL_BATCH, 1), generator=gen, device=dev) \
            * 280 + 120
        src = torch.sin(2 * np.pi * f0 * t)
        x = torch.stack([src, torch.roll(src, 3, -1)], 1) * 0.3
        x = x + 0.05 * torch.randn(x.shape, generator=gen, device=dev)
        cpu_net, gpu_net = (load_checkpoint(EmbedNet(device=d), EMBED_CKPT)
                            for d in ("cpu", "cuda"))
        seen = []
        hooks = [m.register_forward_hook(
                     lambda mod, args, out: seen.append((mod, args[0])))
                 for blk in gpu_net.net.trunk.blocks
                 for m in (blk.intra_rnn, blk.inter_rnn)]
        reset_counts()
        d_gpu = gpu_net(x)
        torch.cuda.synchronize()
        counts = read_counts()
        for h in hooks:
            h.remove()
        expect_counts(counts, {"bilstm_scan": 6}, "EmbedNet")
        d_cpu = cpu_net(x.cpu())
        peak = d_cpu.abs().max().item()
        err = (d_gpu.cpu() - d_cpu).abs().max().item()
        if not (tuple(d_gpu.shape) == (ENROLL_BATCH, 256)
                and torch.isfinite(d_gpu).all() and peak > 0
                and err <= TOL_ENROLL * peak):
            raise AssertionError(f"EmbedNet GPU vs CPU: {err} (peak {peak})")
        enroll.update(net=gpu_net, dvec=d_gpu, x=x, rnn_inputs=seen)
        log(f"  {EMBED_CKPT}: 275 tensors loaded strictly; {ENROLL_BATCH} x "
            f"{ENROLL_SECONDS:g} s, float32: max|GPU - CPU| / peak = "
            f"{err / peak:.3e} (tolerance {TOL_ENROLL}); launches: "
            f"bilstm_scan {counts['bilstm_scan']} (3 blocks x intra and "
            f"inter, no other kernel)")
    phase("path: EmbedNet GPU vs CPU", 30, enroll_check)

    def scan_vs_plain(xp, w_hh, what, c_of_peak=False):
        """B2 against its plain version on the same card tensors (both
        also against a float64 run of the recurrence, logged): ys and
        the final cell state c_t held to TOL_LSTM up to 97 steps and
        TOL_LSTM_LONG beyond, c_t to that times max(1, its peak) where
        `c_of_peak`; the largest |kernel - plain|."""
        got = bilstm_scan_cuda(xp, w_hh)
        plain = bilstm_scan_reference(xp, w_hh)
        exact = bilstm_scan_reference(xp, w_hh, torch.float64)

        def diff(a, b, i):
            return (a[i].double() - b[i].double()).abs().max().item()
        tol = TOL_LSTM if xp.shape[0] <= 97 else TOL_LSTM_LONG
        peak = exact[1].abs().max().item()
        c_tol = tol * max(1.0, peak) if c_of_peak else tol
        e_ys, e_c = diff(got, plain, 0), diff(got, plain, 1)
        log(f"  {what}, xp {list(xp.shape)}: max|kernel - plain| ys "
            f"{e_ys:.3e}, c_t {e_c:.3e} (tolerance {tol}"
            + (f", c_t {c_tol:.3g}: x max(1, peak |c| {peak:.3g})"
               if c_of_peak else "")
            + f"); from float64: kernel ys {diff(got, exact, 0):.3e} c_t "
            f"{diff(got, exact, 1):.3e}, plain ys {diff(plain, exact, 0):.3e}"
            f" c_t {diff(plain, exact, 1):.3e}")
        if not (e_ys <= tol and e_c <= c_tol):
            raise AssertionError(f"bilstm_scan differs: ys {e_ys}, c_t {e_c}")
        return max(e_ys, e_c)

    def lstm_enroll_check():
        """The kernel against its plain version on the six scans of the
        enrollment call above, at their own inputs and shapes."""
        errs, enroll["scan_inputs"] = [], []
        for i, (mod, a) in enumerate(enroll["rnn_inputs"]):
            xp, w_hh = (t.contiguous() for t in bidir_scan_inputs(
                mod.params(), mod.params("_l0_reverse"), a))
            errs.append(scan_vs_plain(
                xp, w_hh, f"block {i // 2} {('intra', 'inter')[i % 2]}"))
            if i < 2:                   # block 0's two, for the times
                enroll["scan_inputs"].append((xp, w_hh))
        res["bilstm_scan"]["max_abs_err"] = max(
            res["bilstm_scan"]["max_abs_err"], *errs)
        del enroll["rnn_inputs"]
    phase("bilstm_scan vs plain, enrollment shapes", 10, lstm_enroll_check)

    # the eval's batch of 4 x 5 s (phase 8): the full forward's scan and
    # EmbedNet's intra and inter scans; the random inputs are kept for
    # the times
    eval_scans = {}

    def lstm_eval_check():
        """B2 against its plain version at the eval's three shapes, on
        random inputs made on the card from a seed and on the eval's own
        inputs: the first batch of the 5k test split through both
        checkpoints, the nine scans' inputs captured by hooks. ys as
        above; c_t, which no model reads (every caller drops the final
        state), to the same bound times max(1, its peak): on the eval's
        1,248-step chains |c| grows to ~600, where float32's spacing is
        6.1e-5 and the plain version itself lies ~1.6e-4 from the
        float64 recurrence, so no absolute bound of 1e-4 can hold."""
        from lookoncetohear_tpu_torch import utils
        from lookoncetohear_tpu_torch.data.loader import collate
        g = torch.Generator(device=dev).manual_seed(2)
        errs = []
        for key, t_, bb in (("eval", 97, 4 * 625),
                            ("eval_enroll_intra", 62, 4 * 1251),
                            ("eval_enroll_inter", 1248, 4 * 65)):
            xp = torch.randn((t_, 2, bb, 256), generator=g, device=dev) * 0.5
            w_hh = torch.randn((2, 64, 256), generator=g, device=dev) * 0.3
            errs.append(scan_vs_plain(xp, w_hh, f"random, {key}", True))
            eval_scans[key] = (xp, w_hh)
        cfg = utils.Params(TSH_5K)
        ds = utils.import_attr(cfg.test_dataset)(**cfg.test_data_args)
        inputs, _ = collate([ds[i] for i in range(4)])
        sep = Net(**FLAGSHIP)
        sep.load_state_dict(sd)
        seen = []
        mods = [m for blk in enroll["net"].net.trunk.blocks
                for m in (blk.intra_rnn, blk.inter_rnn)] + \
            [blk.intra_rnn for blk in sep.tfgridnet.blocks]
        hooks = [m.register_forward_hook(
                     lambda mod, args, out: seen.append((mod, args[0])))
                 for m in mods]
        with torch.no_grad():
            d = enroll["net"](gpu(inputs["enrollments"][:, 0]))
            sep(gpu(inputs["mixture"]), d[:, None])
        for h in hooks:
            h.remove()
        for i, (mod, a) in enumerate(seen):
            xp, w_hh = (t.contiguous() for t in bidir_scan_inputs(
                mod.params(), mod.params("_l0_reverse"), a))
            what = (f"EmbedNet block {i // 2} {('intra', 'inter')[i % 2]}"
                    if i < 6 else f"Net.forward block {i - 6}")
            errs.append(scan_vs_plain(xp, w_hh, f"test scenes 0-3, {what}",
                                      True))
        res["bilstm_scan"]["max_abs_err"] = max(
            res["bilstm_scan"]["max_abs_err"], *errs)
    phase("bilstm_scan vs plain, eval shapes", 10, lstm_eval_check)

    emb = rng.standard_normal((STREAMS, 256)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    t_ax = np.arange(PATH_STEPS * 128) / 16000.0

    def chunks_of(n_streams, n_steps, seed):
        """Binaural chunks: a tone per stream plus noise, the right ear
        a few samples late."""
        g = np.random.default_rng(seed)
        f0 = g.uniform(120, 400, (n_streams, 1))
        src = np.sin(2 * np.pi * f0 * t_ax[None, :n_steps * 128])
        x = np.stack([src, np.roll(src, 3, axis=-1)], axis=1) * 0.3
        x = x + 0.05 * g.standard_normal(x.shape)
        x = x.astype(np.float32).reshape(n_streams, 2, n_steps, 128)
        return x.transpose(2, 0, 1, 3)         # [steps, streams, 2, 128]

    def state_leaves(eng):
        """The engine's carried tensors, in a fixed order."""
        yield "input_tail", eng.input_tail
        for k in ("conv_buf", "deconv_buf", "istft_buf"):
            yield k, eng.state[k]
        for i, blk in enumerate(eng.state["blocks"]):
            for k in sorted(blk):
                yield f"blocks.{i}.{k}", blk[k]

    def path_vs_cpu(kv_dtype, kernel):
        """Every step starts both engines from the CPU engine's state,
        so int8 flips of one step do not compound into the next."""
        n, steps = 4, 6
        engines = [StreamingEngine(net, sd, max_streams=n,
                                   dtype=torch.float32, kv_dtype=kv_dtype,
                                   device=d, cuda_graph=False)
                   for d in ("cuda", "cpu")]
        for eng in engines:
            for s in range(n):
                eng.add_stream(s, emb[s])
        worst, flips, peak = 0.0, 0, 0.0
        reset_counts()
        for x in chunks_of(n, steps, 1):
            for (_, g), (_, c) in zip(*map(state_leaves, engines)):
                g.copy_(c)
            y_gpu, y_cpu = (eng.step(x).float().cpu().numpy()
                            for eng in engines)
            peak = float(np.abs(y_cpu).max())
            err = float(np.abs(y_gpu - y_cpu).max())
            if not (np.isfinite(y_gpu).all()
                    and err <= TOL_PATH * max(peak, 1e-3)):
                raise AssertionError(f"GPU vs CPU engine: {err} (peak {peak})")
            worst = max(worst, err / max(peak, 1e-3))
            for (name, g), (_, c) in zip(*map(state_leaves, engines)):
                g, c = g.cpu(), c
                if c.dtype == torch.int8:
                    d = (g.int() - c.int()).abs()
                    # the slot written this step: n rows x one slot
                    allowed = max(1, n * c.shape[-1] // 1000)
                    if d.max() > 1 or int((d > 0).sum()) > allowed:
                        raise AssertionError(f"{name}: int8 ring differs")
                    flips += int((d > 0).sum())
                elif c.is_floating_point():
                    tol = TOL_STATE * max(1.0, float(c.abs().max()))
                    if float((g - c).abs().max()) > tol:
                        raise AssertionError(f"{name}: state differs")
                elif not torch.equal(g, c):
                    raise AssertionError(f"{name}: cursor differs")
        expect_counts(read_counts(), {"bilstm_scan": 3 * steps,
                                      kernel: 3 * steps,
                                      "flat_norm": flat_norms(kv_dtype)
                                      * steps}, "GPU engine")
        if peak == 0.0:
            raise AssertionError("engine output is all zeros")
        ring = "int8" if kv_dtype == torch.int8 else "float32"
        log(f"  4 streams x {steps} steps, float32, {ring} K/V, each step "
            f"from the same state: max|GPU - CPU| / peak = {worst:.3e} "
            f"(tolerance {TOL_PATH}); float state within {TOL_STATE}; "
            f"{flips} int8 ring entries off by one in {steps} steps")
    phase("path: GPU engine vs CPU engine", 10,
          lambda: path_vs_cpu(torch.int8, "ring_int8_step"))
    phase("path: f32-ring GPU engine vs CPU engine", 10,
          lambda: path_vs_cpu(None, "attn_step_f32"))

    def streamed_vs_full():
        """The engine emits each chunk one step late (it waits for the
        next chunk's lookahead): engine chunk k == full chunk k-1. The
        GPU full forward also runs against the CPU one."""
        n, n_chunks, c = 2, 12, 128
        x = chunks_of(n, n_chunks, 3).transpose(1, 2, 0, 3).reshape(
            n, 2, n_chunks * c)
        eng = StreamingEngine(net, sd, max_streams=n)
        for s in range(n):
            eng.add_stream(s, emb[s])
        streamed = torch.cat([eng.step(x[..., i * c:(i + 1) * c])
                              for i in range(n_chunks)], -1).cpu().numpy()
        net_gpu = Net(**FLAGSHIP)
        net_gpu.load_state_dict(sd)
        e = torch.from_numpy(emb[:n])
        full_gpu, _ = net_gpu.predict(gpu(x), e.to(dev),
                                      net_gpu.init_state(n), pad=False)
        full_cpu, _ = net.predict(torch.from_numpy(x), e, net.init_state(n),
                                  pad=False)
        full_gpu, full_cpu = full_gpu.cpu().numpy(), full_cpu.numpy()
        m = n_chunks * c - c
        err = float(np.abs(streamed[..., c:] - full_gpu[..., :m]).max())
        peak = float(np.abs(full_cpu).max())
        err_cpu = float(np.abs(full_gpu - full_cpu).max())
        if not (full_gpu.shape == (n, 2, m) and np.isfinite(full_gpu).all()
                and peak > 0 and err <= TOL_STREAMED
                and err_cpu <= TOL_PATH * peak):
            raise AssertionError(f"streamed vs full {err}, GPU vs CPU full "
                                 f"{err_cpu} (peak {peak})")
        log(f"  {n} streams x {n_chunks} chunks, float32 ring: max|engine "
            f"chunk k - full chunk k-1| = {err:.3e} (atol {TOL_STREAMED}); "
            f"max|GPU full - CPU full| / peak = {err_cpu / peak:.3e} "
            f"(tolerance {TOL_PATH})")
    phase("path: streamed == full forward on the card", 10,
          streamed_vs_full)

    xs = torch.from_numpy(chunks_of(STREAMS, PATH_STEPS, 2)).to(dev)
    engines = {}

    def path_64(label, dtype, kv_dtype, kernel, steps):
        eng = StreamingEngine(net, sd, max_streams=STREAMS, dtype=dtype,
                              kv_dtype=kv_dtype, cuda_graph=False)
        for s in range(STREAMS):
            eng.add_stream(s, emb[s])
        x = xs.to(dtype)
        reset_counts()
        outs = [eng.step(x[i]) for i in range(steps)]
        torch.cuda.synchronize()
        counts = read_counts()
        y = torch.stack(outs).float()
        if not (tuple(y.shape) == (steps, STREAMS, 2, 128)
                and torch.isfinite(y).all()):
            raise AssertionError(f"bad output {tuple(y.shape)}")
        if y[1:].abs().max().item() == 0.0:
            raise AssertionError("engine output is all zeros")
        flat = flat_norms(kv_dtype)
        expect_counts(counts, {"bilstm_scan": 3 * steps, kernel: 3 * steps,
                               "flat_norm": flat * steps}, label)
        launch_counts[kernel] = counts[kernel]
        launch_counts.setdefault("bilstm_scan", counts["bilstm_scan"])
        launch_counts.setdefault("flat_norm", counts["flat_norm"])
        engines[label] = (eng, x)
        log(f"  {STREAMS} streams x {steps} steps, {label}: finite, peak "
            f"|y| {y.abs().max().item():.3f}; launches: bilstm_scan "
            f"{counts['bilstm_scan']}, {kernel} {counts[kernel]} (3 blocks "
            f"x {steps} steps each), flat_norm {counts['flat_norm']} ({flat} "
            f"a step), no other kernel")
    phase("path: 64-stream bf16 engine", 10, lambda: path_64(
        "bf16 + int8 K/V", torch.bfloat16, torch.int8, "ring_int8_step",
        PATH_STEPS))
    phase("path: 64-stream f32 ring", 10, lambda: path_64(
        "float32 ring", torch.float32, None, "attn_step_f32", PATH_STEPS))
    phase("path: 64-stream bf16 ring", 10, lambda: path_64(
        "bf16 ring", torch.bfloat16, None, "attn_step_bf16", PATH_STEPS))
    phase("path: 64-stream f32 + bf16 ring", 10, lambda: path_64(
        "float32 + bf16 ring", torch.float32, torch.bfloat16,
        "attn_step_f32_bf16kv", FLOAT_PATH_STEPS))

    def op_ring_int8():
        """The op entry of the int8 ring attention kernel on the
        head-major serving rows, against the same op on a CPU copy from
        the same state: ring and cursor bit-exact, out as in phase 5."""
        rows, w1 = ATTN["rows"], ATTN["w1"]
        for qdt, name in ((torch.float32, "attn_step_f32_int8kv"),
                          (torch.bfloat16, "attn_step_bf16_int8kv")):
            a, sc = attn_inputs(rows, qdt, torch.int8, 7)
            ring = [a[3], sc["k_scale"], a[4], sc["v_scale"],
                    torch.tensor(w1 - 3, dtype=torch.int32, device=dev)]
            g = np.random.default_rng(8)
            worst = 0.0
            reset_counts()
            for _ in range(OP_RING_STEPS):
                q, kt, vt = (gpu(g.standard_normal(t.shape).astype(
                    np.float32), qdt) for t in a[:3])
                ring_cpu = [t.to("cpu", copy=True) for t in ring]
                out, *ring = local_attention_step_ring_int8(q, kt, vt, *ring)
                out_cpu, *ring_cpu = local_attention_step_ring_int8(
                    q.cpu(), kt.cpu(), vt.cpu(), *ring_cpu)
                for t, c in zip(ring, ring_cpu):
                    if not torch.equal(t.cpu(), c):
                        raise AssertionError(f"{name}: ring differs")
                err = (out.float().cpu() - out_cpu.float()).abs().max().item()
                tol = TOL_ATTN_INT8 * (1 + out_cpu.float().abs().max().item()) \
                    if qdt == torch.float32 else TOL_ATTN_BF16
                if not err <= tol:
                    raise AssertionError(f"{name}: out differs {err}")
                worst = max(worst, err)
            counts = read_counts()
            expect_counts(counts, {name: OP_RING_STEPS}, name)
            launch_counts[name] = counts[name]
            if int(ring[-1]) != (w1 - 3 + OP_RING_STEPS) % w1:
                raise AssertionError(f"cursor {int(ring[-1])}")
            log(f"  {rows} rows x {w1} int8 slots, {str(qdt)[6:]} q, "
                f"{OP_RING_STEPS} steps through the wrap: ring, scales and "
                f"cursor bit-exact with the CPU op, max|out diff| "
                f"{worst:.3e}; {name} launched {counts[name]} times")
    phase("path: int8 op ring (B4)", 10, op_ring_int8)

    # ---- the CUDA-graph engine ------------------------------------------
    graphs = {}
    graph_rings = (
        ("bf16 + int8 K/V", torch.bfloat16, torch.int8, "ring_int8_step"),
        ("float32 ring", torch.float32, None, "attn_step_f32"),
        ("bf16 ring", torch.bfloat16, None, "attn_step_bf16"),
        ("float32 + bf16 ring", torch.float32, torch.bfloat16,
         "attn_step_f32_bf16kv"))

    def graph_vs_eager(label, dtype, kv_dtype, kernel):
        """The graph engine (the default on the card) against the eager
        engine, 64 streams, GRAPH_STEPS steps from the same start. Both
        run the same kernels on the same state, so the output and every
        state leaf must be bit-identical after every step: a difference
        is a fault of the graph (a stale leaf, a wrong masked restore).
        The masked graph runs at step 0 (no slot primed), at step 20 (an
        `add_stream` between replays) and from step 40 on (slot 9
        inactive); the all-primed graph the other steps. The graph
        engine's Python runs each kernel wrapper only to warm up and
        capture its two graphs."""
        engs = [StreamingEngine(net, sd, max_streams=STREAMS, dtype=dtype,
                                kv_dtype=kv_dtype, cuda_graph=g)
                for g in (False, True)]
        for eng in engs:
            for s in range(STREAMS):
                eng.add_stream(s, emb[s])
        x = xs.to(dtype)
        reset_counts()
        for i in range(GRAPH_STEPS):
            for eng in engs:
                if i == 20:
                    eng.add_stream(5, emb[6])
                if i == 40:
                    eng.remove_stream(9)
            y_e, y_g = (eng.step(x[i % PATH_STEPS]) for eng in engs)
            if not (torch.isfinite(y_g).all() and torch.equal(y_g, y_e)):
                err = (y_g.float() - y_e.float()).abs().max().item()
                raise AssertionError(f"step {i}: graph output differs from "
                                     f"eager by up to {err}")
            for (name, e), (_, g) in zip(*map(state_leaves, engs)):
                if not torch.equal(g, e):
                    raise AssertionError(f"step {i}: graph state {name} "
                                         f"differs from eager")
        counts = read_counts()
        per_call = 3 * (GRAPH_STEPS + 2 * (WARMUP_STEPS + 1))
        expect_counts(counts, {"bilstm_scan": per_call, kernel: per_call,
                               "flat_norm": per_call // 3
                               * flat_norms(kv_dtype)}, label)
        if set(engs[1]._graphs) != {False, True}:
            raise AssertionError("the graph engine did not capture both "
                                 "graphs")
        if y_e[:, 0].abs().max().item() == 0.0:
            raise AssertionError("engine output is all zeros")
        engs[1].add_stream(9, emb[9])           # all slots live again
        engs[1].step(x[0])
        graphs[label] = (engs[1], x)
        log(f"  {label}, {STREAMS} streams x {GRAPH_STEPS} steps: output "
            f"and every state leaf bit-identical to the eager engine's "
            f"after every step; launches: {kernel} and bilstm_scan "
            f"{counts[kernel]} each = 3 x ({GRAPH_STEPS} eager steps + 2 "
            f"graphs x ({WARMUP_STEPS} warm-up steps + 1 capture)), "
            f"flat_norm {counts['flat_norm']}: the replays ran no Python")
    for label, dtype, kv_dtype, kernel in graph_rings:
        phase(f"graph: {label} graph vs eager engine", 10,
              lambda a=(label, dtype, kv_dtype, kernel): graph_vs_eager(*a))

    def look_once_then_hear():
        """The d-vectors EmbedNet made on the card become streams 0 and 1
        of the 64-stream bf16 + int8 graph engine."""
        eng = graphs["bf16 + int8 K/V"][0]
        for s in range(ENROLL_BATCH):
            eng.add_stream(s, enroll["dvec"][s].cpu().numpy())
        x = xs.to(torch.bfloat16)
        ys = torch.stack([eng.step(x[i]) for i in range(6)]).float()
        if not (torch.isfinite(ys).all() and ys[0, :2].abs().max() == 0
                and ys[1:, :2].abs().max() > 0):
            raise AssertionError("the enrolled streams' output is wrong")
        log(f"  EmbedNet d-vectors -> slots 0-{ENROLL_BATCH - 1} of the "
            f"graph engine: 6 steps finite, zero until primed, then peak "
            f"|y| {ys[1:, :2].abs().max().item():.3f}")
    phase("look once, then hear", 10, look_once_then_hear)

    def pipelined():
        """step_pipelined(depth=4) + drain() return exactly the outputs
        of `step` from the same state, in order, from host chunks."""
        eng = graphs["bf16 + int8 K/V"][0]
        host = chunks_of(STREAMS, 12, 7)
        saved = [t.clone() for t in eng._carried()]
        ref = [eng.step(c).float().cpu().numpy() for c in host]
        for t, v in zip(eng._carried(), saved):
            t.copy_(v)
        got = [y for y in (eng.step_pipelined(c, depth=4) for c in host)
               if y is not None] + eng.drain()
        if len(got) != len(ref) or not all(
                np.array_equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError("pipelined outputs differ from step's")
        log(f"  {len(host)} steps, depth 4: step_pipelined + drain == step, "
            f"bit for bit, in order")
    phase("pipelined == step", 10, pipelined)

    def cursors(eng):
        return [int(b["pos"]) for b in eng.state["blocks"] if "pos" in b]

    def share_state(one, two):
        """Copy the 64-stream engine's carried state into the split
        engines' (its first half of the rows into the first engine)."""
        half = STREAMS // len(two.engines)
        for (_, src), *dsts in zip(state_leaves(one),
                                   *map(state_leaves, two.engines)):
            for j, (_, dst) in enumerate(dsts):
                dst.copy_(src[j * half:(j + 1) * half]
                          if src.ndim and src.shape[0] == STREAMS else src)

    def split_engines():
        """`MultiDeviceEngine` over ["cuda:0", "cuda:0"]: two graph
        engines, 32 streams each, against one 64-stream graph engine over
        GRAPH_STEPS steps from the same start, at the float32 ring (within
        TOL_PATH of the peak; bit for bit on an H100), at an int8
        ring under float32 compute and at bf16 + int8; the engines' ring
        cursors equal after every step. With an int8 ring a GEMM over 32
        rows that rounds apart from one over 64 (the flat-norm
        statistics at float32, every bf16 GEMM) can move a ring entry by
        one step, and the carried state compounds it over the steps, as
        between the GPU and CPU engines: there each step also runs from
        the single engine's state copied into the split engines, which
        holds one step to TOL_PATH (float32) or TOL_SPLIT_BF16 (bf16) of
        the peak; free-running, the split's largest and RMS deviations
        are held to TOL_SPLIT_FREE, and printed beside the precision's
        own RMS error (the single engine against a float32-ring engine on
        the same chunks)."""
        for label, dtype, kv_dtype, tol in (
                ("float32 ring", torch.float32, None, TOL_PATH),
                ("float32 + int8 K/V", torch.float32, torch.int8, TOL_PATH),
                ("bf16 + int8 K/V", torch.bfloat16, torch.int8,
                 TOL_SPLIT_BF16)):
            one = StreamingEngine(net, sd, max_streams=STREAMS, dtype=dtype,
                                  kv_dtype=kv_dtype)
            two = MultiDeviceEngine(net, sd, max_streams=STREAMS,
                                    dtype=dtype, kv_dtype=kv_dtype,
                                    devices=["cuda:0", "cuda:0"])
            for eng in (one, two):
                for s in range(STREAMS):
                    eng.add_stream(s, emb[s])
            x = xs.to(dtype)
            shared = kv_dtype == torch.int8
            err = peak = step_err = sq_err = sq = sq_prec = 0.0
            carried = [t for e in (one, *two.engines) for t in e._carried()]
            if shared:
                # the precision's own error: the float32-ring engine
                ref = StreamingEngine(net, sd, max_streams=STREAMS)
                for s in range(STREAMS):
                    ref.add_stream(s, emb[s])
            for i in range(GRAPH_STEPS):
                xi = x[i % PATH_STEPS]
                if shared and i > 0:
                    # one step from the single engine's state, then both
                    # back to where they were
                    saved = [t.clone() for t in carried]
                    share_state(one, two)
                    y1 = one.step(xi).float()
                    step_err = max(step_err, (y1 - two.step(xi).float())
                                   .abs().max().item())
                    for t, v in zip(carried, saved):
                        t.copy_(v)
                y1 = one.step(xi).float()
                y2 = two.step(xi).float()
                if shared:
                    sq_prec += (y1 - ref.step(xs[i % PATH_STEPS])).pow(2) \
                        .sum().item()
                if not (y2.shape == y1.shape and torch.isfinite(y2).all()):
                    raise AssertionError(f"{label}: step {i} output")
                err = max(err, (y1 - y2).abs().max().item())
                peak = max(peak, y1.abs().max().item())
                sq_err += (y1 - y2).pow(2).sum().item()
                sq += y1.pow(2).sum().item()
                if any(cursors(e) != cursors(one) for e in two.engines):
                    raise AssertionError(f"{label}: step {i} cursors differ")
            rms, rms_prec = (sq_err / sq) ** 0.5, (sq_prec / sq) ** 0.5
            if shared:
                free_max, free_rms = TOL_SPLIT_FREE[label]
            bad = not peak > 0 or (
                step_err > tol * peak or err > free_max * peak
                or rms > free_rms if shared else err > tol * peak)
            if bad:
                raise AssertionError(
                    f"{label}: 2 engines vs 1: max {err}, one step from the "
                    f"same state {step_err}, RMS {rms} (peak {peak}, "
                    f"tolerance {tol})")
            ms1 = wall_ms(lambda i: one.step(x[i % PATH_STEPS]), 20)
            ms2 = wall_ms(lambda i: two.step(x[i % PATH_STEPS]), 20)
            held = (f"one step from the same state {step_err / peak:.3e} "
                    f"of the peak (tolerance {tol}); free-running: max "
                    f"{err / peak:.3e} of the peak (tolerance {free_max}), "
                    f"RMS {rms:.3e} of the output's (tolerance "
                    f"{free_rms}; the precision's own against the float32 "
                    f"ring {rms_prec:.3e})") if shared else \
                (f"max|2 engines - 1| / peak = {err / peak:.3e} (tolerance "
                 f"{tol})")
            log(f"  {label}, 2 x {STREAMS // 2} streams vs 1 x {STREAMS}, "
                f"{GRAPH_STEPS} steps: {held}; cursors equal every step; "
                f"step call to sync {ms2:.3f} ms (2 engines) vs {ms1:.3f} ms "
                f"(1) [{smi}]")
    phase("path: 64 streams over 2 engines", 12, split_engines)

    def profiling_phase():
        """`profiling` on the card: LatencyRecorder over PROFILE_STEPS
        steps of the 64-stream bf16 + int8 graph engine, device_step_time
        by CUDA events, cost_analysis of one 64-stream float32 step on the
        card (aten ops: the hand-written kernels are not counted) and on
        the CPU (their plain versions counted), and a trace written."""
        from lookoncetohear_tpu_torch import profiling
        eng, x = graphs["bf16 + int8 K/V"]
        saved = [t.clone() for t in eng._carried()]
        rec = profiling.LatencyRecorder()
        for i in range(PROFILE_STEPS):
            with rec.measure(sync=dev):
                eng.step(x[i % PATH_STEPS])
        lat = rec.summary()
        dev_ms = profiling.device_step_time(eng.step, (x[0],)) * 1e3
        for t, v in zip(eng._carried(), saved):
            t.copy_(v)
        if not (lat["n"] == PROFILE_STEPS and 0 < lat["p50_ms"]
                <= lat["p99_ms"] and dev_ms > 0):
            raise AssertionError(f"latency {lat}, device {dev_ms}")
        eager, x32 = engines["float32 ring"]
        gpu_cost = profiling.cost_analysis(eager.step, x32[0])
        cpu_eng = StreamingEngine(net, sd, max_streams=STREAMS,
                                  device="cpu")
        for s in range(STREAMS):
            cpu_eng.add_stream(s, emb[s])
        cpu_cost = profiling.cost_analysis(cpu_eng.step, x32[0].cpu())
        with tempfile.TemporaryDirectory(prefix="port_trace_") as tmp:
            with profiling.trace(tmp) as prof:
                for i in range(3):
                    eager.step(x32[i])
            with open(os.path.join(tmp, "trace.json")) as f:
                n_events = len(json.load(f)["traceEvents"])
        ran = {k: sum(TRACE_NAMES[k] in ev.name for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA)
               for k in ("bilstm_scan", "attn_step_f32")}
        if not (0 < gpu_cost["flops"] < cpu_cost["flops"] and n_events
                and all(ran.values())):
            raise AssertionError(f"flops {gpu_cost} / {cpu_cost}, "
                                 f"{n_events} trace events, kernels {ran}")
        log(f"  LatencyRecorder, {PROFILE_STEPS} graph steps (bf16 + int8, "
            f"{STREAMS} streams, call to sync): p50 {lat['p50_ms']:.3f} / "
            f"p90 {lat['p90_ms']:.3f} / p99 {lat['p99_ms']:.3f} / max "
            f"{lat['max_ms']:.3f} ms; device_step_time {dev_ms:.3f} ms "
            f"(CUDA events) [{smi}]; cost_analysis of one {STREAMS}-stream "
            f"float32 step: {gpu_cost['flops'] / 1e9:.3f} GFLOP on the card "
            f"(aten ops), {cpu_cost['flops'] / 1e9:.3f} GFLOP on the CPU "
            f"(the plain versions' products too), "
            f"{gpu_cost['bytes_accessed'] / 1e6:.2f} MB in and out; trace: "
            f"{n_events} events in 3 eager float32-ring steps, the port's "
            f"kernels {ran}")
    phase("profiling", 23, profiling_phase)

    # ---- 7. times (CUDA events) ----------------------------------------
    def engine_times(label, kernel, absent=()):
        eng, x = engines[label]
        for i in range(10):                     # warm-up
            eng.step(x[i])
        step_ms = wall_ms(lambda i: eng.step(x[i % PATH_STEPS]),
                          TIMED_STEPS)
        log(f"  engine step, {STREAMS} streams {label}, eager: median "
            f"{step_ms:.3f} ms from call to synchronize ({TIMED_STEPS} "
            f"steps), RTF {step_ms / CHUNK_MS:.4f} [{smi}]")
        out = dict(step_ms=step_ms, rtf=step_ms / CHUNK_MS)
        out.update(profile_steps(eng, x[:10], torch,
                                 {"bilstm_scan": 3, kernel: 3,
                                  "flat_norm": flat_norms(
                                      eng.state["blocks"][0]["k_buf"].dtype)},
                                 absent, (reset_counts, read_counts)))
        return out

    def graph_times(label, kernel, absent=()):
        """The graph engine's step: call to synchronize, its
        `benchmark_device` (replays between CUDA events, slope of 100
        and 500 steps) and `benchmark` (call to a fetched element), and
        a profile of its device ops: 3 BiLSTM scans and 3 ring steps a
        replay, no other kernel of the port, and no launch counter
        bumped (the replays run no wrapper)."""
        eng, x = graphs[label]
        for i in range(10):                     # warm-up
            eng.step(x[i])
        step_ms = wall_ms(lambda i: eng.step(x[i % PATH_STEPS]),
                          TIMED_STEPS)
        out = dict(step_ms=step_ms, rtf=step_ms / CHUNK_MS)
        out.update(eng.benchmark_device())
        out.update(eng.benchmark())
        eager = res["engine"][label]["step_ms"]
        log(f"  engine step, {STREAMS} streams {label}, CUDA graph: median "
            f"{step_ms:.3f} ms from call to synchronize (eager "
            f"{eager:.3f}), RTF {step_ms / CHUNK_MS:.4f}; benchmark_device "
            f"{out['device_p50_ms']:.3f} ms p50, {out['device_best_ms']:.3f} "
            f"best, RTF {out['rtf']:.4f}; benchmark p50 "
            f"{out['p50_ms_incl_transport']:.3f} ms incl. transport [{smi}]")
        reset_counts()
        flat = flat_norms(eng.state["blocks"][0]["k_buf"].dtype)
        out.update(profile_steps(
            eng, x[:10], torch, {"bilstm_scan": 3, kernel: 3,
                                 "flat_norm": flat}, absent,
            replays=f"the graph's every step matched the eager engine's, "
                    f"3 B2, 3 {kernel} and {flat} flat_norm launches a "
                    f"step, bit for bit"))
        expect_counts(read_counts(), {}, f"{label} graph replays")
        return out

    def times():
        # the eager and the graph step at the three rings of the 64-stream
        # paths (the float32 + bf16 ring is checked, not timed)
        timed = [(label, kernel, ("ring_advance_pos",)
                  if kernel == "ring_int8_step" else ())
                 for label, _, _, kernel in graph_rings[:3]]
        res["engine"] = {label: engine_times(label, *a)
                         for label, *a in timed}
        res["graph"] = {label: graph_times(label, *a)
                        for label, *a in timed}

        # the enrollment net on one 5 s enrollment, float32
        x1 = enroll["x"][:1]
        enroll["net"](x1)                           # warm-up
        e_ms = wall_ms(lambda i: enroll["net"](x1), 3)
        res["enroll"] = dict(seconds=ENROLL_SECONDS, ms=e_ms)
        log(f"  EmbedNet, 1 x {ENROLL_SECONDS:g} s, float32: {e_ms:.1f} ms "
            f"from call to synchronize (median of 3) [{smi}]")

        # BiLSTM at the step's shape, xp [97, 2, 64, 256] f32, at the
        # full forward's 625 rows (random inputs), at the enrollment
        # call's intra and inter shapes (block 0's own inputs) and at the
        # eval's three (the checked random inputs above), each
        # beside cuDNN's LSTM (input width 64, the separator checkpoint's
        # block-0 weights) over the same rows and steps
        h = 64
        lstm = torch.nn.LSTM(64, h, batch_first=True,
                             bidirectional=True).to(dev)
        with torch.no_grad():
            for sfx in ("_l0", "_l0_reverse"):
                for a, tn in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                              ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                    getattr(lstm, tn + sfx).copy_(
                        sd[f"tfgridnet.blocks.0.intra_rnn.{a}{sfx}"])

        def random_scan(t_, bb):
            return (gpu((rng.standard_normal((t_, 2, bb, 4 * h)) * 0.5)
                        .astype(np.float32)),
                    gpu((rng.standard_normal((2, h, 4 * h)) * 0.3)
                        .astype(np.float32)))
        cases = [("bilstm_scan", random_scan(97, STREAMS)),
                 ("bilstm_scan_625", random_scan(97, 625)),
                 ("bilstm_scan_enroll_intra", enroll["scan_inputs"][0]),
                 ("bilstm_scan_enroll_inter", enroll["scan_inputs"][1]),
                 *(("bilstm_scan_" + k, v) for k, v in eval_scans.items())]
        for key, (xp, w_hh) in cases:
            t_, _, bb, _ = xp.shape
            for _ in range(5):
                bilstm_scan_cuda(xp, w_hh)
            k_ms = device_ms(lambda i: bilstm_scan_cuda(xp, w_hh), 100)
            p_ms = wall_ms(lambda i: bilstm_scan_reference(xp, w_hh), 3)
            with torch.no_grad():
                x_in = gpu(rng.standard_normal((bb, t_, 64))
                           .astype(np.float32))
                for _ in range(5):
                    lstm(x_in)
                l_ms = device_ms(lambda i: lstm(x_in), 50)
            nbytes = 4 * (xp.numel() + w_hh.numel() + t_ * 2 * bb * h
                          + 2 * bb * h)
            flops = t_ * 2 * bb * (2 * h * 4 * h + 4 * h)
            t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
            row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                       bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            res.setdefault(key, {}).update(row)
            log(f"  bilstm_scan {list(xp.shape)}: kernel {k_ms * 1e3:.1f} "
                f"us, bound {row['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.1f} "
                f"MB, {flops / 1e9:.3f} GFLOP f32), plain {p_ms * 1e3:.1f} "
                f"us, cuDNN nn.LSTM {l_ms * 1e3:.1f} us [{smi}]")

        # int8 ring step at the path's shapes, bf16 q/k/v, three rings
        # (one per block) so the 92 MB do not sit in the 50 MB L2
        rings = [ring_inputs(torch.bfloat16) for _ in range(3)]
        poss = [torch.tensor(7, dtype=torch.int32, device=dev)
                for _ in range(3)]

        def call(step, i):
            r, p = rings[i % 3], poss[i % 3]
            step(r["q"], r["kt"], r["vt"], r["kb"], r["ks"], r["vb"],
                 r["vs"], p, f=f, n_head=nh, w=w)
        for i in range(6):
            call(ring_attend_int8_step_cuda, i)
        k_ms = device_ms(lambda i: call(ring_attend_int8_step_cuda, i), 150)
        p_ms = wall_ms(lambda i: call(ring_attend_int8_step_reference, i),
                       15)
        live = w - 1
        nbytes = (b * live * (dk + dv) + b * live * 2 * nh * 4
                  + 2 * (2 * b * dk + b * dv) + 2 * b * dv
                  + b * (dk + dv) + b * 2 * nh * 4 + 8)
        flops = 2 * b * live * (dk + dv) + 2 * b * dk
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        res["ring_int8_step"].update(
            ms=k_ms, plain_ms=p_ms, library_ms=None,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"  ring_int8_step B=64 bf16: kernel {k_ms * 1e3:.1f} us, "
            f"bound {res['ring_int8_step']['bound_ms'] * 1e3:.2f} us "
            f"({nbytes / 1e6:.1f} MB over {live} live slots), plain "
            f"{p_ms * 1e3:.1f} us [{smi}]")

        # the flat norms at a flagship step's shapes (bf16) and the
        # default Net's rows (float32): the kernel, the eager chain it
        # replaced (its device time, and call to synchronize), and
        # torch's layer_norm where one call computes the same function
        y, parts = flat_qkv_inputs(STREAMS, torch.bfloat16, 40)
        cases = {"qkv bf16": (
            lambda i: flat_qkv_layer_norm(y, FLAT_QKV["nh"], parts),
            lambda i: flat_qkv_plain(y, parts), None,
            2 * y.numel() * 2 + sum(
                2 * 2 * FLAT_QKV["f"] * dim for dim in FLAT_QKV["dims"]))}
        for label, (n, d, dt) in FLAT_ROWS.items():
            dtype = torch.bfloat16 if dt == "bf16" else torch.float32
            x, sc, bi = flat_row_inputs(n, d, dtype, 41)
            cases[label] = (
                lambda i, a=(x, sc, bi): flat_layer_norm(*a, 1e-5),
                lambda i, a=(x, sc, bi): flat_layer_norm_reference(*a, 1e-5),
                lambda i, a=(x, sc, bi): torch.nn.functional.layer_norm(
                    a[0], (a[0].shape[1],), a[1], a[2], 1e-5),
                (2 * n * d + 2 * d) * x.element_size())
        flat = {}
        for label, (kern, plain, lib, nbytes) in cases.items():
            for _ in range(5):
                kern(0), plain(0)
            k_ms = device_ms(kern, 100)
            chain_ms = device_ms(plain, 30)
            p_ms = wall_ms(plain, 10)
            l_ms = None if lib is None else device_ms(lib, 100)
            flat[label] = dict(ms=k_ms, chain_ms=chain_ms, plain_ms=p_ms,
                               library_ms=l_ms,
                               bound_ms=nbytes / PEAK_BYTES_S * 1e3,
                               bound_by="bytes")
            log(f"  flat_norm {label}: kernel {k_ms * 1e3:.2f} us, bound "
                f"{flat[label]['bound_ms'] * 1e3:.2f} us ({nbytes / 1e6:.2f} "
                f"MB), the replaced eager chain {chain_ms * 1e3:.1f} us on "
                f"the device, {p_ms * 1e3:.1f} us call to synchronize"
                + ("" if l_ms is None else
                   f", F.layer_norm {l_ms * 1e3:.2f} us") + f" [{smi}]")
        step = {k: 3 * (v["qkv bf16"] + 2 * v["intra/inter bf16"]
                        + v["attn out bf16"])
                for k, v in (("ms", {a: b["ms"] for a, b in flat.items()}),
                             ("chain_ms", {a: b["chain_ms"]
                                           for a, b in flat.items()}))}
        log(f"  flat_norm, a flagship step's 12 launches: kernel "
            f"{step['ms'] * 1e3:.1f} us, the replaced chains "
            f"{step['chain_ms'] * 1e3:.1f} us (device time, launched one "
            f"after another)")
        res["flat_norm"].update(flat["qkv bf16"], shapes=flat,
                                flagship_step=step)

        # the floor of device_ms: one launch that does nearly nothing
        one = torch.zeros(1, device=dev)
        for _ in range(10):
            one.add_(1)
        floor_ms = device_ms(lambda i: one.add_(1), 150)
        log(f"  device_ms of a one-element add_ (the method's floor): "
            f"{floor_ms * 1e3:.2f} us [{smi}]")

        # ring attention step at the float ring's serving shape (256
        # head-major rows x 49 slots), each instantiation; three input
        # sets, one per block, so the int8 and bf16 rings do not sit in
        # L2; SDPA on the pre-concatenated [rows, 1, W, D] K/V (the
        # concat, and the cast of a bf16 ring under a float32 q, outside
        # the timed call) where it computes the same function
        from torch.nn.attention import SDPBackend
        sdpa = torch.nn.functional.scaled_dot_product_attention
        backend = {int(v): k for k, v in SDPBackend.__members__.items()}
        rows, w1, adk, adv = (ATTN[k] for k in ("rows", "w1", "dk", "dv"))
        for (qdt, kvdt), name in VARIANTS.items():
            sets = [attn_inputs(rows, qdt, kvdt, 300 + j) for j in range(3)]
            run = lambda fn, i: fn(*sets[i % 3][0], **sets[i % 3][1])  # noqa
            for i in range(6):
                run(attention_step_cuda, i)
            k_ms = device_ms(lambda i: run(attention_step_cuda, i), 150)
            p_ms = wall_ms(lambda i: run(attention_step_reference, i), 15)
            bound, by, mb = attn_bound(
                rows, w1, adk, adv, torch.tensor([], dtype=qdt).element_size(),
                torch.tensor([], dtype=kvdt).element_size(),
                kvdt == torch.int8)
            lib_ms, lib_txt = None, "none (no PyTorch call takes per-slot " \
                "int8 scales)"
            if kvdt != torch.int8:
                cat = []
                for (q, kt, vt, kb, vb), _ in sets:
                    k4 = torch.cat([kb.to(qdt), kt[:, None]], 1)[:, None]
                    v4 = torch.cat([vb.to(qdt), vt[:, None]], 1)[:, None]
                    cat.append((q[:, None, None], k4, v4))
                for i in range(6):
                    sdpa(*cat[i % 3])
                lib_ms = device_ms(lambda i: sdpa(*cat[i % 3]), 150)
                choice = getattr(torch, "_fused_sdp_choice", None)
                picked = backend.get(int(choice(*cat[0])), "?") if choice \
                    else "not reported"
                lib_txt = f"{lib_ms * 1e3:.1f} us (backend {picked})"
            res[name].update(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=by)
            log(f"  {name} [{rows} rows x {w1} slots, Dk {adk}, Dv {adv}]: "
                f"kernel {k_ms * 1e3:.1f} us, bound {bound * 1e3:.2f} us "
                f"({by}: {mb:.1f} MB), plain {p_ms * 1e3:.1f} us, SDPA "
                f"{lib_txt} [{smi}]")

        # the full-utterance forward of a 5 s, 1-stream mixture
        net_gpu = Net(**FLAGSHIP)
        net_gpu.load_state_dict(sd)
        n_samp = int(FULL_SECONDS * 16000)
        x = chunks_of(1, PATH_STEPS, 4).transpose(1, 2, 0, 3).reshape(1, 2, -1)
        x = gpu(np.tile(x, (1, 1, -(-n_samp // x.shape[-1])))[..., :n_samp])
        e = gpu(emb[:1, None])
        net_gpu(x, e)                             # warm-up
        # each call between two CUDA events (the card's time from its
        # first launch to its last), and from call to synchronize
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(FULL_REPS)]
        walls = []
        for start, end in ev:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            net_gpu(x, e)
            end.record()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ev_ms = [start.elapsed_time(end) for start, end in ev]
        fwd_ms = float(np.median(ev_ms))
        res["full_forward"] = dict(seconds=FULL_SECONDS, ms=fwd_ms,
                                   ms_min=min(ev_ms), ms_max=max(ev_ms),
                                   wall_ms=float(np.median(walls)),
                                   rtf=fwd_ms / (FULL_SECONDS * 1e3))
        log(f"  Net.forward, 1 stream x {FULL_SECONDS:g} s, float32: "
            f"{fwd_ms:.2f} ms by CUDA events (median of {FULL_REPS}, "
            f"{min(ev_ms):.2f}-{max(ev_ms):.2f}), "
            f"{np.median(walls):.2f} ms from call to synchronize, RTF "
            f"{fwd_ms / (FULL_SECONDS * 1e3):.4f} [{smi}]")
    phase("times", 55, times)

    # ---- 8. the two-stage eval and the serving-precision study ---------
    def eval_5k(mode, ref, enroll_args, per_batch):
        """The port's eval CLI (`ts_hear_test.run`) on the card over the
        first EVAL_SCENES scenes of the 5k test split, each row held to
        the same row of the JAX package's CSV (`eval_check.tolerances`);
        the kernels launched `per_batch` ({counter: launches}) times a
        batch of 4 and no other kernel: B2 for every BiLSTM, the
        training forward for the separator's inter-time LSTM (a
        625-frame scan from a carried state)."""
        from lookoncetohear_tpu_torch import eval_check, ts_hear_test
        os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "runs")) \
                as tmp:
            with open(TSH_5K) as f:
                cfg = json.load(f)
            cfg["test_data_args"]["n_samples"] = EVAL_SCENES
            cfg_path = os.path.join(tmp, "tsh_synthetic_5k_cut.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f)
            args = ts_hear_test.parse_args(
                ["--config", cfg_path, "--run_dir", tmp, "--ckpt", CKPT,
                 "--num_workers", str(EVAL_WORKERS)] + enroll_args)
            reset_counts()
            t0 = time.perf_counter()
            ts_hear_test.run(args)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            enroll_cfg = os.path.basename(args.enroll_run_dir) or "clean"
            got = eval_check.read_csv(os.path.join(
                tmp, f"results_test_{enroll_cfg}.csv"))
        expect_counts(counts, {k: v * EVAL_SCENES // 4
                               for k, v in per_batch.items()},
                      f"eval, {mode}")
        res = eval_check.compare(
            got, eval_check.read_csv(os.path.join(ROOT, ref))[:EVAL_SCENES])
        log(eval_check.report(res))
        if res["failures"]:
            raise AssertionError(f"eval, {mode}: {len(res['failures'])} "
                                 f"values out of tolerance")
        log(f"  {mode}, {EVAL_SCENES} scenes against {ref}: every row within "
            f"tolerance; {secs:.1f} s, {secs / EVAL_SCENES:.3f} s per scene "
            f"from call to return ({EVAL_WORKERS} workers rendering scenes "
            f"included) [{smi}]; launches: "
            + ", ".join(f"{k} {counts[k]} ({v} per batch of 4)"
                        for k, v in per_batch.items())
            + ", no other kernel")
        res["seconds"] = secs
        return res

    def eval_both():
        out = {}
        out["oracle"] = eval_5k(
            "oracle", "docs/results_r5/5k_oracle_results_test_clean.csv",
            ["--enroll_config", "", "--enroll_run_dir", ""],
            {"bilstm_scan": 3, "bilstm_scan_fwd_train": 3})
        out["two-stage"] = eval_5k(
            "two-stage", "docs/results_r5/"
            "5k_twostage_results_test_embed_r5_5k.csv",
            ["--enroll_config", EMBED_5K, "--enroll_run_dir",
             "runs/embed_r5_5k", "--enroll_ckpt", EMBED_CKPT],
            {"bilstm_scan": 3 + 6, "bilstm_scan_fwd_train": 3})
        return out
    evals = phase("eval: two-stage, 5k test split", 33, eval_both)

    def serving_precision():
        """`kv_quality.run`: the first EVAL_SCENES test scenes as as many
        streams of one graph engine at each serving precision; every
        score finite, bf16 + int8 within KV_COST_DB of the port's own
        float32. The engines' eager warm-up and capture steps launch the
        kernels: 2 graphs x (WARMUP_STEPS + 1) steps x 3 blocks each."""
        from lookoncetohear_tpu_torch import kv_quality
        reset_counts()
        t0 = time.perf_counter()
        scores = kv_quality.run(TSH_5K, CKPT, EVAL_SCENES,
                                num_workers=EVAL_WORKERS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = 2 * (WARMUP_STEPS + 1) * 3
        expect_counts(read_counts(), {
            "bilstm_scan": 3 * n, "attn_step_f32": n, "attn_step_bf16": n,
            "ring_int8_step": n, "flat_norm": n // 3 * (
                2 * FLAT_NORMS["float_ring"] + FLAT_NORMS["int8"])},
            "serving precision")
        means = {k: float(np.mean(v)) for k, v in scores.items()}
        for k, v in scores.items():
            if not (v.shape == (EVAL_SCENES,) and np.isfinite(v).all()):
                raise AssertionError(f"{k}: scores not finite")
            log(f"  {k:18s} mean SI-SNRi {means[k]:.4f} dB over "
                f"{EVAL_SCENES} streams (the JAX package on a TPU: "
                f"{kv_quality.TPU_DB[k]:.3f} dB, docs/perf_r5/"
                f"kv_quality_r5.log)")
        cost = means["f32 / f32 K/V"] - means["bf16 / int8 K/V"]
        if not cost <= KV_COST_DB:
            raise AssertionError(f"bf16 + int8 costs {cost:.4f} dB against "
                                 f"float32 (limit {KV_COST_DB})")
        log(f"  bf16 + int8 costs {cost:.4f} dB against the port's float32 "
            f"(limit {KV_COST_DB} dB); {secs:.1f} s with the scenes' "
            f"rendering [{smi}]")
        return means
    kv_means = phase("eval: serving precision, 64 streams", 16,
                     serving_precision)

    # ---- 9. training ------------------------------------------------------
    # the training kernels at the training configs' scan shapes; the
    # inputs are kept for the times
    train_scans = {}

    def train_scan_check():
        """The state-saving forward (y, every c, c_T) and the backward
        (dxp, dh0, dc0, and dW_hh through its product) in the models'
        layouts against their plain versions on the same card tensors:
        random inputs made on the card from a seed, a nonzero (h0, c0)
        where the scan carries a state (the TSE inter-time LSTM and the
        tail shape). The backward of both versions reads the kernel
        forward's y and cs, so each is held alone. The forward is also
        held to a float64 run of the recurrence (logged)."""
        g = torch.Generator(device=dev).manual_seed(3)
        fwd_err = bwd_err = 0.0
        for key, (t_, nd, bb) in [*TRAIN_SCANS.items(),
                                  ("tail", TRAIN_TAIL)]:
            r = lambda *shape, k=0.5: torch.randn(  # noqa: E731
                shape, generator=g, device=dev) * k
            xp, w_hh = r(bb, t_, nd * 256), r(nd, 64, 256, k=0.3)
            h0 = c0 = None
            if key in ("tse_inter", "tail"):
                h0, c0 = r(nd, bb, 64), r(nd, bb, 64)
            dys, dct = r(bb, t_, nd * 64, k=1.0), r(nd, bb, 64, k=1.0)
            tol = TOL_LSTM if t_ <= 97 else TOL_LSTM_LONG
            got = bilstm_scan_train_cuda(xp, w_hh, h0, c0)
            plain = bilstm_train_reference(xp, w_hh, torch.float32, h0, c0,
                                           with_cs=True)
            exact = bilstm_train_reference(xp, w_hh, torch.float64, h0, c0)
            y, _, cs = got
            # a pass that keeps no gradient writes no cs, and the same
            # y and c_T bit for bit
            lean = bilstm_scan_train_cuda(xp, w_hh, h0, c0, save_cs=False)
            if lean[2] is not None or not (torch.equal(lean[0], y)
                                           and torch.equal(lean[1], got[1])):
                raise AssertionError(f"{key}: the forward without cs differs")
            del lean
            gb = bilstm_scan_bwd_cuda(xp, w_hh, h0, c0, y, cs, dys, dct)
            pb = bilstm_train_backward_reference(xp, w_hh, h0, c0, y, cs,
                                                 dys, dct)
            gb = (*gb, scan_weight_grad(gb[0], y, h0, nd))
            pb = (*pb, scan_weight_grad(pb[0], y, h0, nd))
            torch.cuda.synchronize()
            msg = []
            for what, a, b_ in (("y", got[0], plain[0]),
                                ("c_T", got[1], plain[1]),
                                ("cs", got[2], plain[2]),
                                ("dxp", gb[0], pb[0]), ("dh0", gb[1], pb[1]),
                                ("dc0", gb[2], pb[2]),
                                ("dW_hh", gb[3], pb[3])):
                err = (a - b_).abs().max().item()
                peak = b_.abs().max().item()
                if not (torch.isfinite(a).all() and err <= tol * max(1.0,
                                                                     peak)):
                    raise AssertionError(f"{key} {what}: {err} (peak "
                                         f"{peak}, tolerance {tol} of "
                                         f"max(1, peak))")
                if what in ("y", "c_T", "cs"):
                    fwd_err = max(fwd_err, err)
                elif what != "dW_hh":   # the product's, not the kernel's
                    bwd_err = max(bwd_err, err)
                msg.append(f"{what} {err:.2e}/{peak:.3g}")
            drift = [(v[k].double() - exact[k]).abs().max().item()
                     for v in (got, plain) for k in (0, 1)]
            log(f"  {key} xp {list(xp.shape)}"
                + (", h0/c0" if h0 is not None else "")
                + f", tiles of {tile_rows(bb, nd, dev, 'fwd')} / "
                f"{tile_rows(bb, nd, dev, 'bwd')} rows: max|kernel - "
                f"plain| / peak: {', '.join(msg)} (tolerance {tol} of "
                f"max(1, peak)); from float64: kernel y {drift[0]:.2e} c_T "
                f"{drift[1]:.2e}, plain y {drift[2]:.2e} c_T {drift[3]:.2e}")
            del exact, plain, pb
            if key != "tail":
                train_scans[key] = (xp, w_hh, h0, c0, dys, dct, y, cs)
        res["bilstm_scan_fwd_train"]["max_abs_err"] = fwd_err
        res["bilstm_scan_bwd"]["max_abs_err"] = bwd_err
    phase("bilstm_scan training kernels vs plain", 15, train_scan_check)

    from lookoncetohear_tpu_torch import utils as port_utils
    from lookoncetohear_tpu_torch.data.loader import collate
    from lookoncetohear_tpu_torch.train.trainer import (Trainer, build_task,
                                                        to_device)
    # (name, config, committed checkpoint, model class); per-step
    # launches: 3 blocks x (intra, inter), a forward and a backward each
    tasks = (("TSETask", TSH_5K, CKPT, Net),
             ("EmbedTask", EMBED_5K, EMBED_CKPT, EmbedNet))
    per_step = {"bilstm_scan_fwd_train": 6, "bilstm_scan_bwd": 6}

    def host_batch(hp, n, seconds=None):
        args = dict(hp.train_data_args)
        if seconds is not None:
            args["duration"] = seconds
        ds = port_utils.import_attr(hp.train_dataset)(**args)
        return collate([ds[i] for i in range(n)])

    def train_step_check():
        """One loss-and-backward of each task from its committed
        checkpoint on the first TRAIN_CHECK_BATCH scenes (cut to
        TRAIN_CHECK_SECONDS) of the synthetic train split, on the card
        and on the CPU, TF32 off: the loss agrees with the CPU's float32
        run, every gradient with its float64 run, and the card's step
        launched the training kernels `per_step` times and no other
        kernel of the port."""
        for name, cfg, ckpt, _ in tasks:
            hp = port_utils.Params(cfg)
            host = host_batch(hp, TRAIN_CHECK_BATCH, TRAIN_CHECK_SECONDS)
            out = {}
            for d, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu64", torch.float64)):
                task = build_task(hp)
                dev_ = d[:3] if d != "cuda" else d
                model = load_checkpoint(task.model, ckpt).to(dev_, dt)
                batch = {k: v.to(dt) if v.is_floating_point() else v
                         for k, v in to_device(task.device_batch(
                             host, train=True), dev_).items()}
                reset_counts()
                with port_utils.full_float32():
                    loss, _ = task.loss_and_metrics(batch, 0)
                    loss.backward()
                if d == "cuda":
                    torch.cuda.synchronize()
                    counts = read_counts()
                out[d] = (loss.item(), {n: p.grad.cpu().double() for n, p in
                                        model.named_parameters()})
            expect_counts(counts, per_step, f"{name} step")
            (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
            g_64 = out["cpu64"][1]
            if not (np.isfinite(l_gpu)
                    and abs(l_gpu - l_cpu) <= TOL_TRAIN_LOSS * max(
                        1.0, abs(l_cpu))):
                raise AssertionError(f"{name}: loss {l_gpu} vs {l_cpu}")
            floor = 1e-3 * max(g.abs().max().item() for g in g_64.values())
            worst, worst_name, cpu_to64 = 0.0, "", 0.0
            for n, g in g_64.items():
                ref = max(g.abs().max().item(), floor)
                err = (g_gpu[n] - g).abs().max().item()
                if not (torch.isfinite(g_gpu[n]).all()
                        and err <= TOL_TRAIN_GRAD * ref):
                    raise AssertionError(
                        f"{name}: grad {n} lies {err / ref:.3e} of "
                        f"max(peak, floor) from float64")
                cpu_to64 = max(cpu_to64,
                               (g_cpu[n] - g).abs().max().item() / ref)
                if err / ref > worst:
                    worst, worst_name = err / ref, n
            log(f"  {name}, {ckpt.split('/')[-1]}, {TRAIN_CHECK_BATCH} x "
                f"{TRAIN_CHECK_SECONDS:g} s: loss GPU {l_gpu:.6f} CPU "
                f"{l_cpu:.6f} float64 {out['cpu64'][0]:.6f}; {len(g_64)} "
                f"gradients, worst |GPU - float64| / max(peak, floor) "
                f"{worst:.3e} ({worst_name}; tolerance {TOL_TRAIN_GRAD}); "
                f"the CPU's float32 at worst {cpu_to64:.3e}; launches: "
                + ", ".join(f"{k} {counts[k]}" for k in per_step)
                + ", no other kernel of the port")
    phase("path: train step GPU vs CPU", 50, train_step_check, grad=True)

    def trainer_cli():
        """The port's trainer CLI on each committed training config at
        its full width and batch (8 x 5 s), TRAIN_FRAC of an epoch (3
        training batches, 1 validation batch), into a fresh run dir:
        every logged number finite; last, best and the meta file
        written; the best checkpoint loads strictly into a fresh model
        and has the committed checkpoint's keys and shapes; the kernels
        launched what 3 training steps and 1 validation batch imply."""
        from lookoncetohear_tpu_torch import trainer as cli
        with tempfile.TemporaryDirectory(prefix="port_train_") as tmp:
            for name, cfg, ckpt, model_cls in tasks:
                hp = port_utils.Params(cfg)
                run_dir = os.path.join(tmp, name)
                # validation keeps no graph: B2 for every BiLSTM, the
                # training forward for the separator's inter-time LSTM
                val = {"bilstm_scan": 3, "bilstm_scan_fwd_train": 3} \
                    if name == "TSETask" else {"bilstm_scan": 6}
                want = {k: 3 * v for k, v in per_step.items()}
                for k, v in val.items():
                    want[k] = want.get(k, 0) + v
                reset_counts()
                t0 = time.perf_counter()
                cli.run(["--config", cfg, "--run_dir", run_dir, "--frac",
                         str(TRAIN_FRAC), "--epochs", "1"])
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = read_counts()
                expect_counts(counts, want, f"{name} trainer CLI")
                if name == "TSETask":
                    # the main training path: the kernels line reports
                    # this run's launches of the training kernels
                    for k in per_step:
                        launch_counts[k] = counts[k]
                with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                    recs = [json.loads(line) for line in f]
                nums = [v for r in recs for v in r.values()
                        if isinstance(v, float)]
                if not (len(recs) == 1 and recs[0]["step"] == 3
                        and np.isfinite(nums).all()):
                    raise AssertionError(f"{name}: metrics {recs}")
                cli_runs[name] = (recs[0], want)
                for fn in ("last.ckpt", "best.ckpt", "ckpt_meta.json"):
                    if not os.path.exists(os.path.join(run_dir, fn)):
                        raise AssertionError(f"{name}: no {fn}")
                best = os.path.join(run_dir, "best.ckpt")
                got, ref = load_npz(best), load_npz(ckpt)
                if {k: v.shape for k, v in got.items()} != \
                        {k: v.shape for k, v in ref.items()}:
                    raise AssertionError(f"{name}: best.ckpt keys/shapes "
                                         f"differ from {ckpt}")
                mp = hp.pl_module_args["model_params"]
                load_checkpoint(model_cls(**mp, device="cpu"), best)
                log(f"  {name}: {secs:.1f} s for 3 training batches + 1 "
                    f"validation batch of {hp.batch_size} x "
                    f"{hp.train_data_args['duration']:g} s (rendering and "
                    f"checkpoints included) [{smi}]; "
                    + ", ".join(f"{k} {v:.4f}" for k, v in recs[0].items()
                                if "/" in k)
                    + f"; best.ckpt: {len(got)} tensors, keys and shapes of "
                    f"{ckpt.split('/')[-1]}, loads strictly; launches: "
                    + ", ".join(f"{k} {v}" for k, v in want.items()))
    cli_runs: dict = {}
    phase("path: trainer CLI", 65, trainer_cli, grad=True)

    def ddp_one():
        """`parallel.distributed.maybe_initialize` joins an NCCL group of
        one process over tcp://localhost (a free port); the join and the
        first collective (which sets up NCCL's communicator) are timed
        apart. In that group the trainer CLI runs the epoch of "path:
        trainer CLI" (3 steps, 1 validation batch) on the same batches,
        the model unwrapped at one rank while the group's collectives
        run (the batch-count agreement, the metric sums, the checkpoint
        barrier): its training metrics equal that plain run's to TOL_DDP
        and its validation metrics to TOL_DDP_VAL, the kernels launch as
        there, and rank 0 writes the checkpoints. Then DDP itself on
        NCCL: the trainer's `ddp_wrap` around a seeded TSE model, its
        construction timed; from the same weights on one fixed 8 x 5 s
        batch, a loss and backward of the unwrapped model twice (the
        card's own spread) and of DDP once: the loss equal to TOL_DDP,
        every gradient DDP reduced within TOL_DDP_GRAD of max(peak,
        floor) of the unwrapped one's; then DDP_STEPS steps of each, the
        steady step's ms (median after the first) and the losses'
        spread. Last, out of the group, the plain CLI epoch again: it
        follows a CLI run, as the group's does (each run stops the
        loaders' fork server at its end), so the two epochs' seconds
        compare the group alone; both are profiled (cProfile) for the
        seconds their loader workers' launches take."""
        import cProfile
        import pstats
        import socket

        import torch.distributed as dist

        from lookoncetohear_tpu_torch import trainer as cli
        from lookoncetohear_tpu_torch.parallel import distributed
        from lookoncetohear_tpu_torch.train.trainer import (Trainer,
                                                            build_task,
                                                            ddp_wrap)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(LOOKONCE_COORDINATOR=f"localhost:{port}",
                   LOOKONCE_NUM_PROCESSES="1", LOOKONCE_PROCESS_ID="0")
        os.environ.update(env)

        def steps(tr, batch):
            losses, ms = [], []
            for _ in range(DDP_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(tr.train_step(batch, 0)["loss"].item())
                ms.append((time.perf_counter() - t0) * 1e3)
            return losses, float(np.median(ms[1:])), ms[0]

        def cli_epoch(run_dir):
            """The CLI epoch's seconds, and those of its worker launches
            (multiprocessing's `BaseProcess.start`)."""
            prof = cProfile.Profile()
            t0 = time.perf_counter()
            prof.enable()
            cli.run(["--config", TSH_5K, "--run_dir", run_dir, "--frac",
                     str(TRAIN_FRAC), "--epochs", "1"])
            torch.cuda.synchronize()
            prof.disable()
            stats = pstats.Stats(prof).stats
            return time.perf_counter() - t0, sum(
                v[3] for (f, _, fn), v in stats.items()
                if fn == "start" and f.endswith("multiprocessing/process.py"))

        def grads(tr, batch):
            tr.opt.zero_grad(set_to_none=True)
            loss, _ = tr.task.loss_and_metrics(batch, 0)
            loss.backward()
            out = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
                   for p in tr.params]
            tr.opt.zero_grad(set_to_none=True)
            return loss.item(), out

        def grad_dev(got, ref):
            floor = 1e-3 * max(g.abs().max().item() for g in ref)
            return max(((a - b).abs().max() / max(b.abs().max().item(),
                                                  floor)).item()
                       for a, b in zip(got, ref))
        try:
            t0 = time.perf_counter()
            if not distributed.maybe_initialize():
                raise AssertionError("no process group joined")
            join_s = time.perf_counter() - t0
            group = (dist.get_backend(), dist.get_world_size(),
                     dist.get_rank())
            if group != ("nccl", 1, 0):
                raise AssertionError(f"group {group}")
            t0 = time.perf_counter()
            if distributed.agree_count(7, "min") != 7:
                raise AssertionError("agree_count over one rank")
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            plain, want = cli_runs["TSETask"]
            hp = port_utils.Params(TSH_5K)
            with tempfile.TemporaryDirectory(prefix="port_ddp_") as tmp:
                run_dir = os.path.join(tmp, "run")
                reset_counts()
                secs, launch_s = cli_epoch(run_dir)
                counts = read_counts()
                expect_counts(counts, want, "trainer CLI in a group of 1")
                with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                    (rec,) = [json.loads(line) for line in f]
                files = sorted(os.listdir(run_dir))
                host = host_batch(hp, hp.batch_size)
                with port_utils.full_float32():
                    trs = [Trainer(build_task(hp), os.path.join(tmp, w),
                                   epochs=1, device=dev)
                           for w in ("plain", "ddp")]
                    if isinstance(trs[0].task.model,
                                  torch.nn.parallel.DistributedDataParallel):
                        raise AssertionError("wrapped at one rank")
                    trs[1].model.load_state_dict(trs[0].model.state_dict())
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trs[1].task.model = ddp_wrap(trs[1].model, dev)
                    torch.cuda.synchronize()
                    wrap_s = time.perf_counter() - t0
                    batch = to_device(
                        trs[0].task.device_batch(host, train=True), dev)
                    (loss_p, g_p), (_, g_p2), (loss_d, g_d) = [
                        grads(t, batch) for t in (trs[0], trs[0], trs[1])]
                    spread, g_err = grad_dev(g_p2, g_p), grad_dev(g_d, g_p)
                    (l_plain, ms_plain, first_plain), \
                        (l_ddp, ms_ddp, first_ddp) = [steps(t, batch)
                                                      for t in trs]
                del trs, batch, g_p, g_p2, g_d
            for k in ("last.ckpt", "best.ckpt", "ckpt_meta.json"):
                if k not in files:
                    raise AssertionError(f"rank 0 wrote no {k}: {files}")
            diffs = {k: abs(rec[k] - v) / max(1.0, abs(v))
                     for k, v in plain.items() if "/" in k}
            if not (rec["step"] == 3 and all(
                    v <= (TOL_DDP if k.startswith("train/") else TOL_DDP_VAL)
                    for k, v in diffs.items())):
                raise AssertionError(f"group of 1 vs plain: {diffs}")
            d_loss = max(abs(a - b) / max(1.0, abs(a))
                         for a, b in zip(l_plain, l_ddp))
            if not (abs(loss_d - loss_p) <= TOL_DDP * max(1.0, abs(loss_p))
                    and g_err <= TOL_DDP_GRAD
                    and np.isfinite(l_ddp).all() and l_ddp[-1] < l_ddp[0]):
                raise AssertionError(
                    f"DDP: loss {loss_d} vs {loss_p}, gradients {g_err} "
                    f"(unwrapped twice: {spread}), losses {l_ddp}")
        finally:
            for k in env:
                os.environ.pop(k, None)
            if dist.is_initialized():
                dist.destroy_process_group()
        with tempfile.TemporaryDirectory(prefix="port_plain_") as tmp:
            plain_s, plain_launch_s = cli_epoch(os.path.join(tmp, "run"))
        log(f"  NCCL group of 1 (tcp://localhost:{port}): joined in "
            f"{join_s:.2f} s, the first collective (NCCL's communicator) "
            f"{first_s:.2f} s; the trainer CLI in the group, the model "
            f"unwrapped: TSETask, 3 steps + 1 validation batch of 8 x 5 s "
            f"in {secs:.1f} s ({launch_s:.1f} s of it launching loader "
            f"workers), the plain epoch after it {plain_s:.1f} s "
            f"({plain_launch_s:.1f} s) [{smi}]; |group - plain| / max(1, "
            "|plain|): "
            + ", ".join(f"{k} {v:.2e}" for k, v in diffs.items())
            + f" (tolerance {TOL_DDP} train, {TOL_DDP_VAL} validation); "
            f"train/loss {rec['train/loss']:.6f}; rank 0 wrote {files}; "
            "launches as the plain run: "
            + ", ".join(f"{k} {counts[k]}" for k in want)
            + f". DDP on NCCL (`ddp_wrap`): built in {wrap_s:.3f} s; one "
            f"8 x 5 s batch from the same weights: loss {loss_d:.6f} vs "
            f"{loss_p:.6f}, gradients within {g_err:.2e} of max(peak, "
            f"floor) (tolerance {TOL_DDP_GRAD}; the unwrapped model "
            f"against itself {spread:.2e}); {DDP_STEPS} steps: "
            f"{ms_ddp:.1f} ms a step (median after the first, "
            f"{first_ddp:.1f} ms first) against {ms_plain:.1f} ms "
            f"unwrapped ({first_plain:.1f} ms first), losses "
            f"{l_ddp[0]:.4f} -> {l_ddp[-1]:.4f}, within {d_loss:.2e} of "
            f"the unwrapped run's [{smi}]")
    phase("path: DDP, world size 1", 75, ddp_one, grad=True)

    def step_with_remat(tr, batch, steps=3):
        """ms a step (median after the first) and peak GB of the same
        training step with every GridNet block checkpointed (the models'
        `remat`, the JAX package's `nn.remat`: the backward recomputes
        each block from its input), for the trade the models make by
        keeping the activations."""
        trunks = [m for m in tr.model.modules() if hasattr(m, "remat")]
        for m in trunks:
            m.remat = True
        try:
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train_step(batch, 0)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            return (float(np.median(ms[1:])),
                    torch.cuda.max_memory_allocated() / 1e9)
        finally:
            for m in trunks:
                m.remat = False

    def train_times():
        """Training steps at each config's batch of 8 x 5 s, from a
        seeded random init on one fixed batch (TRAIN_STEPS for TSETask,
        whose loss must fall; 4 for EmbedTask): ms per step from call to
        synchronize (median after the first), peak memory, and a
        profile of one step: the port's kernels as counted, no cuDNN RNN
        kernel. Then both training kernels at the four scan shapes
        beside their plain versions and cuDNN's LSTM."""
        for (name, cfg, _, _), steps in zip(tasks, (TRAIN_STEPS, 4)):
            hp = port_utils.Params(cfg)
            host = host_batch(hp, hp.batch_size)
            task = build_task(hp)
            with tempfile.TemporaryDirectory(prefix="port_step_") as tmp, \
                    port_utils.full_float32():
                tr = Trainer(task, tmp, epochs=1, device=dev)
                batch = to_device(task.device_batch(host, train=True), dev)
                torch.cuda.reset_peak_memory_stats()
                losses, ms = [], []
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = tr.train_step(batch, 0)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(m["loss"].item())
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                prof = profile_steps(StepOnce(tr, batch), [None], torch,
                                     per_step, absent=("RNN", "rnn", "LSTM",
                                                       "lstm_cell"),
                                     counters=(reset_counts, read_counts))
                remat_ms, remat_gb = step_with_remat(tr, batch)
            if not (np.isfinite(losses).all() and (
                    name != "TSETask" or losses[-1] < losses[0])):
                raise AssertionError(f"{name}: losses {losses}")
            step_ms = float(np.median(ms[1:]))
            res[f"train_{name}"] = dict(batch=hp.batch_size,
                                        seconds=hp.train_data_args["duration"],
                                        ms=step_ms, peak_gb=peak_gb,
                                        remat_ms=remat_ms,
                                        remat_peak_gb=remat_gb,
                                        losses=losses, **prof)
            log(f"  {name}, {hp.batch_size} x "
                f"{hp.train_data_args['duration']:g} s, seeded random init, "
                f"one fixed batch: {step_ms:.1f} ms a step from call to "
                f"synchronize (median of {steps - 1} after the first, "
                f"{ms[0]:.1f} ms first), peak {peak_gb:.2f} GB; loss "
                f"{losses[0]:.4f} -> {losses[-1]:.4f} in {steps} steps; "
                f"every block checkpointed: {remat_ms:.1f} ms a step, peak "
                f"{remat_gb:.2f} GB [{smi}]")
        for key, (xp, w_hh, h0, c0, dys, dct, ys, cs) in train_scans.items():
            bb, t_, dg = xp.shape
            nd = dg // 256
            h = 64
            fwd = lambda i: bilstm_scan_train_cuda(xp, w_hh, h0, c0)  # noqa
            bwd = lambda i: bilstm_scan_bwd_cuda(  # noqa: E731
                xp, w_hh, h0, c0, ys, cs, dys, dct)
            for _ in range(3):
                fwd(0), bwd(0)
            f_ms, b_ms = device_ms(fwd, 20), device_ms(bwd, 20)
            pf_ms = wall_ms(lambda i: bilstm_train_reference(
                xp, w_hh, torch.float32, h0, c0, with_cs=True), 2)
            pb_ms = wall_ms(lambda i: bilstm_train_backward_reference(
                xp, w_hh, h0, c0, ys, cs, dys, dct), 2)
            lstm = torch.nn.LSTM(h, h, batch_first=True,
                                 bidirectional=nd == 2).to(dev)
            x_in = torch.randn(bb, t_, h, device=dev, requires_grad=True)
            gy = torch.randn(bb, t_, nd * h, device=dev)
            lf = lambda i: lstm(x_in)[0]  # noqa: E731
            lfb = lambda i: lstm(x_in)[0].backward(gy)  # noqa: E731
            for _ in range(3):
                lfb(0)
            lf_ms, lfb_ms = device_ms(lf, 10), device_ms(lfb, 10)
            del lstm, x_in, gy
            n_state = nd * bb * h
            seq = t_ * n_state
            st = 0 if h0 is None else 2 * n_state
            f_bytes = 4 * (xp.numel() + w_hh.numel() + st + 2 * seq
                           + n_state)
            b_bytes = 4 * (2 * xp.numel() + w_hh.numel() + st + 3 * seq
                           + 3 * n_state)
            f_ops = t_ * nd * bb * (2 * h * 4 * h + 4 * h)
            b_ops = t_ * nd * bb * (2 * 2 * h * 4 * h + 16 * h)
            for kname, k_ms, p_ms, l_ms, nb, ops in (
                    ("bilstm_scan_fwd_train", f_ms, pf_ms, lf_ms, f_bytes,
                     f_ops),
                    ("bilstm_scan_bwd", b_ms, pb_ms, lfb_ms, b_bytes,
                     b_ops)):
                t_bytes, t_ops = nb / PEAK_BYTES_S, ops / PEAK_F32_FLOPS
                row = dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                           bound_ms=max(t_bytes, t_ops) * 1e3,
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations")
                res[f"{kname}_{key}"] = row
                if key == "tse_intra":
                    res[kname].update(row)
                log(f"  {kname} {key} xp {list(xp.shape)}: kernel "
                    f"{k_ms * 1e3:.1f} us, bound {row['bound_ms'] * 1e3:.1f} "
                    f"us ({row['bound_by']}: {nb / 1e6:.1f} MB, "
                    f"{ops / 1e9:.2f} GFLOP f32), plain {p_ms * 1e3:.1f} us, "
                    f"cuDNN nn.LSTM "
                    + ("forward" if kname.endswith("train") else
                       "forward + backward")
                    + f" {l_ms * 1e3:.1f} us [{smi}]")
    phase("times: training", 30, train_times, grad=True)

    corpus_phases(torch, smi, res, reset_counts, read_counts, expect_counts,
                  launch_counts,
                  {name: res[f"train_{name}"]["ms"] for name, *_ in tasks})

    phase("default Net (H=128, no attention)", 40,
          lambda: default_net_phase(torch, smi, res, launch_counts,
                                    reset_counts, read_counts, expect_counts))
    phase("default Net training (H=128)", 41,
          lambda: default_net_training_phase(
              torch, smi, res, launch_counts, reset_counts, read_counts,
              expect_counts), grad=True)

    def convert_phase():
        """Random state_dicts in the reference's key layout (the
        streaming TSE net at the flagship geometry, the enrollment net at
        configs/embed_synthetic_5k.json's), converted by `convert` and
        loaded strictly into `Net` / `EmbedNet` on the card and on the
        CPU; the card's output on CONVERT_SECONDS of seeded audio equals
        the CPU's to TOL_CONVERT of its peak."""
        from lookoncetohear_tpu_torch.convert import (load_reference,
                                                      reference_state_dict)
        g = np.random.default_rng(9)
        n = int(CONVERT_SECONDS * 16000)
        x = (0.3 * g.standard_normal((2, 2, n))).astype(np.float32)
        e = g.standard_normal((2, 1, 256)).astype(np.float32)
        embed_params = port_utils.Params(EMBED_5K).pl_module_args[
            "model_params"]
        msg = []
        for name, cls, params, ref, args in (
                ("Net", Net, FLAGSHIP, reference_tse(g), (x, e)),
                ("EmbedNet", EmbedNet, embed_params, reference_embed(g),
                 (x,))):
            port_sd = reference_state_dict(ref)
            outs = []
            for d in ("cuda", "cpu"):
                m = load_reference(cls(**params, device=d), ref).eval()
                with port_utils.full_float32():
                    outs.append(m(*(torch.from_numpy(a).to(d)
                                    for a in args)).float().cpu().numpy())
            got, want = outs
            peak = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            if not (np.isfinite(got).all() and peak > 0
                    and err <= TOL_CONVERT * peak):
                raise AssertionError(f"{name}: card vs CPU {err} (peak "
                                     f"{peak})")
            msg.append(f"{name}: {len(ref)} reference tensors -> "
                       f"{len(port_sd)} parameters, loaded strictly; output "
                       f"{list(got.shape)}, max|card - CPU| / peak = "
                       f"{err / peak:.2e}")
        log("  " + "; ".join(msg) + f" (tolerance {TOL_CONVERT})")
    phase("convert", 10, convert_phase)

    def demo():
        """`stream_demo` with the committed checkpoints: the synthetic
        test scene enrolled by EmbedNet and streamed through the graph
        engine in 8 ms chunks; the wavs written, SI-SNRi above 0 dB."""
        from lookoncetohear_tpu_torch import stream_demo
        with tempfile.TemporaryDirectory(prefix="port_demo_") as tmp:
            out = stream_demo.run(["--tse_ckpt", CKPT, "--embed_ckpt",
                                   EMBED_CKPT, "--out_dir", tmp])
            wavs = sorted(os.listdir(tmp))
        if not (wavs == ["extracted.wav", "mixture.wav", "target.wav"]
                and np.isfinite(out["extracted"]).all()
                and out["si_snr_i"] > 0):
            raise AssertionError(f"demo: {wavs}, SI-SNRi {out['si_snr_i']}")
        chunks = out["extracted"].shape[-1] // 128
        log(f"  committed checkpoints, 5 s scene, {chunks} chunks of 8 ms "
            f"through the graph engine: SI-SNR {out['si_snr_in']:.2f} -> "
            f"{out['si_snr_out']:.2f} dB, SI-SNRi {out['si_snr_i']:.2f} dB")
    phase("demo", 10, demo)

    def no_children():
        """The eval loaders' fork server and resource tracker stopped
        and waited for; no process this script started is left."""
        from lookoncetohear_tpu_torch.data.loader import stop_workers
        stop_workers()
        left = child_pids()
        if left:
            raise AssertionError(f"child processes left: {left}")
        log("  no child process left")
    phase("stop workers", 10, no_children)

    tpu = "lookoncetohear_tpu/ops/pallas_attention.py"
    meta = {
        "bilstm_scan": ("bilstm_scan.cu",
                        "lookoncetohear_tpu/ops/pallas_lstm.py:59"),
        # the differentiated lax.scan of lstm_apply_bidir (:130) and
        # lstm_apply (:108): the Pallas kernel has no gradient
        "bilstm_scan_fwd_train": ("bilstm_scan.cu",
                                  "lookoncetohear_tpu/ops/lstm.py:130"),
        "bilstm_scan_bwd": ("bilstm_scan.cu",
                            "lookoncetohear_tpu/ops/lstm.py:130"),
        # B2 and the inter-time LSTM's forward (lstm_apply) at H=128
        "bilstm_scan_h128": ("bilstm_scan.cu",
                             "lookoncetohear_tpu/ops/pallas_lstm.py:59"),
        "bilstm_scan_fwd_train_h128": ("bilstm_scan.cu",
                                       "lookoncetohear_tpu/ops/lstm.py:108"),
        # the backward of lstm_apply (:108) and lstm_apply_bidir (:130)
        # at H=128
        "bilstm_scan_bwd_train_h128": ("bilstm_scan.cu",
                                       "lookoncetohear_tpu/ops/lstm.py:108"),
        "ring_int8_step": ("ring_int8_step.cu", f"{tpu}:334"),
        # no Pallas kernel: the flat norms' XLA products ("MXU-dot")
        "flat_norm": ("flat_norm.cu", "lookoncetohear_tpu/ops/norms.py:122"),
        **{name: ("attn_step.cu", f"{tpu}:{129 if kvdt == torch.int8 else 54}")
           for (_, kvdt), name in VARIANTS.items()},
    }
    kernels = [dict(name=k, route="cuda",
                    source=f"lookoncetohear_tpu_torch/csrc/{src}",
                    replaces=rep, launches=launch_counts[k],
                    max_abs_err=res[k]["max_abs_err"], ms=res[k]["ms"],
                    plain_ms=res[k]["plain_ms"], bound_ms=res[k]["bound_ms"],
                    bound_by=res[k]["bound_by"],
                    library_ms=res[k]["library_ms"])
               for k, (src, rep) in meta.items()]
    log(f"engine: {json.dumps(res['engine'])}")
    log(f"full forward: {json.dumps(res['full_forward'])}")
    log(f"engine, CUDA graph: {json.dumps(res['graph'])}")
    log(f"EmbedNet: {json.dumps(res['enroll'])}")
    log(f"default Net: {json.dumps(res['default_net'])}")
    log(f"d-vector precompute: {json.dumps(res['dvector'])}")
    for k in [*(f"bilstm_scan_h128_{s}" for s in H128_SCANS),
              "bilstm_scan_h128_eval",
              *(f"bilstm_scan_fwd_train_h128_{s}" for s in H128_TRAIN),
              *(f"bilstm_scan_bwd_train_h128_{s}" for s in H128_BWD_SCANS
                if s.startswith("train"))]:
        log(f"{k}: {json.dumps(res[k])}")
    log("eval: " + json.dumps({
        m: {k: r[k] for k in ("max_dev", "means", "seconds")}
        for m, r in evals.items()}))
    log(f"serving precision: {json.dumps(kv_means)}")
    for name, _, _, _ in tasks:
        log(f"train step {name}: {json.dumps(res['train_' + name])}")
    for key in TRAIN_SCANS:
        for kname in ("bilstm_scan_fwd_train", "bilstm_scan_bwd"):
            log(f"{kname}_{key}: {json.dumps(res[f'{kname}_{key}'])}")
    for k in ("625", "enroll_intra", "enroll_inter", "eval",
              "eval_enroll_intra", "eval_enroll_inter"):
        log(f"bilstm_scan_{k}: {json.dumps(res['bilstm_scan_' + k])}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        # a failed phase exits here too: stop the loaders' helpers
        loader = sys.modules.get("lookoncetohear_tpu_torch.data.loader")
        if loader is not None:
            loader.stop_workers()
    sys.exit(rc)
