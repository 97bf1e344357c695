#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (one nvcc call) and prints what ptxas
reports for each (registers, shared memory, spills), holds each kernel
against its plain PyTorch version at the serving shapes (the BiLSTM
scan also at the full forward's 625 rows and at the enrollment net's
two shapes, the int8 ring step over w + 3 chained calls from one
state, the ring attention step also at an odd K width), loads the
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
(the BiLSTM scan and cuDNN's LSTM at 64 and 625 rows, at the
enrollment shapes and at the eval's batch of 4 x 5 s), beside the floor of that timing (one launch of a
one-element `add_`); the engine step at each ring, eager and as a
CUDA graph (`benchmark_device`, `benchmark`, call to synchronize),
each with a profile of its device ops, which must hold 3 BiLSTM scans
and 3 ring steps a step and no other kernel of the port (the int8 path
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
Then this slice's phases (`corpus_phases`): the reference configs
(configs/tsh.json, configs/embed.json) through the trainer CLI on a
LibriSpeech-format corpus generated in a temporary directory, the
render rate of their dataset, `SeparationTask` (the offline separator
with 2-source PIT) on the card against the CPU and through the CLI, and
the loss registry on the card.
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
# counter name -> the kernel's name in a profiler trace
TRACE_NAMES = {
    "bilstm_scan": "bilstm_scan_kernel<64, false>",
    "bilstm_scan_fwd_train": "bilstm_train_fwd_kernel",
    "bilstm_scan_bwd": "bilstm_train_bwd_kernel",
    "ring_int8_step": "ring_int8_step_kernel<__nv_bfloat16>",
    "attn_step_f32": "attn_step_kernel<float, float>",
    "attn_step_bf16": "attn_step_kernel<__nv_bfloat16, __nv_bfloat16>",
    "attn_step_f32_bf16kv": "attn_step_kernel<float, __nv_bfloat16>"}
PORT_KERNELS = ("bilstm_scan_kernel", "bilstm_train_fwd_kernel",
                "bilstm_train_bwd_kernel", "ring_int8_step_kernel",
                "attn_step_kernel")
# traces of a profile at most: eager-engine traces holding 29 of 10
# steps' 30 B2 launches came back in two runs of this script
TRACE_TRIES = 3
# head-major rows of the float ring at 64 streams (64 x 4 heads); odd_dk
# a K width whose rows start 1- or 2-byte aligned
ATTN = dict(rows=STREAMS * 4, w1=49, dk=97 * 6, dv=97 * 16, odd_dk=525)


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
                  counters=None) -> dict:
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
    records, not launches (a graph replays every node it captured)."""
    from torch.profiler import ProfilerActivity, profile
    n = len(xs)
    want = {k: per_step * n for k, per_step in expect.items()}
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
        ran = {k: sum(TRACE_NAMES[k] in ev.name for ev in kern)
               for k in expect}
        other = sum(any(p in ev.name for p in PORT_KERNELS)
                    for ev in kern) - sum(ran.values())
        if other or any(ran[k] > want[k] for k in want):
            raise AssertionError(f"profiler: {ran} and {other} other "
                                 f"kernels of the port in {n} steps, "
                                 f"want {want} and none")
        if ran == want:
            break
        log(f"  profiler, trace {attempt} of {TRACE_TRIES}: {ran} in {n} "
            f"steps, want {want}: kernel records missing"
            + (" (the wrappers counted every launch)" if counters else ""))
    else:
        raise AssertionError(f"profiler: all {TRACE_TRIES} traces short "
                             f"of {want}")
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
        ran = [name for name in by_name if bad in name]
        if ran:
            raise AssertionError(f"{ran[0]} ran on this path")
        log(f"  no {bad} among the {len(by_name)} kernels of the trace")
    return dict(device_ops_per_step=len(kern) / n,
                device_busy_ms=busy / n / 1e3, busy_share=busy / window)


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


def corpus_phases(torch, smi, reset_counts, read_counts, expect_counts,
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
    c = phase("data: LibriSpeech-format corpus", 30, corpus)

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

    def run_cli(name, cfg, hp, want, run_dir):
        """The trainer CLI for one epoch: returns the launch counts read
        after it; fails unless the kernels launched `want`, the metrics
        are finite and the checkpoints are there."""
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cli.run(["--config", cfg, "--run_dir", run_dir, "--epochs", "1"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
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
    phase("path: trainer CLI, reference configs", 180, reference_cli,
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
    phase("data: render rate", 30, render_rate)

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
    phase("path: SeparationTask", 120, separation, grad=True)

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
    phase("losses on the card", 20, losses_card)
    tmp.cleanup()


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
            bilstm_scan_reference, bilstm_scan_train_cuda,
            bilstm_train_backward_reference, bilstm_train_reference,
            scan_weight_grad, tile_rows)
        from lookoncetohear_tpu_torch.ops.lstm import bidir_scan_inputs
        from lookoncetohear_tpu_torch.ops.ring_step import (
            arrival_counter, ring_attend_int8_step_cuda,
            ring_attend_int8_step_reference)
        from lookoncetohear_tpu_torch.serve.engine import (WARMUP_STEPS,
                                                           StreamingEngine)
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
        ring_attend_int8_step_cuda.launches = 0
        attention_step_cuda.launches = 0
        for k in attn_names:
            attention_step_cuda.variant_launches[k] = 0

    def read_counts():
        return dict(bilstm_scan=bilstm_scan_cuda.launches,
                    bilstm_scan_fwd_train=bilstm_scan_train_cuda.launches,
                    bilstm_scan_bwd=bilstm_scan_bwd_cuda.launches,
                    ring_int8_step=ring_attend_int8_step_cuda.launches,
                    **attention_step_cuda.variant_launches)

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

    # ---- 2. build: one nvcc call for csrc/*.cu -------------------------
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
    phase("build", 60, build)

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
    phase("bilstm_scan vs plain", 20, lstm_check)

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
    phase("ring_int8_step vs plain", 20, ring_check)

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
    phase("attn_step vs plain", 20, attn_check)

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
    phase("bilstm_scan vs plain, enrollment shapes", 20, lstm_enroll_check)

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
    phase("bilstm_scan vs plain, eval shapes", 30, lstm_eval_check)

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
                                      kernel: 3 * steps}, "GPU engine")
        if peak == 0.0:
            raise AssertionError("engine output is all zeros")
        ring = "int8" if kv_dtype == torch.int8 else "float32"
        log(f"  4 streams x {steps} steps, float32, {ring} K/V, each step "
            f"from the same state: max|GPU - CPU| / peak = {worst:.3e} "
            f"(tolerance {TOL_PATH}); float state within {TOL_STATE}; "
            f"{flips} int8 ring entries off by one in {steps} steps")
    phase("path: GPU engine vs CPU engine", 15,
          lambda: path_vs_cpu(torch.int8, "ring_int8_step"))
    phase("path: f32-ring GPU engine vs CPU engine", 15,
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
    phase("path: streamed == full forward on the card", 15,
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
        expect_counts(counts, {"bilstm_scan": 3 * steps, kernel: 3 * steps},
                      label)
        launch_counts[kernel] = counts[kernel]
        launch_counts.setdefault("bilstm_scan", counts["bilstm_scan"])
        engines[label] = (eng, x)
        log(f"  {STREAMS} streams x {steps} steps, {label}: finite, peak "
            f"|y| {y.abs().max().item():.3f}; launches: bilstm_scan "
            f"{counts['bilstm_scan']}, {kernel} {counts[kernel]} (3 blocks "
            f"x {steps} steps each, no other kernel)")
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
        expect_counts(counts, {"bilstm_scan": per_call, kernel: per_call},
                      label)
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
            f"graphs x ({WARMUP_STEPS} warm-up steps + 1 capture)): the "
            f"replays ran no Python")
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
                                 {"bilstm_scan": 3, kernel: 3}, absent,
                                 (reset_counts, read_counts)))
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
        out.update(profile_steps(eng, x[:10], torch,
                                 {"bilstm_scan": 3, kernel: 3}, absent))
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
    phase("times", 75, times)

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
    evals = phase("eval: two-stage, 5k test split", 60, eval_both)

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
            "ring_int8_step": n}, "serving precision")
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
    kv_means = phase("eval: serving precision, 64 streams", 40,
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
    phase("bilstm_scan training kernels vs plain", 30, train_scan_check)

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
    phase("path: train step GPU vs CPU", 60, train_step_check, grad=True)

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
    phase("path: trainer CLI", 90, trainer_cli, grad=True)

    class StepOnce:
        """A training step in the shape `profile_steps` drives."""

        def __init__(self, trainer, batch):
            self.trainer, self.batch = trainer, batch

        def step(self, _):
            self.trainer.train_step(self.batch, 0)

    def step_with_remat(tr, batch, steps=3):
        """ms a step (median after the first) and peak GB of the same
        training step with every GridNet block checkpointed (the JAX
        package's `nn.remat`: the backward recomputes each block from
        its input), for the trade the models make by keeping the
        activations."""
        import functools

        from torch.utils.checkpoint import checkpoint
        blocks = [m for m in tr.model.modules()
                  if type(m).__name__.startswith("GridNetBlock")]
        for m in blocks:
            m.forward = functools.partial(
                checkpoint, type(m).forward.__get__(m), use_reentrant=False)
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
            for m in blocks:
                del m.forward

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
    phase("times: training", 60, train_times, grad=True)

    corpus_phases(torch, smi, reset_counts, read_counts, expect_counts,
                  launch_counts,
                  {name: res[f"train_{name}"]["ms"] for name, *_ in tasks})

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
        "ring_int8_step": ("ring_int8_step.cu", f"{tpu}:334"),
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
