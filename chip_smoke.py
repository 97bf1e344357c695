#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (one nvcc call), holds each kernel
against its plain PyTorch version at the serving shapes, loads the
flagship checkpoint (checkpoints/tsh_r5_5k_best.npz) and drives the
serving path through `StreamingEngine`: 4 streams in float32 on the GPU
against the same engine on the CPU, then 64 streams in bf16 with the
int8 K/V ring, counting the kernel launches. Then it times the engine
step and each kernel with CUDA events.

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
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "tsh_r5_5k_best.npz")
FLAGSHIP = dict(embed_dim=256, stft_chunk_size=128, stft_pad_size=64,
                num_ch=2, D=64, L=4, I=1, J=1, B=3, H=64,
                local_atten_len=50, use_attn=True, lookahead=True,
                chunk_causal=True)
STREAMS = 64
PATH_STEPS = 60
TIMED_STEPS = 50
CHUNK_MS = 8.0                # 128 samples at 16 kHz
# H100 SXM published peaks (NVIDIA data sheet, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
# tolerances (kernel vs its plain version, same inputs, on the card)
TOL_LSTM = 2e-5               # float32, the JAX Pallas-vs-scan bound
TOL_RING_F32 = (2e-5, 2e-6)   # rtol, atol: JAX Pallas-vs-XLA bound
TOL_RING_BF16 = 2e-2          # atol: one bf16 rounding of |out| <~ 4
# GPU vs CPU engine, float32, each step from the same state: the output
# (of its peak) and the float state (of max(1, its peak)) differ only by
# the order of float32 sums; an int8 ring entry whose k/scale lies near
# a .5 rounding boundary may flip by one, in at most 1 of 1000 written
TOL_PATH = 1e-4
TOL_STATE = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str, limit_s: int, fn):
    """Run one phase under a watchdog; exit 1 on any failure."""
    t0 = time.perf_counter()
    faulthandler.dump_traceback_later(limit_s, exit=True)
    try:
        out = fn()
    except Exception:
        traceback.print_exc()
        log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
        sys.exit(1)
    finally:
        faulthandler.cancel_dump_traceback_later()
    log(f"[{name}] ok, {time.perf_counter() - t0:.1f} s")
    return out


def device_ms(fn, reps: int, torch) -> float:
    """Median device time of one call fn(i), i < reps, for a call of a
    few launches. A sleep kernel holds the stream while the host queues
    every call between its pair of CUDA events, so the host's launch
    overhead, larger than many of these calls, is not timed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(0)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    # ~2e9 cycles per second at the H100's clock; 1.5x the host's time
    torch.cuda._sleep(int((1.5 * reps * host_s + 0.01) * 2e9))
    for i in range(reps):
        ev[i][0].record()
        fn(i)
        ev[i][1].record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def wall_ms(fn, reps: int, torch) -> float:
    """Median time from the call of fn(i) to the end of its work on the
    card, for calls of many launches: the host's launch overhead then
    sets the time, and a queue primed as in device_ms would overflow."""
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def profile_steps(eng, xs, torch) -> dict:
    """Where a step's device time goes: kernel time by name and the
    device's busy share, from a torch.profiler trace of len(xs) steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs:
            eng.step(x)
        torch.cuda.synchronize()
    kern = [ev for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log("  profiler: no device events recorded")
        return {}
    n = len(xs)
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
    return dict(device_ops_per_step=len(kern) / n,
                device_busy_ms=busy / n / 1e3, busy_share=busy / window)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from lookoncetohear_tpu_torch import _build
        from lookoncetohear_tpu_torch.models.net import Net
        from lookoncetohear_tpu_torch.ops.bilstm_scan import (
            bilstm_scan_cuda, bilstm_scan_reference)
        from lookoncetohear_tpu_torch.ops.ring_step import (
            ring_attend_int8_step_cuda, ring_attend_int8_step_reference)
        from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
        from lookoncetohear_tpu_torch.weights import (load_npz,
                                                      params_from_jax)
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
    res: dict = {"bilstm_scan": {}, "ring_int8_step": {}}

    def gpu(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return t if dtype is None else t.to(dtype)

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
    smi = phase("device", 30, device)

    # ---- 2. build: one nvcc call for csrc/*.cu -------------------------
    def build():
        _build.load_library()
        b = _build.last_build
        log(f"build: {b['seconds']:.1f} s, cached={b['cached']}: "
            f"{b.get('command', b['path'])}")
        for line in b["ptxas"]:
            log(f"  {line}")
    phase("build", 240, build)

    # ---- 3. BiLSTM kernel vs plain ------------------------------------
    def lstm_check():
        errs = []
        for b in (64, 12):     # the serving batch, and a ragged one
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
    phase("bilstm_scan vs plain", 60, lstm_check)

    # ---- 4. int8 ring step kernel vs plain ------------------------------
    b, f, nh, e, vd, wp, w = STREAMS, 97, 4, 6, 16, 56, 50
    dk, dv = f * nh * e, f * nh * vd

    def ring_inputs(dtype):
        return dict(
            q=gpu(rng.standard_normal((b, dk)).astype(np.float32), dtype),
            kt=gpu(rng.standard_normal((b, dk)).astype(np.float32), dtype),
            vt=gpu(rng.standard_normal((b, dv)).astype(np.float32), dtype),
            kb=gpu(rng.integers(-127, 128, (b, wp, dk)).astype(np.int8)),
            ks=gpu(rng.uniform(1e-3, 2e-2, (b, wp, nh)).astype(np.float32)),
            vb=gpu(rng.integers(-127, 128, (b, wp, dv)).astype(np.int8)),
            vs=gpu(rng.uniform(1e-3, 2e-2, (b, wp, nh)).astype(np.float32)))

    def ring_run(step, a, pos):
        r = {k: v.clone() for k, v in a.items()}
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = step(r["q"], r["kt"], r["vt"], r["kb"], r["ks"], r["vb"],
                   r["vs"], p, f=f, n_head=nh, w=w)
        return out, r, p

    def ring_check():
        errs = []
        for dtype, pos in ((torch.float32, 0), (torch.float32, 7),
                           (torch.float32, 49), (torch.bfloat16, 7)):
            a = ring_inputs(dtype)
            o1, r1, p1 = ring_run(ring_attend_int8_step_cuda, a, pos)
            o2, r2, p2 = ring_run(ring_attend_int8_step_reference, a, pos)
            torch.cuda.synchronize()
            for k in ("kb", "vb", "ks", "vs"):
                if not torch.equal(r1[k], r2[k]):
                    raise AssertionError(f"ring {k} not bit-exact, pos={pos}")
            if int(p1) != int(p2) or int(p1) != (pos + 1) % w:
                raise AssertionError(f"cursor {int(p1)} vs {int(p2)}")
            err = (o1.float() - o2.float()).abs().max().item()
            if dtype == torch.float32:
                torch.testing.assert_close(o1, o2, rtol=TOL_RING_F32[0],
                                           atol=TOL_RING_F32[1])
                tol = f"rtol {TOL_RING_F32[0]}, atol {TOL_RING_F32[1]}"
            else:
                if not err <= TOL_RING_BF16:
                    raise AssertionError(f"bf16 ring out differs: {err}")
                tol = f"atol {TOL_RING_BF16}"
            log(f"  {str(dtype)[6:]} pos={pos}: ring + scales + cursor "
                f"bit-exact; max|out diff| = {err:.3e} ({tol})")
            errs.append(err)
        res["ring_int8_step"]["max_abs_err"] = max(errs)
    phase("ring_int8_step vs plain", 90, ring_check)

    # ---- 5. the serving path ------------------------------------------
    def load():
        sd = params_from_jax(load_npz(CKPT))
        net = Net(**FLAGSHIP, device="cpu")
        net.load_state_dict(sd)
        log(f"  {CKPT}: {len(sd)} tensors, "
            f"{sum(v.numel() for v in sd.values())} params")
        return sd, net
    sd, net = phase("load checkpoint", 60, load)
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

    def path_vs_cpu():
        """Every step starts both engines from the CPU engine's state,
        so int8 flips of one step do not compound into the next."""
        n, steps = 4, 6
        engines = [StreamingEngine(net, sd, max_streams=n,
                                   dtype=torch.float32, device=d)
                   for d in ("cuda", "cpu")]
        for eng in engines:
            for s in range(n):
                eng.add_stream(s, emb[s])
        worst, flips, peak = 0.0, 0, 0.0
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
        if peak == 0.0:
            raise AssertionError("engine output is all zeros")
        log(f"  4 streams x {steps} steps, float32, int8 K/V, each step "
            f"from the same state: max|GPU - CPU| / peak = {worst:.3e} "
            f"(tolerance {TOL_PATH}); float state within {TOL_STATE}; "
            f"{flips} int8 ring entries off by one in {steps} steps")
    phase("path: GPU engine vs CPU engine", 200, path_vs_cpu)

    eng = StreamingEngine(net, sd, max_streams=STREAMS, dtype=torch.bfloat16,
                          kv_dtype=torch.int8)
    xs = torch.from_numpy(chunks_of(STREAMS, PATH_STEPS, 2)).to(
        dev, torch.bfloat16)
    launch_counts = {}

    def path_64():
        for s in range(STREAMS):
            eng.add_stream(s, emb[s])
        bilstm_scan_cuda.launches = 0
        ring_attend_int8_step_cuda.launches = 0
        outs = [eng.step(x) for x in xs]
        torch.cuda.synchronize()
        launch_counts["bilstm_scan"] = bilstm_scan_cuda.launches
        launch_counts["ring_int8_step"] = ring_attend_int8_step_cuda.launches
        y = torch.stack(outs).float()
        want = 3 * PATH_STEPS
        if not (tuple(y.shape) == (PATH_STEPS, STREAMS, 2, 128)
                and torch.isfinite(y).all()):
            raise AssertionError(f"bad output {tuple(y.shape)}")
        if y[1:].abs().max().item() == 0.0:
            raise AssertionError("engine output is all zeros")
        for k, v in launch_counts.items():
            if v != want:
                raise AssertionError(f"{k}: {v} launches, want {want}")
        log(f"  {STREAMS} streams x {PATH_STEPS} steps, bf16 + int8 K/V: "
            f"finite, peak |y| {y.abs().max().item():.3f}; launches "
            f"{launch_counts} (3 blocks x {PATH_STEPS} steps each)")
    phase("path: 64-stream bf16 engine", 150, path_64)

    # ---- 6. times (CUDA events) ----------------------------------------
    def times():
        for x in xs[:10]:                       # warm-up
            eng.step(x)
        step_ms = wall_ms(lambda i: eng.step(xs[i % PATH_STEPS]),
                          TIMED_STEPS, torch)
        log(f"  engine step, {STREAMS} streams bf16 + int8 K/V, eager: "
            f"median {step_ms:.3f} ms from call to synchronize "
            f"({TIMED_STEPS} steps), RTF {step_ms / CHUNK_MS:.4f} [{smi}]")
        res["engine"] = dict(step_ms=step_ms, rtf=step_ms / CHUNK_MS)
        res["engine"].update(profile_steps(eng, xs[:10], torch))

        # BiLSTM at the path's shape: xp [97, 2, 64, 256] f32
        t_, bb, h = 97, STREAMS, 64
        xp = gpu((rng.standard_normal((t_, 2, bb, 4 * h)) * 0.5)
                 .astype(np.float32))
        w_hh = gpu((rng.standard_normal((2, h, 4 * h)) * 0.3)
                   .astype(np.float32))
        for _ in range(5):
            bilstm_scan_cuda(xp, w_hh)
        k_ms = device_ms(lambda i: bilstm_scan_cuda(xp, w_hh), 100, torch)
        p_ms = wall_ms(lambda i: bilstm_scan_reference(xp, w_hh), 5, torch)
        lstm = torch.nn.LSTM(64, h, batch_first=True,
                             bidirectional=True).to(dev)
        with torch.no_grad():
            for sfx, tsfx in (("_l0", "_l0"), ("_l0_reverse", "_l0_reverse")):
                for a, tn in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                              ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                    getattr(lstm, tn + tsfx).copy_(
                        sd[f"tfgridnet.blocks.0.intra_rnn.{a}{sfx}"])
            x_in = gpu(rng.standard_normal((bb, t_, 64)).astype(np.float32))
            for _ in range(5):
                lstm(x_in)
            l_ms = device_ms(lambda i: lstm(x_in), 50, torch)
        nbytes = 4 * (xp.numel() + w_hh.numel() + t_ * 2 * bb * h
                      + 2 * bb * h)
        flops = t_ * 2 * bb * (2 * h * 4 * h + 4 * h)
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        res["bilstm_scan"].update(
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"  bilstm_scan [97,2,64,256]: kernel {k_ms * 1e3:.1f} us, "
            f"bound {res['bilstm_scan']['bound_ms'] * 1e3:.2f} us "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP f32), plain "
            f"{p_ms * 1e3:.1f} us, cuDNN nn.LSTM {l_ms * 1e3:.1f} us [{smi}]")

        # ring step at the path's shapes, bf16 q/k/v, three rings (one
        # per block) so the 92 MB do not sit in the 50 MB L2
        rings = [ring_inputs(torch.bfloat16) for _ in range(3)]
        poss = [torch.tensor(7, dtype=torch.int32, device=dev)
                for _ in range(3)]

        def call(step, i):
            r, p = rings[i % 3], poss[i % 3]
            step(r["q"], r["kt"], r["vt"], r["kb"], r["ks"], r["vb"],
                 r["vs"], p, f=f, n_head=nh, w=w)
        for i in range(6):
            call(ring_attend_int8_step_cuda, i)
        k_ms = device_ms(lambda i: call(ring_attend_int8_step_cuda, i), 150,
                         torch)
        p_ms = wall_ms(lambda i: call(ring_attend_int8_step_reference, i),
                       15, torch)
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
    phase("times", 180, times)

    meta = {
        "bilstm_scan": ("lookoncetohear_tpu_torch/csrc/bilstm_scan.cu",
                        "lookoncetohear_tpu/ops/pallas_lstm.py:59"),
        "ring_int8_step": ("lookoncetohear_tpu_torch/csrc/ring_int8_step.cu",
                           "lookoncetohear_tpu/ops/pallas_attention.py:334"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launch_counts[k],
                    max_abs_err=res[k]["max_abs_err"], ms=res[k]["ms"],
                    plain_ms=res[k]["plain_ms"], bound_ms=res[k]["bound_ms"],
                    bound_by=res[k]["bound_by"],
                    library_ms=res[k]["library_ms"])
               for k, (src, rep) in meta.items()]
    log(f"engine: {json.dumps(res['engine'])}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
