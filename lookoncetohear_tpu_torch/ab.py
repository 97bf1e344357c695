"""A/B of the port against another version of it, on one GPU.

    python3 -m lookoncetohear_tpu_torch.ab --baseline DIR [--pairs N]
        [--h128] [--out FILE]

DIR is a tree of another version of the port (for example the parent
commit's `lookoncetohear_tpu_torch/`, unpacked with `git archive`); its
kernels are built with its own `_build.py`. Both versions run in turns
within one call, on one card:
  * kernels, device time by CUDA events at the serving shapes: the
    BiLSTM scan (B2) at [97, 2, 64, 256] and at the full forward's
    [97, 2, 625, 256], the int8 ring step (B1) at 64 rows, w=50 in 56
    slots, bf16 and float32. B1 also as compiled with each other
    cluster split of --splits (LOOKONCE_RING_SPLIT in
    csrc/ring_int8_step.cu). A version's B1 entry is called with the
    signature its source declares (with or without the arrival counter).
    The ring attention step (B3/B4): all five `attn_step_*` entries at
    the float ring's serving shape (256 head-major rows x 49 slots, Dk
    582, Dv 1552), each on three input sets made on the card, so the
    rings do not sit in the 50 MB L2; then each entry's change. Beside
    them the floor of the timing method: `device_ms` of a one-element
    `add_`.
  * each version's ring-step wrapper, `ring_attend_int8_step_cuda`:
    host µs per call, which a host-bound step pays three times;
  * the engine step of the flagship at 64 streams, bf16 + int8 K/V and
    float32 ring: ms from call to synchronize (the step's latency) and
    ms of host time to queue one step (--pairs 0: none). Each version
    runs in a process of its own, with the weights of this tree's
    checkpoint, in N pairs whose first version alternates; then each
    version's median and quartiles, and the pairs in which this
    version's int8 step was the faster.
  * the two training scan kernels (`csrc/bilstm_scan.cu`: the
    state-saving forward and the backward) at the committed training
    configs' four scan shapes, from the same inputs in the models'
    layout [N, T, D*4H]. A version's entries are called with the
    signature and layout its source declares: a version that takes the
    scan layout [T, D, N, 4H] (`bilstm_scan_train_f32`) gets flipped and
    permuted copies, made outside the timing; a version with tiles
    (`bilstm_train_fwd_f32`) gets this tree's choice of tile.
  * one training step of each task (`TSETask`, `EmbedTask`) at its
    config's batch of 8 x 5 s from a seeded random init: ms a step from
    call to synchronize (median after the first), peak GB, and from one
    profiled step the device time of all kernels and of the layout
    copies (`direct_copy`); each version in a process of its own, in
    the order this, baseline, baseline, this (TRAIN_STEPS steps).
  * the H = 128 kernels (B2 and the training forward at the reference's
    default `Net`'s width) at its three path shapes: B2 at the 64-stream
    step's [141, 2, 64, 512] and the full forward's [141, 2, 500, 512],
    the training forward at the full forward's inter-time scan (T=500,
    D=1, N=141) from a carried state without cs; each version through
    its C entries with the signature its source declares and the tile
    its own wrapper picks (`scan_phases.h128_tile`), each output's
    largest difference from the plain version; then at the default
    `Net`'s two training scans at 8 x 5 s, (141, 2, 4000) and (500, 1,
    1128) from a carried state: the training forward as each version's
    training step runs it (this one with cs and the gates, and also
    without the gates; the baseline with what its source writes) and the
    backward, each version through its own C signature (one that
    recomputes the gates takes xp and y, one that reads them the
    gates), all from the outputs of one forward, with each output's
    largest difference from the plain version over max(1, peak); then
    the default `Net` (seeded weights) in processes of their own per
    version and turn (this, baseline, baseline, this): its 64-stream
    CUDA-graph step at float32 (ms from call to synchronize, median of
    NET_STEPS) and its full forward on 5 s (CUDA events, median of 5);
    and `Trainer.train_step` of `TSETask` with the default `Net` and the
    rest of configs/tsh_synthetic_5k.json at 8 x 5 s, keeping every
    activation and with every block checkpointed (ms a step, median
    after the first of TRAIN_STEPS, and peak GB allocated in the
    process). `--h128` runs only these.
The kernels run in the order this, baseline, baseline, this. Prints one
JSON object per measurement, each with the card's name and power limit,
and writes them to --out if given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch import scan_phases
from lookoncetohear_tpu_torch.ops import ring_step as rs
from lookoncetohear_tpu_torch.ops.attn_step import (VARIANTS,
                                                    attention_step_cuda,
                                                    attention_step_reference)
from lookoncetohear_tpu_torch.ops.bilstm_scan import (
    bilstm_scan_bwd_cuda, bilstm_scan_cuda, bilstm_scan_reference,
    bilstm_scan_train_cuda, bilstm_train_bwd_h128_cuda,
    bilstm_train_gates_backward_reference, bilstm_train_reference,
    scan_layout, tile_rows)
from lookoncetohear_tpu_torch.timing import attn_entry, attn_inputs, device_ms

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints" / "tsh_r5_5k_best.npz"
# the flagship separator, as chip_smoke.py drives it
FLAGSHIP = dict(embed_dim=256, stft_chunk_size=128, stft_pad_size=64,
                num_ch=2, D=64, L=4, I=1, J=1, B=3, H=64,
                local_atten_len=50, use_attn=True, lookahead=True,
                chunk_causal=True)
# the int8 ring at the serving shape: 64 rows, F=97, 4 heads, e=6, v 16
RING = dict(b=64, f=97, nh=4, e=6, vd=16, wp=56, w=50)
# the float ring at the serving shape: 64 streams x 4 heads, 49 slots
ATTN = dict(rows=256, w1=49, dk=97 * 6, dv=97 * 16)
ORDER = ("this", "baseline", "baseline", "this")   # the kernels
# the committed training configs' scans, (T, D, N): TSE intra and inter
# (from a carried state), EmbedNet intra and inter
TRAIN_SCANS = {"tse_intra": (97, 2, 5000), "tse_inter": (625, 1, 776),
               "embed_intra": (62, 2, 10008),
               "embed_inter": (1248, 2, 520)}
TRAIN_CONFIGS = {"TSETask": ROOT / "configs" / "tsh_synthetic_5k.json",
                 "EmbedTask": ROOT / "configs" / "embed_synthetic_5k.json"}
TRAIN_STEPS = 5  # steps a version's process times; the first is not kept
# the default Net's H = 128 scans: B2 [T, 2, B]; the training forward
# (T, D, N) from a carried state
H128_SHAPES = {"b2_serving": (141, 2, 64), "b2_full_forward": (141, 2, 500),
               "fwd_full_forward_inter": (500, 1, 141)}
NET_STEPS = 50   # timed graph steps of the default Net at 64 streams
# the default Net's training scans at 8 x 5 s, (T, D, N): the inter-time
# LSTM from a carried state
H128_TRAIN = {"train_intra": (141, 2, 4000), "train_inter": (500, 1, 1128)}
# the reference's `Net()` defaults, as chip_smoke.py trains them
DEFAULT_NET = dict(embed_dim=256, stft_chunk_size=160, stft_pad_size=120,
                   num_ch=2, D=64, L=0, I=1, J=1, B=6, H=128,
                   use_attn=False, lookahead=True, local_atten_len=100,
                   chunk_causal=False)

# One version's default Net (seeded weights, as chip_smoke.py builds it),
# in a process of its own with its tree first on sys.path: the 64-stream
# CUDA-graph step at float32 and the full forward on 5 s. Prints one JSON
# object.
_NET_PROBE = r"""
import json, sys, time
import numpy as np, torch
tree, streams, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
sys.path.insert(0, tree)
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
with torch.random.fork_rng(devices=[]):
    torch.manual_seed(14)
    net_cpu = Net(device="cpu").eval()
sd = net_cpu.state_dict()
net = Net()
net.load_state_dict(sd)
net.eval()
rng = np.random.default_rng(14)
emb = rng.standard_normal((streams, 256)).astype(np.float32)
emb /= np.linalg.norm(emb, axis=1, keepdims=True)
xs = torch.from_numpy((rng.standard_normal(
    (steps, streams, 2, net.stft_chunk_size)) * 0.1).astype(
        np.float32)).to(dev)
out = {}
with torch.no_grad():
    eng = StreamingEngine(net, sd, max_streams=streams, cuda_graph=True)
    for s in range(streams):
        eng.add_stream(s, emb[s])
    for i in range(10):
        eng.step(xs[i])
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(xs[i])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["graph_step_ms"] = float(np.median(ms))
    x5 = torch.from_numpy((rng.standard_normal((1, 2, 80000)) * 0.1).astype(
        np.float32)).to(dev)
    e5 = torch.from_numpy(emb[:1, None]).to(dev)
    net(x5, e5)
    ev = []
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        net(x5, e5)
        b.record()
        ev.append((a, b))
    torch.cuda.synchronize()
    out["full_forward_ms"] = float(np.median([a.elapsed_time(b)
                                              for a, b in ev]))
print(json.dumps(out))
"""

# One version's default Net in training, in a process of its own with its
# tree first on sys.path: `Trainer.train_step` at the config's 8 x 5 s,
# keeping every activation and then with every block checkpointed. Prints
# one JSON object.
_NET_TRAIN_PROBE = r"""
import json, sys, tempfile, time
import numpy as np, torch
tree, cfg, params, steps = sys.argv[1], sys.argv[2], json.loads(
    sys.argv[3]), int(sys.argv[4])
sys.path.insert(0, tree)
from lookoncetohear_tpu_torch import utils
from lookoncetohear_tpu_torch.data.loader import collate
from lookoncetohear_tpu_torch.train.trainer import (Trainer, build_task,
                                                    to_device)
dev = torch.device("cuda")
hp = utils.Params(cfg)
hp.pl_module_args = dict(hp.pl_module_args, model_params=params)
ds = utils.import_attr(hp.train_dataset)(**hp.train_data_args)
host = collate([ds[i] for i in range(hp.batch_size)])
task = build_task(hp, seed=16)
out = {}
with tempfile.TemporaryDirectory() as tmp, utils.full_float32():
    tr = Trainer(task, tmp, epochs=1, device=dev)
    batch = to_device(task.device_batch(host, train=True), dev)
    for remat in (False, True):
        task.model.tfgridnet.remat = remat
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(batch, 0)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["remat" if remat else "plain"] = dict(
            step_ms=float(np.median(ms[1:])), first_ms=ms[0],
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
print(json.dumps(out))
"""

# Run in a process of its own with one version's tree first on sys.path:
# its engine step and its ring-step wrapper, through entry points that
# every version of the port has. Prints one JSON object.
_STEP_PROBE = r"""
import json, sys, time
import numpy as np, torch
tree, ckpt, cfg, ring = sys.argv[1], sys.argv[2], json.loads(sys.argv[3]), \
    json.loads(sys.argv[4])
sys.path.insert(0, tree)
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.ops.ring_step import ring_attend_int8_step_cuda
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import load_npz, params_from_jax
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
out = {}
# the wrapper alone: host time per call, three rings (one per block)
b, f, nh, e, vd, wp, w = (ring[k] for k in ("b", "f", "nh", "e", "vd",
                                            "wp", "w"))
g = torch.Generator(device=dev).manual_seed(0)
def ring_state():
    r = [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
         for s in ((b, f * nh * e), (b, f * nh * e), (b, f * nh * vd))]
    for d in (f * nh * e, f * nh * vd):
        r += [torch.randint(-127, 128, (b, wp, d), generator=g, device=dev,
                            dtype=torch.int8),
              torch.rand((b, wp, nh), generator=g, device=dev) * 0.02 + 1e-3]
    return r + [torch.tensor(7, dtype=torch.int32, device=dev)]
rings = [ring_state() for _ in range(3)]
host = []
for i in range(400):
    if i % 50 == 0:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ring_attend_int8_step_cuda(*rings[i % 3], f=f, n_head=nh, w=w)
    host.append(time.perf_counter() - t0)
torch.cuda.synchronize()
out["wrapper_host_us"] = float(np.median(host[50:])) * 1e6
# the engine step
sd = params_from_jax(load_npz(ckpt))
net = Net(**cfg, device="cpu")
net.load_state_dict(sd)
rng = np.random.default_rng(0)
emb = rng.standard_normal((64, 256)).astype(np.float32)
emb /= np.linalg.norm(emb, axis=1, keepdims=True)
xs = torch.from_numpy(rng.standard_normal((60, 64, 2, 128)).astype(
    np.float32) * 0.1).to(dev)
for label, dtype, kv in (("bf16 + int8 K/V", torch.bfloat16, torch.int8),
                         ("float32 ring", torch.float32, None)):
    eng = StreamingEngine(net, sd, max_streams=64, dtype=dtype, kv_dtype=kv)
    for s in range(64):
        eng.add_stream(s, emb[s])
    x = xs.to(dtype)
    for i in range(10):
        eng.step(x[i])
    wall, queue = [], []
    for i in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step(x[10 + i % 50])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        queue.append((t1 - t0) * 1e3)
    out[label] = dict(step_ms=float(np.median(wall)),
                      host_ms=float(np.median(queue)))
print(json.dumps(out))
"""


# One version's training step, in a process of its own with its tree
# first on sys.path, through entry points every version with training
# has. Prints one JSON object.
_TRAIN_PROBE = r"""
import json, sys, tempfile, time
import numpy as np, torch
tree, cfg, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
sys.path.insert(0, tree)
from torch.profiler import ProfilerActivity, profile
from lookoncetohear_tpu_torch import utils
from lookoncetohear_tpu_torch.data.loader import collate
from lookoncetohear_tpu_torch.train.trainer import (Trainer, build_task,
                                                    to_device)
dev = torch.device("cuda")
hp = utils.Params(cfg)
ds = utils.import_attr(hp.train_dataset)(**hp.train_data_args)
host = collate([ds[i] for i in range(hp.batch_size)])
torch.manual_seed(0)
task = build_task(hp)
with tempfile.TemporaryDirectory() as tmp, utils.full_float32():
    tr = Trainer(task, tmp, epochs=1, device=dev)
    batch = to_device(task.device_batch(host, train=True), dev)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch, 0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(batch, 0)
        torch.cuda.synchronize()
kern = [ev for ev in prof.events()
        if ev.device_type == torch.autograd.DeviceType.CUDA]
print(json.dumps(dict(
    step_ms=float(np.median(ms[1:])), first_ms=ms[0],
    peak_gb=torch.cuda.max_memory_allocated() / 1e9,
    device_ms=sum(ev.time_range.elapsed_us() for ev in kern) / 1e3,
    direct_copy_ms=sum(ev.time_range.elapsed_us() for ev in kern
                       if "direct_copy" in ev.name) / 1e3)))
"""


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def _bind_ring(lib, src: Path) -> bool:
    """ctypes signatures of a version's B1 entries; True if they take the
    arrival counter."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    arrivals = "arrivals" in src.read_text()
    for name in ("ring_int8_step_f32", "ring_int8_step_bf16"):
        getattr(lib, name).argtypes = [P] * (10 if arrivals else 9) + \
            [I] * 7 + [F, P]
    return arrivals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--splits", default="4",
                    help="other B1 cluster splits to build and time")
    ap.add_argument("--pairs", type=int, default=2,
                    help="pairs of processes (this, baseline) that time "
                    "the engine step")
    ap.add_argument("--h128", action="store_true",
                    help="only the H = 128 kernels and the default Net")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab: no CUDA device", file=sys.stderr)
        return 1
    base_tree = args.baseline.resolve()
    base_csrc = base_tree / "lookoncetohear_tpu_torch" / "csrc"
    if not base_csrc.is_dir():
        print(f"ab: {base_csrc} is not there", file=sys.stderr)
        return 1
    splits = [int(s) for s in args.splits.split(",") if s]
    work = _build.BUILD_DIR
    work.mkdir(parents=True, exist_ok=True)
    # every build at once: the baseline tree's own, one per other split
    # of this tree's B1, and this tree's (in this process)
    base_build = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from lookoncetohear_tpu_torch import _build; print(_build.build())",
         str(base_tree)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    split_builds = {
        sp: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DLOOKONCE_RING_SPLIT={sp}",
             "-o", str(work / f"ring_split{sp}.so"),
             str(_build.CSRC / "ring_int8_step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for sp in splits}
    _build.load_library()
    out, err = base_build.communicate(timeout=_build.NVCC_TIMEOUT_S + 60)
    if base_build.returncode:
        print(err, file=sys.stderr)
        return 1
    base = ctypes.CDLL(out.strip().splitlines()[-1])
    base.bilstm_scan_f32.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    base_arrivals = _bind_ring(
        base, base_csrc / "ring_int8_step.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    base_tiles = "bilstm_train_fwd_f32" in \
        (base_csrc / "bilstm_scan.cu").read_text()
    if base_tiles:
        base.bilstm_train_fwd_f32.argtypes = [P] * 7 + [I] * 5 + [P]
        base.bilstm_train_bwd_f32.argtypes = [P] * 11 + [I] * 5 + [P]
    else:
        base.bilstm_scan_train_f32.argtypes = [P] * 7 + [I] * 4 + [P]
        base.bilstm_scan_bwd_f32.argtypes = [P] * 11 + [I] * 4 + [P]
    split_libs = {}
    for sp, proc in split_builds.items():
        log, _ = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode:
            print(log, file=sys.stderr)
            return 1
        split_libs[sp] = ctypes.CDLL(str(work / f"ring_split{sp}.so"))
        _bind_ring(split_libs[sp], _build.CSRC / "ring_int8_step.cu")

    smi = _smi()
    rows = []

    def emit(**kw):
        kw["device"] = smi
        rows.append(kw)
        print(json.dumps(kw), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def probe(name, tree, turn) -> int:
        """One process of one version: its ring-step wrapper's host time
        and its engine steps. Returns non-zero if the process failed."""
        proc = subprocess.run(
            [sys.executable, "-c", _STEP_PROBE, str(tree), str(CKPT),
             json.dumps(FLAGSHIP), json.dumps(RING)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        us = got.pop("wrapper_host_us")
        emit(what="ring_attend_int8_step_cuda host", version=name,
             turn=turn, us=us)
        seen.setdefault(("wrapper host us", "int8", name), []).append(us)
        for label, t in got.items():
            emit(what="engine step, 64 streams", ring=label, version=name,
                 turn=turn, **t)
            seen.setdefault(("engine step ms", label, name), []).append(
                t["step_ms"])
        return 0

    # ---- the H = 128 kernels and the default Net
    if "bilstm_scan_h128_f32" in (base_csrc / "bilstm_scan.cu").read_text():
        if h128_section(base, base_tree, emit, g, stream()):
            return 1
    if args.h128:
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
        return 0

    # ---- B2
    for b in (64, 625):
        xp = torch.randn((97, 2, b, 256), generator=g, device=dev) * 0.5
        w_hh = torch.randn((2, 64, 256), generator=g, device=dev) * 0.3
        ys = torch.empty((97, 2, b, 64), device=dev)
        c_t = torch.empty((2, b, 64), device=dev)

        def base_scan(i):
            _build.check(base.bilstm_scan_f32(
                xp.data_ptr(), w_hh.data_ptr(), ys.data_ptr(),
                c_t.data_ptr(), 97, b, 64, stream()), "baseline bilstm_scan")
            return ys, c_t
        fns = {"this": lambda i: bilstm_scan_cuda(xp, w_hh),
               "baseline": base_scan}
        want = bilstm_scan_reference(xp, w_hh)
        for name, fn in fns.items():
            got = fn(0)
            torch.cuda.synchronize()
            emit(kernel="bilstm_scan", version=name, rows=b,
                 max_abs_err=max((a - r).abs().max().item()
                                 for a, r in zip(got, want)))
        for name in ORDER:
            for i in range(3):
                fns[name](i)
            emit(kernel="bilstm_scan", version=name, rows=b,
                 us=device_ms(fns[name], 100) * 1e3)

    # ---- the training kernels, from inputs in the models' layout; the
    # baseline gets them in the layout its entries take
    for key, (t_, nd, n) in TRAIN_SCANS.items():
        def r_(*shape, k=0.5):
            return torch.randn(shape, generator=g, device=dev) * k
        xp, w_hh = r_(n, t_, nd * 256), r_(nd, 64, 256, k=0.3)
        h0 = c0 = None
        if key == "tse_inter":
            h0, c0 = r_(nd, n, 64), r_(nd, n, 64)
        dy, dct = r_(n, t_, nd * 64, k=1.0), r_(nd, n, 64, k=1.0)
        y, c_t, cs = bilstm_scan_train_cuda(xp, w_hh, h0, c0)
        p = (lambda t: None if t is None else t.data_ptr())
        if base_tiles:
            bx, bdy = xp, dy
            b_out = [torch.empty_like(y), torch.empty_like(c_t),
                     torch.empty_like(cs)]
            b_grad = [torch.empty_like(xp), torch.empty_like(c_t),
                      torch.empty_like(c_t)]
        else:
            bx, bdy = scan_layout(xp, nd), scan_layout(dy, nd)
            b_out = [torch.empty(t_, nd, n, 64, device=dev),
                     torch.empty_like(c_t),
                     torch.empty(t_, nd, n, 64, device=dev)]
            b_grad = [torch.empty_like(bx), torch.empty_like(c_t),
                      torch.empty_like(c_t)]

        def base_fwd(i):
            yb, cb, csb = b_out
            if base_tiles:
                rc = base.bilstm_train_fwd_f32(
                    p(bx), p(w_hh), p(h0), p(c0), p(yb), p(csb), p(cb), t_,
                    nd, n, 64, tile_rows(n, nd, dev, "fwd"), stream())
            else:
                rc = base.bilstm_scan_train_f32(
                    p(bx), p(w_hh), p(h0), p(c0), p(yb), p(csb), p(cb), t_,
                    nd, n, 64, stream())
            _build.check(rc, "baseline training forward")

        def base_bwd(i):
            yb, _, csb = b_out
            dx, dh, dc = b_grad
            if base_tiles:
                rc = base.bilstm_train_bwd_f32(
                    p(bx), p(w_hh), p(h0), p(c0), p(yb), p(csb), p(bdy),
                    p(dct), p(dx), p(dh), p(dc), t_, nd, n, 64,
                    tile_rows(n, nd, dev, "bwd"), stream())
            else:
                rc = base.bilstm_scan_bwd_f32(
                    p(bx), p(w_hh), p(h0), p(c0), p(yb), p(csb), p(bdy),
                    p(dct), p(dx), p(dh), p(dc), t_, nd, n, 64, stream())
            _build.check(rc, "baseline training backward")
        fns = {("fwd", "this"): lambda i: bilstm_scan_train_cuda(
                   xp, w_hh, h0, c0),
               ("bwd", "this"): lambda i: bilstm_scan_bwd_cuda(
                   xp, w_hh, h0, c0, y, cs, dy, dct),
               ("fwd", "baseline"): base_fwd, ("bwd", "baseline"): base_bwd}
        base_fwd(0)
        base_bwd(0)
        dxp = fns[("bwd", "this")](0)[0]
        torch.cuda.synchronize()
        # the two versions' outputs, in the baseline's layout
        mine = (y, dxp) if base_tiles else (scan_layout(y, nd),
                                            scan_layout(dxp, nd))
        emit(kernel="bilstm_train", shape=key,
             what="max |this - baseline|",
             y=(mine[0] - b_out[0]).abs().max().item(),
             dxp=(mine[1] - b_grad[0]).abs().max().item())
        for kname in ("fwd", "bwd"):
            for version in ORDER:
                fn = fns[(kname, version)]
                for i in range(3):
                    fn(i)
                emit(kernel=f"bilstm_train_{kname}", shape=key,
                     version=version, us=device_ms(fn, 10) * 1e3)
        del xp, dy, y, cs, bx, bdy, b_out, b_grad, dxp, fns
        torch.cuda.empty_cache()

    # ---- B1, three rings so the 92 MB do not sit in the 50 MB L2
    b, f, nh, e, vd, wp, w = (RING[k] for k in
                              ("b", "f", "nh", "e", "vd", "wp", "w"))
    dk, dv = f * nh * e, f * nh * vd
    inv = float(1.0 / np.sqrt(f * e))

    def ring(dtype):
        def int8(d):
            return torch.randint(-127, 128, (b, wp, d), generator=g,
                                 device=dev, dtype=torch.int8)

        def scales():
            return torch.rand((b, wp, nh), generator=g, device=dev) \
                * 1.9e-2 + 1e-3
        return [torch.randn((b, dk), generator=g, device=dev).to(dtype),
                torch.randn((b, dk), generator=g, device=dev).to(dtype),
                torch.randn((b, dv), generator=g, device=dev).to(dtype),
                int8(dk), scales(), int8(dv), scales(),
                torch.tensor(7, dtype=torch.int32, device=dev)]

    def raw_step(lib, arrivals, r):
        """One B1 call through a library's C entry."""
        out = torch.empty_like(r[2])
        fn = lib.ring_int8_step_f32 if r[0].dtype == torch.float32 \
            else lib.ring_int8_step_bf16
        ptrs = [t.data_ptr() for t in r]
        if arrivals:
            ptrs.append(rs.arrival_counter(r[7]).data_ptr())
        _build.check(fn(*ptrs, out.data_ptr(), b, dk, dv, wp, w, f, nh, inv,
                        stream()), "ring_int8_step")

    for dtype in (torch.bfloat16, torch.float32):
        rings = [ring(dtype) for _ in range(3)]
        fns = {"this": lambda i: rs.ring_attend_int8_step_cuda(
                   *rings[i % 3], f=f, n_head=nh, w=w),
               "baseline": lambda i: raw_step(base, base_arrivals,
                                              rings[i % 3])}
        for sp, lib in split_libs.items():
            fns[f"this, split {sp}"] = (
                lambda i, lib=lib: raw_step(lib, True, rings[i % 3]))
        order = list(fns) + list(fns)[::-1]
        for name in order:
            for i in range(6):
                fns[name](i)
            emit(kernel="ring_int8_step", version=name,
                 dtype=str(dtype)[6:], us=device_ms(fns[name], 150) * 1e3)
    del rings
    torch.cuda.empty_cache()

    # ---- the floor of device_ms: one launch that does nearly nothing
    one = torch.zeros(1, device=dev)
    for _ in range(10):
        one.add_(1)
    emit(what="device_ms floor: one-element add_",
         us=device_ms(lambda i: one.add_(1), 150) * 1e3)

    # ---- B3/B4, each entry on three input sets
    nrows, w1, adk, adv = (ATTN[k] for k in ("rows", "w1", "dk", "dv"))
    for (qdt, kvdt), name in VARIANTS.items():
        sets = [attn_inputs(g, nrows, w1, adk, adv, qdt, kvdt)
                for _ in range(3)]
        base_fn = attn_entry(base, name)
        fns = {"this": lambda i, sets=sets: attention_step_cuda(
                   *sets[i % 3][:5], *sets[i % 3][5:]),
               "baseline": lambda i, sets=sets, f=base_fn: f(
                   sets[i % 3], torch.empty_like(sets[i % 3][2]))}
        want = attention_step_reference(*sets[0][:5], *sets[0][5:]).float()
        for version, fn in fns.items():
            got = fn(0).float()
            torch.cuda.synchronize()
            emit(kernel=name, version=version,
                 max_abs_err=(got - want).abs().max().item())
        us = {}
        for version in ORDER:
            for i in range(6):
                fns[version](i)
            t = device_ms(fns[version], 150) * 1e3
            us.setdefault(version, []).append(t)
            emit(kernel=name, version=version, us=t)
        this_us, base_us = (float(np.mean(us[v])) for v in ("this",
                                                             "baseline"))
        emit(kernel=name, what="summary", this_us=this_us,
             baseline_us=base_us, change=this_us / base_us - 1.0)
        del sets
    torch.cuda.empty_cache()

    # ---- the wrapper's host time and the engine step, one process per
    # version and turn, --pairs pairs, each pair's first version
    # alternating (the host varies more than the versions may differ)
    seen: dict = {}
    for k in range(args.pairs):
        for name in ("this", "baseline")[::1 if k % 2 == 0 else -1]:
            if probe(name, ROOT if name == "this" else base_tree, k):
                return 1
    # ---- a training step of each task, one process per version and
    # turn: this, baseline, baseline, this
    for task, cfg in TRAIN_CONFIGS.items():
        for turn, name in enumerate(ORDER):
            proc = subprocess.run(
                [sys.executable, "-c", _TRAIN_PROBE,
                 str(ROOT if name == "this" else base_tree), str(cfg),
                 str(TRAIN_STEPS)], capture_output=True, text=True,
                timeout=900)
            if proc.returncode:
                print(proc.stderr, file=sys.stderr)
                return 1
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            emit(what="training step, 8 x 5 s", task=task, version=name,
                 turn=turn, **got)
            seen.setdefault(("training step ms", task, name), []).append(
                got["step_ms"])
    for key, runs in seen.items():
        emit(what=f"{key[0]}, summary", ring=key[1], version=key[2],
             runs=len(runs), median=float(np.median(runs)),
             quartiles=[float(np.percentile(runs, 25)),
                        float(np.percentile(runs, 75))])
    if args.pairs:
        this_ms, base_ms = (seen[("engine step ms", "bf16 + int8 K/V", v)]
                            for v in ("this", "baseline"))
        emit(what="engine step ms, bf16 + int8 K/V: pairs this ran faster",
             wins=sum(a < b for a, b in zip(this_ms, base_ms)),
             pairs=args.pairs)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


def h128_section(base, base_tree, emit, g, stream) -> int:
    """The H = 128 kernels of both versions at H128_SHAPES, then each
    version's default Net in processes of their own; non-zero if a
    process failed."""
    source = (base_tree / "lookoncetohear_tpu_torch" / "csrc" /
              "bilstm_scan.cu").read_text()
    design = scan_phases.design_of(source)
    sig = scan_phases.signatures(source)
    scan_phases.bind_h128(base, design, sig)
    cost = scan_phases.cost_table(base_tree)
    dev = g.device
    p = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    for key, (t_, nd, n) in H128_SHAPES.items():
        train = key.startswith("fwd")

        def r_(*shape, k=0.5):
            return torch.randn(shape, generator=g, device=dev) * k
        tile = scan_phases.h128_tile(design, base, cost, n, nd, train)
        if train:
            xp, w = r_(n, t_, nd * 512), r_(nd, 128, 512, k=0.2)
            h0, c0 = r_(nd, n, 128), r_(nd, n, 128)
            want = bilstm_train_reference(xp, w, torch.float32, h0, c0)
            got = tuple(torch.empty_like(e) for e in want)

            def this(i):
                return bilstm_scan_train_cuda(xp, w, h0, c0,
                                              save_cs=False)[:2]

            def baseline(i):
                _build.check(base.bilstm_train_fwd_h128_f32(
                    *scan_phases.fwd_args(sig, xp, w, h0, c0, got[0], None,
                                          None, got[1]),
                    t_, nd, n, *tile, stream), "baseline training forward")
                return got
        else:
            xp, w = r_(t_, 2, n, 512), r_(2, 128, 512, k=0.2)
            want = bilstm_scan_reference(xp, w)
            got = tuple(torch.empty_like(e) for e in want)

            def this(i):
                return bilstm_scan_cuda(xp, w)

            def baseline(i):
                _build.check(base.bilstm_scan_h128_f32(
                    p(xp), p(w), p(got[0]), p(got[1]), t_, n, *tile,
                    stream), "baseline B2")
                return got
        fns = {"this": this, "baseline": baseline}
        for name, fn in fns.items():
            out = fn(0)
            torch.cuda.synchronize()
            emit(kernel="h128", shape=key, version=name,
                 max_abs_err=max((a - e).abs().max().item()
                                 for a, e in zip(out, want)))
        us = {}
        for name in ORDER:
            for i in range(3):
                fns[name](i)
            v = device_ms(fns[name], 20) * 1e3
            us.setdefault(name, []).append(v)
            emit(kernel="h128", shape=key, version=name, us=v,
                 **({"tile": list(tile)} if name == "baseline" else {}))
        this_us, base_us = (float(np.mean(us[v])) for v in ("this",
                                                             "baseline"))
        emit(kernel="h128", shape=key, what="summary", this_us=this_us,
             baseline_us=base_us, speedup=base_us / this_us)
        del xp, w, want, got, fns
        torch.cuda.empty_cache()
    train_section(base, sig, design, cost, base_tree, emit, g, stream)
    runs: dict = {}
    for turn, name in enumerate(ORDER):
        proc = subprocess.run(
            [sys.executable, "-c", _NET_PROBE,
             str(ROOT if name == "this" else base_tree), "64",
             str(NET_STEPS)], capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        emit(what="default Net, 64 streams, float32", version=name,
             turn=turn, **got)
        for k, v in got.items():
            runs.setdefault((k, name), []).append(v)
    for turn, name in enumerate(ORDER):
        proc = subprocess.run(
            [sys.executable, "-c", _NET_TRAIN_PROBE,
             str(ROOT if name == "this" else base_tree),
             str(TRAIN_CONFIGS["TSETask"]), json.dumps(DEFAULT_NET),
             str(TRAIN_STEPS)], capture_output=True, text=True, timeout=900)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return 1
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        for label, row in got.items():
            emit(what="default Net train_step, 8 x 5 s", remat=label,
                 version=name, turn=turn, **row)
            for k, v in row.items():
                runs.setdefault((f"train_step {label} {k}", name),
                                []).append(v)
    for (k, name), v in runs.items():
        emit(what=f"default Net {k}, summary", version=name,
             mean=float(np.mean(v)), runs=v)
    return 0


def train_section(base, sig, design, cost, base_tree, emit, g,
                  stream) -> None:
    """At the default Net's training scans H128_TRAIN: the training
    forward and the backward of both versions, in turns, from one
    forward's outputs; nothing when the baseline has no H = 128
    backward."""
    if not sig["bwd"]:
        return
    bcost = scan_phases.cost_table(base_tree, "H128_BWD_TILE_COST")
    dev = g.device
    for key, (t_, nd, n) in H128_TRAIN.items():
        def r_(*shape, k=0.5):
            return torch.randn(shape, generator=g, device=dev) * k
        xp, w = r_(n, t_, nd * 512), r_(nd, 128, 512, k=0.2)
        h0, c0 = (r_(nd, n, 128), r_(nd, n, 128)) if nd == 1 \
            else (None, None)
        dy, dct = r_(n, t_, nd * 128, k=1.0), r_(nd, n, 128, k=1.0)
        y, c_t, cs, gates = bilstm_scan_train_cuda(xp, w, h0, c0,
                                                   save_gates=True)
        b_fwd = [torch.empty_like(v) for v in (y, c_t, cs, gates)]
        b_bwd = [torch.empty_like(xp), torch.empty_like(c_t),
                 torch.empty_like(c_t)]
        ftile = scan_phases.h128_tile(design, base, cost, n, nd, 1)
        btile = scan_phases.h128_tile(design, base, bcost, n, nd, 2)

        def base_fwd(i):
            # what the baseline's training step has its forward write
            _build.check(base.bilstm_train_fwd_h128_f32(
                *scan_phases.fwd_args(sig, xp, w, h0, c0, b_fwd[0], b_fwd[2],
                                      b_fwd[3], b_fwd[1]),
                t_, nd, n, *ftile, stream), "baseline training forward")
            return b_fwd[:3] + (b_fwd[3:] if sig["fwd"] == 8 else [])

        def base_bwd(i):
            _build.check(base.bilstm_train_bwd_h128_f32(
                *scan_phases.bwd_args(sig, xp, w, h0, c0, y, cs, gates, dy,
                                      dct, *b_bwd),
                t_, nd, n, *btile, stream), "baseline backward")
            return b_bwd
        fns = {
            "fwd": {"this": lambda i: bilstm_scan_train_cuda(
                        xp, w, h0, c0, save_gates=True),
                    "this, no gates": lambda i: bilstm_scan_train_cuda(
                        xp, w, h0, c0),
                    "baseline": base_fwd},
            "bwd": {"this": lambda i: bilstm_train_bwd_h128_cuda(
                        gates, w, c0, cs, dy, dct),
                    "baseline": base_bwd}}
        wants = {"fwd": bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                               with_cs=True, with_gates=True),
                 "bwd": bilstm_train_gates_backward_reference(
                     gates, w, c0, cs, dy, dct)}
        for kname, group in fns.items():
            for name, fn in group.items():
                out = fn(0)
                torch.cuda.synchronize()
                emit(kernel=f"h128 {kname}", shape=key, version=name,
                     max_err_of_peak=max(
                         (a - e).abs().max().item()
                         / max(1.0, e.abs().max().item())
                         for a, e in zip(out, wants[kname])))
            order = ORDER if kname == "bwd" else (
                "this", "this, no gates", "baseline", "baseline",
                "this, no gates", "this")
            us = {}
            for name in order:
                for i in range(2):
                    group[name](i)
                v = device_ms(group[name], 5) * 1e3
                us.setdefault(name, []).append(v)
                emit(kernel=f"h128 {kname}", shape=key, version=name, us=v,
                     tile=list(btile if kname == "bwd" else ftile)
                     if name == "baseline" else None)
            emit(kernel=f"h128 {kname}", shape=key, what="summary",
                 **{f"{name} us": float(np.mean(v))
                    for name, v in us.items()})
        del xp, w, h0, c0, dy, dct, y, c_t, cs, gates, b_fwd, b_bwd, fns
        del wants
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
