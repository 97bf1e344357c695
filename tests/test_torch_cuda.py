"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skipped elsewhere. On a machine
without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: BiLSTM float32 atol 2e-5; ring step int8 writes, scales
and cursor bit-exact after every one of w + 3 chained calls, float32
out rtol 2e-5 / atol 2e-6, bf16 q/k/v out atol 2e-2
(one bf16 rounding of the output, ~2^-8 relative at |out| <= ~3).
Ring attention step: float32 over a float ring atol 1e-4 (the JAX
package's bound for the Pallas step at the flagship shapes), over an
int8 ring rtol/atol 2e-5; a bf16 q or ring atol 2e-2.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from lookoncetohear_tpu_torch.ops.bilstm_scan import (H128_TILE_COST,
                                                      bilstm_scan_cuda,
                                                      bilstm_scan_reference)
from lookoncetohear_tpu_torch.ops.attn_step import (
    VARIANTS, attention_step_cuda, attention_step_reference)
from lookoncetohear_tpu_torch.ops.ring_step import (
    arrival_counter, ring_attend_int8_step_cuda,
    ring_attend_int8_step_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,h", [(64, 64), (12, 64), (625, 64)])
def test_bilstm_kernel_matches_plain(dev, b, h):
    """The serving batch, a ragged one, and the full forward's 625 rows
    (1,250 blocks, several per SM), all 97 steps at atol 2e-5."""
    g = torch.Generator().manual_seed(b + h)
    xp = (torch.randn(97, 2, b, 4 * h, generator=g) * 0.5).to(dev)
    w_hh = (torch.randn(2, h, 4 * h, generator=g) * 0.3).to(dev)
    ys, c_t = bilstm_scan_cuda(xp, w_hh)
    rys, rc = bilstm_scan_reference(xp, w_hh)
    torch.cuda.synchronize()
    torch.testing.assert_close(ys, rys, atol=2e-5, rtol=0)
    torch.testing.assert_close(c_t, rc, atol=2e-5, rtol=0)


def test_bilstm_kernel_refuses_other_widths(dev):
    """The kernels are built for H=64 and H=128 only."""
    xp = torch.zeros(3, 2, 5, 64, device=dev)
    w_hh = torch.zeros(2, 16, 64, device=dev)
    with pytest.raises(ValueError, match="H=64"):
        bilstm_scan_cuda(xp, w_hh)


def _ring(dev, b, f, nh, e, vd, wp, dtype, seed):
    rng = np.random.default_rng(seed)
    dk, dv = f * nh * e, f * nh * vd
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(
        q=t(rng.standard_normal((b, dk)).astype(np.float32)).to(dtype),
        kt=t(rng.standard_normal((b, dk)).astype(np.float32)).to(dtype),
        vt=t(rng.standard_normal((b, dv)).astype(np.float32)).to(dtype),
        kb=t(rng.integers(-127, 128, (b, wp, dk)).astype(np.int8)),
        ks=t(rng.uniform(1e-3, 2e-2, (b, wp, nh)).astype(np.float32)),
        vb=t(rng.integers(-127, 128, (b, wp, dv)).astype(np.int8)),
        vs=t(rng.uniform(1e-3, 2e-2, (b, wp, nh)).astype(np.float32)))


def _chain(dev, a, pos, f, nh, w, dtype, seed):
    """w + 3 consecutive calls of the kernel and of its plain version,
    each from its own copy of one state, with fresh q/k_t/v_t per call:
    after every call the ring, scales and pos are bit-exact, out is
    within tolerance, and the arrival counter is back at 0."""
    rng = np.random.default_rng(seed)
    states = [{k: v.clone() for k, v in a.items()} for _ in range(2)]
    ps = [torch.tensor(pos, dtype=torch.int32, device=dev) for _ in range(2)]
    for call in range(w + 3):
        q, kt, vt = (torch.from_numpy(rng.standard_normal(
            a[k].shape).astype(np.float32)).to(dev, dtype)
            for k in ("q", "kt", "vt"))
        outs = [step(q, kt, vt, r["kb"], r["ks"], r["vb"], r["vs"], p,
                     f=f, n_head=nh, w=w)
                for step, r, p in zip((ring_attend_int8_step_cuda,
                                       ring_attend_int8_step_reference),
                                      states, ps)]
        torch.cuda.synchronize()
        assert int(arrival_counter(ps[0])) == 0, call
        assert int(ps[0]) == int(ps[1]) == (pos + call + 1) % w, call
        for k in ("kb", "vb", "ks", "vs"):
            assert torch.equal(states[0][k], states[1][k]), (k, call)
        if dtype == torch.float32:
            torch.testing.assert_close(outs[0], outs[1], rtol=2e-5,
                                       atol=2e-6)
        else:
            torch.testing.assert_close(outs[0].float(), outs[1].float(),
                                       rtol=0, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 7, 49])
def test_ring_kernel_matches_plain(dev, dtype, pos):
    """The serving shape (w=50 over the 2 CTAs of a row: 25 and 25
    slots), w + 3 chained calls through the wrap of the cursor."""
    f, nh, e, vd, b, wp, w = 97, 4, 6, 16, 64, 56, 50
    a = _ring(dev, b, f, nh, e, vd, wp, dtype, seed=pos)
    _chain(dev, a, pos, f, nh, w, dtype, seed=100 + pos)


@pytest.mark.parametrize("w", [2, 7])
def test_ring_kernel_ragged_split(dev, w):
    """w not a multiple of the split: w=7 gives the two CTAs of a row 3
    and 4 slots; at w=2, whenever `pos` is 0 or 1, the CTA holding it has
    no live slot (w + 3 calls run `pos` through every slot)."""
    f, nh, e, vd, b, wp = 5, 4, 2, 16, 6, 8
    a = _ring(dev, b, f, nh, e, vd, wp, torch.float32, seed=w)
    _chain(dev, a, w - 1, f, nh, w, torch.float32, seed=200 + w)


def test_ring_kernel_two_rings_on_two_streams(dev):
    """Two rings at the serving shape stepped at once, each on a stream
    of its own, w + 3 calls: each ring has its own arrival counter, so
    both stay bit-exact with the plain version and each cursor advances
    once per call."""
    f, nh, e, vd, b, wp, w = 97, 4, 6, 16, 64, 56, 50
    rings = [_ring(dev, b, f, nh, e, vd, wp, torch.bfloat16, seed=s)
             for s in (1, 2)]
    plain = [{k: v.clone() for k, v in r.items()} for r in rings]
    starts = (3, 30)
    pos = [torch.tensor(p, dtype=torch.int32, device=dev) for p in starts]
    pos_plain = [p.clone() for p in pos]
    streams = [torch.cuda.Stream(dev) for _ in rings]
    g = torch.Generator(device=dev).manual_seed(9)
    for call in range(w + 3):
        frames = [[torch.randn(r[k].shape, generator=g, device=dev)
                   .to(torch.bfloat16) for k in ("q", "kt", "vt")]
                  for r in rings]
        torch.cuda.synchronize()
        outs = []
        for r, p, fr, st in zip(rings, pos, frames, streams):
            with torch.cuda.stream(st):
                outs.append(ring_attend_int8_step_cuda(
                    *fr, r["kb"], r["ks"], r["vb"], r["vs"], p, f=f,
                    n_head=nh, w=w))
        torch.cuda.synchronize()
        for i, (r, rp, fr) in enumerate(zip(rings, plain, frames)):
            want = ring_attend_int8_step_reference(
                *fr, rp["kb"], rp["ks"], rp["vb"], rp["vs"], pos_plain[i],
                f=f, n_head=nh, w=w)
            assert int(pos[i]) == int(pos_plain[i]) == \
                (starts[i] + call + 1) % w, (i, call)
            assert int(arrival_counter(pos[i])) == 0, (i, call)
            for k in ("kb", "vb", "ks", "vs"):
                assert torch.equal(r[k], rp[k]), (i, k, call)
            torch.testing.assert_close(outs[i].float(), want.float(),
                                       rtol=0, atol=2e-2)
    assert arrival_counter(pos[0]) is not arrival_counter(pos[1])


def _attn_inputs(dev, b, w1, dk, dv, qdt, kvdt, seed):
    g = torch.Generator().manual_seed(seed)
    q, kt = (torch.randn(b, dk, generator=g) for _ in range(2))
    vt = torch.randn(b, dv, generator=g)
    scales = {}
    if kvdt == torch.int8:
        kb = torch.randint(-127, 128, (b, w1, dk), generator=g,
                           dtype=torch.int8)
        vb = torch.randint(-127, 128, (b, w1, dv), generator=g,
                           dtype=torch.int8)
        scales = {k: (torch.rand(b, w1, generator=g) * 0.02 + 1e-3).to(dev)
                  for k in ("k_scale", "v_scale")}
    else:
        kb = torch.randn(b, w1, dk, generator=g).to(kvdt)
        vb = torch.randn(b, w1, dv, generator=g).to(kvdt)
    args = [x.to(dev, qdt) for x in (q, kt, vt)] + [kb.to(dev), vb.to(dev)]
    return args, scales


def _check_attn(got, want, qdt, kvdt):
    if qdt == kvdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    elif kvdt == torch.int8 and qdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-2)


@pytest.mark.parametrize("qdt,kvdt", list(VARIANTS), ids=list(
    VARIANTS.values()))
@pytest.mark.parametrize("b", [256, 5])
def test_attention_step_kernel_matches_plain(dev, qdt, kvdt, b):
    """Every instantiation at the flagship head-major widths (64 streams
    x 4 heads = 256 rows, 49 slots, Dk 582, Dv 1552) and a ragged row
    count, and at an odd Dk = 525; K rows start off 16-byte alignment
    (582: 4-byte aligned in bf16; 525: 2-byte aligned in bf16, 1-byte
    in int8)."""
    for dk in (582, 525):
        args, scales = _attn_inputs(dev, b, 49, dk, 1552, qdt, kvdt, b + dk)
        before = attention_step_cuda.variant_launches[VARIANTS[(qdt, kvdt)]]
        got = attention_step_cuda(*args, **scales)
        want = attention_step_reference(*args, **scales)
        torch.cuda.synchronize()
        assert attention_step_cuda.variant_launches[
            VARIANTS[(qdt, kvdt)]] == before + 1
        assert got.dtype == qdt and got.shape == (b, 1552)
        _check_attn(got, want, qdt, kvdt)


@pytest.mark.parametrize("qdt,kvdt", list(VARIANTS), ids=list(
    VARIANTS.values()))
@pytest.mark.parametrize("w1,dk,dv", [(3, 7, 16), (1, 1, 32), (2, 9, 16),
                                      (120, 33, 48), (49, 582, 4208)])
def test_attention_step_kernel_edge_shapes(dev, qdt, kvdt, w1, dk, dv):
    """K spans shorter than 16 bytes, one slot, 120 slots, and V rows
    wider than one block's columns (Dv 4208: two or three column
    blocks, more tiles than buffers)."""
    args, scales = _attn_inputs(dev, 7, w1, dk, dv, qdt, kvdt, w1 + dk)
    got = attention_step_cuda(*args, **scales)
    want = attention_step_reference(*args, **scales)
    torch.cuda.synchronize()
    assert got.dtype == qdt and got.shape == (7, dv)
    _check_attn(got, want, qdt, kvdt)


def test_attention_step_kernel_refuses_what_it_cannot_take(dev):
    args, _ = _attn_inputs(dev, 4, 3, 7, 16, torch.float32, torch.float32, 0)
    # q one element into its storage: 4-byte aligned, not 16
    args[0] = torch.empty(4 * 7 + 1, device=dev)[1:].view(4, 7).copy_(
        args[0])
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_step_cuda(*args)
    args, _ = _attn_inputs(dev, 4, 3, 7, 16, torch.float32, torch.float32, 0)
    args[3] = args[3].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        attention_step_cuda(*args)
    args, _ = _attn_inputs(dev, 4, 3, 8, 16, torch.bfloat16, torch.float32,
                           0)
    with pytest.raises(TypeError, match="unsupported types"):
        attention_step_cuda(*args)


def test_ring_ops_launch_the_kernel(dev):
    """The op entries of the ring attention go through the kernel on
    CUDA tensors: one launch each, and the same results as on the CPU."""
    from lookoncetohear_tpu_torch.ops import attention as att
    args, _ = _attn_inputs(dev, 8, 6, 24, 32, torch.float32, torch.float32, 1)
    pos = torch.tensor(5, dtype=torch.int32, device=dev)
    cpu = [a.cpu() for a in args] + [pos.cpu()]
    before = attention_step_cuda.launches
    out, kb, vb, p = att.local_attention_step_ring(*args, pos)
    want, kb_c, vb_c, p_c = att.local_attention_step_ring(*cpu)
    assert attention_step_cuda.launches == before + 1
    torch.testing.assert_close(out.cpu(), want, rtol=0, atol=1e-5)
    assert torch.equal(kb.cpu(), kb_c) and torch.equal(vb.cpu(), vb_c)
    assert int(p) == int(p_c) == 0
    args, sc = _attn_inputs(dev, 8, 6, 24, 32, torch.float32, torch.int8, 2)
    q, kt, vt, kb, vb = args
    ring = [kb, sc["k_scale"], vb, sc["v_scale"],
            torch.tensor(2, dtype=torch.int32, device=dev)]
    cpu_ring = [t.cpu() for t in ring]
    out, *ring = att.local_attention_step_ring_int8(q, kt, vt, *ring)
    want, *cpu_ring = att.local_attention_step_ring_int8(
        q.cpu(), kt.cpu(), vt.cpu(), *cpu_ring)
    assert attention_step_cuda.launches == before + 2
    torch.testing.assert_close(out.cpu(), want, rtol=2e-5, atol=2e-5)
    for g, c in zip(ring, cpu_ring):
        assert torch.equal(g.cpu(), c)


def test_steps_after_a_full_pass_on_the_card(dev):
    """A full pass, then streaming steps, at a small size: the ring the
    full pass leaves feeds the ring kernel, and the GPU agrees with the
    CPU (float32, atol 1e-4). F=33, e=16: Dk=528, and Dv=264 a multiple
    of 4 (V rows go by 16-byte copies)."""
    from lookoncetohear_tpu_torch.models.net import Net
    chunk, nfft = 48, 64
    small = dict(embed_dim=32, stft_chunk_size=chunk,
                 stft_pad_size=nfft - chunk, num_ch=2, D=16, L=2, B=2, H=64,
                 local_atten_len=5, use_attn=True, chunk_causal=True)
    full = nfft + 5 * chunk                         # 6 frames
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2, full + 3 * nfft, generator=g)
    emb = torch.randn(2, 32, generator=g)
    outs = []
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        net = Net(**small, device="cpu").to(device)
        xd, ed = x.to(device), emb.to(device)
        y, state = net.predict(xd[..., :full], ed, net.init_state(2),
                               pad=False)
        ys = [y]
        for i in range(3):
            w0 = full + i * nfft
            y, state = net.step(xd[..., w0:w0 + nfft], ed, state)
            ys.append(y)
        outs.append(torch.cat(ys, -1).cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-4)


# ---- the CUDA-graph engine and the enrollment net ----------------------------

# F=65 (e=8, v dim 16): a size every ring kernel takes, with B2's H=64
GRAPH_NET = dict(embed_dim=32, stft_chunk_size=96, stft_pad_size=32,
                 num_ch=2, D=32, L=2, B=2, H=64, local_atten_len=5,
                 use_attn=True, chunk_causal=True)


def _engine_pair(dev, dtype, kv_dtype, n=4):
    from lookoncetohear_tpu_torch.models.net import Net
    from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
    torch.manual_seed(0)
    net = Net(**GRAPH_NET, device="cpu")
    engs = [StreamingEngine(net, max_streams=n, dtype=dtype,
                            kv_dtype=kv_dtype, cuda_graph=g)
            for g in (False, True)]
    emb = torch.randn(n + 1, GRAPH_NET["embed_dim"],
                      generator=torch.Generator().manual_seed(1))
    for eng in engs:
        for s in range(n):
            eng.add_stream(s, emb[s].numpy())
    return engs, emb


@pytest.mark.parametrize("dtype,kv_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.int8), (torch.float32, torch.int8),
    (torch.float32, torch.bfloat16)], ids=str)
def test_graph_engine_matches_eager(dev, dtype, kv_dtype):
    """10 steps (the ring wraps twice) through the masked graph (step 0,
    an add_stream at step 3, slot 2 inactive from step 6) and the
    all-primed graph: the output and every carried tensor bit-identical
    to the eager engine's, which runs the same kernels on its own
    state."""
    (eager, graph), emb = _engine_pair(dev, dtype, kv_dtype)
    x = torch.randn(10, 4, 2, GRAPH_NET["stft_chunk_size"],
                    generator=torch.Generator().manual_seed(2))
    for i in range(10):
        for eng in (eager, graph):
            if i == 3:
                eng.add_stream(1, emb[4].numpy())
            if i == 6:
                eng.remove_stream(2)
        assert torch.equal(graph.step(x[i]), eager.step(x[i]))
        for a, b in zip(eager._carried(), graph._carried()):
            assert torch.equal(a, b)
    assert set(graph._graphs) == {False, True}


def test_graph_output_survives_the_next_step(dev):
    (_, graph), _ = _engine_pair(dev, torch.float32, None)
    x = torch.randn(3, 4, 2, GRAPH_NET["stft_chunk_size"], device=dev)
    graph.step(x[0])
    y1 = graph.step(x[1])
    keep = y1.clone()
    graph.step(x[2])
    assert torch.equal(y1, keep)


def test_pipelined_and_benchmarks_on_the_card(dev):
    """step_pipelined + drain == step from the same state (every slot
    primed), bit for bit, from host chunks; benchmark_device leaves the
    live state."""
    (_, eng), _ = _engine_pair(dev, torch.bfloat16, torch.int8)
    x = torch.randn(7, 4, 2, GRAPH_NET["stft_chunk_size"],
                    generator=torch.Generator().manual_seed(3)).numpy()
    eng.step(x[0])
    saved = [t.clone() for t in eng._carried()]
    ref = [eng.step(c).float().cpu().numpy() for c in x]
    for t, s in zip(eng._carried(), saved):
        t.copy_(s)
    got = [y for y in (eng.step_pipelined(c, depth=3) for c in x)
           if y is not None] + eng.drain()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    before = [t.clone() for t in eng._carried()]
    rep = eng.benchmark_device(n_short=3, n_long=9, repeats=2)
    assert rep["streams"] == 4 and rep["device_best_ms"] > 0
    for t, b in zip(eng._carried(), before):
        assert torch.equal(t, b)


def test_embed_net_on_the_card_matches_the_cpu(dev):
    """EmbedNet from its checkpoint, 1 s binaural enrollment: 6 B2
    launches, d-vector within 1e-4 of the CPU net's peak (float32, TF32
    off)."""
    from lookoncetohear_tpu_torch.models.net import EmbedNet
    from lookoncetohear_tpu_torch.weights import load_checkpoint
    ckpt = "checkpoints/embed_r5_5k_best.npz"
    x = torch.randn(2, 2, 16000, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        cpu = load_checkpoint(EmbedNet(device="cpu"), ckpt)(x)
        before = bilstm_scan_cuda.launches
        gpu = load_checkpoint(EmbedNet(), ckpt)(x.to(dev))
    assert bilstm_scan_cuda.launches == before + 6
    peak = cpu.abs().max().item()
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=0, atol=1e-4 * peak)


def _eval_args(tmp_path, sub, mode, device):
    """The eval CLI's arguments for the first 4 scenes of the 5k test
    split in `mode` ("oracle" or "two-stage"), into tmp_path/sub."""
    from lookoncetohear_tpu_torch import ts_hear_test
    with open("configs/tsh_synthetic_5k.json") as f:
        cfg = json.load(f)
    cfg["test_data_args"]["n_samples"] = 4
    config = tmp_path / "tsh_4.json"
    config.write_text(json.dumps(cfg))
    enroll = ["--enroll_config", "", "--enroll_run_dir", ""]
    if mode == "two-stage":
        enroll = ["--enroll_config", "configs/embed_synthetic_5k.json",
                  "--enroll_run_dir", "runs/embed_r5_5k", "--enroll_ckpt",
                  "checkpoints/embed_r5_5k_best.npz"]
    return ts_hear_test.parse_args(
        ["--config", str(config), "--run_dir", str(tmp_path / sub),
         "--ckpt", "checkpoints/tsh_r5_5k_best.npz", "--num_workers", "0",
         "--device", device] + enroll)


@pytest.mark.parametrize("mode", ["oracle", "two-stage"])
def test_eval_on_the_card_matches_the_cpu(dev, tmp_path, mode):
    """The eval CLI over 4 scenes of the 5k split on the card and on the
    CPU: every CSV row agrees (dB columns 1e-3, embedding_sim 1e-5, the
    scene's metadata equal)."""
    from lookoncetohear_tpu_torch import eval_check, ts_hear_test
    csvs = []
    for device in ("cuda", "cpu"):
        args = _eval_args(tmp_path, device, mode, device)
        ts_hear_test.run(args)
        name = os.path.basename(args.enroll_run_dir) or "clean"
        csvs.append(eval_check.read_csv(
            str(tmp_path / device / f"results_test_{name}.csv")))
    res = eval_check.compare(*csvs, tol={
        "si_snr_i": 1e-3, "output_sisnr": 1e-3, "embedding_sim": 1e-5})
    assert res["rows"] == 4 and not res["failures"], eval_check.report(res)


def test_eval_cli_refusals_on_the_card(dev, tmp_path, monkeypatch):
    """--embed_from_wav without resemblyzer is an ImportError naming it,
    and a missing checkpoint or an orbax directory is refused, on the card
    too, before any work."""
    from lookoncetohear_tpu_torch import ts_hear_test
    args = _eval_args(tmp_path, "r", "oracle", "cuda")
    monkeypatch.setitem(sys.modules, "resemblyzer", None)
    args.embed_from_wav = True
    with pytest.raises(ImportError, match="resemblyzer"):
        ts_hear_test.run(args)
    args.embed_from_wav = False
    for ckpt in (str(tmp_path / "best.ckpt"), str(tmp_path)):
        args.ckpt = ckpt
        with pytest.raises(ValueError, match="npz"):
            ts_hear_test.run(args)


# ---- training ----------------------------------------------------------------

@pytest.mark.parametrize("t,nd,b", [(97, 2, 12), (97, 1, 12), (300, 1, 5),
                                    (97, 1, 5), (97, 2, 5), (97, 1, 37),
                                    (97, 2, 37), (97, 1, 1040),
                                    (97, 2, 1040)])
def test_bilstm_train_kernels_match_plain(dev, t, nd, b):
    """The state-saving forward (y, c_T, every c; without cs the same
    y and c_T bit for bit) and the backward (dxp, dh0, dc0) in the
    models' layouts against their plain versions from a nonzero
    (h0, c0): 2e-5 of each output's peak over 97 steps, 1e-4 over 300
    (float32 rounding compounds along the chain). Row counts that no
    tile (4, 8, 16 rows) divides leave a tail in the last block."""
    from lookoncetohear_tpu_torch.ops.bilstm_scan import (
        bilstm_scan_bwd_cuda, bilstm_scan_train_cuda,
        bilstm_train_backward_reference, bilstm_train_reference)
    g = torch.Generator().manual_seed(t + nd + b)
    r = lambda *s, k=0.5: (torch.randn(*s, generator=g) * k).to(dev)
    xp, w = r(b, t, nd * 256), r(nd, 64, 256, k=0.3)
    h0, c0, dys, dct = r(nd, b, 64), r(nd, b, 64), r(b, t, nd * 64), \
        r(nd, b, 64)
    tol = 2e-5 if t <= 97 else 1e-4
    got = bilstm_scan_train_cuda(xp, w, h0, c0)
    want = bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                  with_cs=True)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0,
                                   atol=tol * max(1.0, e.abs().max().item()))
    lean = bilstm_scan_train_cuda(xp, w, h0, c0, save_cs=False)
    assert lean[2] is None
    assert torch.equal(lean[0], got[0]) and torch.equal(lean[1], got[1])
    ys, _, cs = want
    got = bilstm_scan_bwd_cuda(xp, w, h0, c0, ys, cs, dys, dct)
    want = bilstm_train_backward_reference(xp, w, h0, c0, ys, cs, dys, dct)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0,
                                   atol=tol * max(1.0, e.abs().max().item()))


@pytest.mark.parametrize("t,b", [(141, 64), (141, 500), (141, 13),
                                 (1, 64), (2, 13), (3, 9)])
def test_bilstm_h128_kernel_matches_plain(dev, t, b):
    """B2 at H = 128 (clusters of C CTAs, tiles of R rows) at the default
    Net's serving and full-forward rows, a count no tile divides and
    scans of 1 to 3 steps (the hand-over's first phases), through the
    wrapper and through the C entry at every tile (R, C): at atol 2e-5,
    as B2 at H = 64."""
    from lookoncetohear_tpu_torch import _build
    from lookoncetohear_tpu_torch.ops.bilstm_scan import \
        bilstm_scan_h128_cuda
    g = torch.Generator().manual_seed(t + b)
    xp = (torch.randn(t, 2, b, 512, generator=g) * 0.5).to(dev)
    w_hh = (torch.randn(2, 128, 512, generator=g) * 0.2).to(dev)
    rys, rc = bilstm_scan_reference(xp, w_hh)
    before = bilstm_scan_h128_cuda.launches
    got = [bilstm_scan_cuda(xp, w_hh)]
    assert bilstm_scan_h128_cuda.launches == before + 1
    lib = _build.load_library()
    for tile in H128_TILE_COST:
        ys, c_t = torch.empty_like(rys), torch.empty_like(rc)
        _build.check(lib.bilstm_scan_h128_f32(
            xp.data_ptr(), w_hh.data_ptr(), ys.data_ptr(), c_t.data_ptr(),
            t, b, *tile, torch.cuda.current_stream().cuda_stream),
            "bilstm_scan_h128_f32")
        got.append((ys, c_t))
    torch.cuda.synchronize()
    for ys, c_t in got:
        torch.testing.assert_close(ys, rys, atol=2e-5, rtol=0)
        torch.testing.assert_close(c_t, rc, atol=2e-5, rtol=0)


@pytest.mark.parametrize("t,nd,n,carried", [(500, 1, 141, True),
                                            (97, 2, 37, False),
                                            (60, 2, 9, True),
                                            (500, 1, 564, True),
                                            (1, 2, 9, True),
                                            (2, 1, 17, False)])
def test_bilstm_train_fwd_h128_matches_plain(dev, t, nd, n, carried):
    """The training forward at H = 128 in the models' layouts: the full
    forward's and the eval's inter-time scans (T=500, D=1, N=141 and
    564) from (h0, c0), both directions from zero and from (h0, c0), and
    scans of 1 and 2 steps, at every tile (R, C); y, c_T, every c and
    every step's activated gates (the backward's input) against the
    plain version at 2e-5 of the peak up to 97 steps, 1e-4 beyond (as
    at H = 64); without the gates, and without cs, the same y and c_T
    bit for bit."""
    from lookoncetohear_tpu_torch import _build
    from lookoncetohear_tpu_torch.ops.bilstm_scan import (
        bilstm_scan_train_cuda, bilstm_train_fwd_h128_cuda,
        bilstm_train_reference)
    g = torch.Generator().manual_seed(t + nd + n)
    r = lambda *s, k=0.5: (torch.randn(*s, generator=g) * k).to(dev)
    xp, w = r(n, t, nd * 512), r(nd, 128, 512, k=0.2)
    h0, c0 = (r(nd, n, 128), r(nd, n, 128)) if carried else (None, None)
    want = bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                  with_cs=True, with_gates=True)
    tol = 2e-5 if t <= 97 else 1e-4
    before = bilstm_train_fwd_h128_cuda.launches
    runs = [bilstm_scan_train_cuda(xp, w, h0, c0, save_gates=True)]
    plain = bilstm_scan_train_cuda(xp, w, h0, c0)
    lean = bilstm_scan_train_cuda(xp, w, h0, c0, save_cs=False)
    assert bilstm_train_fwd_h128_cuda.launches == before + 3
    lib = _build.load_library()
    p = lambda v: None if v is None else v.data_ptr()
    for tile in H128_TILE_COST:
        out = tuple(torch.empty_like(e) for e in want)
        _build.check(lib.bilstm_train_fwd_h128_f32(
            p(xp), p(w), p(h0), p(c0), p(out[0]), p(out[2]), p(out[3]),
            p(out[1]), t, nd, n, *tile,
            torch.cuda.current_stream().cuda_stream),
            "bilstm_train_fwd_h128_f32")
        runs.append(out)
    torch.cuda.synchronize()
    for got in runs:
        assert len(got) == 4
        for a, e in zip(got, want):
            torch.testing.assert_close(
                a, e, rtol=0, atol=tol * max(1.0, e.abs().max().item()))
    assert len(plain) == 3 and lean[2] is None
    for v in (plain, lean):
        assert torch.equal(v[0], runs[0][0]) and torch.equal(v[1],
                                                             runs[0][1])
    assert torch.equal(plain[2], runs[0][2])


@pytest.mark.parametrize("t,nd,n", [(1, 2, 9), (2, 1, 17), (3, 2, 13),
                                    (141, 2, 64), (141, 1, 37),
                                    (500, 1, 141), (500, 2, 9)])
def test_bilstm_train_bwd_h128_matches_plain(dev, t, nd, n):
    """The backward at H = 128 (clusters of 8 CTAs, two an SM, a
    reduce-scatter of dh over the cluster) in the models' layouts, from
    a nonzero (h0, c0) and with dy and dc_T, against the plain version
    on the forward's gates and cs (themselves held to the plain forward):
    dxp, dh0 and dc0 at 2e-5 of each output's peak up to 141 steps and 1e-4 at 500 (as at H = 64),
    through the wrapper and through the C entry at every tile (R, C) of
    the backward's table; scans of 1 to 3 steps (the double buffer's
    first phases) and row counts no tile divides. The wrapper refuses
    nothing of the forward's outputs, and `bilstm_scan_bwd_cuda` (the
    H = 64 entry, which takes xp) refuses H = 128."""
    from lookoncetohear_tpu_torch import _build
    from lookoncetohear_tpu_torch.ops.bilstm_scan import (
        H128_BWD_TILE_COST, bilstm_scan_bwd_cuda, bilstm_scan_train_cuda,
        bilstm_train_bwd_h128_cuda, bilstm_train_gates_backward_reference,
        bilstm_train_reference)
    g = torch.Generator().manual_seed(t + nd + n)
    r = lambda *s, k=0.5: (torch.randn(*s, generator=g) * k).to(dev)
    xp, w = r(n, t, nd * 512), r(nd, 128, 512, k=0.2)
    h0, c0, dys, dct = r(nd, n, 128), r(nd, n, 128), \
        r(n, t, nd * 128, k=1.0), r(nd, n, 128, k=1.0)
    y, _, cs, gates = bilstm_scan_train_cuda(xp, w, h0, c0, save_gates=True)
    want = bilstm_train_gates_backward_reference(gates, w, c0, cs, dys, dct)
    tol = 2e-5 if t <= 141 else 1e-4
    fwd = bilstm_train_reference(xp, w, torch.float32, h0, c0, with_cs=True,
                                 with_gates=True)
    for a, e in zip((cs, gates), fwd[2:]):
        torch.testing.assert_close(
            a, e, rtol=0, atol=tol * max(1.0, e.abs().max().item()))
    before = bilstm_train_bwd_h128_cuda.launches
    runs = [bilstm_train_bwd_h128_cuda(gates, w, c0, cs, dys, dct)]
    assert bilstm_train_bwd_h128_cuda.launches == before + 1
    with pytest.raises(ValueError, match="gates"):
        bilstm_scan_bwd_cuda(xp, w, h0, c0, y, cs, dys, dct)
    lib = _build.load_library()
    p = lambda v: None if v is None else v.data_ptr()
    for tile in H128_BWD_TILE_COST:
        out = tuple(torch.empty_like(e) for e in want)
        _build.check(lib.bilstm_train_bwd_h128_f32(
            p(gates), p(w), p(c0), p(cs), p(dys), p(dct),
            p(out[0]), p(out[1]), p(out[2]), t, nd, n, *tile,
            torch.cuda.current_stream().cuda_stream),
            "bilstm_train_bwd_h128_f32")
        runs.append(out)
    torch.cuda.synchronize()
    for got in runs:
        for a, e in zip(got, want):
            torch.testing.assert_close(
                a, e, rtol=0, atol=tol * max(1.0, e.abs().max().item()))


def test_h128_gradient_runs_the_backward_kernel(dev, monkeypatch):
    """A gradient at H = 128 through the BiLSTM and the one-direction
    LSTM launches the training forward and the backward kernel once per
    LSTM call, never B2 or the H = 64 kernels, and no plain version runs
    (they are made to raise); every parameter gets its gradient."""
    from lookoncetohear_tpu_torch.ops import bilstm_scan as bs
    from lookoncetohear_tpu_torch.ops.lstm import LSTM

    def plain(*a, **k):
        raise AssertionError("a plain version ran on the card")
    for name in ("bilstm_train_reference", "bilstm_train_backward_reference",
                 "bilstm_train_gates_backward_reference",
                 "bilstm_scan_reference", "bilstm_scan_backward_reference",
                 "bilstm_scan_gates_backward_reference"):
        monkeypatch.setattr(bs, name, plain)
    torch.manual_seed(0)
    bi = LSTM(16, 128, bidirectional=True).to(dev)
    uni = LSTM(16, 128).to(dev)
    x = torch.randn(3, 9, 16, device=dev)
    counts = lambda: (bs.bilstm_scan_h128_cuda.launches,
                      bs.bilstm_train_fwd_h128_cuda.launches,
                      bs.bilstm_train_bwd_h128_cuda.launches,
                      bs.bilstm_scan_cuda.launches,
                      bs.bilstm_scan_train_cuda.launches,
                      bs.bilstm_scan_bwd_cuda.launches)
    c0 = counts()
    (bi(x)[0].sum() + uni(x)[0].sum()).backward()
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), c0)] == [0, 2, 2, 0, 0, 0]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in (*bi.parameters(), *uni.parameters()))


def test_training_reciprocal_is_the_ieee_quotient(dev):
    """The training kernels' sigmoid takes 1 / (1 + exp(-x)) by the
    division's fast path without its range check (`rcp_rn`): bit for
    bit the IEEE quotient 1 / d on every float d in [1, 2) and on d
    spread over [1, 2^126), the range its clamped input keeps to."""
    from lookoncetohear_tpu_torch import _build
    ones = torch.arange(1 << 23, device=dev, dtype=torch.int32) + (127 << 23)
    g = torch.Generator(device=dev).manual_seed(0)
    spread = torch.exp2(torch.rand(1 << 22, generator=g, device=dev) * 126)
    d = torch.cat([ones.view(torch.float32), spread.clamp(1.0, 2.0 ** 125)])
    out = torch.empty_like(d)
    _build.check(_build.load_library().bilstm_train_rcp_f32(
        d.data_ptr(), out.data_ptr(), d.numel(),
        torch.cuda.current_stream().cuda_stream), "bilstm_train_rcp_f32")
    assert torch.equal(out.view(torch.int32), (1.0 / d).view(torch.int32))


def test_lstm_ops_route_through_the_training_kernels(dev):
    """With a gradient to keep, the BiLSTM and the one-direction LSTM
    launch the training forward and backward kernels and never B2;
    without one the BiLSTM is B2 and the one-direction LSTM the training
    forward. B2 refuses an input that needs a gradient."""
    from lookoncetohear_tpu_torch.ops import bilstm_scan as bs
    from lookoncetohear_tpu_torch.ops.lstm import LSTM
    torch.manual_seed(0)
    bi, uni = LSTM(16, 64, bidirectional=True).to(dev), LSTM(16, 64).to(dev)
    x = torch.randn(3, 9, 16, device=dev)
    counts = lambda: (bs.bilstm_scan_cuda.launches,
                      bs.bilstm_scan_train_cuda.launches,
                      bs.bilstm_scan_bwd_cuda.launches)
    c0 = counts()
    (bi(x)[0].sum() + uni(x)[0].sum()).backward()
    assert [a - b for a, b in zip(counts(), c0)] == [0, 2, 2]
    assert all(p.grad is not None for p in (*bi.parameters(),
                                            *uni.parameters()))
    c0 = counts()
    with torch.no_grad():
        bi(x), uni(x)
    assert [a - b for a, b in zip(counts(), c0)] == [1, 1, 0]
    xp = torch.zeros(3, 2, 1, 256, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        bs.bilstm_scan_cuda(xp, torch.zeros(2, 64, 256, device=dev))


@pytest.mark.parametrize("task_name", ["tse", "embed"])
def test_train_step_on_the_card_matches_the_cpu(dev, task_name):
    """One loss-and-backward of each committed task's model (from its
    checkpoint) on a 2 x 1 s batch of the synthetic train split: loss
    1e-4 of the CPU's float32 run, every gradient within 1e-3 of
    max(its peak, 1e-3 of the model's largest peak) of the CPU's float64
    run, as chip_smoke.py holds it and says why (float32 through the
    whole network; TF32 off)."""
    from lookoncetohear_tpu_torch.data.loader import collate
    from lookoncetohear_tpu_torch.data.synthetic import SyntheticTSEDataset
    from lookoncetohear_tpu_torch.train.trainer import build_task, to_device
    from lookoncetohear_tpu_torch.utils import Params
    from lookoncetohear_tpu_torch.weights import load_checkpoint
    cfg, ckpt = {"tse": ("configs/tsh_synthetic_5k.json",
                         "checkpoints/tsh_r5_5k_best.npz"),
                 "embed": ("configs/embed_synthetic_5k.json",
                           "checkpoints/embed_r5_5k_best.npz")}[task_name]
    hp = Params(cfg)
    ds = SyntheticTSEDataset(**{**hp.train_data_args, "duration": 1.0})
    host = collate([ds[0], ds[1]])
    out = []
    for device, dt in (("cpu", torch.float32), (dev, torch.float32),
                       ("cpu", torch.float64)):
        task = build_task(hp)
        model = load_checkpoint(task.model, ckpt).to(device, dt)
        batch = {k: v.to(dt) if v.is_floating_point() else v for k, v in
                 to_device(task.device_batch(host, train=True),
                           device).items()}
        loss, _ = task.loss_and_metrics(batch, 0)
        loss.backward()
        out.append((loss.item(), {n: p.grad.cpu().double() for n, p in
                                  model.named_parameters()}))
    (lc, _), (lg, gg), (_, g64) = out
    assert abs(lg - lc) <= 1e-4 * max(1.0, abs(lc))
    floor = 1e-3 * max(g.abs().max().item() for g in g64.values())
    for n, g in g64.items():
        torch.testing.assert_close(
            gg[n], g, rtol=0, atol=1e-3 * max(g.abs().max().item(), floor))


# ---- the flat LayerNorms (csrc/flat_norm.cu) -----------------------------

# the default Net's constructor defaults (benchmark/configs/net_default.json)
DEFAULT_NET = dict(embed_dim=256, stft_chunk_size=160, stft_pad_size=120,
                   num_ch=2, D=64, L=0, I=1, J=1, B=6, H=128,
                   local_atten_len=100, use_attn=False, lookahead=True,
                   chunk_causal=False)


def _flat_qkv(dev, b, dtype, seed, f=97, nh=4, e=6, vd=16):
    """A fused projection y [b, f, 2*e*nh + vd*nh] before its PReLUs and
    the three blocks' (dim, alpha, scale, bias, eps), on the CPU and on
    the card (the flagship's geometry by default)."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(b, f, 2 * e * nh + vd * nh, generator=g) * 0.7 + 0.1
    parts = [(dim, torch.rand(1, generator=g) * 0.4,
              1 + 0.3 * torch.randn(f * dim, generator=g),
              0.2 * torch.randn(f * dim, generator=g), 1e-5)
             for dim in (e, e, vd)]
    cpu = (y.to(dtype), [(dim, *(t.to(dtype) for t in ts), eps)
                         for dim, *ts, eps in parts])
    gpu = (cpu[0].to(dev), [(dim, *(t.to(dev) for t in ts), eps)
                            for dim, *ts, eps in cpu[1]])
    return cpu, gpu


def _close_flat(got, want):
    """float32: the two sums' order, ~1e-6 at |out| <= ~5; bf16: the
    output's one rounding may land one bf16 step (2^-7 relative) away."""
    if want.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-2)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("b", [64, 1, 3])
def test_flat_qkv_kernel_matches_plain(dev, dtype, b):
    """The flagship's Q/K/V norms read from the fused projection y [B, 97,
    112] where they lie, each block's PReLU folded in: one launch, each
    block against the PReLU and `flat_head_layer_norm` on the CPU."""
    from lookoncetohear_tpu_torch.ops.norms import (flat_norm_cuda,
                                                    flat_qkv_layer_norm)
    (y, parts), (yd, partsd) = _flat_qkv(dev, b, dtype, b)
    before = flat_norm_cuda.launches
    got = flat_qkv_layer_norm(yd, 4, partsd)
    torch.cuda.synchronize()
    assert flat_norm_cuda.launches == before + 1
    for out, want in zip(got, flat_qkv_layer_norm(y, 4, parts)):
        assert out.dtype == dtype and out.is_contiguous()
        assert out.shape == want.shape
        _close_flat(out.cpu(), want)


@pytest.mark.parametrize("rows,d,dtype", [
    (64 * 97, 64, torch.bfloat16), (64, 97 * 64, torch.bfloat16),
    (64 * 141, 64, torch.float32), (97, 64, torch.bfloat16),
    (3 * 97, 64, torch.float32), (3, 97 * 64, torch.float32),
    (1, 97 * 64, torch.bfloat16), (5, 10, torch.float32)], ids=str)
def test_flat_row_kernel_matches_plain(dev, rows, d, dtype):
    """Whole-row norms at the serving shapes (the flagship's intra and
    inter rows and attention output, the default Net's rows), at 1 and 3
    streams, and a width 16 bytes do not divide: one launch each,
    against the plain version on the card."""
    from lookoncetohear_tpu_torch.ops.norms import (
        flat_layer_norm, flat_layer_norm_reference, flat_norm_cuda)
    g = torch.Generator().manual_seed(rows + d)
    x = (torch.randn(rows, d, generator=g) * 1.3 - 0.4).to(dtype).to(dev)
    sc = (1 + 0.3 * torch.randn(d, generator=g)).to(dtype).to(dev)
    bi = (0.2 * torch.randn(d, generator=g)).to(dtype).to(dev)
    before = flat_norm_cuda.launches
    got = flat_layer_norm(x, sc, bi, 1e-5)
    torch.cuda.synchronize()
    assert flat_norm_cuda.launches == before + 1
    _close_flat(got, flat_layer_norm_reference(x, sc, bi, 1e-5))


def test_flat_row_kernel_takes_strided_views(dev):
    """Rows of a column-major view (copied first) and every other row of
    a tensor (read in place), against the plain version."""
    from lookoncetohear_tpu_torch.ops.norms import (
        flat_layer_norm, flat_layer_norm_reference, flat_norm_cuda)
    g = torch.Generator().manual_seed(11)
    sc = (1 + 0.3 * torch.randn(64, generator=g)).to(dev)
    bi = (0.2 * torch.randn(64, generator=g)).to(dev)
    base = torch.randn(64, 2 * 97, generator=g).to(dev)
    for x in (base[:, :97].t(), base.reshape(194, 64)[::2]):
        before = flat_norm_cuda.launches
        got = flat_layer_norm(x, sc, bi, 1e-5)
        assert flat_norm_cuda.launches == before + 1
        _close_flat(got, flat_layer_norm_reference(x, sc, bi, 1e-5))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_flat_norm_kernel_on_constant_rows(dev, dtype):
    """A constant row: its variance is 0 up to rounding, clamped at 0, so
    the output is the bias, as in the plain version; a constant segment
    of a head norm likewise."""
    from lookoncetohear_tpu_torch.ops.norms import (
        flat_layer_norm, flat_layer_norm_reference, flat_qkv_layer_norm)
    x = torch.full((4, 97 * 64), 0.10009765625, dtype=dtype, device=dev)
    x[1] = -3.0
    x[2] = 0.0
    x[3, ::2] = 2.5                       # a live row beside them
    g = torch.Generator().manual_seed(5)
    sc = (1 + 0.3 * torch.randn(97 * 64, generator=g)).to(dtype).to(dev)
    bi = (0.2 * torch.randn(97 * 64, generator=g)).to(dtype).to(dev)
    got = flat_layer_norm(x, sc, bi, 1e-5)
    want = flat_layer_norm_reference(x, sc, bi, 1e-5)
    assert torch.isfinite(got).all()
    _close_flat(got, want)
    _close_flat(got[:3], bi.expand(3, -1))
    (_, _), (yd, partsd) = _flat_qkv(dev, 2, dtype, 6)
    yd[:, :, :6] = 0.75                   # head 0 of Q: a constant segment
    q = flat_qkv_layer_norm(yd, 4, partsd)[0].reshape(2, 97, 4, 6)
    bias_q = partsd[0][3].reshape(97, 6)
    _close_flat(q[:, :, 0], bias_q.expand(2, -1, -1))


def test_flat_norm_kernel_in_a_cuda_graph(dev):
    """The Q/K/V launch and a row norm captured in a CUDA graph and
    replayed on new inputs give the eager launches' bits."""
    from lookoncetohear_tpu_torch.ops.norms import (flat_layer_norm,
                                                    flat_qkv_layer_norm)
    (_, _), (yd, partsd) = _flat_qkv(dev, 64, torch.bfloat16, 7)
    x = torch.randn(64 * 97, 64, device=dev).bfloat16()
    sc, bi = partsd[2][2][:64].contiguous(), partsd[2][3][:64].contiguous()

    def run():
        return flat_qkv_layer_norm(yd, 4, partsd) + [
            flat_layer_norm(x, sc, bi, 1e-5)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for seed in (8, 9):
        (_, _), (y2, _) = _flat_qkv(dev, 64, torch.bfloat16, seed)
        yd.copy_(y2)
        x.copy_(torch.randn(64 * 97, 64, device=dev).bfloat16())
        graph.replay()
        for a, b in zip(outs, run()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("streams", [2, 1])
@pytest.mark.parametrize("config", ["flagship", "net_default"])
def test_a_streaming_step_launches_twelve_flat_norms(dev, config, streams):
    """An eager engine step launches the kernel 12 times: the flagship's
    3 blocks x (Q/K/V, intra, inter, attention output) at bf16 with the
    int8 ring, the default Net's 6 blocks x (intra, inter) at float32.
    A graph replay runs no Python and counts nothing. At one stream the
    intra norm's [F, C] input is a row-strided view of the frame."""
    from lookoncetohear_tpu_torch.entry import FLAGSHIP
    from lookoncetohear_tpu_torch.models.net import Net
    from lookoncetohear_tpu_torch.ops.norms import flat_norm_cuda
    from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
    flagship = config == "flagship"
    params = FLAGSHIP if flagship else DEFAULT_NET
    torch.manual_seed(0)
    net = Net(**params, device="cpu")
    engs = [StreamingEngine(
        net, max_streams=streams, dtype=torch.bfloat16 if flagship
        else torch.float32, kv_dtype=torch.int8 if flagship else None,
        cuda_graph=g) for g in (False, True)]
    chunk = params["stft_chunk_size"]
    x = torch.randn(4, streams, 2, chunk,
                    generator=torch.Generator().manual_seed(0))
    for eng in engs:
        for s in range(streams):
            eng.add_stream(s, np.ones(256, np.float32) / 16)
        for i in range(2):          # the graph engine captures both graphs
            eng.step(x[i])
    eager, graph = engs
    before = flat_norm_cuda.launches
    eager.step(x[2])
    assert flat_norm_cuda.launches == before + 12
    graph.step(x[2])
    assert flat_norm_cuda.launches == before + 12
    assert torch.equal(graph.step(x[3]), eager.step(x[3]))
