"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skipped elsewhere. On a machine
without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: BiLSTM float32 atol 2e-5; ring step float32 int8 writes
bit-exact and floats rtol 2e-5 / atol 2e-6, bf16 q/k/v out atol 2e-2
(one bf16 rounding of the output, ~2^-8 relative at |out| <= ~3).
Ring attention step: float32 over a float ring atol 1e-4 (the JAX
package's bound for the Pallas step at the flagship shapes), over an
int8 ring rtol/atol 2e-5; a bf16 q or ring atol 2e-2.
"""

import numpy as np
import pytest
import torch

from lookoncetohear_tpu_torch.ops.bilstm_scan import (bilstm_scan_cuda,
                                                      bilstm_scan_reference)
from lookoncetohear_tpu_torch.ops.attn_step import (
    VARIANTS, attention_step_cuda, attention_step_reference)
from lookoncetohear_tpu_torch.ops.ring_step import (
    ring_attend_int8_step_cuda, ring_attend_int8_step_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,h", [(64, 64), (12, 64)])
def test_bilstm_kernel_matches_plain(dev, b, h):
    g = torch.Generator().manual_seed(b + h)
    xp = (torch.randn(97, 2, b, 4 * h, generator=g) * 0.5).to(dev)
    w_hh = (torch.randn(2, h, 4 * h, generator=g) * 0.3).to(dev)
    ys, c_t = bilstm_scan_cuda(xp, w_hh)
    rys, rc = bilstm_scan_reference(xp, w_hh)
    torch.cuda.synchronize()
    torch.testing.assert_close(ys, rys, atol=2e-5, rtol=0)
    torch.testing.assert_close(c_t, rc, atol=2e-5, rtol=0)


def test_bilstm_kernel_refuses_other_widths(dev):
    """The kernel is built for the model's H=64 only."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 7, 49])
def test_ring_kernel_matches_plain(dev, dtype, pos):
    f, nh, e, vd, b, wp, w = 97, 4, 6, 16, 64, 56, 50
    a = _ring(dev, b, f, nh, e, vd, wp, dtype, seed=pos)
    outs = []
    for step in (ring_attend_int8_step_cuda, ring_attend_int8_step_reference):
        r = {k: v.clone() for k, v in a.items()}
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        out = step(r["q"], r["kt"], r["vt"], r["kb"], r["ks"], r["vb"],
                   r["vs"], p, f=f, n_head=nh, w=w)
        outs.append((out, r, int(p)))
    torch.cuda.synchronize()
    (o1, r1, p1), (o2, r2, p2) = outs
    assert p1 == p2 == (pos + 1) % w
    for k in ("kb", "vb", "ks", "vs"):
        assert torch.equal(r1[k], r2[k]), k
    if dtype == torch.float32:
        torch.testing.assert_close(o1, o2, rtol=2e-5, atol=2e-6)
    else:
        torch.testing.assert_close(o1.float(), o2.float(), rtol=0, atol=2e-2)


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


@pytest.mark.parametrize("qdt,kvdt", list(VARIANTS), ids=list(
    VARIANTS.values()))
@pytest.mark.parametrize("b", [256, 5])
def test_attention_step_kernel_matches_plain(dev, qdt, kvdt, b):
    """Every instantiation at the flagship head-major widths (64 streams
    x 4 heads = 256 rows, 49 slots, Dk 582, Dv 1552) and a ragged row
    count; odd slots of a 582-wide K row start off 16-byte alignment."""
    args, scales = _attn_inputs(dev, b, 49, 582, 1552, qdt, kvdt, b)
    before = attention_step_cuda.variant_launches[VARIANTS[(qdt, kvdt)]]
    got = attention_step_cuda(*args, **scales)
    want = attention_step_reference(*args, **scales)
    torch.cuda.synchronize()
    assert attention_step_cuda.variant_launches[
        VARIANTS[(qdt, kvdt)]] == before + 1
    assert got.dtype == qdt and got.shape == (b, 1552)
    if qdt == kvdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    elif kvdt == torch.int8 and qdt == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=2e-2)


def test_attention_step_kernel_refuses_what_it_cannot_take(dev):
    args, _ = _attn_inputs(dev, 4, 3, 7, 16, torch.float32, torch.float32, 0)
    with pytest.raises(ValueError, match="even"):
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
    CPU (float32, atol 1e-4). F=33, e=16: Dk=528 is even, as the kernel
    needs, and Dv=264 a multiple of 4."""
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
