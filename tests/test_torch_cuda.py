"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Needs an NVIDIA GPU and nvcc; skipped elsewhere. On a machine
without JAX, run them without the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: BiLSTM float32 atol 2e-5; ring step float32 int8 writes
bit-exact and floats rtol 2e-5 / atol 2e-6, bf16 q/k/v out atol 2e-2
(one bf16 rounding of the output, ~2^-8 relative at |out| <= ~3).
"""

import numpy as np
import pytest
import torch

from lookoncetohear_tpu_torch.ops.bilstm_scan import (bilstm_scan_cuda,
                                                      bilstm_scan_reference)
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
