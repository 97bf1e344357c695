"""Plain PyTorch versions of the two ported kernels vs the JAX package's
Pallas kernels (run in interpret mode on the CPU, as the JAX package's
own tests run them) and its XLA reference branches.

Tolerances: BiLSTM 2e-5 absolute (tests/test_pallas_lstm.py's bound
for the Pallas kernel against the scan). Ring step: the int8 slot
written and every untouched slot bit-exact, the scales bit-exact
against the XLA branch; floats rtol 2e-5 / atol 2e-6
(tests/test_attention.py's bound for the Pallas step kernel against
the XLA branch).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.ops import attention as jatt
from lookoncetohear_tpu.ops.lstm import LSTMParams, lstm_apply_bidir
from lookoncetohear_tpu.ops.pallas_attention import \
    ring_attend_int8_step_pallas
from lookoncetohear_tpu.ops.pallas_lstm import bilstm_scan_pallas
from lookoncetohear_tpu_torch.ops.bilstm_scan import (bilstm_scan,
                                                      bilstm_scan_reference)
from lookoncetohear_tpu_torch.ops.ring_step import (
    ring_attend_int8_native, ring_attend_int8_step_reference)


def _xp(rng, t, b, h):
    xp = (rng.standard_normal((t, 2, b, 4 * h)) * 0.5).astype(np.float32)
    w_hh = (rng.standard_normal((2, h, 4 * h)) * 0.3).astype(np.float32)
    return xp, w_hh


@pytest.mark.parametrize("b,h", [(12, 16), (12, 64), (1, 16)])
def test_bilstm_reference_matches_pallas(b, h):
    rng = np.random.default_rng(b * 100 + h)
    xp, w_hh = _xp(rng, 97, b, h)
    ys, c_t = bilstm_scan_reference(torch.from_numpy(xp),
                                    torch.from_numpy(w_hh))
    jys, jc = bilstm_scan_pallas(jnp.asarray(xp), jnp.asarray(w_hh),
                                 interpret=True)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), atol=2e-5)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(jc), atol=2e-5)


def test_bilstm_reference_matches_scan_branch():
    """The full bidirectional LSTM (JAX scan branch) == the port's, whose
    CPU recurrence is the kernel's plain version."""
    from lookoncetohear_tpu_torch.ops import lstm as tlstm
    rng = np.random.default_rng(3)
    b, t, i, h = 12, 97, 16, 16
    arrs = [[(rng.standard_normal(s) * 0.3).astype(np.float32)
             for s in ((4 * h, i), (4 * h, h), (4 * h,), (4 * h,))]
            for _ in range(2)]
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    jy, (_, (jcf, jcb)) = lstm_apply_bidir(
        *(LSTMParams(*map(jnp.asarray, a)) for a in arrs), jnp.asarray(x))
    ty, (_, (tcf, tcb)) = tlstm.lstm_apply_bidir(
        *(tlstm.LSTMParams(*map(torch.from_numpy, a)) for a in arrs),
        torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5)
    np.testing.assert_allclose(tcf.numpy(), np.asarray(jcf), atol=2e-5)
    np.testing.assert_allclose(tcb.numpy(), np.asarray(jcb), atol=2e-5)


def test_bilstm_dispatch_takes_reference_on_cpu():
    rng = np.random.default_rng(4)
    xp, w_hh = map(torch.from_numpy, _xp(rng, 9, 3, 8))
    for a, b in zip(bilstm_scan(xp, w_hh), bilstm_scan_reference(xp, w_hh)):
        assert torch.equal(a, b)


# ---- int8 ring step ---------------------------------------------------------

def _ring(rng, b, f, nh, e, vd, wp):
    dk, dv = f * nh * e, f * nh * vd
    arrs = dict(
        q=rng.standard_normal((b, dk)).astype(np.float32),
        kt=rng.standard_normal((b, dk)).astype(np.float32),
        vt=rng.standard_normal((b, dv)).astype(np.float32),
        # padding slots get random content so the masks are exercised
        kb=rng.integers(-127, 128, (b, wp, dk)).astype(np.int8),
        ks=rng.uniform(1e-3, 2e-2, (b, wp, nh)).astype(np.float32),
        vb=rng.integers(-127, 128, (b, wp, dv)).astype(np.int8),
        vs=rng.uniform(1e-3, 2e-2, (b, wp, nh)).astype(np.float32))
    return arrs


def _port_step(a, pos, f, nh, w):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    p = torch.tensor(pos, dtype=torch.int32)
    out = ring_attend_int8_step_reference(
        t["q"], t["kt"], t["vt"], t["kb"], t["ks"], t["vb"], t["vs"], p,
        f=f, n_head=nh, w=w)
    return [out.numpy(), t["kb"].numpy(), t["ks"].numpy(), t["vb"].numpy(),
            t["vs"].numpy(), int(p)]


def _compare(want, got, exact_scales=True):
    """int8 ring and pos bit-exact; scales bit-exact against the XLA
    branch (same formula), within the float tolerance against the
    Pallas kernel, whose scales differ from XLA's by an ulp too."""
    exact = ("pos",) + (("k_scale", "v_scale") if exact_scales else ())
    for name, a, b in zip(("out", "k_buf", "k_scale", "v_buf", "v_scale",
                           "pos"), want, got):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == np.int8 or name in exact:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6,
                                       err_msg=name)


@pytest.mark.parametrize("w,pos", [(6, 0), (6, 4), (6, 5), (8, 7), (8, 0)])
def test_ring_reference_matches_pallas_and_xla(w, pos):
    """w=6 < WP=8 (dead padding slots masked) and w == WP; pos = w-1
    wraps the cursor to 0."""
    f, nh, e, vd, b, wp = 5, 4, 3, 2, 8, 8
    a = _ring(np.random.default_rng(10 * w + pos), b, f, nh, e, vd, wp)
    got = _port_step(a, pos, f, nh, w)
    j = [jnp.asarray(a[k]) for k in ("q", "kt", "vt", "kb", "ks", "vb", "vs")]
    xla = jatt.ring_attend_int8_native(*j, jnp.asarray(pos, jnp.int32),
                                       f=f, n_head=nh, w=w)
    pallas = ring_attend_int8_step_pallas(
        *j, jnp.asarray(pos, jnp.int32), f=f, n_head=nh, w_real=w,
        block_rows=8, interpret=True)
    _compare(xla, got)
    _compare(pallas, got, exact_scales=False)
    assert got[-1] == (pos + 1) % w
    # only slot `pos` was written
    keep = np.ones(wp, bool)
    keep[pos] = False
    np.testing.assert_array_equal(got[1][:, keep], a["kb"][:, keep])
    np.testing.assert_array_equal(got[3][:, keep], a["vb"][:, keep])


def test_ring_reference_matches_xla_at_serving_widths():
    """Flagship head geometry (F=97, nh=4, e=6, vd=16, w=50 in 56
    slots), a few rows, over consecutive steps through the wrap."""
    f, nh, e, vd, b, wp, w = 97, 4, 6, 16, 2, 56, 50
    rng = np.random.default_rng(11)
    a = _ring(rng, b, f, nh, e, vd, wp)
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    jkb, jks, jvb, jvs = (jnp.asarray(a[k]) for k in ("kb", "ks", "vb", "vs"))
    jpos = jnp.asarray(47, jnp.int32)
    p = torch.tensor(47, dtype=torch.int32)
    for step in range(5):
        q, kt, vt = (rng.standard_normal(a[k].shape).astype(np.float32)
                     for k in ("q", "kt", "vt"))
        jo, jkb, jks, jvb, jvs, jpos = jatt.ring_attend_int8_native(
            jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jkb, jks, jvb,
            jvs, jpos, f=f, n_head=nh, w=w)
        out = ring_attend_int8_native(
            torch.from_numpy(q), torch.from_numpy(kt), torch.from_numpy(vt),
            t["kb"], t["ks"], t["vb"], t["vs"], p, f=f, n_head=nh, w=w)
        _compare((jo, jkb, jks, jvb, jvs, jpos),
                 (out, t["kb"], t["ks"], t["vb"], t["vs"], int(p)))
    assert int(p) == (47 + 5) % w


def test_ring_bf16_inputs_give_bf16_out():
    f, nh, e, vd, b, wp = 5, 4, 3, 2, 3, 8
    a = _ring(np.random.default_rng(12), b, f, nh, e, vd, wp)
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    q, kt, vt = (t[k].to(torch.bfloat16) for k in ("q", "kt", "vt"))
    out = ring_attend_int8_step_reference(
        q, kt, vt, t["kb"], t["ks"], t["vb"], t["vs"],
        torch.tensor(2, dtype=torch.int32), f=f, n_head=nh, w=6)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
