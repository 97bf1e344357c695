"""The port's attention ops vs the JAX package, on the CPU: the plain
version of the ring attention kernel (B3 float ring, B4 int8 ring)
against the Pallas kernels in interpret mode and the XLA branches, the
flat-buffer ring wrappers, and the full-utterance banded attention.

Tolerances and why:
  * float ring step vs the XLA branch and the Pallas kernel: atol 1e-5
    (tests/test_serve.py's bound for the Pallas step against the XLA
    step; float32 sums in another order);
  * int8 ring step vs the Pallas kernel and the XLA branch: rtol/atol
    2e-5 (tests/test_attention.py's bound); the quantized slot and its
    scale bit-exact against the XLA branch (same formula);
  * `local_attention` and `causal_banded_attention_full`: 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.ops import attention as jatt
from lookoncetohear_tpu.ops.pallas_attention import (
    attention_step_int8_pallas, attention_step_pallas)
from lookoncetohear_tpu_torch.ops import attention as tatt
from lookoncetohear_tpu_torch.ops.attn_step import (
    attention_step, attention_step_cuda, attention_step_reference)


def _t(a):
    return torch.from_numpy(np.array(a))


def _float_ring(rng, b, w1, dk, dv):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, dk), (b, dk), (b, dv), (b, w1, dk), (b, w1, dv))]


def _int8_ring(rng, b, w1, dk, dv):
    q, kt, vt = (rng.standard_normal(s).astype(np.float32)
                 for s in ((b, dk), (b, dk), (b, dv)))
    kb = rng.integers(-127, 128, (b, w1, dk)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (b, w1)).astype(np.float32)
    vb = rng.integers(-127, 128, (b, w1, dv)).astype(np.int8)
    vs = rng.uniform(1e-3, 2e-2, (b, w1)).astype(np.float32)
    return [q, kt, vt, kb, ks, vb, vs]


# ---- B3: float ring ------------------------------------------------------

@pytest.mark.parametrize("b,w,dk,dv", [(8, 10, 50, 36), (5, 50, 582, 776),
                                       (3, 2, 6, 16)])
def test_float_step_reference_matches_pallas_and_xla(b, w, dk, dv):
    """Ragged rows (5, 3: the Pallas kernel pads to 8), the flagship
    head-major widths, and a one-slot ring."""
    a = _float_ring(np.random.default_rng(b + w), b, w - 1, dk, dv)
    got = attention_step_reference(*map(_t, a)).numpy()
    ja = list(map(jnp.asarray, a))
    pallas, _, _ = attention_step_pallas(*ja, interpret=True,
                                         update_buffers=False)
    xla = jatt.ring_attend(*ja)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)


def test_float_step_bf16():
    """bf16 q/k/v and ring: f32 compute, bf16 out, like the Pallas body;
    f32 q over a bf16 ring gives f32 out. Both within one bf16 rounding
    of the f32 result."""
    a = _float_ring(np.random.default_rng(1), 6, 9, 40, 32)
    ref = attention_step_reference(*map(_t, a))
    bf = [_t(x).bfloat16() for x in a]
    out16 = attention_step_reference(*bf)
    assert out16.dtype == torch.bfloat16
    mixed = attention_step_reference(*map(_t, a[:3]), bf[3], bf[4])
    assert mixed.dtype == torch.float32
    for got, tol in ((out16, 3e-2), (mixed, 2e-2)):
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=tol)
    ja = [jnp.asarray(x, jnp.bfloat16) for x in a]
    pallas, _, _ = attention_step_pallas(*ja, interpret=True,
                                         update_buffers=False)
    np.testing.assert_allclose(out16.float().numpy(),
                               np.asarray(pallas, np.float32), atol=1e-2)


def test_shift_step_matches_jax():
    a = _float_ring(np.random.default_rng(2), 4, 7, 30, 20)
    got = tatt.local_attention_step(*map(_t, a))
    want = jatt.local_attention_step(*map(jnp.asarray, a))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ring_step_matches_jax_through_the_wrap():
    """`local_attention_step_ring` over 9 steps of a 4-slot ring: out,
    buffers and cursor against the JAX function; the cursor wraps mod
    W-1 = 4, and the buffers are written in place."""
    rng = np.random.default_rng(3)
    b, w1, dk, dv = 3, 4, 12, 8
    kb = rng.standard_normal((b, w1, dk)).astype(np.float32)
    vb = rng.standard_normal((b, w1, dv)).astype(np.float32)
    jkb, jvb, jpos = jnp.asarray(kb), jnp.asarray(vb), jnp.int32(2)
    tkb, tvb = _t(kb), _t(vb)
    tpos = torch.tensor(2, dtype=torch.int32)
    for step in range(9):
        q, kt, vt = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, dk), (b, dk), (b, dv)))
        jo, jkb, jvb, jpos = jatt.local_attention_step_ring(
            jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), jkb, jvb, jpos)
        to, rk, rv, rp = tatt.local_attention_step_ring(
            _t(q), _t(kt), _t(vt), tkb, tvb, tpos)
        assert rk is tkb and rv is tvb and rp is tpos
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_array_equal(tkb.numpy(), np.asarray(jkb))
        np.testing.assert_array_equal(tvb.numpy(), np.asarray(jvb))
        assert int(tpos) == int(jpos) == (2 + step + 1) % w1


# ---- B4: int8 ring -------------------------------------------------------

@pytest.mark.parametrize("b,w1,dk,dv", [(8, 9, 40, 32), (5, 49, 582, 1552)])
def test_int8_step_reference_matches_pallas_and_xla(b, w1, dk, dv):
    a = _int8_ring(np.random.default_rng(b), b, w1, dk, dv)
    q, kt, vt, kb, ks, vb, vs = a
    got = attention_step_reference(*map(_t, (q, kt, vt, kb, vb)),
                                   k_scale=_t(ks), v_scale=_t(vs)).numpy()
    ja = list(map(jnp.asarray, a))
    pallas = attention_step_int8_pallas(*ja, interpret=True, block_rows=4)
    xla = jatt.ring_attend_int8(*ja)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=2e-5, atol=2e-5)


def test_int8_ring_step_matches_jax_through_the_wrap():
    """`local_attention_step_ring_int8`: the slot quantized per row
    (`quantize_rows`) and its scale bit-exact against the XLA branch,
    out within 2e-5, cursor mod W-1 = 5, over 7 steps."""
    rng = np.random.default_rng(4)
    b, w1, dk, dv = 4, 5, 24, 16
    q, kt, vt, kb, ks, vb, vs = _int8_ring(rng, b, w1, dk, dv)
    j = [jnp.asarray(x) for x in (kb, ks, vb, vs)] + [jnp.int32(3)]
    t = [_t(x) for x in (kb, ks, vb, vs)] + [torch.tensor(3,
                                                          dtype=torch.int32)]
    for step in range(7):
        q, kt, vt = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, dk), (b, dk), (b, dv)))
        jo, *j = jatt.local_attention_step_ring_int8(
            jnp.asarray(q), jnp.asarray(kt), jnp.asarray(vt), *j)
        to, *_ = tatt.local_attention_step_ring_int8(_t(q), _t(kt), _t(vt),
                                                     *t)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=2e-5,
                                   atol=2e-5)
        for tx, jx in zip(t, j):
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        assert int(t[-1]) == (3 + step + 1) % w1


def test_quantize_rows_matches_jax():
    x = np.random.default_rng(5).standard_normal((3, 4, 50)).astype(
        np.float32)
    x[0, 0] = 0.0                                   # amax clamped at 1e-12
    q8, sc = tatt.quantize_rows(_t(x))
    jq8, jsc = jatt.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


# ---- dispatch ------------------------------------------------------------

def test_dispatch_takes_the_plain_version_on_cpu():
    a = [_t(x) for x in _int8_ring(np.random.default_rng(6), 3, 4, 8, 16)]
    q, kt, vt, kb, ks, vb, vs = a
    assert torch.equal(attention_step(q, kt, vt, kb, vb, ks, vs),
                       attention_step_reference(q, kt, vt, kb, vb, ks, vs))
    a = [_t(x) for x in _float_ring(np.random.default_rng(7), 3, 4, 8, 16)]
    assert torch.equal(tatt.ring_attend(*a), attention_step_reference(*a))


def test_kernel_wrapper_refuses_cpu_tensors():
    a = [_t(x) for x in _float_ring(np.random.default_rng(8), 2, 3, 8, 16)]
    before = attention_step_cuda.launches
    with pytest.raises(ValueError, match="GPU"):
        attention_step_cuda(*a)
    q, kt, vt, kb, ks, vb, vs = (
        _t(x) for x in _int8_ring(np.random.default_rng(9), 2, 3, 8, 16))
    with pytest.raises(ValueError, match="GPU"):
        attention_step_cuda(q, kt, vt, kb, vb, ks, vs)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        attention_step_cuda(q, kt, vt, kb, vb)
    assert attention_step_cuda.launches == before


# ---- full-utterance attention --------------------------------------------

@pytest.mark.parametrize("t,w,carried", [(23, 5, False), (23, 5, True),
                                         (3, 8, True), (10, 5, True)])
def test_local_attention_matches_jax(t, w, carried):
    """Ragged T, T < W, T a multiple of W; with and without a carried
    context."""
    rng = np.random.default_rng(t * w)
    b, dk, dv = 3, 12, 8
    q, k = (rng.standard_normal((b, t, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, t, dv)).astype(np.float32)
    bufs = ([rng.standard_normal((b, w - 1, d)).astype(np.float32)
             for d in (dk, dv)] if carried else [None, None])
    got = tatt.local_attention(_t(q), _t(k), _t(v), w,
                               *(None if x is None else _t(x) for x in bufs))
    want = jatt.local_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), w,
                                *(None if x is None else jnp.asarray(x)
                                  for x in bufs))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5)


@pytest.mark.parametrize("t,w", [(17, 5), (4, 9)])
def test_causal_banded_attention_full_matches_jax(t, w):
    rng = np.random.default_rng(t + w)
    q, k = (rng.standard_normal((2, t, 10)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, t, 6)).astype(np.float32)
    got = tatt.causal_banded_attention_full(_t(q), _t(k), _t(v), w)
    want = jatt.causal_banded_attention_full(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
