"""The reference's default `Net` structure, PyTorch port vs the JAX
package, on the CPU: no attention (L=0, `use_attn=False`), H=128, at a
small size (D=16, 2 blocks, chunk 32 + pad 16, F=25 bins).
JAX-initialised random params carried over with `params_from_jax`,
float32 compute. Also the plain LSTM recurrences at H=128 against the
Pallas kernel (interpret mode) and the JAX `lstm_apply`, and the scan
wrappers' width checks, which run without a card.

The JAX package cannot build a block at L=0: its `v_dim` divides the
channels by the head count even without attention
(lookoncetohear_tpu/models/streaming_tfgridnet.py:167), so its `Net()`
with the defaults raises ZeroDivisionError at init. Its side here takes
L=2, which without attention adds no parameter and no state and changes
nothing; the port runs the default's L=0.

Tolerance: atol 1e-4 everywhere (the JAX package's parity bound,
tests/test_reference_parity.py); with no attention and no int8 ring
nothing rounds apart, so free-running steps stay within it too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.models.net import Net as JaxNet
from lookoncetohear_tpu.ops import lstm as jlstm
from lookoncetohear_tpu.ops.pallas_lstm import bilstm_scan_pallas
from lookoncetohear_tpu.serve.engine import StreamingEngine as JaxEngine
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.ops import bilstm_scan as bs
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import (flatten_params,
                                              params_from_jax,
                                              params_to_jax)

SMALL = dict(embed_dim=32, stft_chunk_size=32, stft_pad_size=16,
             num_ch=2, D=16, L=0, I=1, J=1, B=2, H=128, use_attn=False,
             lookahead=True)
# the JAX side: any head count but 0 (see above)
JAX_SMALL = {**SMALL, "L": 2}
CHUNK = SMALL["stft_chunk_size"]
NFFT = CHUNK + SMALL["stft_pad_size"]
F = NFFT // 2 + 1
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """Small-op loops (the plain scans, the engine's short steps) run on
    one thread (several test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JaxNet(**JAX_SMALL)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 4 * NFFT)),
        jnp.zeros((1, 1, SMALL["embed_dim"])))["params"]
    sd = params_from_jax(flatten_params(params))
    tm = Net(**SMALL, device="cpu")
    tm.load_state_dict(sd)
    jfns = {
        "step": jax.jit(lambda p, x, e, s: jm.apply(
            {"params": p}, x, e, s, method=jm.step)),
        "forward": jax.jit(lambda p, x, e: jm.apply({"params": p}, x, e)),
        "predict": jax.jit(lambda p, x, e, s: jm.apply(
            {"params": p}, x, e, s, method=jm.predict))}
    return jm, params, jfns, tm, sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_states_close(jstate, tstate):
    jl, tl = list(_leaves(jstate)), list(_leaves(tstate))
    assert [n for n, _ in jl] == [n for n, _ in tl]
    for (name, a), (_, b) in zip(jl, tl):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), name
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=name)


def _inputs(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, n)).astype(np.float32)
    emb = rng.standard_normal((b, SMALL["embed_dim"])).astype(np.float32)
    return x, emb


def test_state_has_no_ring_like_jax(models):
    """Without attention a block carries only the inter-time LSTM's (h,
    c), in any kv_dtype (which then has no effect), as in the JAX
    package."""
    jm, _, _, tm, _ = models
    for jkv, tkv in ((None, None), (jnp.int8, torch.int8),
                     (jnp.bfloat16, torch.bfloat16)):
        js, ts = jm.init_state(3, kv_dtype=jkv), tm.init_state(
            3, kv_dtype=tkv)
        _assert_states_close(js, ts)
        for blk in ts["blocks"]:
            assert set(blk) == {"h", "c"}
            assert blk["h"].shape == (3, F, SMALL["H"])


def test_params_carry_over_both_ways(models):
    """The no-attention tree (no attn_* entries) loads strictly, and the
    port's state_dict goes back to the JAX names and values exactly."""
    _, params, _, tm, sd = models
    flat = flatten_params(params)
    assert not any("attn" in k for k in flat)
    assert set(sd) == set(tm.state_dict())
    back = params_to_jax(tm.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_forward_matches_jax(models):
    """Net.forward over a ragged length (mod-padded, lookahead, trimmed)
    from a fresh state against JAX Net.__call__: the intra BiLSTM over
    every frame at once and the inter-time LSTM over T > 1."""
    _, params, jfns, tm, _ = models
    x, emb = _inputs(1, 2, 9 * CHUNK + 7)
    emb = emb[:, None]
    jy = jfns["forward"](params, jnp.asarray(x), jnp.asarray(emb))
    with torch.no_grad():
        ty = tm(torch.from_numpy(x), torch.from_numpy(emb))
    assert ty.shape == (2, 2, x.shape[-1])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_predict_twice_matches_jax(models):
    """Two `predict` calls in a row: the second runs the inter-time LSTM
    from the carried (h, c) the first left; output and state after each
    against the JAX package."""
    jm, params, jfns, tm, _ = models
    b = 2
    x, emb = _inputs(2, b, 11 * CHUNK)
    js, ts = jm.init_state(b), tm.init_state(b)
    for part in (x[..., :5 * CHUNK], x[..., 5 * CHUNK:]):
        jy, js = jfns["predict"](params, jnp.asarray(part), jnp.asarray(emb),
                                 js)
        ty, ts = tm.predict(torch.from_numpy(part), torch.from_numpy(emb),
                            ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        _assert_states_close(js, ts)


def test_steps_match_jax(models):
    """Free-running streaming steps (the T=1 path: B2's plain version
    for the intra BiLSTM, one LSTM step for the inter one): audio and
    the whole state after each."""
    jm, params, jfns, tm, _ = models
    b = 3
    xs, emb = _inputs(3, b, 6 * NFFT)
    js, ts = jm.init_state(b), tm.init_state(b)
    for i in range(6):
        x = xs[..., i * NFFT:(i + 1) * NFFT]
        jy, js = jfns["step"](params, jnp.asarray(x), jnp.asarray(emb), js)
        ty, ts = tm.step(torch.from_numpy(x), torch.from_numpy(emb), ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        _assert_states_close(js, ts)


def test_engine_matches_jax(models):
    """5 slots over 9 chunks: streams 0 and 1 from the start, stream 2
    attached at chunk 3, stream 1 removed at chunk 5 and re-attached at
    chunk 7, slot 4 never active. Outputs and every state leaf after each
    chunk; inactive and unprimed slots output zeros."""
    jm, params, _, tm, sd = models
    n = 5
    je = JaxEngine(jm, params, max_streams=n)
    te = StreamingEngine(tm, sd, max_streams=n, device="cpu")
    _assert_states_close(je.state, te.state)
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((n, SMALL["embed_dim"])).astype(np.float32)
    events = {0: [("add", 0), ("add", 1)], 3: [("add", 2)],
              5: [("remove", 1)], 7: [("add", 1)]}
    for i in range(9):
        for what, s in events.get(i, []):
            for eng in (je, te):
                if what == "add":
                    eng.add_stream(s, emb[s])
                else:
                    eng.remove_stream(s)
        x = rng.standard_normal((n, 2, CHUNK)).astype(np.float32)
        jy = np.asarray(je.step(x))
        ty = te.step(x).numpy()
        np.testing.assert_allclose(ty, jy, atol=ATOL)
        _assert_states_close(je.state, te.state)
        np.testing.assert_array_equal(te.primed, je.primed)
        assert np.abs(ty[4]).max() == 0.0
        if i in (3, 7):           # a new stream's first chunk only primes
            assert np.abs(ty[2 if i == 3 else 1]).max() == 0.0
        if i in (5, 6):           # removed
            assert np.abs(ty[1]).max() == 0.0
    assert np.abs(ty[1]).max() > 0.0


def test_streamed_equals_full_in_the_port(models):
    """10 streaming steps == one full pass of the same 10 chunks, at
    the JAX package's bound for the same relation (tests/test_models.py:
    rtol 2e-4, atol 2e-5)."""
    *_, tm, _ = models
    b, n = 2, 10 * CHUNK
    x, emb = _inputs(5, b, n)
    with torch.no_grad():
        full = tm(torch.from_numpy(x), torch.from_numpy(emb)[:, None]).numpy()
    xp = np.concatenate([x, np.zeros((b, 2, NFFT - CHUNK), np.float32)], -1)
    state = tm.init_state(b)
    outs = []
    for c in range(10):
        y, state = tm.step(torch.from_numpy(
            xp[..., c * CHUNK:c * CHUNK + NFFT]), torch.from_numpy(emb), state)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, -1), full, rtol=2e-4,
                               atol=2e-5)


# ---- the plain recurrences at H = 128 ---------------------------------------

def test_plain_b2_at_h128_matches_the_pallas_kernel():
    """`bilstm_scan_reference` (B2's plain version, what the CPU runs)
    against the Pallas kernel in interpret mode at H=128."""
    rng = np.random.default_rng(6)
    xp = (rng.standard_normal((7, 2, 3, 512)) * 0.5).astype(np.float32)
    w_hh = (rng.standard_normal((2, 128, 512)) * 0.2).astype(np.float32)
    jys, jc = bilstm_scan_pallas(jnp.asarray(xp), jnp.asarray(w_hh),
                                 interpret=True)
    tys, tc = bs.bilstm_scan_reference(torch.from_numpy(xp),
                                       torch.from_numpy(w_hh))
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)


def _jax_params(p):
    return jlstm.LSTMParams(*(jnp.asarray(a) for a in p))


def test_plain_training_forward_at_h128_matches_jax_lstm():
    """`bilstm_train_reference` (the training forward's plain version) in
    the models' layouts at H=128: one direction from (h0, c0) against
    the JAX `lstm_apply`, two from zero against `lstm_apply_bidir`
    (fused=False: its lax.scan), every output and the final states."""
    rng = np.random.default_rng(7)
    n, t, i_dim, h = 3, 6, 16, 128

    def params():
        return [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in
                ((4 * h, i_dim), (4 * h, h), (4 * h,), (4 * h,))]
    x = rng.standard_normal((n, t, i_dim)).astype(np.float32)
    h0, c0 = (rng.standard_normal((n, h)).astype(np.float32)
              for _ in range(2))
    p = params()
    jy, (jh, jc) = jlstm.lstm_apply(_jax_params(p), jnp.asarray(x),
                                    jnp.asarray(h0), jnp.asarray(c0))
    w_ih, w_hh, b_ih, b_hh = map(torch.from_numpy, p)
    xp = torch.from_numpy(x) @ w_ih.T + (b_ih + b_hh)
    ty, tc = bs.bilstm_train_reference(xp, w_hh.T[None], torch.float32,
                                       torch.from_numpy(h0)[None],
                                       torch.from_numpy(c0)[None])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(ty[:, -1].numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc), atol=ATOL)
    pf, pb = params(), params()
    jy, (_, (jcf, jcb)) = jlstm.lstm_apply_bidir(
        _jax_params(pf), _jax_params(pb), jnp.asarray(x))
    tf, tb = [list(map(torch.from_numpy, q)) for q in (pf, pb)]
    xp = torch.from_numpy(x) @ torch.cat([tf[0], tb[0]]).T + torch.cat(
        [tf[2] + tf[3], tb[2] + tb[3]])
    ty, tc = bs.bilstm_train_reference(xp, torch.stack([tf[1].T, tb[1].T]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.stack([jcf, jcb]), atol=ATOL)


# ---- the wrappers' width checks (no card needed) -----------------------------

@pytest.mark.parametrize("hidden", [64, 128])
def test_kernel_widths_are_accepted(hidden):
    bs.check_width(hidden, "scan")
    # on a tensor that is not on the CPU the width passes and the device
    # check refuses: there is no card here ("meta" tensors hold no data)
    xp = torch.zeros(2, 5, 4 * hidden, device="meta")
    with pytest.raises(ValueError, match="GPU"):
        bs.bilstm_scan_train(xp, torch.zeros(1, hidden, 4 * hidden,
                                             device="meta"))


@pytest.mark.parametrize("hidden", [16, 96, 256])
def test_other_widths_are_refused(hidden):
    with pytest.raises(ValueError, match="H=64 or H=128"):
        bs.check_width(hidden, "scan")
    xp = torch.zeros(2, 5, 4 * hidden, device="meta")
    with pytest.raises(ValueError, match=f"not {hidden}"):
        bs.bilstm_scan_train(xp, torch.zeros(1, hidden, 4 * hidden,
                                             device="meta"))


def test_backward_width_is_64_only():
    """Both widths have a backward kernel now (the name is kept from when
    only H=64 had one); any other width is refused."""
    assert bs.BACKWARD_WIDTHS == (64, 128)
    for hidden in bs.BACKWARD_WIDTHS:
        bs.check_width(hidden, "backward", bs.BACKWARD_WIDTHS)
    with pytest.raises(ValueError, match="H=64 or H=128, not 96"):
        bs.check_width(96, "backward", bs.BACKWARD_WIDTHS)


def test_gradient_at_h128_is_refused_off_the_cpu():
    """Off the CPU a call at H=128 that needs a gradient goes on to the
    kernels, as at H=64, which refuse the meta tensor's device (there is
    no card here): nothing refuses the width any more (the name is kept
    from when the gradient was refused). Without a gradient it reaches
    the same check, and on the CPU H=128 differentiates through the
    plain loops."""
    for hidden in (128, 64):
        w = torch.zeros(1, hidden, 4 * hidden, device="meta",
                        requires_grad=True)
        xp = torch.zeros(2, 5, 4 * hidden, device="meta")
        with pytest.raises(ValueError, match="GPU"):
            bs.bilstm_scan_train(xp, w)
        with torch.no_grad(), pytest.raises(ValueError, match="GPU"):
            bs.bilstm_scan_train(xp, w)
    state = torch.zeros(1, 2, 128, device="meta")
    with pytest.raises(ValueError, match="GPU"):
        bs.bilstm_scan_bwd_cuda(torch.zeros(2, 5, 512, device="meta"),
                                torch.zeros(1, 128, 512, device="meta"),
                                state, state,
                                torch.zeros(2, 5, 128, device="meta"),
                                torch.zeros(2, 5, 128, device="meta"),
                                None, None)
    wc = torch.zeros(1, 128, 512, requires_grad=True)
    y, _ = bs.bilstm_scan_train(torch.ones(2, 5, 512), wc)
    y.sum().backward()
    assert wc.grad is not None and wc.grad.shape == wc.shape
