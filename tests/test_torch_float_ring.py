"""The float K/V ring and the full-utterance forward, PyTorch port vs the
JAX package, on the CPU at a small size (D=16, 2 blocks, H=16, 2 heads,
chunk 32 + pad 16, attention window 5: a 4-slot ring): JAX-initialised
random params carried over with `params_from_jax`, float32 compute.

Tolerances and why:
  * streaming steps, full forward and engine vs JAX: atol 1e-4 (the JAX
    package's parity bound, tests/test_reference_parity.py); a float
    ring has no rounding flips, so free-running steps stay within it;
  * streamed == full in the port: rtol 2e-4 / atol 2e-5, the JAX
    package's own bound for the same relation (tests/test_models.py);
  * a bfloat16 ring under float32 compute: 5e-2 of the float32 peak
    (tests/test_serve.py's bound for the same comparison).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.models.net import Net as JaxNet
from lookoncetohear_tpu.serve.engine import StreamingEngine as JaxEngine
from lookoncetohear_tpu_torch.models.net import Net, mod_pad
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import flatten_params, params_from_jax

SMALL = dict(embed_dim=32, stft_chunk_size=32, stft_pad_size=16,
             num_ch=2, D=16, L=2, I=1, J=1, B=2, H=16,
             local_atten_len=5, use_attn=True, lookahead=True,
             chunk_causal=True)
W = SMALL["local_atten_len"]
CHUNK = SMALL["stft_chunk_size"]
NFFT = CHUNK + SMALL["stft_pad_size"]
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """JAX and port nets for both chunk_causal settings, one set of
    params (chunk_causal adds none)."""
    jnets = {cc: JaxNet(**{**SMALL, "chunk_causal": cc})
             for cc in (True, False)}
    params = jax.jit(jnets[True].init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 4 * NFFT)),
        jnp.zeros((1, 1, SMALL["embed_dim"])))["params"]
    sd = params_from_jax(flatten_params(params))
    tnets = {}
    for cc in (True, False):
        tnets[cc] = Net(**{**SMALL, "chunk_causal": cc}, device="cpu")
        tnets[cc].load_state_dict(sd)
    return jnets, params, tnets, sd


_JITTED = {}


def _jit(jm, what):
    """The JAX net's step / forward / predict(pad=False), jitted once per
    net for the whole module."""
    key = (id(jm), what)
    if key not in _JITTED:
        if what == "step":
            fn = lambda p, x, e, s: jm.apply({"params": p}, x, e, s,  # noqa
                                             method=jm.step)
        elif what == "forward":
            fn = lambda p, x, e: jm.apply({"params": p}, x, e)  # noqa
        else:
            fn = lambda p, x, e, s: jm.apply(  # noqa
                {"params": p}, x, e, s, pad=False, method=jm.predict)
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


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
    for (name, a), (_, b) in zip(_leaves(jstate), _leaves(tstate)):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), name
        np.testing.assert_allclose(b, a, atol=ATOL, err_msg=name)


def _inputs(seed, b, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 2, n)).astype(np.float32)
    emb = rng.standard_normal((b, SMALL["embed_dim"])).astype(np.float32)
    return x, emb


def test_default_state_is_a_float_ring_like_jax(models):
    jnets, _, tnets, _ = models
    js = jnets[True].init_state(3)
    ts = tnets[True].init_state(3)
    for (name, a), (_, b) in zip(_leaves(js), _leaves(ts)):
        assert a.shape == b.shape and str(a.dtype) == str(b.dtype), name
    assert ts["blocks"][0]["k_buf"].shape == (3, 2, W - 1, 25 * 21)
    assert ts["blocks"][0]["k_buf"].dtype == torch.float32
    assert tnets[True].init_state(3, torch.bfloat16)["blocks"][0][
        "v_buf"].dtype == torch.bfloat16


def test_f32_step_matches_jax_over_12_steps(models):
    """Free-running steps through three wraps of the 4-slot ring: audio
    and the whole state after every step; the cursor wraps mod W-1."""
    jnets, params, tnets, _ = models
    jstep = _jit(jnets[True], "step")
    b = 3
    xs, emb = _inputs(0, b, 12 * NFFT)
    js = jnets[True].init_state(b)
    ts = tnets[True].init_state(b)
    for i in range(12):
        x = xs[..., i * NFFT:(i + 1) * NFFT]
        jy, js = jstep(params, jnp.asarray(x), jnp.asarray(emb), js)
        ty, ts = tnets[True].step(torch.from_numpy(x), torch.from_numpy(emb),
                                  ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
        _assert_states_close(js, ts)
        assert all(int(blk["pos"]) == (i + 1) % (W - 1)
                   for blk in ts["blocks"])


@pytest.mark.parametrize("chunk_causal", [True, False])
def test_forward_matches_jax(models, chunk_causal):
    """Net.forward (a ragged length: mod-padded, lookahead, trimmed)
    against JAX Net.__call__ from a fresh state."""
    jnets, params, tnets, _ = models
    x, emb = _inputs(1, 2, 7 * CHUNK + 11)
    emb = emb[:, None]
    jy = _jit(jnets[chunk_causal], "forward")(params, jnp.asarray(x),
                                        jnp.asarray(emb))
    with torch.no_grad():
        ty = tnets[chunk_causal](torch.from_numpy(x), torch.from_numpy(emb))
    assert ty.shape == (2, 2, x.shape[-1])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_mod_pad():
    x = torch.arange(10.0).reshape(1, 10)
    y, mod = mod_pad(x, 4, (0, 3))
    assert mod == 2 and y.shape == (1, 15)
    assert torch.equal(y[0, :10], x[0]) and not y[0, 10:].any()
    assert mod_pad(x, 5, (1, 0))[1] == 0


def test_streamed_equals_full_in_the_port(models):
    """12 streaming steps == one full pass of the same 12 chunks (the
    streamed windows hop by a chunk; the last one zero-padded)."""
    *_, tnets, _ = models
    net = tnets[True]
    b, n = 2, 12 * CHUNK
    x, emb = _inputs(2, b, n)
    with torch.no_grad():
        full = net(torch.from_numpy(x),
                   torch.from_numpy(emb)[:, None]).numpy()
    xp = np.concatenate([x, np.zeros((b, 2, NFFT - CHUNK), np.float32)], -1)
    state = net.init_state(b)
    outs = []
    for c in range(12):
        y, state = net.step(torch.from_numpy(xp[..., c * CHUNK:c * CHUNK
                                                 + NFFT]),
                            torch.from_numpy(emb), state)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, -1), full, rtol=2e-4,
                               atol=2e-5)


def test_bf16_ring_tracks_f32(models):
    *_, tnets, _ = models
    net = tnets[True]
    x, emb = _inputs(3, 1, NFFT)
    x, emb = torch.from_numpy(x), torch.from_numpy(emb)

    def run(kv):
        state = net.init_state(1, kv_dtype=kv)
        outs = []
        for _ in range(8):
            y, state = net.step(x, emb, state)
            outs.append(y)
        assert state["blocks"][0]["k_buf"].dtype == kv
        return torch.cat(outs, -1).numpy()

    y32, y16 = run(torch.float32), run(torch.bfloat16)
    assert np.abs(y16 - y32).max() <= 5e-2 * np.abs(y32).max()


@pytest.mark.parametrize("chunk_causal", [True, False])
def test_full_pass_after_ring_steps(models, chunk_causal):
    """Three ring steps leave pos = 3; a 6-frame full pass then keeps
    pos under chunk_causal and resets it to 0 in the offline branch,
    and the ring steps after it still match JAX in both."""
    jnets, params, tnets, _ = models
    jm, tm = jnets[chunk_causal], tnets[chunk_causal]
    jstep, jpred = _jit(jm, "step"), _jit(jm, "predict")
    b = 2
    x, emb = _inputs(4, b, 3 * NFFT + NFFT + 5 * CHUNK + 5 * NFFT)
    je, te = jnp.asarray(emb), torch.from_numpy(emb)
    js, ts = jm.init_state(b), tm.init_state(b)

    def both_step(xw):
        nonlocal js, ts
        jy, js = jstep(params, jnp.asarray(xw), je, js)
        ty, ts = tm.step(torch.from_numpy(xw), te, ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)

    for i in range(3):
        both_step(x[..., i * NFFT:(i + 1) * NFFT])
    assert int(ts["blocks"][0]["pos"]) == 3
    xf = x[..., 3 * NFFT:4 * NFFT + 5 * CHUNK]          # 6 frames
    jy, js = jpred(params, jnp.asarray(xf), je, js)
    ty, ts = tm.predict(torch.from_numpy(xf), te, ts, pad=False)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    _assert_states_close(js, ts)
    want_pos = 3 if chunk_causal else 0
    assert all(int(blk["pos"]) == want_pos for blk in ts["blocks"])
    rest = x[..., 4 * NFFT + 5 * CHUNK:]
    for i in range(5):
        both_step(rest[..., i * NFFT:(i + 1) * NFFT])
    _assert_states_close(js, ts)


def test_default_engine_matches_jax(models):
    """Both engines built with defaults carry a float32 ring and agree
    over 7 steps, with stream 2 attached mid-run and slot 3 idle."""
    jnets, params, tnets, sd = models
    n = 4
    je = JaxEngine(jnets[True], params, max_streams=n)
    te = StreamingEngine(tnets[True], sd, max_streams=n, device="cpu")
    for jb, tb in zip(je.state["blocks"], te.state["blocks"]):
        assert str(jb["k_buf"].dtype) == "float32"
        assert tb["k_buf"].dtype == torch.float32
        assert tuple(jb["v_buf"].shape) == tuple(tb["v_buf"].shape)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((n, SMALL["embed_dim"])).astype(np.float32)
    for s in (0, 1):
        je.add_stream(s, emb[s])
        te.add_stream(s, emb[s])
    for i in range(7):
        if i == 3:
            je.add_stream(2, emb[2])
            te.add_stream(2, emb[2])
        x = rng.standard_normal((n, 2, CHUNK)).astype(np.float32)
        jy = np.asarray(je.step(x))
        ty = te.step(x).numpy()
        np.testing.assert_allclose(ty, jy, atol=ATOL)
        assert np.abs(ty[3]).max() == 0.0
        _assert_states_close(je.state, te.state)
        assert all(int(b["pos"]) == (i + 1) % (W - 1)
                   for b in te.state["blocks"])


def test_one_state_dict_drives_every_path(models):
    """One `params_from_jax` state dict: the int8 step, the float step
    and the full forward each match the JAX package on it."""
    jnets, params, _, sd = models
    jm = jnets[True]
    net = Net(**SMALL, device="cpu")
    net.load_state_dict(sd)
    jstep = _jit(jm, "step")
    b = 2
    x, emb = _inputs(6, b, 3 * CHUNK)
    xw = x[..., :NFFT]
    for kv, jkv, tol in ((torch.float32, None, ATOL),
                         (torch.int8, jnp.int8, ATOL)):
        jy, _ = jstep(params, jnp.asarray(xw), jnp.asarray(emb),
                      jm.init_state(b, kv_dtype=jkv))
        ty, _ = net.step(torch.from_numpy(xw), torch.from_numpy(emb),
                         net.init_state(b, kv_dtype=kv))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=tol)
    jy = _jit(jm, "forward")(params, jnp.asarray(x), jnp.asarray(emb[:, None]))
    with torch.no_grad():
        ty = net(torch.from_numpy(x), torch.from_numpy(emb)[:, None])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_int8_ring_refuses_a_full_pass(models):
    *_, tnets, _ = models
    net = tnets[True]
    state = net.init_state(1, kv_dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        net.predict(torch.zeros(1, 2, 4 * CHUNK), torch.zeros(1, 32), state)


def test_full_pass_leaves_a_contiguous_ring(models):
    """The next step's ring kernel reads a flat view of the ring, so a
    full pass must leave it contiguous."""
    *_, tnets, _ = models
    for net in tnets.values():
        _, state = net.predict(torch.zeros(2, 2, 6 * CHUNK),
                               torch.zeros(2, 32), net.init_state(2))
        for blk in state["blocks"]:
            assert blk["k_buf"].is_contiguous()
            assert blk["v_buf"].is_contiguous()
