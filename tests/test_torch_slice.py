"""The serving slice end to end, PyTorch port vs the JAX package, on
the CPU at a small size (D=16, 2 blocks, H=16, 2 heads, chunk 32 + pad
16, attention window 5 in 8 padded ring slots): JAX-initialised random
params carried over with `params_from_jax`, int8 K/V, float32 compute.

Tolerances and why:
  * one step from the same state: audio and float state atol 1e-4 (the
    JAX package's own parity bound, tests/test_reference_parity.py);
  * int8 ring entries written by a step: at most 1 in 1000 may differ,
    and by at most 1. Both sides quantize round(k / scale) of the
    normalized projections; float32 reassociation in the norms moves a
    value across a .5 rounding boundary now and then, and the entry
    flips by one;
  * several steps free-running: such flips compound through later
    steps, so the audio is held to 1e-3 of its peak instead.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.models.net import Net as JaxNet
from lookoncetohear_tpu.serve.engine import StreamingEngine as JaxEngine
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.ops.bilstm_scan import bilstm_scan_cuda
from lookoncetohear_tpu_torch.ops.ring_step import ring_attend_int8_step_cuda
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import flatten_params, params_from_jax

SMALL = dict(embed_dim=32, stft_chunk_size=32, stft_pad_size=16,
             num_ch=2, D=16, L=2, I=1, J=1, B=2, H=16,
             local_atten_len=5, use_attn=True, lookahead=True,
             chunk_causal=True)
W = SMALL["local_atten_len"]
NFFT = SMALL["stft_chunk_size"] + SMALL["stft_pad_size"]


@pytest.fixture(scope="module")
def models():
    jm = JaxNet(**SMALL)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 2, 4 * NFFT)),
                     jnp.zeros((1, 1, SMALL["embed_dim"])))["params"]
    sd = params_from_jax(flatten_params(params))
    tm = Net(**SMALL, device="cpu")
    tm.load_state_dict(sd)
    jstep = jax.jit(lambda p, x, e, s: jm.apply(
        {"params": p}, x, e, s, method=jm.step))
    return jm, params, jstep, tm, sd


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_states_close(jstate, tstate, written_rows):
    for (name, a), (_, b) in zip(_leaves(jstate), _leaves(tstate)):
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1, name
            assert np.count_nonzero(diff) <= max(1, written_rows * a.shape[-1]
                                                 // 1000), name
        else:
            np.testing.assert_allclose(b, a, atol=1e-4, err_msg=name)


def test_step_matches_jax_from_the_same_state(models):
    """Each of 8 steps (through the cursor wrap) starts both packages
    from the JAX state and compares audio and the whole new state."""
    jm, params, jstep, tm, _ = models
    rng = np.random.default_rng(0)
    b = 3
    emb = rng.standard_normal((b, SMALL["embed_dim"])).astype(np.float32)
    js = jm.init_state(b, jnp.float32, kv_dtype=jnp.int8)
    for step in range(8):
        x = rng.standard_normal((b, 2, NFFT)).astype(np.float32)
        ts = _to_torch(js)
        jy, js = jstep(params, jnp.asarray(x), jnp.asarray(emb), js)
        ty, ts = tm.step(torch.from_numpy(x), torch.from_numpy(emb), ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4)
        _assert_states_close(js, ts, written_rows=b)
        assert int(ts["blocks"][0]["pos"]) == (step + 1) % W


def test_free_running_steps_track_jax(models):
    jm, params, jstep, tm, _ = models
    rng = np.random.default_rng(1)
    b = 4
    emb = rng.standard_normal((b, SMALL["embed_dim"])).astype(np.float32)
    js = jm.init_state(b, jnp.float32, kv_dtype=jnp.int8)
    ts = tm.init_state(b, torch.float32, torch.int8)
    for _ in range(8):
        x = rng.standard_normal((b, 2, NFFT)).astype(np.float32)
        jy, js = jstep(params, jnp.asarray(x), jnp.asarray(emb), js)
        ty, ts = tm.step(torch.from_numpy(x), torch.from_numpy(emb), ts)
        jy = np.asarray(jy)
        assert ty.shape == jy.shape == (b, 2, SMALL["stft_chunk_size"])
        np.testing.assert_allclose(ty.numpy(), jy,
                                   atol=1e-3 * np.abs(jy).max())


def test_bf16_step_runs(models):
    """bf16 params, activations and state with the int8 ring: finite,
    bf16, and near the float32 step (bf16 keeps ~3 digits)."""
    *_, tm, sd = models
    rng = np.random.default_rng(2)
    b = 2
    x = torch.from_numpy(rng.standard_normal((b, 2, NFFT)).astype(np.float32))
    emb = torch.from_numpy(
        rng.standard_normal((b, SMALL["embed_dim"])).astype(np.float32))
    y32, _ = tm.step(x, emb, tm.init_state(b, torch.float32))
    net16 = Net(**SMALL, device="cpu")
    net16.load_state_dict(sd)
    net16.to(torch.bfloat16)
    y16, s16 = net16.step(x.bfloat16(), emb.bfloat16(),
                          net16.init_state(b, torch.bfloat16))
    assert y16.dtype == torch.bfloat16 and torch.isfinite(y16).all()
    assert s16["blocks"][0]["k_buf"].dtype == torch.int8
    assert s16["blocks"][0]["k_scale"].dtype == torch.float32
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(),
                               atol=0.05 * float(y32.abs().max()))


# ---- engine ----------------------------------------------------------------

def _engines(models, n):
    jm, params, _, tm, sd = models
    je = JaxEngine(jm, params, max_streams=n, dtype=jnp.float32,
                   kv_dtype=jnp.int8)
    te = StreamingEngine(tm, sd, max_streams=n, dtype=torch.float32,
                         kv_dtype=torch.int8, device="cpu")
    return je, te


def test_engine_matches_jax(models):
    """4 slots: streams 0 and 1 from the start, stream 2 attached mid-run,
    slot 3 never active (its output is exactly zero). The shared ring
    cursor advances every step, primed or not."""
    n, c = 4, SMALL["stft_chunk_size"]
    je, te = _engines(models, n)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((n, SMALL["embed_dim"])).astype(np.float32)
    for s in (0, 1):
        je.add_stream(s, emb[s])
        te.add_stream(s, emb[s])
    for i in range(7):
        if i == 3:
            je.add_stream(2, emb[2])
            te.add_stream(2, emb[2])
        x = rng.standard_normal((n, 2, c)).astype(np.float32)
        jy = np.asarray(je.step(x))
        ty = te.step(x).numpy()
        np.testing.assert_allclose(ty, jy, atol=1e-3 * np.abs(jy).max())
        assert np.abs(ty[3]).max() == 0.0
        if i == 3:   # slot 2's first step only primes its tail
            assert np.abs(ty[2]).max() == 0.0
        for jb, tb in zip(je.state["blocks"], te.state["blocks"]):
            assert int(tb["pos"]) == int(jb["pos"]) == (i + 1) % W
    np.testing.assert_array_equal(te.primed, je.primed)


def test_engine_slot_isolation(models):
    """Re-attaching slot 1 mid-run leaves slots 0 and 2 untouched."""
    *_, tm, sd = models
    n, c = 3, SMALL["stft_chunk_size"]
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((n, SMALL["embed_dim"])).astype(np.float32)
    x = rng.standard_normal((6, n, 2, c)).astype(np.float32)
    outs = []
    for reset_at in (None, 3):
        eng = StreamingEngine(tm, sd, max_streams=n, device="cpu")
        for s in range(n):
            eng.add_stream(s, emb[s])
        ys = []
        for i in range(6):
            if i == reset_at:
                eng.add_stream(1, emb[1])
            ys.append(eng.step(x[i]).numpy())
        outs.append(np.stack(ys))
    ref, got = outs
    np.testing.assert_allclose(got[:, [0, 2]], ref[:, [0, 2]], atol=1e-6)
    assert np.abs(got[3, 1]).max() == 0.0
    assert not np.allclose(got[5, 1], ref[5, 1])


def test_unprimed_slot_keeps_its_ring(models):
    """The ring step writes slot `pos` of every row in place; the engine
    puts back what an unprimed (or inactive) row held there."""
    *_, tm, sd = models
    eng = StreamingEngine(tm, sd, max_streams=2, device="cpu")
    eng.add_stream(0, np.ones(SMALL["embed_dim"], np.float32))
    x = np.random.default_rng(5).standard_normal(
        (2, 2, SMALL["stft_chunk_size"])).astype(np.float32)
    for _ in range(3):
        eng.step(x)
    for blk in eng.state["blocks"]:
        for k in ("k_buf", "v_buf", "k_scale", "v_scale", "h", "c"):
            assert not blk[k][1].any(), k
        assert blk["k_buf"][0].any()


def test_ring_cursor_wraps_mod_w_and_reset_leaves_it(models):
    """Traps from the JAX package: the int8 cursor wraps mod w (not
    mod W-1 like the float ring), and a slot reset zeroes the slot's
    batch-major leaves but leaves the one shared cursor alone."""
    *_, tm, sd = models
    eng = StreamingEngine(tm, sd, max_streams=2, device="cpu")
    eng.add_stream(0, np.ones(SMALL["embed_dim"], np.float32))
    x = np.zeros((2, 2, SMALL["stft_chunk_size"]), np.float32)
    for i in range(W + 2):
        eng.step(x)
        assert all(int(b["pos"]) == (i + 1) % W for b in eng.state["blocks"])
    eng.add_stream(1, np.ones(SMALL["embed_dim"], np.float32))
    assert all(int(b["pos"]) == (W + 2) % W for b in eng.state["blocks"])
    assert not eng.state["blocks"][0]["k_buf"][1].any()


# ---- the GPU default and no fallback --------------------------------------

def test_entry_points_need_a_card_unless_cpu_is_asked(models, monkeypatch):
    *_, tm, sd = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Net(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEngine(tm, sd)


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="GPU"):
        bilstm_scan_cuda(torch.zeros(3, 2, 1, 16), torch.zeros(2, 4, 16))
    z = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="GPU"):
        ring_attend_int8_step_cuda(
            z, z, z, torch.zeros(1, 8, 8, dtype=torch.int8),
            torch.zeros(1, 8, 2), torch.zeros(1, 8, 8, dtype=torch.int8),
            torch.zeros(1, 8, 2), torch.zeros((), dtype=torch.int32),
            f=2, n_head=2, w=8)
