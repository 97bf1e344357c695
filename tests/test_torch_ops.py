"""PyTorch port vs the JAX package: weights, filterbank STFT, norms and
LSTM pieces of the streaming step, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. All in
float32; tolerance 1e-5 unless stated (float32 reassociation only:
both sides compute the same formula in another order).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.ops import lstm as jlstm
from lookoncetohear_tpu.ops import norms as jnorms
from lookoncetohear_tpu.ops import stft as jstft
from lookoncetohear_tpu.ops.attention import quantize_slot_native as jquant
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.ops import lstm as tlstm
from lookoncetohear_tpu_torch.ops import norms as tnorms
from lookoncetohear_tpu_torch.ops import stft as tstft
from lookoncetohear_tpu_torch.ops.attention import quantize_slot_native
from lookoncetohear_tpu_torch.weights import load_npz, params_from_jax

FLAGSHIP = dict(embed_dim=256, stft_chunk_size=128, stft_pad_size=64,
                num_ch=2, D=64, L=4, I=1, J=1, B=3, H=64,
                local_atten_len=50, use_attn=True, lookahead=True,
                chunk_causal=True)
ATOL = 1e-5
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "tsh_r5_5k_best.npz")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---- weights -------------------------------------------------------------

def test_checkpoint_maps_onto_port_one_to_one():
    """Every key of the flagship checkpoint maps to a port tensor of the
    right shape; no key and no port tensor is left over."""
    flat = load_npz(CKPT)
    assert len(flat) == 128
    sd = params_from_jax(flat)
    net = Net(**FLAGSHIP, device="cpu")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    assert got == want
    net.load_state_dict(sd, strict=True)
    n_params = sum(v.numel() for v in sd.values())
    assert n_params == sum(int(np.prod(v.shape)) for v in flat.values())


@pytest.mark.parametrize("key,rule", [
    ("tfgridnet/conv/kernel", (3, 2, 0, 1)),
    ("tfgridnet/deconv/kernel", (3, 2, 0, 1)),
    ("tfgridnet/blocks_2/attn_v/dense/kernel", (1, 0)),
    ("tfgridnet/blocks_1/intra_rnn/w_hh_l0_reverse", None),
    ("tfgridnet/embed_proj_norm/scale", None),
    ("tfgridnet/blocks_0/attn_q/act/alpha", None),
])
def test_layout_rules(key, rule):
    flat = load_npz(CKPT)
    sd = params_from_jax({key: flat[key]})
    (name, val), = sd.items()
    want = flat[key] if rule is None else np.transpose(flat[key], rule)
    np.testing.assert_array_equal(val.numpy(), want)
    leaf = key.rsplit("/", 1)[1]
    assert name.rsplit(".", 1)[1] == ("weight" if leaf in (
        "kernel", "scale", "alpha") else leaf)


def test_params_accept_p_prefix():
    a = {"p//x/dense/kernel": np.ones((2, 3), np.float32)}
    assert list(params_from_jax(a)) == ["x.dense.weight"]


# ---- filterbank STFT -------------------------------------------------------

@pytest.mark.parametrize("n_fft,stride", [(192, 128), (48, 32)])
def test_filterbank_matches_jax(n_fft, stride):
    np.testing.assert_array_equal(
        tstft._stft_filterbank_np(n_fft, n_fft, stride),
        np.asarray(jstft.stft_filterbank(n_fft, n_fft, stride)))


def test_fb_encode_decode_match_jax():
    rng = np.random.default_rng(0)
    n_fft, stride = 192, 128
    x = rng.standard_normal((2, 2, n_fft + 4 * stride)).astype(np.float32)
    _close(tstft.fb_encode(_t(x), n_fft, stride),
           jstft.fb_encode(jnp.asarray(x), n_fft, stride), atol=2e-5)
    spec = rng.standard_normal((2, 2, 2 * 97, 5)).astype(np.float32)
    _close(tstft.fb_decode(_t(spec), n_fft, stride),
           jstft.fb_decode(jnp.asarray(spec), n_fft, stride), atol=2e-5)
    _close(tstft.fb_decode_frame(_t(spec[..., 0]), n_fft, stride),
           jstft.fb_decode_frame(jnp.asarray(spec[..., 0]), n_fft, stride),
           atol=2e-5)


@pytest.mark.parametrize("frame_len,hop", [(192, 128), (8, 3), (6, 6)])
def test_frame_and_overlap_add_match_jax(frame_len, hop):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, frame_len + 5 * hop)).astype(np.float32)
    fr = tstft.frame_signal(_t(x), frame_len, hop)
    np.testing.assert_array_equal(
        fr.numpy(), np.asarray(jstft.frame_signal(jnp.asarray(x),
                                                  frame_len, hop)))
    _close(tstft.overlap_add(fr, hop),
           jstft.overlap_add(jnp.asarray(fr.numpy()), hop))


def test_streamed_decode_equals_offline():
    """One frame at a time with a 1-frame lookback (the serving step's
    istft_buf) reproduces the offline overlap-add."""
    rng = np.random.default_rng(2)
    n_fft, stride, t = 192, 128, 6
    spec = _t(rng.standard_normal((1, 2 * 97, t)).astype(np.float32))
    offline = tstft.fb_decode(spec, n_fft, stride)
    buf = torch.zeros((1, 2 * 97, 1))
    out = []
    for i in range(t):
        y = torch.cat([buf, spec[..., i:i + 1]], dim=-1)
        buf = y[..., -1:]
        out.append(tstft.fb_decode(y, n_fft, stride)[..., stride:2 * stride])
    streamed = torch.cat(out, dim=-1)
    _close(streamed, offline[..., :t * stride], atol=2e-5)


# ---- norms ---------------------------------------------------------------

def test_layer_norm_and_prelu_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 5, 32)).astype(np.float32)
    sc = rng.standard_normal(32).astype(np.float32)
    bi = rng.standard_normal(32).astype(np.float32)
    ln = tnorms.LayerNorm(32)
    with torch.no_grad():
        ln.weight.copy_(_t(sc))
        ln.bias.copy_(_t(bi))
    want = jnorms.LayerNorm(32).apply(
        {"params": {"scale": sc, "bias": bi}}, jnp.asarray(x))
    _close(ln(_t(x)).detach(), want)
    pr = tnorms.PReLU()
    with torch.no_grad():
        pr.weight.fill_(0.1)
    want = jnorms.PReLU().apply(
        {"params": {"alpha": np.full((1,), 0.1, np.float32)}}, jnp.asarray(x))
    _close(pr(_t(x)).detach(), want)


@pytest.mark.parametrize("f,nh,dim", [(97, 4, 6), (97, 4, 16), (5, 2, 3)])
def test_flat_head_layer_norm_matches_jax(f, nh, dim):
    rng = np.random.default_rng(4)
    d = f * nh * dim
    x = (rng.standard_normal((6, d)) * 3 + 1).astype(np.float32)
    sc = rng.standard_normal(d).astype(np.float32)
    bi = rng.standard_normal(d).astype(np.float32)
    seg = tnorms.head_segment_matrix(d, nh, dim)
    np.testing.assert_array_equal(seg,
                                  jnorms.head_segment_matrix(d, nh, dim))
    got = tnorms.flat_head_layer_norm(_t(x), _t(seg), float(f * dim),
                                      _t(sc), _t(bi), 1e-5)
    want = jnorms.flat_head_layer_norm(jnp.asarray(x), jnp.asarray(seg),
                                       float(f * dim), sc, bi, 1e-5)
    _close(got, want, atol=5e-5)


@pytest.mark.parametrize("shape", [(97 * 3, 64), (2, 97 * 64)])
def test_flat_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(shape) * 2 - 1).astype(np.float32)
    sc = rng.standard_normal(shape[-1]).astype(np.float32)
    bi = rng.standard_normal(shape[-1]).astype(np.float32)
    _close(tnorms.flat_layer_norm(_t(x), _t(sc), _t(bi), 1e-5),
           jnorms.flat_layer_norm(jnp.asarray(x), sc, bi, 1e-5), atol=5e-5)


def test_flat_layer_norm_keeps_bf16():
    x = torch.randn(3, 64, dtype=torch.bfloat16)
    y = tnorms.flat_layer_norm(x, torch.ones(64, dtype=torch.bfloat16),
                               torch.zeros(64, dtype=torch.bfloat16), 1e-5)
    assert y.dtype == torch.bfloat16


# ---- LSTM ----------------------------------------------------------------

def _lstm_params(rng, i, h):
    arrs = [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((4 * h, i), (4 * h, h), (4 * h,), (4 * h,))]
    return (jlstm.LSTMParams(*map(jnp.asarray, arrs)),
            tlstm.LSTMParams(*map(_t, arrs)))


def test_lstm_step_and_apply_match_jax():
    rng = np.random.default_rng(6)
    jp, tp = _lstm_params(rng, 16, 16)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    h0 = rng.standard_normal((5, 16)).astype(np.float32)
    c0 = rng.standard_normal((5, 16)).astype(np.float32)
    jh, jc = jlstm.lstm_step(jp, jnp.asarray(x[:, 0]), jnp.asarray(h0),
                             jnp.asarray(c0))
    th, tc = tlstm.lstm_step(tp, _t(x[:, 0]), _t(h0), _t(c0))
    _close(th, jh)
    _close(tc, jc)
    jy, (jh, jc) = jlstm.lstm_apply(jp, jnp.asarray(x), jnp.asarray(h0),
                                    jnp.asarray(c0))
    ty, (th, tc) = tlstm.lstm_apply(tp, _t(x), _t(h0), _t(c0))
    _close(ty, jy)
    _close(th, jh)
    _close(tc, jc)


@pytest.mark.parametrize("b,t,i,h", [(6, 97, 16, 16), (5, 9, 12, 8)])
def test_lstm_apply_bidir_matches_jax(b, t, i, h):
    """CPU tensors: the recurrence runs the kernel's plain version."""
    rng = np.random.default_rng(7)
    jf, tf = _lstm_params(rng, i, h)
    jb, tb = _lstm_params(rng, i, h)
    x = rng.standard_normal((b, t, i)).astype(np.float32)
    jy, ((jhf, jhb), (jcf, jcb)) = jlstm.lstm_apply_bidir(jf, jb,
                                                          jnp.asarray(x))
    ty, ((thf, thb), (tcf, tcb)) = tlstm.lstm_apply_bidir(tf, tb, _t(x))
    for g, w in ((ty, jy), (thf, jhf), (thb, jhb), (tcf, jcf), (tcb, jcb)):
        _close(g, w, atol=2e-5)


# ---- int8 slot quantization ----------------------------------------------

@pytest.mark.parametrize("f,nh,dim", [(97, 4, 6), (5, 4, 3)])
def test_quantize_slot_native_matches_jax(f, nh, dim):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((7, f * nh * dim)).astype(np.float32)
    q8, sc = quantize_slot_native(_t(x), f, nh)
    jq8, jsc = jquant(jnp.asarray(x), f, nh)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


def test_quantize_rounds_half_to_even():
    """x / scale lands exactly on .5: jnp.round and torch.round go to
    the even integer, where round-half-away would not."""
    f, nh = 1, 1
    x = np.array([[127.0, 0.5, 1.5, 2.5, -2.5]], np.float32)
    q8, _ = quantize_slot_native(_t(x), f, nh)
    jq8, _ = jquant(jnp.asarray(x), f, nh)
    np.testing.assert_array_equal(q8.numpy(), [[127, 0, 2, 2, -2]])
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
