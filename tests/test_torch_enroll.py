"""The enrollment path, PyTorch port vs the JAX package, on the CPU:
the centered STFT, the offline nets' norms, the offline TF-GridNet
pieces and nets at small sizes with JAX-initialised random params
carried over by `params_from_jax`, and `EmbedNet` at full width from
checkpoints/embed_r5_5k_best.npz on a short enrollment.

Tolerances and why:
  * STFT, iSTFT and the norms: atol 1e-5 on O(1) values, float32
    rounding of two FFT / reduction implementations;
  * blocks and nets: atol 1e-4 (the JAX package's own parity bound,
    tests/test_reference_parity.py): the same float32 arithmetic through
    LSTM recurrences and a T x T softmax, in another summation order.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookoncetohear_tpu.models import net as jnet
from lookoncetohear_tpu.models import offline_tfgridnet as joff
from lookoncetohear_tpu.ops import norms as jnorms
from lookoncetohear_tpu.ops import stft as jstft
from lookoncetohear_tpu_torch.models import net as tnet
from lookoncetohear_tpu_torch.models import offline_tfgridnet as toff
from lookoncetohear_tpu_torch.ops import norms as tnorms
from lookoncetohear_tpu_torch.ops import stft as tstft
from lookoncetohear_tpu_torch.weights import (flatten_params, load_checkpoint,
                                              load_npz, params_from_jax)

EMBED_CKPT = "checkpoints/embed_r5_5k_best.npz"


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jax_init(module, x, seed=0):
    return jax.jit(module.init)(jax.random.PRNGKey(seed),
                                jnp.asarray(x))["params"]


def _jax_apply(module, params, x):
    return jax.jit(module.apply)({"params": params}, jnp.asarray(x))


def _port(module, params):
    """`module` with the JAX params loaded strictly."""
    module.load_state_dict(params_from_jax(flatten_params(params)),
                           strict=True)
    return module.eval()


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# ---- centered STFT -----------------------------------------------------------

@pytest.mark.parametrize("n_fft,hop,n", [(128, 64, 1000), (32, 16, 333),
                                         (64, 16, 256)])
def test_stft_center_matches_jax_and_round_trips(n_fft, hop, n):
    x = _rand((2, 2, n), 1)
    want = np.asarray(jstft.stft_center(jnp.asarray(x), n_fft, hop))
    got = tstft.stft_center(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == want.shape == (2, 2, n // hop + 1, n_fft // 2 + 1)
    _close(got, want, 1e-5)
    back_j = jstft.istft_center(jnp.asarray(want), n_fft, hop, length=n)
    back = tstft.istft_center(torch.from_numpy(got), n_fft, hop, length=n)
    _close(back, back_j, 1e-5)
    _close(back, x, 1e-5)


def test_hann_window_is_jaxs_and_torchs():
    """Computed in float64 then rounded, as the JAX package does;
    torch.hann_window rounds in float32 (within 1 ulp of 1)."""
    _close(tstft.hann_window(128), jstft.hann_window(128), 0)
    _close(tstft.hann_window(128), torch.hann_window(128), 2e-7)


# ---- norms ---------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("EspnetLayerNorm4D", (6,)), ("EspnetLayerNorm4DCF", (6, 9)),
    ("GroupNorm1", (6,))])
def test_offline_norms_match_jax(name, args):
    x = _rand((2, 6, 5, 9), 2, 3.0) + 1.0
    jm = getattr(jnorms, name)(*args)
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(_rand(p.shape, 3, 0.5)), _jax_init(jm, x))
    want = _jax_apply(jm, params, x)
    tm = _port(getattr(tnorms, name)(*args), params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want, 1e-5)


# ---- offline TF-GridNet pieces and nets ----------------------------------------

def test_unfold_k_matches_jax():
    x = _rand((3, 5, 11), 4)
    _close(toff._unfold_k(torch.from_numpy(x), 4),
           joff._unfold_k(jnp.asarray(x), 4), 0)


def test_conv_transpose_matches_jax():
    x = _rand((3, 7, 10), 5)
    jm = joff.ConvTranspose1dK(out_features=6, k=4)
    params = _jax_init(jm, x)
    tm = _port(toff.ConvTranspose1dK(10, 6, 4), params)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), _jax_apply(jm, params, x), 1e-5)


def test_gridnet_block_matches_jax():
    c, f = 16, 17
    x = _rand((2, c, 9, f), 6)
    jm = joff.GridNetBlockOffline(emb_dim=c, emb_ks=4, emb_hs=1, n_freqs=f,
                                  hidden=16, n_head=4, remat_stages=False)
    params = _jax_init(jm, x)
    tm = _port(toff.GridNetBlockOffline(c, 4, 1, f, 16, 4), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, _jax_apply(jm, params, x), 1e-4)


def test_small_embed_tfgridnet_matches_jax():
    cfg = dict(embed_dim=32, n_fft=32, stride=16, n_imics=2, n_layers=2,
               emb_dim=16, lstm_hidden_units=16)
    x = _rand((2, 2, 400), 7, 0.1)
    jm = joff.EmbedTFGridNet(**cfg)
    params = _jax_init(jm, x)
    tm = _port(toff.EmbedTFGridNet(**cfg), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 32)
    _close(got, _jax_apply(jm, params, x), 1e-4)


def test_small_offline_separator_matches_jax():
    cfg = dict(num_ch=1, n_fft=32, stride=16, num_blocks=1, n_srcs=2)
    x = _rand((2, 1, 300), 8, 0.1)
    jm = jnet.OfflineSeparatorNet(**cfg)
    params = _jax_init(jm, x)
    tm = _port(tnet.OfflineSeparatorNet(**cfg, device="cpu"), params)
    with torch.no_grad():  # the forward is differentiable (training)
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 2, 300)
    _close(got, _jax_apply(jm, params, x), 1e-4)


# ---- EmbedNet from the checkpoint ------------------------------------------------

@pytest.fixture(scope="module")
def embed_flat():
    return load_npz(EMBED_CKPT)


def test_embed_checkpoint_loads_strictly(embed_flat):
    """All 275 keys map to a parameter of the same shape, none left over
    on either side."""
    sd = params_from_jax(embed_flat)
    own = tnet.EmbedNet(device="cpu").state_dict()
    assert len(embed_flat) == len(sd) == len(own) == 275
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in own.items()}
    net = load_checkpoint(tnet.EmbedNet(device="cpu"), EMBED_CKPT)
    w = net.state_dict()["net.trunk.blocks.2.attn_k.3.weight"]
    _close(w, embed_flat["net/trunk/blocks_2/attn_k_3/kernel"].T, 0)


def test_embed_net_from_checkpoint_matches_jax(embed_flat):
    """Full width (F=65, C=64, H=64, 3 blocks) on a 0.5 s binaural
    enrollment: 126 frames, a 123-step inter-time recurrence."""
    x = _rand((2, 2, 8000), 9, 0.1)
    params = flax.traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in embed_flat.items()})
    want = _jax_apply(jnet.EmbedNet(), params, x)
    net = load_checkpoint(tnet.EmbedNet(device="cpu"), EMBED_CKPT)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (2, 256) and torch.isfinite(got).all()
    _close(got, want, 1e-4)
