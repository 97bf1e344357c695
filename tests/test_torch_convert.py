"""The reference-checkpoint converter in the port (`convert.py`), on the
CPU: the layout rules against the JAX converter's and against torch's own
ops (the cases of `tests/test_convert.py`), and random state_dicts in
the reference's key layout converted into the port's `Net` and
`EmbedNet`, loaded strictly, whose outputs equal the JAX-converted
models' to 1e-4 of the output's peak (float32 in another order; the
model tests' bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookoncetohear_tpu import convert as jconv
from lookoncetohear_tpu.models import net as jnet
from lookoncetohear_tpu_torch import convert as tconv
from lookoncetohear_tpu_torch.models.net import EmbedNet, Net
from lookoncetohear_tpu_torch.weights import flatten_params
from test_convert import _fake_tse_state_dict

TOL = 1e-4


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("rule,shape", [("_t", (5, 7)),
                                        ("_conv2d", (8, 4, 3, 3)),
                                        ("_deconv2d", (6, 4, 3, 3))])
def test_layout_rules_are_the_jax_converters(rule, shape):
    w = _rand(*shape, seed=1)
    got, want = getattr(tconv, rule)(w), getattr(jconv, rule)(w)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_rules_against_torch_ops():
    """A Linear, Conv2d and the streaming deconv, run through the port's
    modules from the converted kernels (weights.params_from_jax's
    rules), equal torch's own ops."""
    from lookoncetohear_tpu_torch.weights import params_from_jax
    torch.manual_seed(2)
    conv = torch.nn.Conv2d(4, 8, (3, 3), padding=(0, 1))
    x = torch.randn(2, 4, 12, 9)
    sd = params_from_jax({"c/kernel": tconv._conv2d(conv.weight.detach()),
                          "c/bias": conv.bias.detach().numpy()})
    got = torch.nn.functional.conv2d(x, sd["c.weight"], sd["c.bias"],
                                     padding=(0, 1))
    torch.testing.assert_close(got, conv(x), atol=1e-5, rtol=1e-5)
    # ConvTranspose2d(k=3, s=1, padding=(2, 1)) == a VALID-in-time conv
    # of the flipped, swapped kernel, padded (0, 1) in frequency
    de = torch.nn.ConvTranspose2d(6, 4, (3, 3), padding=(2, 1))
    x = torch.randn(2, 6, 12, 9)
    sd = params_from_jax({"d/kernel": tconv._deconv2d(de.weight.detach()),
                          "d/bias": de.bias.detach().numpy()})
    got = torch.nn.functional.conv2d(x, sd["d.weight"], sd["d.bias"],
                                     padding=(0, 1))
    torch.testing.assert_close(got, de(x), atol=1e-5, rtol=1e-5)
    lin = torch.nn.Linear(7, 5)
    sd = params_from_jax({"l/kernel": tconv._t(lin.weight.detach()),
                          "l/bias": lin.bias.detach().numpy()})
    x = torch.randn(4, 7)
    torch.testing.assert_close(x @ sd["l.weight"].T + sd["l.bias"], lin(x),
                               atol=1e-5, rtol=1e-5)


def _close(got, want):
    peak = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= TOL * peak, (err, peak)


def test_tse_state_dict_into_net():
    sd = _fake_tse_state_dict()
    tree = tconv.convert_tse_state_dict(sd, n_layers=2)
    want_tree = jconv.convert_tse_state_dict(sd, n_layers=2)
    flat, want_flat = flatten_params(tree), flatten_params(want_tree)
    assert sorted(flat) == sorted(want_flat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], want_flat[k])
    kw = dict(embed_dim=64, stft_chunk_size=128, stft_pad_size=64,
              num_ch=2, D=16, L=2, B=2, H=16, local_atten_len=10,
              use_attn=True)
    net = tconv.load_reference(Net(**kw, device="cpu"), sd)
    x, e = _rand(2, 2, 1600, seed=1), _rand(2, 1, 64, seed=2)
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(e)).numpy()
    want = np.asarray(jnet.Net(**kw).apply(
        {"params": want_tree}, jnp.asarray(x), jnp.asarray(e)))
    assert got.shape == want.shape == (2, 2, 1600)
    _close(got, want)


def _fake_embed_state_dict(D=64, M=2, H=64, E=64, F=33, nh=4):
    rng = np.random.default_rng(3)

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)
    e_dim = int(np.ceil(512 / F))
    vd = D // nh
    sd = {
        "model.conv.0.weight": r(D, 2 * M, 3, 3),
        "model.conv.0.bias": r(D),
        "model.conv.1.weight": r(D),
        "model.conv.1.bias": r(D),
        "model.embed_proj.0.weight": r(E, F * D),
        "model.embed_proj.0.bias": r(E),
        "model.embed_proj.1.weight": r(E),
        "model.embed_proj.1.bias": r(E),
    }
    b = "model.blocks.0"
    for rnn in ("intra_rnn", "inter_rnn"):
        for sfx in ("", "_reverse"):
            sd.update({
                f"{b}.{rnn}.weight_ih_l0{sfx}": r(4 * H, D * 4),
                f"{b}.{rnn}.weight_hh_l0{sfx}": r(4 * H, H),
                f"{b}.{rnn}.bias_ih_l0{sfx}": r(4 * H),
                f"{b}.{rnn}.bias_hh_l0{sfx}": r(4 * H),
            })
    for lin in ("intra_linear", "inter_linear"):
        sd[f"{b}.{lin}.weight"] = r(2 * H, D, 4)
        sd[f"{b}.{lin}.bias"] = r(D)
    for norm in ("intra_norm", "inter_norm"):
        sd[f"{b}.{norm}.gamma"] = r(1, D, 1, 1)
        sd[f"{b}.{norm}.beta"] = r(1, D, 1, 1)
    for h in range(nh):
        for name, w in ((f"attn_conv_Q_{h}", e_dim),
                        (f"attn_conv_K_{h}", e_dim),
                        (f"attn_conv_V_{h}", vd)):
            sd.update({
                f"{b}.{name}.0.weight": r(w, D, 1, 1),
                f"{b}.{name}.0.bias": r(w),
                f"{b}.{name}.1.weight": r(1),
                f"{b}.{name}.2.gamma": r(1, w, 1, F),
                f"{b}.{name}.2.beta": r(1, w, 1, F),
            })
    sd.update({
        f"{b}.attn_concat_proj.0.weight": r(D, D, 1, 1),
        f"{b}.attn_concat_proj.0.bias": r(D),
        f"{b}.attn_concat_proj.1.weight": r(1),
        f"{b}.attn_concat_proj.2.gamma": r(1, D, 1, F),
        f"{b}.attn_concat_proj.2.beta": r(1, D, 1, F),
    })
    return sd


def test_embed_state_dict_into_embednet():
    sd = _fake_embed_state_dict()
    want_tree = jconv.convert_embed_state_dict(sd, n_layers=1, n_head=4)
    kw = dict(embed_dim=64, num_ch=2, n_fft=64, stride=32, num_blocks=1)
    net = tconv.load_reference(EmbedNet(**kw, device="cpu"), sd)
    x = _rand(2, 2, 1600, seed=5)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(jnet.EmbedNet(**kw).apply(
        {"params": want_tree}, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 64)
    _close(got, want)


def test_load_torch_checkpoint(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in _fake_tse_state_dict().items()}
    path = str(tmp_path / "epoch=1.ckpt")
    torch.save({"state_dict": sd, "epoch": 1}, path)
    got = tconv.load_torch_checkpoint(path)
    want = jconv.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    net = Net(embed_dim=64, stft_chunk_size=128, stft_pad_size=64,
              num_ch=2, D=16, L=2, B=2, H=16, local_atten_len=10,
              use_attn=True, device="cpu")
    tconv.load_reference(net, got)
    # a missing tensor is an error, not a silent default
    del got["model.tfgridnet.deconv.bias"]
    with pytest.raises(KeyError):
        tconv.load_reference(net, got)

