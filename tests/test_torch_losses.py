"""The loss registry, PyTorch port vs the JAX package, on the CPU: every
`LossFn` name, PIT's reordering, the spectral losses' filterbanks, and
the CDPAM distance with its weight paths (the JAX `.npz` dump, the JAX
params carried over, and a torch state_dict mapped by
`load_torch_state`).

Tolerances: every loss value 1e-5 relative (float32 in both, the same
formulas; the FFTs and reductions sum in another order); PIT's reordered
estimates exactly (each is one of its inputs); the filterbanks exactly
(both built by the same numpy code); CDPAM distances 1e-5 relative and
its loaded states exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookoncetohear_tpu.losses import cdpam as jcdpam
from lookoncetohear_tpu.losses import spectral as jspec
from lookoncetohear_tpu.losses.loss_fn import LossFn as JLossFn
from lookoncetohear_tpu_torch.losses import cdpam as tcdpam
from lookoncetohear_tpu_torch.losses import spectral as tspec
from lookoncetohear_tpu_torch.losses.loss_fn import LossFn as TLossFn

RTOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _jax_filterbanks_built_eagerly():
    """The JAX spectral losses cache their filterbanks as JAX arrays; one
    first built inside a trace would leak it, so build every one these
    tests use before any is traced."""
    for n_fft in (1024, 2048, 8192, 256):
        jspec.a_weighting(16000, n_fft)
        for n_mels in (128, 32):
            jspec.mel_filterbank(16000, n_fft, n_mels)


def _both(fn_t, fn_j, *arrays, **kw):
    """fn_t on tensors, fn_j jitted on JAX arrays."""
    got = fn_t(*[None if a is None else torch.from_numpy(a)
                 for a in arrays],
               **{k: torch.from_numpy(v) for k, v in kw.items()})
    fn_j = jax.jit(fn_j, static_argnums=tuple(
        i for i, a in enumerate(arrays) if a is None))
    want = fn_j(*[None if a is None else jnp.asarray(a) for a in arrays],
                **{k: jnp.asarray(v) for k, v in kw.items()})
    return got, want


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


@pytest.mark.parametrize("name", ["sisdr", "snr", "sdsdr", "snr_sdsdr",
                                  "fused", "mel", "l1_mel"])
def test_loss_fn_names_match_jax(name):
    """(B, C, T) pairs: unrelated signals and a close estimate."""
    t = 4000 if name in ("mel", "l1_mel") else 700
    g = _rand(2, 2, t, seed=1)
    for e in (_rand(2, 2, t, seed=2), g + _rand(2, 2, t, seed=3,
                                                scale=0.05)):
        got, want = _both(TLossFn(name), JLossFn(name), e, g)
        assert got.shape == () and np.isfinite(got.item())
        _close(got.item(), float(want))


def test_sisdr_with_sum_matches_jax():
    e, g = _rand(2, 2, 500, seed=4), _rand(2, 2, 500, seed=5)
    noise = _rand(2, 2, 500, seed=6)
    got, want = _both(TLossFn("sisdr_with_sum"), JLossFn("sisdr_with_sum"),
                      e, g, noise_estimate=noise, mixture=e + 2 * noise)
    _close(got.item(), float(want))


@pytest.mark.parametrize("reduce", [True, False])
def test_pit_matches_jax_and_reorders_exactly(reduce):
    """Estimates: the swapped targets plus noise in batch row 0, in order
    plus noise in row 1, so rows and channels take both permutations."""
    g1, g2 = _rand(2, 2, 600, seed=7), _rand(2, 2, 600, seed=8)
    n1, n2 = (_rand(2, 2, 600, seed=s, scale=0.1) for s in (9, 10))
    e1 = np.stack([g2[0], g1[1]]) + n1
    e2 = np.stack([g1[0], g2[1]]) + n2
    kw = dict(est1=e1, est2=e2, gt1=g1, gt2=g2)
    if reduce:
        got, want = _both(TLossFn("pit_sisdr"), JLossFn("pit_sisdr"), None,
                          None, **kw)
    else:
        from lookoncetohear_tpu.losses.loss_fn import _pit_sisdr as jpit
        from lookoncetohear_tpu_torch.losses.loss_fn import \
            _pit_sisdr as tpit
        got, want = _both(lambda **k: tpit(None, None, reduce=False, **k),
                          lambda **k: jpit(None, None, reduce=False, **k),
                          **kw)
    _close(got[0].numpy(), np.asarray(want[0]))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[1][0].numpy(), e2[0])
    np.testing.assert_array_equal(got[1][1].numpy(), e1[1])


def test_pit_gradient_matches_jax():
    """The loss SeparationTask trains on, differentiated (1e-5 of the
    gradient's peak)."""
    from lookoncetohear_tpu.losses.loss_fn import _pit_sisdr as jpit
    from lookoncetohear_tpu_torch.losses.loss_fn import _pit_sisdr as tpit
    e = _rand(3, 2, 1, 400, seed=11)
    g = _rand(3, 2, 1, 400, seed=12)
    jg = jax.jit(jax.grad(lambda x: jpit(
        None, None, x[:, 0], x[:, 1], jnp.asarray(g[:, 0]),
        jnp.asarray(g[:, 1]))[0]))(jnp.asarray(e))
    x = torch.from_numpy(e).requires_grad_()
    tpit(None, None, x[:, 0], x[:, 1], torch.from_numpy(g[:, 0]),
         torch.from_numpy(g[:, 1]))[0].backward()
    want = np.asarray(jg)
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def test_unknown_name_refused():
    with pytest.raises(AssertionError, match="nope"):
        TLossFn("nope")


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 1024, 128),
                                             (16000, 64, 8),
                                             (22050, 2048, 40)])
def test_filterbanks_are_the_jax_packages(sr, n_fft, n_mels):
    np.testing.assert_array_equal(
        tspec.mel_filterbank(sr, n_fft, n_mels).numpy(),
        np.asarray(jspec.mel_filterbank(sr, n_fft, n_mels)))
    np.testing.assert_array_equal(tspec.a_weighting(sr, n_fft).numpy(),
                                  np.asarray(jspec.a_weighting(sr, n_fft)))


@pytest.mark.parametrize("mel,weight", [(None, False), (32, True)])
def test_stft_loss_matches_jax(mel, weight):
    """One resolution, including an 8192-point frame over 3000 samples,
    where the centered STFT's reflect pad exceeds the signal."""
    e, g = _rand(3, 3000, seed=13), _rand(3, 3000, seed=14)
    for n_fft, hop in ((256, 64), (8192, 2048)):
        got, want = _both(
            lambda a, b: tspec.stft_loss(a, b, n_fft, hop, mel, 16000,
                                         weight),
            lambda a, b: jspec.stft_loss(a, b, n_fft, hop, mel, 16000,
                                         weight), e, g)
        _close(got.item(), float(want))


# ---- CDPAM --------------------------------------------------------------------

def _pair_inputs():
    return _rand(2, 4096, seed=20, scale=0.1), _rand(2, 4096, seed=21,
                                                      scale=0.1)


def _jax_cdpam(path=None, params=None, batch_stats=None):
    """The JAX package's CDPAM holding the weights of an `.npz` in its
    layout, or the given params and batch stats (its own random init,
    which runs the network op by op, is not under test)."""
    j = jcdpam.CDPAM.__new__(jcdpam.CDPAM)
    j.encoder, j.input_sr = jcdpam.CDPAMEncoder(), 16000
    if path is not None:
        j._load(path)
    else:
        j.params, j.batch_stats = params, batch_stats
    return j


# the JAX distance, compiled once per input shape, the weights passed in
_jax_distance = jax.jit(lambda p, bs, x, y: _jax_cdpam(
    params=p, batch_stats=bs)(x, y))


def _distances(t, j, x=None, y=None):
    if x is None:
        x, y = _pair_inputs()
    got = t(torch.from_numpy(x), torch.from_numpy(y)).item()
    rows = (-1, x.shape[-1])                     # as LossFn flattens
    want = float(_jax_distance(j.params, j.batch_stats,
                               jnp.asarray(x.reshape(rows)),
                               jnp.asarray(y.reshape(rows))))
    assert 1e-4 < got < 4
    return got, want


@pytest.fixture(scope="module")
def jax_cdpam(tmp_path_factory):
    """A JAX CDPAM (the weights of the port's seed-7 network, written by
    the port and read by the JAX package) and the JAX package's own
    `.npz` dump of it."""
    d = tmp_path_factory.mktemp("cdpam")
    tcdpam.CDPAM(seed=7).save(str(d / "port.npz"))
    j = _jax_cdpam(str(d / "port.npz"))
    j.save(str(d / "jax.npz"))
    return j, str(d / "jax.npz")


def test_cdpam_from_a_jax_npz_dump(jax_cdpam, tmp_path):
    j, path = jax_cdpam
    t = tcdpam.CDPAM(weights=path)
    assert t.pretrained
    _close(*_distances(t, j))
    # the port's dump is the JAX package's file, array for array
    t.save(str(tmp_path / "port.npz"))
    with np.load(path) as want, np.load(str(tmp_path / "port.npz")) as got:
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the JAX params and batch stats carried over directly
    t2 = tcdpam.CDPAM(seed=3)
    t2.load_jax_state(j.params, j.batch_stats)
    for k, v in t.flat_state().items():
        np.testing.assert_array_equal(t2.flat_state()[k], v, err_msg=k)


def _torch_state(m, bias=True):
    """A torch state_dict in the `cdpam` package's module layout: random
    tensors of each of the network's shapes, the convolutions at a gain
    near 1 a layer (as a trained network's BatchNorms keep it)."""
    flat = m.flat_state()
    g = torch.Generator().manual_seed(0)
    sd = {}
    for i in range(16):
        k = flat[f"params/conv_{i}/kernel"].shape        # [k, in, out]
        sd[f"base_encoder.conv{i}.weight"] = torch.randn(
            k[2], k[1], k[0], generator=g) / (k[0] * k[1]) ** 0.5
        if bias:
            sd[f"base_encoder.conv{i}.bias"] = 0.1 * torch.randn(
                k[2], generator=g)
        sd[f"base_encoder.bn{i}.weight"] = 1 + 0.1 * torch.randn(
            k[2], generator=g)
        sd[f"base_encoder.bn{i}.bias"] = 0.1 * torch.randn(k[2], generator=g)
        sd[f"base_encoder.bn{i}.running_mean"] = 0.1 * torch.randn(
            k[2], generator=g)
        sd[f"base_encoder.bn{i}.running_var"] = 0.5 + torch.rand(
            k[2], generator=g)
    for name in ("acoustic_fc0", "acoustic_fc1", "content_fc0",
                 "content_fc1"):
        w = flat[f"params/{name}/kernel"]
        sd[f"proj.{name}.weight"] = 0.05 * torch.randn(w.shape[1],
                                                       w.shape[0],
                                                       generator=g)
        sd[f"proj.{name}.bias"] = 0.05 * torch.randn(w.shape[1], generator=g)
    return sd


def test_cdpam_load_torch_state_matches_jax(tmp_path):
    """With and without conv biases (Conv1d(bias=False) before BN)."""
    t = tcdpam.CDPAM(seed=0)
    t.save(str(tmp_path / "init.npz"))
    j = _jax_cdpam(str(tmp_path / "init.npz"))
    for bias in (False, True):
        path = str(tmp_path / f"cdpam{bias}.pth")
        torch.save({"state": _torch_state(t, bias)}, path)
        j.load_torch_state(path)
        t.load_torch_state(path)
        flat = {**{f"params/{k}": v for k, v in
                   jcdpam._flatten(j.params).items()},
                **{f"batch_stats/{k}": v for k, v in
                   jcdpam._flatten(j.batch_stats).items()}}
        got = t.flat_state()
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        _close(*_distances(t, j))
    # the loss follows its input through autograd, its weights do not
    x, y = (torch.from_numpy(a) for a in _pair_inputs())
    x.requires_grad_()
    t(x, y).backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    assert all(p.grad is None for p in t.encoder.parameters())


def test_cdpam_incomplete_torch_state_raises(tmp_path):
    t = tcdpam.CDPAM(seed=0)
    sd = _torch_state(t)
    for k in [k for k in sd if "content" in k]:
        del sd[k]
    path = str(tmp_path / "partial.pth")
    torch.save(sd, path)
    with pytest.raises(ValueError, match="did not cover"):
        t.load_torch_state(path)


def test_cdpam_weights_contract(jax_cdpam, monkeypatch):
    """Random weights only with allow_random=True; the environment
    variable names the weights as `weights=` does."""
    monkeypatch.delenv("LOOKONCE_CDPAM_WEIGHTS", raising=False)
    with pytest.raises(ValueError, match="allow_random"):
        TLossFn("cdpam")
    fn = TLossFn("cdpam", allow_random=True)
    assert not fn._fn.pretrained
    x = _rand(2, 2, 2048, seed=30)
    assert abs(fn(torch.from_numpy(x), torch.from_numpy(x)).item()) < 1e-8
    j, path = jax_cdpam
    monkeypatch.setenv("LOOKONCE_CDPAM_WEIGHTS", path)
    fn = TLossFn("cdpam")
    assert fn._fn.pretrained
    y = _rand(2, 2, 2048, seed=31, scale=0.5)
    _close(*_distances(fn, j, x, y))


@pytest.mark.parametrize("sr_in,sr_out,n", [(16000, 22050, 1600),
                                            (22050, 16000, 999),
                                            (16000, 16000, 10)])
def test_resample_fft_matches_jax(sr_in, sr_out, n):
    x = _rand(2, n, seed=40)
    got = tcdpam.resample_fft(torch.from_numpy(x), sr_in, sr_out).numpy()
    want = np.asarray(jcdpam.resample_fft(jnp.asarray(x), sr_in, sr_out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
