"""The d-vector precompute (`data/prep/dvector_embeddings.py`), TitaNet's
precompute (`data/prep/nemo_embed.py`) and the eval's `--embed_from_wav`,
PyTorch port vs the JAX package, on the CPU, over a scaper-layout
directory written here (2 speakers x 2 utterances at two lengths, one of
the speakers in stereo).

resemblyzer and NeMo are not installed, so both packages run against
stand-in modules put into `sys.modules`: deterministic embeddings of the
audio they are given (a unit vector of segment RMS values), and records
of the device each was handed.

Tolerances and why:
  * the embednet backend: atol/rtol 1e-4 (the module slices' bound; the
    same float32 network in another summation order);
  * the stand-in backends: equal (the same numpy code on the same file);
  * the eval CSV: `DB_TOL` (tests/test_torch_eval.py).
"""

import json
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from lookoncetohear_tpu import ts_hear_test as jcli
from lookoncetohear_tpu import utils as jutils
from lookoncetohear_tpu.data.prep import dvector_embeddings as jdv
from lookoncetohear_tpu.data.prep import nemo_embed as jnemo
from lookoncetohear_tpu.train.npz_ckpt import save_npz
from lookoncetohear_tpu_torch import ts_hear_test as tcli
from lookoncetohear_tpu_torch.data.prep import dvector_embeddings as tdv
from lookoncetohear_tpu_torch.data.prep import nemo_embed as tnemo
from test_eval_harness import TINY_EMBED_CFG, TINY_TSE_CFG
from test_torch_convert import _fake_embed_state_dict
from test_torch_eval import DB_TOL, _args, _hold, _lightning_ckpt, _write

SR = 16000
LENGTHS = (0.5, 0.75)          # seconds: one jit compile each on the JAX side
SPEAKERS = ("19", "27")
EMBED_DIM = 64                 # the tiny TSE config's embedding width

# the smallest enrollment config that returns audio, so the JAX CLI's
# --embed_from_wav runs to its end: EmbedNet returns a d-vector, which
# resemblyzer cannot embed
TINY_SEP_CFG = {
    "pl_module": "lookoncetohear_tpu.train.tasks.SeparationTask",
    "pl_module_args": {
        "model": "lookoncetohear_tpu.models.net.OfflineSeparatorNet",
        "model_params": {"num_ch": 2, "n_fft": 64, "stride": 32,
                         "num_blocks": 1},
        "lr": 1e-3},
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops in loops: one torch thread, as the other small-op files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """root/<split>/<speaker>/<utterance>.wav, float32 wav; the second
    speaker's files in stereo."""
    root = tmp_path_factory.mktemp("scaper") / "root"
    g = np.random.default_rng(0)
    for s, spk in enumerate(SPEAKERS):
        d = root / "dev-clean" / spk
        d.mkdir(parents=True)
        for u, secs in enumerate(LENGTHS):
            n = int(secs * SR)
            t = np.arange(n) / SR
            x = (0.3 * np.sin(2 * np.pi * (120 + 40 * s + 15 * u) * t)
                 + 0.05 * g.standard_normal(n)).astype(np.float32)
            if s == 1:
                x = np.stack([x, 0.7 * np.roll(x, 3)], 1)
            wavfile.write(str(d / f"{spk}-0-{u}.wav"), SR, x)
    return str(root)


def _read(path):
    sr, x = wavfile.read(path)
    return (x.mean(1) if x.ndim == 2 else x).astype(np.float32), sr


def _segment_rms(wav) -> np.ndarray:
    seg = np.array([np.sqrt(np.mean(s.astype(np.float64) ** 2))
                    for s in np.array_split(wav, EMBED_DIM)])
    return (seg / np.linalg.norm(seg)).astype(np.float32)


def _resemblyzer(devices: list):
    """A stand-in `resemblyzer`: `preprocess_wav` takes a path or a 1-D
    waveform, as the package does (its silence trimming takes len() of
    the waveform, so anything but 1-D fails there too)."""
    mod = types.ModuleType("resemblyzer")

    class VoiceEncoder:
        def __init__(self, device=None):
            devices.append(device)

        def embed_utterance(self, wav):
            return _segment_rms(wav)

    def preprocess_wav(fpath_or_wav, source_sr=None):
        if isinstance(fpath_or_wav, (str, os.PathLike)):
            fpath_or_wav, source_sr = _read(fpath_or_wav)
        wav = np.asarray(fpath_or_wav, np.float32)
        if wav.ndim != 1 or source_sr != SR:
            raise ValueError(f"wav {wav.shape} at {source_sr} Hz")
        return wav

    mod.VoiceEncoder, mod.preprocess_wav = VoiceEncoder, preprocess_wav
    return mod


def _nemo(devices: list):
    """Stand-in `nemo`, `nemo.collections` and `nemo.collections.asr`."""
    class EncDecSpeakerLabelModel:
        @classmethod
        def from_pretrained(cls, name):
            assert name == "titanet_large"
            return cls()

        def to(self, device):
            devices.append(device)
            return self

        def eval(self):
            return self

        def get_embedding(self, path):
            return torch.from_numpy(_segment_rms(_read(path)[0]))[None]

    mods = {n: types.ModuleType(n) for n in
            ("nemo", "nemo.collections", "nemo.collections.asr")}
    mods["nemo"].collections = mods["nemo.collections"]
    mods["nemo.collections"].asr = mods["nemo.collections.asr"]
    mods["nemo.collections.asr"].models = types.SimpleNamespace(
        EncDecSpeakerLabelModel=EncDecSpeakerLabelModel)
    return mods


def _run_jax(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    main()


def _outputs(out_dir):
    """{split/file: {utterance: embedding}} of an output directory."""
    got = {}
    for dset in sorted(os.listdir(out_dir)):
        for f in sorted(os.listdir(os.path.join(out_dir, dset))):
            path = os.path.join(out_dir, dset, f)
            got[f"{dset}/{f}"] = (
                torch.load(path, weights_only=False) if f.endswith(".pt")
                else dict(np.load(path)))
    return got


def _same_files(got, want, **tol):
    assert list(got) == list(want)
    for f in want:
        assert list(got[f]) == list(want[f]), f
        for k in want[f]:
            np.testing.assert_allclose(got[f][k], want[f][k], **tol,
                                       err_msg=f"{f}:{k}")


def _lightning_embed_ckpt(path):
    sd = {k: torch.from_numpy(v) for k, v in _fake_embed_state_dict().items()}
    torch.save({"state_dict": sd, "epoch": 3}, path)


@pytest.mark.parametrize("weights", ["npz", "lightning"])
def test_embednet_backend_matches_jax(tmp_path, monkeypatch, corpus,
                                      weights):
    """The embednet backend of both packages over the same directory:
    the same files, utterances and embeddings (1e-4); from a
    JAX-initialised npz, and from a reference Lightning `best.ckpt`
    that both packages convert."""
    cfg = _write(tmp_path, TINY_EMBED_CFG, "embed.json")
    run_dir = tmp_path / "run"
    run_dir.mkdir()
    if weights == "npz":
        npz = _jax_init_npz(tmp_path, TINY_EMBED_CFG, "embed.npz")
        shutil.copy(npz, run_dir / "best.ckpt")      # the port's trainer's name
        load_task = jcli.load_task
        monkeypatch.setattr(jcli, "load_task", lambda config, rd, ckpt=None:
                            load_task(config, rd, ckpt=npz))
    else:
        _lightning_embed_ckpt(run_dir / "best.ckpt")
    flags = ["--root_dir", corpus, "--backend", "embednet",
             "--embednet_config", cfg, "--embednet_run_dir", str(run_dir)]
    _run_jax(monkeypatch, jdv.main,
             flags + ["--output_dir", str(tmp_path / "jax")])
    tdv.main(flags + ["--output_dir", str(tmp_path / "port"),
                      "--device", "cpu"])
    got, want = _outputs(tmp_path / "port"), _outputs(tmp_path / "jax")
    assert list(want) == ["dev-clean/19.npz", "dev-clean/19.pt",
                          "dev-clean/27.npz", "dev-clean/27.pt"]
    _same_files(got, want, atol=1e-4, rtol=1e-4)
    for v in got["dev-clean/19.npz"].values():
        assert v.shape == (EMBED_DIM,) and v.dtype == np.float32


def test_stand_in_backends_match_jax(tmp_path, monkeypatch, corpus):
    """resemblyzer (dvector_embeddings) and NeMo (nemo_embed) through
    stand-in modules: both packages write the same files under the same
    names; the port hands each model its device."""
    devices: list = []
    monkeypatch.setitem(sys.modules, "resemblyzer", _resemblyzer(devices))
    for name, mod in _nemo(devices).items():
        monkeypatch.setitem(sys.modules, name, mod)
    for pkg, jmain, tmain in (("dvector", jdv.main, tdv.main),
                              ("nemo", jnemo.main, tnemo.main)):
        flags = ["--root_dir", corpus]
        _run_jax(monkeypatch, jmain,
                 flags + ["--output_dir", str(tmp_path / f"jax_{pkg}")])
        n = len(devices)
        tmain(flags + ["--output_dir", str(tmp_path / f"port_{pkg}"),
                       "--device", "cpu"])
        assert devices[n:] == [torch.device("cpu")], pkg
        got = _outputs(tmp_path / f"port_{pkg}")
        _same_files(got, _outputs(tmp_path / f"jax_{pkg}"), rtol=0, atol=0)
        assert len(got) == (4 if pkg == "dvector" else 2)


@pytest.mark.parametrize("pkg", ["resemblyzer", "nemo"])
def test_missing_packages_raise_import_error(tmp_path, monkeypatch, corpus,
                                             pkg):
    monkeypatch.setitem(sys.modules, pkg, None)
    jmain, tmain = (jdv.main, tdv.main) if pkg == "resemblyzer" \
        else (jnemo.main, tnemo.main)
    flags = ["--root_dir", corpus, "--output_dir", str(tmp_path / "out")]
    with pytest.raises(ImportError, match=pkg):
        _run_jax(monkeypatch, jmain, flags)
    with pytest.raises(ImportError, match=pkg):
        tmain(flags + ["--device", "cpu"])
    assert not os.path.exists(tmp_path / "out")


def test_existing_output_split_is_refused(tmp_path, monkeypatch, corpus):
    monkeypatch.setitem(sys.modules, "resemblyzer", _resemblyzer([]))
    (tmp_path / "out" / "dev-clean").mkdir(parents=True)
    flags = ["--root_dir", corpus, "--output_dir", str(tmp_path / "out")]
    with pytest.raises(AssertionError, match="exists"):
        _run_jax(monkeypatch, jdv.main, flags)
    with pytest.raises(FileExistsError, match="exists"):
        tdv.main(flags + ["--device", "cpu"])
    assert os.listdir(tmp_path / "out" / "dev-clean") == []


def _jax_init_npz(tmp_path, cfg, name):
    """The PRNGKey(0) init of `cfg`'s JAX model on a [1, 2, 4000] input
    (jit-compiled: faster than flax's op-by-op init), as a p// npz."""
    task = jutils.import_attr(cfg["pl_module"])(**cfg["pl_module_args"])
    params = jax.jit(task.model.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 2, 4000)))["params"]
    path = str(tmp_path / name)
    save_npz(path, params)
    return path


def test_embed_from_wav_matches_the_jax_cli(tmp_path, monkeypatch):
    """--embed_from_wav with the stand-in resemblyzer: the enrollment
    net's output audio re-embedded, both CLIs from the same weights (the
    separator's JAX init, the TSE net's reference Lightning file in each
    run dir); the CSVs agree row by row (`DB_TOL`), and the port's
    encoder was handed the device."""
    devices: list = []
    monkeypatch.setitem(sys.modules, "resemblyzer", _resemblyzer(devices))
    # one batch of 4 scenes: the JAX CLI compiles both nets once
    cfg = dict(TINY_TSE_CFG, test_data_args=dict(
        TINY_TSE_CFG["test_data_args"], n_samples=4))
    tsh = _write(tmp_path, cfg, "tsh.json")
    sep = _write(tmp_path, TINY_SEP_CFG, "sep.json")
    extra = dict(enroll_ckpt=_jax_init_npz(tmp_path, TINY_SEP_CFG, "sep.npz"),
                 embed_from_wav=True)
    csvs = []
    for cli, sub, kw in ((jcli, "jax", {}),
                         (tcli, "port", {"device": "cpu"})):
        run_dir = str(tmp_path / sub)
        os.makedirs(run_dir)
        _lightning_ckpt(os.path.join(run_dir, "best.ckpt"))
        cli.run(_args(tsh, run_dir, sep, str(tmp_path / "sep_run"), **extra,
                      **kw))
        csvs.append(os.path.join(run_dir, "results_test_sep_run.csv"))
    assert devices == [None, torch.device("cpu")]
    from lookoncetohear_tpu_torch import eval_check
    res = _hold(csvs[1], eval_check.read_csv(csvs[0]), DB_TOL)
    assert res["rows"] == 4


def test_embed_from_wav_needs_an_enrollment_net_that_returns_audio(
        tmp_path, monkeypatch):
    """With EmbedNet as the enrollment net, --embed_from_wav hands
    resemblyzer a d-vector's mean, a scalar, which it cannot embed: both
    CLIs stop at the first batch (the stand-in's ValueError, where the
    package's silence trimming would raise a TypeError)."""
    monkeypatch.setitem(sys.modules, "resemblyzer", _resemblyzer([]))
    cfg = dict(TINY_TSE_CFG, test_data_args=dict(
        TINY_TSE_CFG["test_data_args"], n_samples=4))
    tsh = _write(tmp_path, cfg, "tsh.json")
    emb = _write(tmp_path, TINY_EMBED_CFG, "embed.json")
    extra = dict(embed_from_wav=True, enroll_ckpt=_jax_init_npz(
        tmp_path, TINY_EMBED_CFG, "embed.npz"))
    for cli, sub, kw in ((jcli, "jax", {}),
                         (tcli, "port", {"device": "cpu"})):
        run_dir = str(tmp_path / sub)
        os.makedirs(run_dir)
        _lightning_ckpt(os.path.join(run_dir, "best.ckpt"))
        with pytest.raises(ValueError, match=r"wav \(\)"):
            cli.run(_args(tsh, run_dir, emb, str(tmp_path / "erun"), **extra,
                          **kw))


def test_embed_from_wav_needs_resemblyzer(tmp_path, monkeypatch):
    """Without resemblyzer the flag is an ImportError naming it, raised
    before any work (no model, no dataset, no CSV)."""
    monkeypatch.setitem(sys.modules, "resemblyzer", None)
    tsh = _write(tmp_path, TINY_TSE_CFG, "tsh.json")
    with pytest.raises(ImportError, match="resemblyzer"):
        tcli.run(_args(tsh, str(tmp_path), embed_from_wav=True,
                       ckpt=str(tmp_path / "missing.npz"), device="cpu"))
    assert os.listdir(tmp_path) == ["tsh.json"]


def test_the_configs_read_the_written_files(tmp_path, monkeypatch, corpus):
    """The `.pt` and `.npz` files the port writes are what the datasets'
    `_load_embedding_map` reads back, bit for bit."""
    from lookoncetohear_tpu_torch.data.datasets import _load_embedding_map
    monkeypatch.setitem(sys.modules, "resemblyzer", _resemblyzer([]))
    tdv.main(["--root_dir", corpus, "--output_dir", str(tmp_path),
              "--device", "cpu"])
    d = str(tmp_path / "dev-clean")
    for spk in SPEAKERS:
        got = _load_embedding_map(d, spk)               # the .pt
        want = dict(np.load(os.path.join(d, f"{spk}.npz")))
        assert list(got) == [f"{spk}-0-0.wav", f"{spk}-0-1.wav"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        os.remove(os.path.join(d, f"{spk}.pt"))
        for k, v in _load_embedding_map(d, spk).items():
            np.testing.assert_array_equal(v, want[k])
