"""The real-corpus data pipeline, PyTorch port vs the JAX package, on the
CPU: audio IO, the loudness meter, the noise generators, scene specs and
their renderer, every spatializer, the MixLibriSpeech datasets, and the
prep CLIs, on a generated micro-corpus in the reference configs' layout
(`data/prep/synth_corpus.py`) with generated SOFA, ASH and PRA fixtures.

Both packages run the same numpy and scipy arithmetic in the same
order, so everything is held bit for bit: val/test items as they are,
train items under the same `random` / `np.random` seeds. The SOFA cases
need h5py and skip by name without it.
"""

import json
import os
import random
import shutil

import numpy as np
import pytest

from lookoncetohear_tpu.data import audio_io as jio
from lookoncetohear_tpu.data import augmentations as jaug
from lookoncetohear_tpu.data import dataset_variants as jvar
from lookoncetohear_tpu.data import datasets as jds
from lookoncetohear_tpu.data import loudness as jloud
from lookoncetohear_tpu.data import scene as jscene
from lookoncetohear_tpu.data.prep import generate_jams as jgen
from lookoncetohear_tpu.data.prep import librispeech2scaper as jl2s
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.data import audio_io as tio
from lookoncetohear_tpu_torch.data import augmentations as taug
from lookoncetohear_tpu_torch.data import dataset_variants as tvar
from lookoncetohear_tpu_torch.data import datasets as tds
from lookoncetohear_tpu_torch.data import loudness as tloud
from lookoncetohear_tpu_torch.data import scene as tscene
from lookoncetohear_tpu_torch.data.prep import generate_jams as tgen
from lookoncetohear_tpu_torch.data.prep import librispeech2scaper as tl2s
from lookoncetohear_tpu_torch.data.prep.synth_corpus import write_corpus

SR = 16000
SCENES = 6
SCENE_SECONDS = 0.5


def same(a, b, where="item"):
    """a and b equal bit for bit, down through dicts, lists and tuples,
    with the same array dtypes and container types."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _sofa(path, n_dirs, ir_len=32):
    import h5py
    ir = np.zeros((n_dirs, 2, ir_len))
    for m in range(n_dirs):
        ir[m, 0, m % 5] = 1.0
        ir[m, 1, (2 * m) % 7] = 0.8
        ir[m, :, 8:] = 0.01 * np.cos(m + np.arange(ir_len - 8))
    with h5py.File(path, "w") as f:
        f.create_dataset("Data.IR", data=ir)
        f.create_dataset("Data.SamplingRate", data=np.array([SR * 1.0]))


def _sofa_list(root, name, n_dirs):
    """A two-subject SOFA set with its list file; None without h5py."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        return None
    d = os.path.join(root, name)
    os.makedirs(d)
    for s in ("s1.sofa", "s2.sofa"):
        _sofa(os.path.join(d, s), n_dirs)
    with open(os.path.join(d, "list.txt"), "w") as f:
        f.write("s1.sofa\ns2.sofa")
    return os.path.join(d, "list.txt")


def _ir(rng, n_ch=2, n=48):
    ir = 0.05 * rng.standard_normal((n_ch, n))
    ir[:, 0] = 1.0
    return ir.astype(np.float32)


def make_corpus(root, scenes=SCENES, seconds=SCENE_SECONDS):
    """The micro-corpus: 4 speakers x 2 utterances of 2 s per split,
    WHAM!-style noise, d-vectors and every CATT room (synth_corpus),
    scene specs of `seconds` per split, and SOFA (CIPIC with its 610
    directions, APL, RRBRIR), ASH and PRA fixtures."""
    root = str(root)
    c = write_corpus(root, n_speakers=4, n_utts=2, seconds=2.0,
                     ir_len=32)
    for s, split in enumerate(("train-clean-360", "dev-clean",
                               "test-clean")):
        jscene.generate_scene_specs(
            c[split]["fg"], c["bg"], c[split]["jams"],
            num_soundscapes=scenes, seed=s + 3,
            bg_labels=[["tr", "cv", "tt"][s]], duration=seconds,
            event_duration_min=seconds, event_duration_max=seconds)
    c["cipic"] = _sofa_list(root, "cipic", 610)
    c["apl"] = _sofa_list(root, "apl", 8)
    c["rrbrir"] = _sofa_list(root, "rrbrir", 24)
    rng = np.random.default_rng(11)
    c["ash"] = os.path.join(root, "ash")
    for room in ("05A", "06", "03", "04", "01", "02"):
        d = os.path.join(c["ash"], f"R{room}")
        os.makedirs(d)
        for cfg in ("1", "2"):
            for az in ("0", "30", "-30", "90"):
                tio.write_wav(os.path.join(d, f"BRIR_R{room}_C{cfg}_E0_A"
                                              f"{az}.wav"), _ir(rng), SR)
    c["pra"] = os.path.join(root, "pra")
    angles = [0, 45, 90, 95, 135, 180, 270]
    for r in range(10):
        d = os.path.join(c["pra"], f"room{r:02d}")
        os.makedirs(d)
        with open(os.path.join(d, "metadata.json"), "w") as f:
            json.dump({"rir_params": {"angles": angles}}, f)
        for a in range(len(angles)):
            tio.write_wav(os.path.join(d, f"rir_{a:02d}.wav"),
                          _ir(rng, 3), SR)
    return c


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


# ---- audio IO, loudness, noise ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int16", "int32", "uint8"])
def test_audio_io_reads_as_the_jax_package(tmp_path, dtype):
    from scipy.io import wavfile
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (2, 3001))
    if dtype == "float32":
        data = x.T.astype(np.float32)
    elif dtype == "uint8":
        data = ((x.T + 1) * 127).astype(np.uint8)
    else:
        scale = np.iinfo(dtype).max
        data = (x.T * scale).astype(dtype)
    p = str(tmp_path / "a.wav")
    wavfile.write(p, 22050, data)
    got, want = tio.read_audio(p), jio.read_audio(p)
    same(got, want)
    for sr in (16000, 22050, 44100):
        same(tio.resample(got[0], 22050, sr), jio.resample(want[0], 22050,
                                                           sr))
    tio.write_wav(str(tmp_path / "t.wav"), got[0], 8000)
    jio.write_wav(str(tmp_path / "j.wav"), got[0], 8000)
    assert open(tmp_path / "t.wav", "rb").read() == \
        open(tmp_path / "j.wav", "rb").read()


def test_flac_needs_soundfile(tmp_path):
    p = tmp_path / "a.flac"
    p.write_bytes(b"")
    try:
        import soundfile  # noqa: F401
    except ImportError:
        for mod in (tio, jio):
            with pytest.raises(ImportError, match="soundfile"):
                mod.read_audio(str(p))
    else:
        with pytest.raises(RuntimeError):
            tio.read_audio(str(p))


@pytest.mark.parametrize("seconds", [0.2, 3.0])
def test_loudness_is_the_jax_packages(seconds):
    rng = np.random.default_rng(2)
    n = int(seconds * SR)
    burst = np.zeros(n)
    burst[: n // 5] = np.sin(2 * np.pi * 500 * np.arange(n // 5) / SR)
    for x in (0.1 * rng.standard_normal(n), burst,
              rng.standard_normal((2, n)), np.zeros(n)):
        for sr in (16000, 44100):
            assert tloud.integrated_loudness(x, sr) == \
                jloud.integrated_loudness(x, sr)
            assert tloud.gain_to_target(x, sr, -25.0) == \
                jloud.gain_to_target(x, sr, -25.0)


@pytest.mark.parametrize("name", ["generate_white_noise",
                                  "generate_pink_noise",
                                  "generate_brown_noise"])
def test_noise_generators_are_the_jax_packages(name):
    for shape in ((2, 1000), (3, 777)):
        got = getattr(taug, name)(shape, 0.05, np.random.default_rng(4))
        same(got, getattr(jaug, name)(shape, 0.05,
                                      np.random.default_rng(4)))


# ---- scenes ---------------------------------------------------------------

def test_scene_specs_are_the_jax_packages(corpus, tmp_path):
    split = corpus["dev-clean"]
    for mod, out in ((tscene, tmp_path / "t"), (jscene, tmp_path / "j")):
        mod.generate_scene_specs(split["fg"], corpus["bg"], str(out),
                                 num_soundscapes=4, seed=9,
                                 bg_labels=["cv"])
    for d in sorted(os.listdir(tmp_path / "j")):
        for f in ("mixture.jams", "mixture.txt"):
            assert (tmp_path / "t" / d / f).read_bytes() == \
                (tmp_path / "j" / d / f).read_bytes()
    scene = tscene.load_scene(str(tmp_path / "t" / "00000002"))
    tscene.save_scene(scene, str(tmp_path / "again"))
    assert tscene.load_scene(str(tmp_path / "again")) == scene
    want =jscene.load_scene(str(tmp_path / "j" / "00000002"))
    assert [vars(e) for e in scene.events] == [vars(e) for e in want.events]
    assert (scene.duration, scene.sr, scene.ref_db) == \
        (want.duration, want.sr, want.ref_db)


def test_render_scene_is_the_jax_packages(corpus):
    split = corpus["test-clean"]
    for i in range(SCENES):
        d = os.path.join(split["jams"], "%08d" % i)
        got = tscene.render_scene(d, split["fg"], corpus["bg"])
        want = jscene.render_scene(d, split["fg"], corpus["bg"])
        same(got[0], want[0])
        same(got[2], want[2])
        same(got[3], want[3])


# ---- spatializers ------------------------------------------------------

def _sims(corpus, name, dset):
    if name in ("CIPIC", "APL", "RRBRIR", "MultiCh"):
        pytest.importorskip("h5py")
    arg = {"CIPIC": corpus["cipic"], "APL": corpus["apl"],
           "RRBRIR": corpus["rrbrir"], "ASH": corpus["ash"],
           "CATTRIR": corpus["catt"], "PRA": corpus["pra"],
           "MultiCh": [corpus["cipic"], corpus["rrbrir"], corpus["ash"],
                       corpus["catt"]]}[name]
    return (tds.make_simulator(name, arg, SR, dset),
            jds.make_simulator(name, arg, SR, dset))


@pytest.mark.parametrize("name", ["CIPIC", "APL", "RRBRIR", "ASH",
                                  "CATTRIR", "PRA", "MultiCh"])
def test_spatializers_are_the_jax_packages(corpus, name):
    rng = np.random.default_rng(5)
    srcs = [rng.standard_normal(4000).astype(np.float32) for _ in range(3)]
    noise = rng.standard_normal(4000).astype(np.float32)
    for dset in ("train", "val", "test"):
        tsim, jsim = _sims(corpus, name, dset)
        for seed in (1, 2, 77):
            for f2f in (None, 0, 2):
                got = tsim.simulate(srcs, noise, seed, face_to_face_idx=f2f)
                want = jsim.simulate(srcs, noise, seed,
                                     face_to_face_idx=f2f)
                same(tuple(got), tuple(want), f"{name} {dset} {seed} {f2f}")


def test_motion_and_sofa_gates(corpus):
    """The motion branches build the port's own moving-source simulator
    (renders: tests/test_torch_motion.py); an unknown type raises."""
    from lookoncetohear_tpu_torch.data.motion import CIPICMotionSimulator
    with pytest.raises(NotImplementedError, match="nope"):
        tds.make_simulator("nope", None, SR, "val")
    if corpus["cipic"] is None:          # the SOFA fixtures need h5py
        pytest.importorskip("h5py")
    multi = [corpus["cipic"], corpus["rrbrir"], corpus["ash"],
             corpus["catt"]]
    for kw, lists in ((dict(hrtf_type="MultiCh", use_motion=True), multi),
                      (dict(hrtf_type="CIPIC_MOTION"), corpus["cipic"])):
        sim = tds.make_simulator(hrtf_list=lists, sr=SR, dset="val", **kw)
        if kw["hrtf_type"] == "MultiCh":
            sim = sim.simulators[0]
        assert type(sim) is CIPICMotionSimulator


# ---- datasets ---------------------------------------------------------------

SPLIT_DIR = {"train": "train-clean-360", "val": "dev-clean",
             "test": "test-clean"}


def _args(corpus, dset, hrtf_type="CATTRIR", **kw):
    split = corpus[SPLIT_DIR[dset]]
    hrtf = {"CATTRIR": corpus["catt"], "CIPIC": corpus["cipic"],
            "MultiCh": [corpus["cipic"], corpus["rrbrir"], corpus["ash"],
                        corpus["catt"]]}[hrtf_type]
    if hrtf_type != "CATTRIR":
        pytest.importorskip("h5py")
    return dict(fg_dir=split["fg"], bg_dir=corpus["bg"],
                embed_dir=split["embed"], jams_dir=split["jams"],
                hrtf_list=hrtf, dset=dset, sr=SR, hrtf_type=hrtf_type, **kw)


def _hold(tds_, jds_, dset, seed=0):
    """Every item of the two datasets equal; train items under the same
    `random` and `np.random` seeds."""
    assert len(tds_) == len(jds_)
    for i in range(len(jds_)):
        random.seed(seed + i)
        np.random.seed(seed + i)
        want = jds_[i]
        random.seed(seed + i)
        np.random.seed(seed + i)
        same(tds_[i], want, f"{dset} item {i}")


@pytest.mark.parametrize("dset,hrtf_type,kw", [
    ("val", "CATTRIR", {}), ("test", "CATTRIR", {}),
    ("train", "CATTRIR", {}),
    ("train", "CATTRIR", dict(augment=True, variant="base")),
    ("val", "MultiCh", {}), ("train", "MultiCh", dict(noise_scale=2.0)),
])
def test_noisy_enroll_items_are_the_jax_packages(corpus, dset, hrtf_type,
                                                 kw):
    args = _args(corpus, dset, hrtf_type, **kw)
    t, j = tds.MixLibriSpeechNoisyEnroll(**args), \
        jds.MixLibriSpeechNoisyEnroll(**args)
    assert t.speaker_info == j.speaker_info and t.speaker_info
    _hold(t, j, dset)
    inputs, targets = t[0]
    assert set(inputs) == tds.INPUT_KEYS == jds.INPUT_KEYS
    assert set(targets) == tds.TARGET_KEYS == jds.TARGET_KEYS
    assert inputs["mixture"].shape == (2, int(SR * SCENE_SECONDS))


VARIANTS = [
    ("MixLibriSpeechNoisyEnrollWP", dict(randomize_volume=True,
                                         skip_enrollment_simulation=True,
                                         noise_scale=3.0)),
    ("MixLibriSpeechNoisyEnrollDirectional", {}),
    ("MixLibriSpeechCIPIC", dict(hrtf_type="CATTRIR", num_enroll=2)),
    ("SpeechSeparationDataset", {}),
    ("SpeechSeparationDataset", dict(use_bg=False)),
    ("OracleMixLibriSpeech", {}),
]


@pytest.mark.parametrize("dset", ["val", "train"])
@pytest.mark.parametrize("name,kw", VARIANTS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(VARIANTS)])
def test_variant_items_are_the_jax_packages(corpus, name, kw, dset):
    kw = dict(kw)
    args = _args(corpus, dset, kw.pop("hrtf_type", "CATTRIR"), **kw)
    _hold(getattr(tvar, name)(**args), getattr(jvar, name)(**args), dset)


def test_dynamic_mixing_items_are_the_jax_packages(corpus):
    split = corpus["train-clean-360"]
    args = dict(fg_dir=split["fg"], bg_dir=corpus["bg"],
                embed_dir=split["embed"], hrtf_list=corpus["catt"],
                hrtf_type="CATTRIR", n_samples=3, duration=SCENE_SECONDS)
    _hold(tvar.MixLibriSpeechDM(**args), jvar.MixLibriSpeechDM(**args),
          "train", seed=40)


def test_the_configs_dataset_paths_resolve_to_the_port():
    """Every dotted path of the eight configs names a port class; the
    reference's dataset paths map as the JAX package maps them."""
    import glob

    from lookoncetohear_tpu import utils as jutils

    def paths(o):
        if isinstance(o, dict):
            for v in o.values():
                yield from paths(v)
        elif isinstance(o, list):
            for v in o:
                yield from paths(v)
        elif isinstance(o, str) and "/" not in o and o.count(".") >= 2:
            yield o

    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    files = sorted(glob.glob(os.path.join(root, "*.json")))
    assert len(files) == 8
    seen = set()
    for f in files:
        for p in paths(json.load(open(f))):
            cls = tutils.import_attr(p)
            assert cls.__module__.startswith("lookoncetohear_tpu_torch."), p
            assert cls.__name__ == jutils.import_attr(p).__name__, p
            seen.add(p)
    assert "src.datasets.MixLibriSpeechNoisyEnrollNorm." \
        "MixLibriSpeechNoisyEnroll" in seen
    for p in jutils._COMPAT_REGISTRY:
        assert tutils.import_attr(p).__name__ == \
            jutils.import_attr(p).__name__, p
        if "Motion" in p:
            assert tutils.import_attr(p) is tvar.MixLibriSpeechMotion


# ---- prep CLIs -------------------------------------------------------------

def test_generate_jams_cli_is_the_jax_packages(tmp_path, monkeypatch):
    """The port's CLI from a directory holding data/MixLibriSpeech/,
    against the JAX module's split specs."""
    write_corpus(str(tmp_path), n_speakers=3, n_utts=1, seconds=0.5,
                 ir_len=16)
    monkeypatch.chdir(tmp_path)
    tgen.main(["--only", "dev-clean", "--num", "3"])
    spec = dict(jgen.DATASETS[1], num_soundscapes=3,
                output_dir=str(tmp_path / "want"))
    jscene.generate_scene_specs(**spec, **jgen.COMMON)
    got = tmp_path / "data/MixLibriSpeech/jams/dev-clean"
    assert sorted(os.listdir(got)) == sorted(os.listdir(tmp_path / "want"))
    assert not (tmp_path / "data/MixLibriSpeech/jams/test-clean").exists()
    for d in os.listdir(got):
        for f in ("mixture.jams", "mixture.txt"):
            assert (got / d / f).read_bytes() == \
                (tmp_path / "want" / d / f).read_bytes()
    assert tgen.DATASETS == jgen.DATASETS and tgen.COMMON == jgen.COMMON


def test_librispeech2scaper_on_placeholders(tmp_path):
    """Empty .flac placeholders in the LibriSpeech layout become the same
    symlink farm as the JAX package makes."""
    src = tmp_path / "src"
    for dset in ("dev-clean", "test-clean"):
        for spk in ("84", "174"):
            for ch in ("121123", "50561"):
                d = src / "LibriSpeech" / dset / spk / ch
                d.mkdir(parents=True)
                for u in range(2):
                    (d / f"{spk}-{ch}-{u:04d}.flac").write_bytes(b"")
                (d / f"{spk}-{ch}.trans.txt").write_text("")
    for name in ("t", "j"):
        shutil.copytree(src, tmp_path / name)
    tl2s.convert(str(tmp_path / "t"))
    jl2s.convert(str(tmp_path / "j"))

    def farm(root):
        out = {}
        for dirpath, _, files in os.walk(root / "librispeech_scaper_fmt"):
            for f in files:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = os.readlink(p)
        return out
    got = farm(tmp_path / "t")
    assert got == farm(tmp_path / "j") and len(got) == 16
    for rel in got:
        assert os.path.exists(tmp_path / "t" / rel)
    with pytest.raises(AssertionError, match="already exists"):
        tl2s.convert(str(tmp_path / "t"))
