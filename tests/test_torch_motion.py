"""Moving sources in the port, on the CPU: the native renderer's bridge
(the cases of `tests/test_motion.py`), the CIPIC and RRBRIR motion
simulators' paths and renders, `make_simulator`'s motion branches, and
the `MixLibriSpeechMotion` / `CIPIC_MOTION` dataset items, each against
the JAX package on the same inputs.

Both bridges drive one library built by the port from
`native/motion_simulator/moving_sources.cpp` (the JAX bridge's own
build, `make` inside `native/`, is not invoked here), and the paths draw
from the same random streams in the same order, so everything is held
bit for bit. The SOFA cases write h5py fixtures with source positions
and skip by name without h5py.
"""

import os
import random

import numpy as np
import pytest

from lookoncetohear_tpu.data import dataset_variants as jvar
from lookoncetohear_tpu.data import datasets as jds
from lookoncetohear_tpu.data import motion as jm
from lookoncetohear_tpu.data import scene as jscene
from lookoncetohear_tpu_torch.data import dataset_variants as tvar
from lookoncetohear_tpu_torch.data import datasets as tds
from lookoncetohear_tpu_torch.data import motion as tm
from lookoncetohear_tpu_torch.data import spatializer as tsp
from lookoncetohear_tpu_torch.data.prep.synth_corpus import write_corpus
from test_torch_data import same

SR = 16000
SECONDS = 0.5


@pytest.fixture(scope="module")
def lib():
    return tm.build_native()


@pytest.fixture(autouse=True)
def _one_library(monkeypatch, lib):
    """The JAX bridge loads the port's build of the same source."""
    monkeypatch.setattr(jm, "build_native", lambda force=False: lib)


def _delta_db(n_dirs=8, n_ir=32):
    """IR set: direction m delays left by m, right by 2m samples, the
    positions spread over azimuth in the horizontal plane."""
    irs = np.zeros((n_dirs, 2, n_ir), np.float32)
    pos = np.zeros((n_dirs, 3), np.float32)
    for m in range(n_dirs):
        irs[m, 0, m] = 1.0
        irs[m, 1, min(2 * m, n_ir - 1)] = 1.0
        az = -np.pi / 2 + np.pi * m / max(n_dirs - 1, 1)
        pos[m] = [np.cos(az), np.sin(az), 0.0]
    return irs, pos


def _sim(module=tm):
    sim = module.MotionSimulator(SR, 0.025)
    sim.set_hrtf_arrays(*_delta_db())
    return sim


# ---- the bridge (tests/test_motion.py's cases) --------------------------

def test_build(lib):
    assert os.path.exists(lib) and "_build" in lib
    assert tm.build_native() == lib            # cached by its hash


def test_round_trip_static_source():
    sim = _sim()
    audio = np.random.default_rng(0).standard_normal(SR).astype(np.float32)
    path = np.tile(_delta_db()[1][0], (41, 1)).astype(np.float32)
    sim.add_source(audio, path)
    out = sim.simulate()
    assert out.shape == (1, 2, SR)
    np.testing.assert_allclose(out[0, 0], audio, atol=1e-5)
    np.testing.assert_allclose(out[0, 1], audio, atol=1e-5)


def test_known_delay():
    sim = _sim()
    n = SR // 2
    audio = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    path = np.tile(_delta_db()[1][3], (21, 1)).astype(np.float32)
    sim.add_source(audio, path)
    out = sim.simulate()
    np.testing.assert_allclose(out[0, 0, 3:], audio[:-3], atol=1e-5)
    np.testing.assert_allclose(out[0, 1, 6:], audio[:-6], atol=1e-5)


def test_moving_source_switches_hrir():
    sim = _sim()
    pos = _delta_db()[1]
    audio = np.random.default_rng(7).standard_normal(SR).astype(np.float32)
    path = np.tile(pos[0], (41, 1))
    path[20:] = pos[7]                  # delays 0/0, then 7/14 samples
    sim.add_source(audio, path.astype(np.float32))
    out = sim.simulate()

    def lr_lag(seg_l, seg_r, max_lag=20):
        lags = [np.dot(seg_l[max_lag:-max_lag],
                       seg_r[max_lag + k:len(seg_r) - max_lag + k])
                for k in range(-max_lag, max_lag + 1)]
        return int(np.argmax(lags)) - max_lag

    assert lr_lag(out[0, 0, :SR // 4], out[0, 1, :SR // 4]) == 0
    assert lr_lag(out[0, 0, -SR // 4:], out[0, 1, -SR // 4:]) == 7


def test_multiple_sources():
    sim = _sim()
    n = SR // 4
    a = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    path = np.tile(_delta_db()[1][0], (11, 1)).astype(np.float32)
    for _ in range(3):
        sim.add_source(a, path)
    out = sim.simulate()
    assert out.shape == (3, 2, n)
    np.testing.assert_allclose(out[0], out[2], atol=1e-6)
    sim.add_source(a, path)             # simulate cleared the sources
    assert sim.simulate().shape == (1, 2, n)


def test_bad_sources_rejected():
    sim = _sim()
    audio = np.zeros(SR, np.float32)
    with pytest.raises(ValueError, match="path too short"):
        sim.add_source(audio, np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        sim.add_source(audio, np.zeros((41, 2), np.float32))
    # the library reads past a shorter source (the JAX bridge's output
    # there is undefined): the port refuses unequal lengths
    sim.add_source(audio, np.zeros((41, 3), np.float32))
    with pytest.raises(ValueError, match="equal lengths"):
        sim.add_source(audio[:SR // 2], np.zeros((41, 3), np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_renders_are_the_jax_bridges(seed):
    rng = np.random.default_rng(seed)
    irs = rng.standard_normal((12, 2, 40)).astype(np.float32)
    pos = rng.standard_normal((12, 3)).astype(np.float32)
    audio = [rng.standard_normal(SR // 2).astype(np.float32)
             for _ in range(3)]
    paths = [rng.standard_normal((21, 3)).astype(np.float32)
             for _ in range(3)]
    outs = []
    for module in (tm, jm):
        sim = module.MotionSimulator(SR, 0.025)
        sim.set_hrtf_arrays(irs, pos)
        for a, p in zip(audio, paths):
            sim.add_source(a, p)
        outs.append(sim.simulate())
    same(outs[0], outs[1])


# ---- the simulators -------------------------------------------------------

def _sofa_set(root, n_subjects=2, n_dirs=10):
    """SOFA files with spherical source positions in the horizontal
    plane and direction-dependent interaural delays; the list file."""
    h5py = pytest.importorskip("h5py")
    os.makedirs(root, exist_ok=True)
    names = []
    for s in range(n_subjects):
        irs = np.zeros((n_dirs, 2, 32))
        pos = np.zeros((n_dirs, 3))
        for m in range(n_dirs):
            irs[m, 0, (m + s) % 8] = 1.0
            irs[m, 1, (2 * m) % 8] = 0.9
            irs[m, :, 10:] = 0.02 * np.cos(m + s + np.arange(22))
            pos[m] = [m * 360.0 / n_dirs - 162.0, 10.0 * s, 1.0]
        names.append(f"s{s}.sofa")
        with h5py.File(os.path.join(root, names[-1]), "w") as f:
            f.create_dataset("Data.IR", data=irs)
            f.create_dataset("Data.SamplingRate", data=np.array([SR * 1.0]))
            d = f.create_dataset("SourcePosition", data=pos)
            d.attrs["Type"] = "spherical"
    listfile = os.path.join(root, "list.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(names))
    return listfile


@pytest.fixture(scope="module")
def sofa(tmp_path_factory):
    return _sofa_set(str(tmp_path_factory.mktemp("sofa")))


def test_sofa_reads_as_the_jax_bridge(sofa):
    path = os.path.join(os.path.dirname(sofa), "s1.sofa")
    ir, sr, pos = tsp._load_sofa(path)
    same((ir, pos, sr), jm._load_sofa_full(path))


CLASSES = [("CIPICMotionSimulator", {}),
           ("CIPICMotionSimulator", dict(use_piecewise_arcs=True)),
           ("RRBRIRMotionSimulator", {})]


@pytest.mark.parametrize("name,kw", CLASSES,
                         ids=["arcs", "piecewise", "rrbrir"])
def test_simulators_are_the_jax_packages(sofa, name, kw):
    t, j = getattr(tm, name)(sofa, SR, **kw), getattr(jm, name)(sofa, SR,
                                                                  **kw)
    rng = np.random.default_rng(3)
    srcs = [rng.standard_normal(SR).astype(np.float32) for _ in range(2)]
    noise = rng.standard_normal(SR).astype(np.float32)
    for seed in (11, 12):
        for f2f in (None, 0, 1):
            got = t.simulate(srcs, noise, seed=seed, face_to_face_idx=f2f)
            same(got, j.simulate(srcs, noise, seed=seed,
                                 face_to_face_idx=f2f), f"{seed} {f2f}")
    assert len(got[0]) == 2 and got[0][0].shape == (2, SR)
    # deterministic under one seed
    same(t.simulate(srcs, noise, seed=12, face_to_face_idx=1), got)
    t_ = np.arange(0, 5.0, 0.025)
    for s in range(3):
        same(t.get_random_source_path(random.Random(s), t_),
             j.get_random_source_path(random.Random(s), t_))
        same(t.get_face_to_face_source_path(s, t_),
             j.get_face_to_face_source_path(s, t_))
        same(t.get_piecewise_arc_path(random.Random(s), t_),
             j.get_piecewise_arc_path(random.Random(s), t_))


def test_path_geometry(sofa):
    t_ = np.arange(0, 5.0, 0.025)
    cipic = tm.CIPICMotionSimulator(sofa, SR)
    path, err = cipic.get_face_to_face_source_path(7, t_[:40])
    assert path.shape == (40, 3) and np.all(path[:, 1] > 0.7)
    assert 0 <= err <= np.pi / 10
    path, _ = cipic.get_piecewise_arc_path(random.Random(3), t_)
    np.testing.assert_allclose(np.linalg.norm(path, axis=1), 1.0, atol=1e-6)
    rr = tm.RRBRIRMotionSimulator(sofa, SR)
    path, _ = rr.get_random_source_path(random.Random(5), t_[:80])
    assert np.all(path[:, 0] >= 0)
    np.testing.assert_allclose(np.linalg.norm(path, axis=1), 1.5, atol=1e-6)


@pytest.mark.parametrize("kw", [dict(hrtf_type="CIPIC_MOTION"),
                                dict(hrtf_type="MultiCh", use_motion=True),
                                dict(hrtf_type="MultiCh", use_motion=True,
                                     motion_use_piecewise_arcs=True)])
def test_make_simulator_motion_branches(sofa, corpus, kw):
    lists = sofa if kw["hrtf_type"] == "CIPIC_MOTION" else \
        [sofa, sofa, corpus["ash"], corpus["catt"]]
    t = tds.make_simulator(hrtf_list=lists, sr=SR, dset="val", **kw)
    j = jds.make_simulator(hrtf_list=lists, sr=SR, dset="val", **kw)
    cipic = t if kw["hrtf_type"] == "CIPIC_MOTION" else t.simulators[0]
    assert type(cipic) is tm.CIPICMotionSimulator
    assert cipic.use_piecewise_arcs == \
        kw.get("motion_use_piecewise_arcs", False)
    rng = np.random.default_rng(5)
    srcs = [rng.standard_normal(4000).astype(np.float32) for _ in range(3)]
    noise = rng.standard_normal(4000).astype(np.float32)
    for seed in range(1, 9):
        same(t.simulate(srcs, noise, seed, face_to_face_idx=0),
             j.simulate(srcs, noise, seed, face_to_face_idx=0), seed)


# ---- the datasets -----------------------------------------------------------

SPLITS = {"train": "train-clean-360", "val": "dev-clean",
          "test": "test-clean"}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 speakers x 2 utterances of 2 s a split (synth_corpus), scene
    specs of SECONDS, the CATT rooms, an ASH-style set and the motion
    SOFA set."""
    root = str(tmp_path_factory.mktemp("mcorpus"))
    c = write_corpus(root, n_speakers=4, n_utts=2, seconds=2.0, ir_len=32)
    for s, split in enumerate(SPLITS.values()):
        jscene.generate_scene_specs(
            c[split]["fg"], c["bg"], c[split]["jams"], num_soundscapes=3,
            seed=s + 5, bg_labels=[["tr", "cv", "tt"][s]], duration=SECONDS,
            event_duration_min=SECONDS, event_duration_max=SECONDS)
    c["ash"] = os.path.join(root, "ash")
    rng = np.random.default_rng(11)
    for room in ("05A", "06", "03", "04", "01", "02"):
        d = os.path.join(c["ash"], f"R{room}")
        os.makedirs(d)
        for az in ("0", "30", "-30", "90"):
            ir = 0.05 * rng.standard_normal((2, 48))
            ir[:, 0] = 1.0
            from lookoncetohear_tpu_torch.data import audio_io
            audio_io.write_wav(os.path.join(d, f"BRIR_R{room}_C1_E0_A{az}"
                                               ".wav"),
                               ir.astype(np.float32), SR)
    c["motion_sofa"] = _sofa_set(os.path.join(root, "msofa"))
    return c


def _args(corpus, dset, **kw):
    split = corpus[SPLITS[dset]]
    return dict(fg_dir=split["fg"], bg_dir=corpus["bg"],
                embed_dir=split["embed"], jams_dir=split["jams"],
                hrtf_list=corpus["motion_sofa"], dset=dset, sr=SR, **kw)


def _hold(t, j, seed=0):
    """Every item equal, each under the same `random` / `np.random`
    seeds (train items draw from them)."""
    assert len(t) == len(j) > 0
    items = []
    for i in range(len(j)):
        random.seed(seed + i)
        np.random.seed(seed + i)
        want = j[i]
        random.seed(seed + i)
        np.random.seed(seed + i)
        items.append(t[i])
        same(items[-1], want, f"item {i}")
    return items


@pytest.mark.parametrize("dset", ["val", "train"])
@pytest.mark.parametrize("kw", [{}, dict(motion_use_piecewise_arcs=True)])
def test_motion_dataset_items_are_the_jax_packages(corpus, dset, kw):
    _hold(tvar.MixLibriSpeechMotion(**_args(corpus, dset, **kw)),
          jvar.MixLibriSpeechMotion(**_args(corpus, dset, **kw)))


@pytest.mark.parametrize("dset", ["val", "test", "train"])
def test_cipic_motion_noisy_enroll_items_are_the_jax_packages(corpus, dset):
    args = _args(corpus, dset, hrtf_type="CIPIC_MOTION", use_motion=True)
    t, j = tds.MixLibriSpeechNoisyEnroll(**args), \
        jds.MixLibriSpeechNoisyEnroll(**args)
    assert isinstance(t.simulator, tm.CIPICMotionSimulator)
    items = _hold(t, j)
    vels = [float(inp["tgt_ang_vel"]) for inp, _ in items]
    assert np.isfinite(vels).all() and any(abs(v) > 0 for v in vels), vels


def test_sofa_reader_is_shared():
    """The bridge reads SOFA through the spatializers' loader, its
    cache and its lazy h5py import."""
    assert tm._load_sofa is tsp._load_sofa
