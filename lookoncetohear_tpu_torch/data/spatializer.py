"""HRTF / BRIR spatializers: mono sources -> binaural, host-side numpy
(counterpart of `lookoncetohear_tpu/data/spatializer.py`), with the
same seeded draw order, so val/test scenes are the JAX package's bit
for bit given the same IR sets:

* `SOFASimulator` (CIPIC / APL / RRBRIR): a random subject's SOFA file,
  a random measurement index per source; `face_to_face_idx` pins the
  enrollment target to each set's frontal index and re-seeds the RNG
  with seed + 123.
* `ASHSimulator` / `CATTRIRSimulator` / `PRASimulator`: wav BRIR sets
  with room-based train/val/test splits; CATT and PRA render the noise
  as 3 random-direction copies at U[0.5, 1] gains, peak-matched back to
  the mono noise.
* `MultiChSimulator`: a per-sample choice of CIPIC / RRBRIR / ASH / CATT
  with weights 35 / 5 / 45 / 15 drawn from random.Random(seed + 246).

SOFA files are HDF5 and are read with h5py, imported when the first
one is read: the wav sets need no h5py.
"""

from __future__ import annotations

import functools
import glob
import json
import os
import random
import re

import numpy as np
from scipy.signal import fftconvolve

from lookoncetohear_tpu_torch.data import audio_io


def open_sofa(path: str):
    """A SOFA file opened for reading (an `h5py.File`, h5py imported
    here)."""
    try:
        import h5py
    except ImportError:
        raise ImportError("reading SOFA HRTFs requires h5py") from None
    return h5py.File(path, "r")


@functools.lru_cache(maxsize=8)
def _load_sofa(path: str):
    """Read a SOFA file -> (ir [M, R, N] float32, sampling_rate, source
    positions [M, 3] float32: cartesian, on the unit sphere when stored
    as spherical; None where the file holds none)."""
    with open_sofa(path) as f:
        ir = np.asarray(f["Data.IR"], dtype=np.float32)
        sr = float(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
        if "SourcePosition" not in f:
            return ir, sr, None
        pos = np.asarray(f["SourcePosition"], dtype=np.float64)
        ptype = f["SourcePosition"].attrs.get("Type", b"spherical")
    if isinstance(ptype, bytes):
        ptype = ptype.decode()
    if "spherical" in str(ptype):
        az = np.deg2rad(pos[:, 0])
        el = np.deg2rad(pos[:, 1])
        pos = np.stack([np.cos(el) * np.cos(az),
                        np.cos(el) * np.sin(az),
                        np.sin(el)], axis=1)
    return ir, sr, pos[:, :3].astype(np.float32)


def _convolve_binaural(src: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """src [N] mono, rir [2, L] -> [2, N] (full conv trimmed to N)."""
    left = fftconvolve(src, rir[0])[: len(src)]
    right = fftconvolve(src, rir[1])[: len(src)]
    return np.stack([left, right], axis=0).astype(np.float32)


class SOFASimulator:
    """Random-subject, random-direction HRIR spatializer."""

    face_to_face_idx: int | None = None

    def __init__(self, sofa_text_file: str, fs: int) -> None:
        sofa_dir = os.path.dirname(sofa_text_file)
        with open(sofa_text_file) as f:
            names = [x for x in f.read().split("\n") if x]
        self.sofa_files = [os.path.join(sofa_dir, x) for x in names]
        self.fs = fs

    def _rir(self, sofa_path: str, idx: int) -> np.ndarray:
        ir, sr, _ = _load_sofa(sofa_path)
        rir = ir[idx]
        if int(sr) != self.fs:
            rir = audio_io.resample(rir, int(sr), self.fs)
        return rir

    def simulate(self, srcs, noise, seed=None, face_to_face_idx=None):
        rng = random.Random(seed)
        sofa_file = rng.choice(self.sofa_files)
        if face_to_face_idx is not None:
            rng = random.Random(seed + 123)
        n_dirs = _load_sofa(sofa_file)[0].shape[0]
        bi_srcs = []
        for i, src in enumerate(srcs):
            if face_to_face_idx is not None and i == face_to_face_idx:
                idx = self.face_to_face_idx
            else:
                idx = rng.choice(range(n_dirs))
            bi_srcs.append(_convolve_binaural(src, self._rir(sofa_file,
                                                             idx)))
        bi_noise = _convolve_binaural(
            noise, self._rir(sofa_file, rng.choice(range(n_dirs))))
        return bi_srcs, bi_noise


class CIPICSimulator(SOFASimulator):
    face_to_face_idx = 608  # ~0° azimuth in CIPIC's measurement grid


class APLSimulator(SOFASimulator):
    face_to_face_idx = 0


class RRBRIRSimulator(SOFASimulator):
    face_to_face_idx = 18


def _load_rir_wav(path: str, fs: int) -> np.ndarray:
    rir, sr = audio_io.read_audio(path)
    if sr != fs:
        rir = audio_io.resample(rir, sr, fs)
    return rir


class ASHSimulator:
    """ASH-Listening-Set BRIRs: per-sample room config, 0°-azimuth set
    for enrollment."""

    TRAIN_ROOMS = ['05A', '05B', '06', '07', '09', '12', '13', '17', '18',
                   '19', '20', '21', '22', '23', '24', '25', '26', '27',
                   '28', '31', '32', '33', '34']
    VAL_ROOMS = ['03', '04', '08', '10', '11', '30']
    TEST_ROOMS = ['01', '02', '14', '15', '16', '29']

    def __init__(self, hrtf_list: str, fs: int, dset: str = "train") -> None:
        self.fs = fs
        rooms = {"train": self.TRAIN_ROOMS, "val": self.VAL_ROOMS,
                 "test": self.TEST_ROOMS}[dset]
        pat = re.compile(r".*?/BRIR_R(.*?)_C(.*?)_E(.*?)_A(.*?)\.wav")
        by_cfg_0, by_cfg_non0 = {}, {}
        for path in sorted(glob.glob(os.path.join(hrtf_list, "*/*.wav"))):
            m = pat.match(path)
            if not m:
                continue
            room, config, _elev, azimuth = m.groups()
            if room not in rooms:
                continue
            cfg = f"{room}_{config}"
            target = by_cfg_0 if azimuth == "0" else by_cfg_non0
            target.setdefault(cfg, []).append(path)
        self.configs = sorted(by_cfg_non0)
        self.by_cfg_0 = by_cfg_0
        self.by_cfg_non0 = by_cfg_non0

    def simulate(self, srcs, noise, seed=None, face_to_face_idx=None):
        rng = random.Random(seed)
        cfg = rng.choice(self.configs)
        if face_to_face_idx is not None:
            rng = random.Random(seed + 123)
        bi_srcs = []
        for i, src in enumerate(srcs):
            if face_to_face_idx is not None and i == face_to_face_idx:
                path = rng.choice(self.by_cfg_0[cfg])
            else:
                path = rng.choice(self.by_cfg_non0[cfg])
            bi_srcs.append(_convolve_binaural(src,
                                              _load_rir_wav(path, self.fs)))
        path = rng.choice(self.by_cfg_non0[cfg])
        bi_noise = _convolve_binaural(noise, _load_rir_wav(path, self.fs))
        return bi_srcs, bi_noise


class CATTRIRSimulator:
    """CATT-acoustics BRIRs at ±90°/5° azimuths; noise = 3 summed
    random directions."""

    TRAIN_ROOMS = ['0_0s', '0_1s', '0_2s', '0_5s', '0_6s', '0_7s', '1_0s']
    VAL_ROOMS = ['0_3s', '0_9s']
    TEST_ROOMS = ['0_4s', '0_8s']

    def __init__(self, hrtf_list: str, fs: int, dset: str = "train") -> None:
        self.fs = fs
        self.hrtf_list = hrtf_list
        self.rooms = {"train": self.TRAIN_ROOMS, "val": self.VAL_ROOMS,
                      "test": self.TEST_ROOMS}[dset]
        self.azimuths = list(range(-90, 95, 5))
        az0 = [a for a in self.azimuths if abs(a) <= 15]
        self.enroll_azimuths_0 = az0[1:-1]  # (-15, 15) exclusive
        self.enroll_azimuths_non0 = [a for a in self.azimuths
                                     if abs(a) > 15]

    def _path(self, room: str, az: int) -> str:
        return os.path.join(self.hrtf_list, room, f"CATT_{room}_{az}.wav")

    def simulate(self, srcs, noise, seed=None, face_to_face_idx=None):
        rng = random.Random(seed)
        room = rng.choice(self.rooms)
        azimuths = self.azimuths
        if face_to_face_idx is not None:
            rng = random.Random(seed + 123)
            azimuths = self.enroll_azimuths_non0
        bi_srcs = []
        for i, src in enumerate(srcs):
            if face_to_face_idx is not None and i == face_to_face_idx:
                az = rng.choice(self.enroll_azimuths_0)
            else:
                az = rng.choice(azimuths)
            bi_srcs.append(_convolve_binaural(
                src, _load_rir_wav(self._path(room, az), self.fs)))
        bi_noise = 0.0
        for az in rng.sample(azimuths, 3):
            rir = _load_rir_wav(self._path(room, az), self.fs)
            bi_noise = bi_noise + rng.uniform(0.5, 1.0) * \
                _convolve_binaural(noise, rir)
        bi_noise = bi_noise / np.abs(bi_noise).max() * np.abs(noise).max()
        return bi_srcs, bi_noise.astype(np.float32)


class PRASimulator:
    """Pyroomacoustics-style pre-rendered RIR rooms with metadata.json
    angle lists."""

    F2F_MAX_DIFF = 15

    def __init__(self, hrtf_list: str, fs: int, dset: str = "train") -> None:
        self.fs = fs
        self.hrtf_list = hrtf_list
        rooms = sorted(os.listdir(hrtf_list))
        n = len(rooms)
        tr, va = int(round(n * 0.7)), int(round(n * 0.8))
        self.rooms = {"train": rooms[:tr], "val": rooms[tr:va],
                      "test": rooms[va:]}[dset]

    def _convolve_multi(self, src: np.ndarray, path: str) -> np.ndarray:
        rir = _load_rir_wav(path, self.fs)
        return np.stack([fftconvolve(src, r)[: len(src)] for r in rir],
                        axis=0).astype(np.float32)

    def simulate(self, srcs, noise, seed=None, face_to_face_idx=None):
        rng = random.Random(seed)
        room = rng.choice(self.rooms)
        room_dir = os.path.join(self.hrtf_list, room)
        with open(os.path.join(room_dir, "metadata.json")) as f:
            metadata = json.load(f)
        azimuths = np.array(metadata["rir_params"]["angles"])
        ids = np.arange(azimuths.shape[0])
        if face_to_face_idx is not None:
            rng = random.Random(seed + 123)
            front = (np.abs(azimuths - 90) % 180) < self.F2F_MAX_DIFF
            ids_f2f = np.where(front)[0].tolist()
            ids = np.where(~front)[0].tolist()
        else:
            ids = ids.tolist()
        mc_srcs = []
        for i, src in enumerate(srcs):
            if face_to_face_idx is not None and i == face_to_face_idx:
                az_idx = rng.choice(ids_f2f)
            else:
                az_idx = rng.choice(ids)
            mc_srcs.append(self._convolve_multi(
                src, os.path.join(room_dir, f"rir_{az_idx:02d}.wav")))
        mc_noise = 0.0
        for az in rng.sample(ids, 3):
            mc_noise = mc_noise + rng.uniform(0.5, 1.0) * \
                self._convolve_multi(
                    noise, os.path.join(room_dir, f"rir_{az:02d}.wav"))
        mc_noise = mc_noise / np.abs(mc_noise).max() * np.abs(noise).max()
        return mc_srcs, mc_noise.astype(np.float32)


class MultiChSimulator:
    """Weighted per-sample mix of CIPIC/RRBRIR/ASH/CATT."""

    def __init__(self, hrtf_list, fs, cipic_simulator_type=CIPICSimulator,
                 dset: str = "train") -> None:
        cipic_list, rrbrir_list, ash_list, catt_list = hrtf_list
        self.simulators = [
            cipic_simulator_type(cipic_list, fs),
            RRBRIRSimulator(rrbrir_list, fs),
            ASHSimulator(ash_list, fs, dset=dset),
            CATTRIRSimulator(catt_list, fs, dset=dset),
        ]
        self.sampling_counts = [35, 5, 45, 15]
        self.fs = fs

    def simulate(self, srcs, noise, seed=None, face_to_face_idx=None):
        rng = random.Random(seed + 246)
        sim = rng.sample(self.simulators, 1,
                         counts=self.sampling_counts)[0]
        return sim.simulate(srcs, noise, seed, face_to_face_idx)
