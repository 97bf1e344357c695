"""Moving-source binaural rendering: the ctypes bridge over the native
renderer and the source paths (counterpart of
`lookoncetohear_tpu/data/motion.py`).

The host draws a 3-D source path on the unit sphere, one point per
25 ms frame: a constant-angular-velocity arc, piecewise random arcs, or
a jittered face-to-face path for the enrollment target. The C++
library (`native/motion_simulator/moving_sources.cpp`) picks the HRIR
nearest each frame's point, cross-fades between them and convolves.

`build_native()` compiles that source as it stands, with the flags of
its Makefile, into this package's `_build/` directory (git-ignored) at
first use; the library's name carries a hash of the source, flags and
compiler. A build failure raises. SOFA files are HDF5: the bridge reads
them with h5py (`spatializer._load_sofa`, imported only then) and hands
the IRs and source positions to the library through
`simulator_set_hrtf_data`, as the JAX bridge does; `set_hrtf_arrays`
takes them from arrays and needs no h5py.

The paths draw from the same `random.Random` and `np.random.RandomState`
streams in the same order as the JAX package, and the library is built
from the same source, so a render is that package's bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import random
import subprocess
import time
from pathlib import Path

import numpy as np

from lookoncetohear_tpu_torch.data import audio_io
from lookoncetohear_tpu_torch.data.spatializer import (CIPICSimulator,
                                                       _load_sofa)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "motion_simulator" / "moving_sources.cpp"
BUILD_DIR = _PKG / "_build"
# native/motion_simulator/Makefile's CXXFLAGS
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]
BUILD_TIMEOUT_S = 120

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "simulator_init": [ctypes.POINTER(_P), _I, ctypes.c_float],
    "simulator_set_hrtf_data": [_P, _FP, _I, _I, _I, _FP],
    "simulator_add_source": [_P, _FP, _I, _FP, _I],
    "simulator_simulate": [_P, ctypes.POINTER(_FP), ctypes.POINTER(_I),
                           ctypes.POINTER(_I)],
    "simulator_cleanup": [_P],
    "simulator_destroy": [_P],
}

_lib = None
# what the last build_native() did: seconds, path, cached, command
last_build: dict = {}


def build_native() -> str:
    """Compile moving_sources.cpp into `_build/` unless this exact
    build is there already; returns the library's path."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join([cxx] + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libmoving_sources_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        last_build.update(seconds=0.0, cached=True, path=str(lib))
        return str(lib)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    os.replace(tmp, lib)
    last_build.update(seconds=time.perf_counter() - t0, cached=False,
                      path=str(lib), command=" ".join(cmd))
    return str(lib)


def load_native() -> ctypes.CDLL:
    """The renderer's library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        _lib = lib
    return _lib


def _floats(a: np.ndarray):
    return a.ctypes.data_as(_FP)


class MotionSimulator:
    """One native renderer: set an HRIR set, add sources with their
    paths, simulate (which also clears the sources)."""

    def __init__(self, sr: int, frame_duration: float = 0.025) -> None:
        self.lib = load_native()
        self.sr = sr
        self.frame_duration = frame_duration
        self._p = _P()
        self._call_raw("simulator_init", ctypes.byref(self._p), sr,
                       frame_duration)
        self._n_audio = None        # the length of the sources added

    def _call_raw(self, name: str, *args) -> None:
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed with code {err}")

    def _call(self, name: str, *args) -> None:
        self._call_raw(name, self._p, *args)

    def set_hrtf(self, sofa_path: str) -> None:
        """The HRIRs and source positions of a SOFA file, resampled to
        this simulator's rate where the file's differs."""
        if not os.path.exists(sofa_path):
            raise FileNotFoundError(f"HRTF not found: {sofa_path}")
        irs, file_sr, pos = _load_sofa(sofa_path)
        if pos is None:
            raise ValueError(f"{sofa_path} holds no SourcePosition")
        if int(file_sr) != self.sr:
            irs = audio_io.resample(irs, int(file_sr), self.sr)
        self.set_hrtf_arrays(irs, pos)

    def set_hrtf_arrays(self, irs: np.ndarray, pos: np.ndarray) -> None:
        """irs [M, R, N] (R >= 2: left, right), pos [M, 3] cartesian."""
        irs = np.ascontiguousarray(irs, dtype=np.float32)
        pos = np.ascontiguousarray(pos, dtype=np.float32)
        m, r, n = irs.shape
        if pos.shape != (m, 3):
            raise ValueError(f"positions {pos.shape} for {m} IRs")
        self._call("simulator_set_hrtf_data", _floats(irs), m, r, n,
                   _floats(pos))

    def add_source(self, data: np.ndarray, path: np.ndarray) -> None:
        """A mono source and its path [N, 3], one point per frame; the
        path must cover the audio. Every source of one render has the
        same length: the library writes each source's output over the
        longest source's length and reads past the end of a shorter
        one's (the JAX bridge returns garbage or NaN there)."""
        if path.ndim != 2 or path.shape[1] != 3:
            raise ValueError(f"Path must have shape (N, 3), found "
                             f"{path.shape}")
        n_frames_needed = int(np.ceil(
            (data.shape[-1] / self.sr) / self.frame_duration))
        if path.shape[0] < n_frames_needed:
            raise ValueError(f"path too short: {path.shape[0]} < "
                             f"{n_frames_needed}")
        audio = np.ascontiguousarray(data, dtype=np.float32).reshape(-1)
        if self._n_audio not in (None, audio.size):
            raise ValueError(f"a source of {audio.size} samples after one "
                             f"of {self._n_audio}: the sources of a render "
                             "must have equal lengths")
        pathf = np.ascontiguousarray(path, dtype=np.float32).reshape(-1)
        self._call("simulator_add_source", _floats(audio), audio.size,
                   _floats(pathf), pathf.size)
        self._n_audio = audio.size

    def simulate(self) -> np.ndarray:
        """Render every source added since the last call: [S, 2, T]."""
        data_p = _FP()
        n_src, n_samp = _I(0), _I(0)
        self._call("simulator_simulate", ctypes.byref(data_p),
                   ctypes.byref(n_src), ctypes.byref(n_samp))
        n_src, n_samp = n_src.value, n_samp.value
        audio = np.ctypeslib.as_array(
            data_p, shape=(n_src * n_samp,)).copy()
        audio = audio.reshape(n_src, n_samp // 2, 2)
        audio = np.transpose(audio, (0, 2, 1))         # [S, 2, T]
        self._call("simulator_cleanup")
        self._n_audio = None
        return audio

    def __del__(self):
        if getattr(self, "_p", None):
            self.lib.simulator_destroy(self._p)
            self._p = None


class CIPICMotionSimulator(CIPICSimulator):
    """CIPIC HRTFs with moving sources: a random subject's SOFA file and
    a path per source (`simulate` returns the binaural sources, the
    binaural noise and each source's angular velocity, or for the
    face-to-face source its largest angular error)."""

    def __init__(self, sofa_text_file: str, sr: int,
                 frame_duration: float = 0.025,
                 use_piecewise_arcs: bool = False) -> None:
        super().__init__(sofa_text_file, sr)
        self.sr = sr
        self.frame_duration = frame_duration
        self._simulator = MotionSimulator(sr, frame_duration)
        self.use_piecewise_arcs = use_piecewise_arcs

    # -- paths ---------------------------------------------------------------

    def get_piecewise_arc_path(self, rng: random.Random, t: np.ndarray):
        """Bursts of movement: the source rests, and with probability dt
        a frame starts a 0.1-1 s arc at an angular speed of
        U[pi/6, pi/2] (each sign random) in both angles."""
        theta0 = rng.uniform(0, 2 * np.pi)
        phi0 = rng.uniform(0, np.pi / 2)
        dt = t[1] - t[0]
        theta = np.zeros_like(t)
        phi = np.zeros_like(t)
        i = 0
        while i < len(t):
            if rng.random() < dt:
                seconds = rng.uniform(0.1, 1.0)
                nsteps = int(round(seconds / dt))
                wtheta = rng.uniform(np.pi / 6, np.pi / 2) \
                    * ((-1) ** rng.randint(0, 1))
                wphi = rng.uniform(np.pi / 6, np.pi / 2) \
                    * ((-1) ** rng.randint(0, 1))
                j = 0
                while i < len(t) and j < nsteps:
                    theta0 += wtheta * dt
                    phi0 += wphi * dt
                    theta[i] = theta0
                    phi[i] = phi0
                    i += 1
                    j += 1
            else:
                theta[i] = theta0
                phi[i] = phi0
                i += 1
        path = np.stack([np.sin(phi) * np.cos(theta),
                         np.sin(phi) * np.sin(theta),
                         np.cos(phi)], axis=1)
        return path, 0.0

    def get_random_source_path(self, rng: random.Random, t: np.ndarray):
        """An arc at constant angular velocity and fixed coaltitude;
        returns (path [N, 3], angular velocity)."""
        if self.use_piecewise_arcs:
            return self.get_piecewise_arc_path(rng, t)
        theta0 = rng.uniform(0, np.pi / 2)
        w_theta = rng.uniform(-np.pi / 2, np.pi / 2)
        phi0 = rng.uniform(0, np.pi / 2)
        theta_t = theta0 + w_theta * t
        path = np.stack([np.sin(phi0) * np.cos(theta_t),
                         np.sin(phi0) * np.sin(theta_t),
                         np.cos(phi0) * np.ones_like(t)], axis=1)
        return path, w_theta

    def get_face_to_face_source_path(self, seed: int, t: np.ndarray):
        """A jittered frontal path for the enrollment target; returns
        (path, largest error in radians)."""
        rng = np.random.RandomState(seed)
        max_error = rng.uniform(0, np.pi / 10)
        theta_phi = rng.uniform(np.pi / 2 - max_error,
                                np.pi / 2 + max_error, size=(len(t), 2))
        path = np.stack([np.sin(theta_phi[:, 1]) * np.cos(theta_phi[:, 0]),
                         np.sin(theta_phi[:, 1]) * np.sin(theta_phi[:, 0]),
                         np.cos(theta_phi[:, 1])], axis=1)
        return path, max_error

    # -- render --------------------------------------------------------------

    def simulate(self, srcs, noise, seed=None, face_to_face_idx=None):
        simulation_time = srcs[0].shape[-1] / self.sr
        t = np.arange(0, self.frame_duration + simulation_time,
                      self.frame_duration)
        rng = random.Random(seed)
        hrtf = rng.choice(self.sofa_files)
        self._simulator.set_hrtf(hrtf)

        params = []
        for i, src in enumerate(srcs):
            if face_to_face_idx is not None and i == face_to_face_idx:
                path, param = self.get_face_to_face_source_path(seed, t)
            else:
                path, param = self.get_random_source_path(rng, t)
            params.append(param)
            self._simulator.add_source(src, path)
        noise_path, _ = self.get_random_source_path(rng, t)
        self._simulator.add_source(noise, noise_path)

        rendered = self._simulator.simulate()
        bi_srcs = [rendered[i] for i in range(len(srcs))]
        bi_noise = rendered[-1]
        return bi_srcs, bi_noise, params


class RRBRIRMotionSimulator(CIPICMotionSimulator):
    """The RRBRIR set: azimuth within [-90, 90] degrees at 0 elevation,
    radius 1.5 m."""

    def get_random_source_path(self, rng: random.Random, t: np.ndarray):
        theta0 = rng.uniform(-np.pi / 2, np.pi / 2)
        w_theta = rng.uniform(-np.pi / 2, np.pi / 2)
        r = 1.5
        phi0 = np.pi / 2
        theta_t = theta0 + w_theta * t
        path = np.stack([np.abs(r * np.sin(phi0) * np.cos(theta_t)),
                         r * np.sin(phi0) * np.sin(theta_t),
                         r * np.cos(phi0) * np.ones_like(t)], axis=1)
        return path, w_theta

    def get_face_to_face_source_path(self, seed: int, t: np.ndarray):
        rng = np.random.RandomState(seed)
        r = 1.5
        theta_phi = rng.multivariate_normal(
            mean=[0, np.pi / 2], cov=[[np.pi / 30, 0], [0, 0]],
            size=len(t))
        theta_phi[:, 0] = np.clip(theta_phi[:, 0], -np.pi / 2, np.pi / 2)
        path = np.stack([r * np.sin(theta_phi[:, 1])
                         * np.cos(theta_phi[:, 0]),
                         r * np.sin(theta_phi[:, 1])
                         * np.sin(theta_phi[:, 0]),
                         r * np.cos(theta_phi[:, 1])], axis=1)
        return path, 0.0
