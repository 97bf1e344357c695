"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by ONE `nvcc` call into a shared library
with a plain `extern "C"` interface, loaded with `ctypes`. No source
includes PyTorch's headers, so the build takes seconds, not minutes.
The library's name carries a hash of the sources and flags, and it is
written under `_build/` beside this file (listed in `.gitignore`).
Nothing is built when the package is imported: the first kernel call
builds, and the CPU paths never do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 240

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # xp, w_hh, ys, c_T, T, B, H, stream
    "bilstm_scan_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    # q, k_t, v_t, k_buf, k_scale, v_buf, v_scale, pos, out,
    # B, Dk, Dv, WP, w, F, nh, inv_sqrt, stream
    "ring_int8_step_f32": [_P] * 9 + [_I] * 7 + [_F, _P],
    "ring_int8_step_bf16": [_P] * 9 + [_I] * 7 + [_F, _P],
}

_lib = None
# what the last build did: seconds, command, and nvcc's -Xptxas -v
# lines (registers, shared memory and spills of every kernel)
last_build: dict = {}


def _nvcc() -> str:
    """nvcc from $CUDA_HOME, else from PATH; raise if neither has it."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def build() -> Path:
    """Compile all sources (if this exact build is not on disk yet) and
    return the library's path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"liblookonce_kernels_{h.hexdigest()[:16]}.so"
    if lib.is_file():
        last_build.update(seconds=0.0, cached=True, path=str(lib),
                          ptxas=[])
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    lines = (proc.stdout + proc.stderr).splitlines()
    last_build.update(
        seconds=secs, cached=False, path=str(lib), command=" ".join(cmd),
        ptxas=[ln for ln in lines if "ptxas" in ln])
    return lib


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
