"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by an `nvcc` of its own, all started
together, and the objects are linked into one shared library with a
plain `extern "C"` interface, loaded with `ctypes`. No source
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# a shared library from sources in one call (the tools that build one
# source alone use these too); build() compiles each source with them
# less -shared, and links with -shared
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 240

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # xp, w_hh, ys, c_T, T, B, H, stream
    "bilstm_scan_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    # xp, w_hh, h0, c0, y, cs, c_T, T, D, N, H, R, stream
    "bilstm_train_fwd_f32": [_P] * 7 + [_I] * 5 + [_P],
    # xp, w_hh, h0, c0, y, cs, dy, dc_T, dxp, dh0, dc0, T, D, N, H, R,
    # stream
    "bilstm_train_bwd_f32": [_P] * 11 + [_I] * 5 + [_P],
    # R, backward, int[5] out
    "bilstm_train_info": [_I, _I, _P],
    # at H=128: xp, w_hh, ys, c_T, T, B, R, C, stream
    "bilstm_scan_h128_f32": [_P] * 4 + [_I] * 4 + [_P],
    # xp, w_hh, h0, c0, y, cs, gates, c_T, T, D, N, R, C, stream
    "bilstm_train_fwd_h128_f32": [_P] * 8 + [_I] * 5 + [_P],
    # gates, w_hh, c0, cs, dy, dc_T, dxp, dh0, dc0, T, D, N, R, C, stream
    "bilstm_train_bwd_h128_f32": [_P] * 9 + [_I] * 5 + [_P],
    # R, C, train, int[6] out
    "bilstm_h128_info": [_I, _I, _I, _P],
    # d, out, n, stream
    "bilstm_train_rcp_f32": [_P, _P, _I, _P],
    # q, k_t, v_t, k_buf, k_scale, v_buf, v_scale, pos, arrivals, out,
    # B, Dk, Dv, WP, w, F, nh, inv_sqrt, stream
    "ring_int8_step_f32": [_P] * 10 + [_I] * 7 + [_F, _P],
    "ring_int8_step_bf16": [_P] * 10 + [_I] * 7 + [_F, _P],
    # q, k_t, v_t, k_buf, v_buf, k_scale, v_scale (NULL for a float
    # ring), out, B, W1, Dk, Dv, inv_sqrt, stream
    **{name: [_P] * 8 + [_I] * 4 + [_F, _P] for name in (
        "attn_step_f32", "attn_step_bf16", "attn_step_f32_bf16kv",
        "attn_step_f32_int8kv", "attn_step_bf16_int8kv")},
    # ptrs (n x: x, out, scale, bias, alpha), dims (n x: rows, groups,
    # segs, width, row_stride, group_stride, vec, team), eps[n], n, stream
    "flat_norm_f32": [_P, _P, _P, _I, _P],
    "flat_norm_bf16": [_P, _P, _P, _I, _P],
}

_lib = None
# what the last build did: seconds, command, and nvcc's -Xptxas -v
# lines (registers, shared memory and, on the lines without "ptxas",
# the stack frame and spills of every kernel)
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


def _run_all(cmds: list) -> list:
    """Run the commands at once, each to NVCC_TIMEOUT_S; their completed
    processes, in order."""
    with ThreadPoolExecutor(len(cmds)) as pool:
        return list(pool.map(lambda c: subprocess.run(
            c, capture_output=True, text=True, timeout=NVCC_TIMEOUT_S),
            cmds))


def build() -> Path:
    """Compile all sources (if this exact build is not on disk yet), one
    `nvcc` a source at once, link them, and return the library's
    path."""
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
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    cmds = [[_nvcc(), *flags, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
    t0 = time.perf_counter()
    try:
        done = _run_all(cmds)
        if all(p.returncode == 0 for p in done):
            done += _run_all([link])
        for p in done:
            if p.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"nvcc failed ({p.returncode}): {' '.join(p.args)}\n"
                    f"{p.stdout}\n{p.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    secs = time.perf_counter() - t0
    os.replace(tmp, lib)
    lines = "".join(p.stdout + p.stderr for p in done).splitlines()
    last_build.update(
        seconds=secs, cached=False, path=str(lib),
        command=" && ".join(" ".join(c) for c in (*cmds, link)),
        ptxas=[ln for ln in lines if "ptxas" in ln or "spill" in ln])
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
