"""How the port builds its CUDA kernels, checked without a compiler:
one nvcc -c on each csrc/*.cu, all started together, and one link into
a hashed library under the build directory, with the flags the
kernels' numerics rely on, nothing built on import, and a clear error
when nvcc is missing."""

import ctypes
import pathlib
import re
import subprocess
import sys

import pytest

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops.attn_step import VARIANTS


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Stand-in for nvcc: records each command and writes its -o file."""
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return subprocess.CompletedProcess(
            cmd, 0, stdout="", stderr="ptxas info    : Used 92 registers\n")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "last_build", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    return calls


def test_one_nvcc_call_for_all_sources(fake_nvcc, tmp_path):
    """One nvcc call a source, then one link of their objects (the name
    is kept from the single call for all sources that this replaced)."""
    lib = _build.build()
    sources = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    assert len(sources) == 4 and len(fake_nvcc) == len(sources) + 1
    compiles, link = fake_nvcc[:-1], fake_nvcc[-1]
    assert sorted(cmd[-1] for cmd in compiles) == sources
    for cmd in compiles:
        assert "-c" in cmd and "-shared" not in cmd
        for flag in ("arch=compute_90a,code=sm_90a", "-fPIC", "-O3"):
            assert flag in cmd
        assert cmd[cmd.index("-Xptxas") + 1] == "-v"
        # fast-math would change expf and division: the ring kernel's
        # int8 writes must match the plain version bit for bit
        assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    objs = sorted(cmd[cmd.index("-o") + 1] for cmd in compiles)
    assert "-shared" in link and sorted(link[link.index("-o") + 2:]) == objs
    assert not any(pathlib.Path(o).exists() for o in objs)
    assert lib.parent == tmp_path / "_build" and lib.is_file()
    assert lib.name.startswith("liblookonce_kernels_") and lib.suffix == ".so"
    assert _build.last_build["ptxas"] == [
        "ptxas info    : Used 92 registers"] * len(fake_nvcc)
    # the same sources and flags are not built twice
    assert _build.build() == lib and len(fake_nvcc) == len(sources) + 1
    assert _build.last_build["cached"]


def _c_entries():
    """{name: number of parameters} of every exported C entry in
    csrc/*.cu, written out or through the ATTN_STEP_ENTRY macro."""
    out = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            if m.group(1) != "name":           # the macro's own template
                out[m.group(1)] = len(m.group(2).split(","))
        macro = re.search(r"#define ATTN_STEP_ENTRY\(name, T, S\)(.*?)\{",
                          text, re.S)
        if macro:
            n_args = len(re.search(r"\(([^)]*)\)", macro.group(1).split(
                "name", 1)[1]).group(1).split(","))
            for m in re.finditer(r"^ATTN_STEP_ENTRY\((\w+),", text, re.M):
                out[m.group(1)] = n_args
    return out


def test_signatures_match_the_sources():
    """Every C entry of the sources has a ctypes signature of its arity,
    pointers as c_void_p (a c_int would cut them to 32 bits)."""
    entries = _c_entries()
    assert set(entries) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert len(argtypes) == entries[name], name
        assert argtypes[-1] is ctypes.c_void_p, name      # the stream
    attn = {n: a for n, a in _build._SIGNATURES.items()
            if n.startswith("attn_step_")}
    assert sorted(attn) == sorted(VARIANTS.values())
    for argtypes in attn.values():
        assert argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
    # the ring step: 10 pointers (q, k_t, v_t, the ring, pos, the arrival
    # counter, out), 7 ints (B, Dk, Dv, WP, w, F, nh), 1/sqrt
    for name in ("ring_int8_step_f32", "ring_int8_step_bf16"):
        assert _build._SIGNATURES[name] == [ctypes.c_void_p] * 10 + [
            ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build._nvcc() == str(tmp_path / "bin" / "nvcc")


def test_importing_the_port_builds_nothing():
    code = (
        "import lookoncetohear_tpu_torch.serve.engine, "
        "lookoncetohear_tpu_torch.ops.ring_step as r, "
        "lookoncetohear_tpu_torch.ops.attn_step as a, "
        "lookoncetohear_tpu_torch._build as b\n"
        "assert b._lib is None and not b.last_build\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
