"""How the port builds its CUDA kernels, checked without a compiler:
one nvcc call on every csrc/*.cu into a hashed library under the build
directory, with the flags the kernels' numerics rely on, nothing built
on import, and a clear error when nvcc is missing."""

import pathlib
import subprocess
import sys

import pytest

from lookoncetohear_tpu_torch import _build


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
    lib = _build.build()
    assert len(fake_nvcc) == 1
    cmd = fake_nvcc[0]
    sources = sorted(str(p) for p in _build.CSRC.glob("*.cu"))
    assert len(sources) == 2 and cmd[-len(sources):] == sources
    for flag in ("arch=compute_90a,code=sm_90a", "-shared", "-fPIC", "-O3"):
        assert flag in cmd
    assert cmd[cmd.index("-Xptxas") + 1] == "-v"
    # fast-math would change expf and division: the ring kernel's int8
    # writes must match the plain version bit for bit
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert lib.parent == tmp_path / "_build" and lib.is_file()
    assert lib.name.startswith("liblookonce_kernels_") and lib.suffix == ".so"
    assert _build.last_build["ptxas"] == ["ptxas info    : Used 92 registers"]
    # the same sources and flags are not built twice
    assert _build.build() == lib and len(fake_nvcc) == 1
    assert _build.last_build["cached"]


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
        "lookoncetohear_tpu_torch._build as b\n"
        "assert b._lib is None and not b.last_build\n")
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
