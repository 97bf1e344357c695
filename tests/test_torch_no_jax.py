"""The port and chip_smoke.py run where JAX is not installed: no import
of jax, flax, optax, the JAX package or pandas anywhere in them, no
scipy outside the port's data package, and a CPU engine step with jax
blocked from importing. chip_smoke.py reports no result without a card
or without the package beside it."""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the machine with the card has no JAX and no pandas; scipy (wav IO,
# resample_poly, lfilter, fftconvolve) only in the host-side data
# pipeline, lookoncetohear_tpu_torch/data/
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "lookoncetohear_tpu",
             "pandas"}
SCIPY_ALLOWED = ROOT / "lookoncetohear_tpu_torch" / "data"
FILES = sorted((ROOT / "lookoncetohear_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    forbidden = FORBIDDEN if SCIPY_ALLOWED in path.parents \
        else FORBIDDEN | {"scipy"}
    assert not roots & forbidden, roots & forbidden


def test_no_extension_builds():
    """Kernels come from csrc/*.cu through one nvcc call, never from
    PyTorch's C++ extension builder or its headers."""
    pkg = ROOT / "lookoncetohear_tpu_torch"
    for p in list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "cpp_extension" not in p.read_text(), p
    for p in pkg.rglob("*.cu*"):
        assert "torch/extension.h" not in p.read_text(), p


def test_cpu_engine_step_with_jax_blocked():
    code = """
import sys
for m in ("jax", "jaxlib", "flax", "optax", "lookoncetohear_tpu"):
    sys.modules[m] = None
import numpy as np, torch
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
net = Net(embed_dim=32, stft_chunk_size=32, stft_pad_size=16, num_ch=2,
          D=16, L=2, B=2, H=16, local_atten_len=5, use_attn=True,
          device="cpu")
eng = StreamingEngine(net, max_streams=2, device="cpu")
eng.add_stream(0, np.ones(32, np.float32))
x = np.random.default_rng(0).standard_normal((2, 2, 32)).astype(np.float32)
for _ in range(2):
    y = eng.step(x)
assert y.shape == (2, 2, 32) and torch.isfinite(y).all()
assert not any(m.startswith(("jax", "flax")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert out.stdout == "" and "no CUDA device" in out.stderr
