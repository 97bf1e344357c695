"""The port and chip_smoke.py run where JAX is not installed: no import
of jax, flax, optax, the JAX package or pandas anywhere in them, no
scipy outside the port's data package, and a CPU engine step with jax
blocked from importing. chip_smoke.py reports no result without a card
or without the package beside it."""

import ast
import os
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
    """Kernels come from csrc/*.cu through nvcc, never from
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


# the modules that port the rest of the JAX package: the render-ahead
# cache, moving sources, process groups, the rank's device, profiling,
# the reference-checkpoint converter, the launcher, the demo and the two
# speaker-embedding precomputes
NEW_MODULES = ["data.prep.prerender", "data.motion", "parallel.distributed",
               "parallel.mesh", "profiling", "convert", "launch",
               "stream_demo", "data.prep.dvector_embeddings",
               "data.prep.nemo_embed"]


def test_new_modules_run_with_jax_blocked(tmp_path):
    """Each module imports, and its pure-host path runs (a moving-source
    render through the native library, a cache round trip, a FLOP
    count, the launcher's script), with JAX unimportable."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "lookoncetohear_tpu"):
    sys.modules[m] = None
import importlib, os
import numpy as np, torch
mods = {{n: importlib.import_module("lookoncetohear_tpu_torch." + n)
        for n in {NEW_MODULES!r}}}
sim = mods["data.motion"].MotionSimulator(16000)
irs = np.zeros((2, 2, 8), np.float32); irs[:, :, 0] = 1
sim.set_hrtf_arrays(irs, np.eye(3, dtype=np.float32)[:2])
sim.add_source(np.ones(800, np.float32), np.ones((3, 3), np.float32))
assert sim.simulate().shape == (1, 2, 800)
pre = mods["data.prep.prerender"]
class DS:
    def __len__(self): return 2
    def __getitem__(self, i):
        return {{"mixture": np.full((2, 4), i, np.float32)}}, {{}}
pre.render_split(DS(), {str(tmp_path)!r})
assert pre.PrerenderedDataset({str(tmp_path)!r})[1][0]["mixture"][0, 0] == 1
flops = mods["profiling"].cost_analysis(torch.mm, torch.ones(2, 3),
                                        torch.ones(3, 4))["flops"]
assert flops == 48, flops
assert not mods["parallel.distributed"].maybe_initialize("cpu")
assert not any(m.startswith(("jax", "flax")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LOOKONCE_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    files = {str(p.relative_to(ROOT / "lookoncetohear_tpu_torch"))
             for p in FILES if "lookoncetohear_tpu_torch" in p.parts}
    for n in NEW_MODULES:
        assert n.replace(".", "/") + ".py" in files, n


def test_film_and_crossval_run_with_jax_blocked(tmp_path):
    """FiLM and the scaper cross-validation harness import and run with
    JAX unimportable: a FiLM forward, and `against_scaper` refusing
    without scaper (ImportError, which the CLI reports as a skip)."""
    code = """
import sys
for m in ("jax", "jaxlib", "flax", "optax", "lookoncetohear_tpu", "scaper"):
    sys.modules[m] = None
import torch
from lookoncetohear_tpu_torch.data import scaper_crossval
from lookoncetohear_tpu_torch.ops.film import FiLM
y = FiLM(4, 3)(torch.ones(2, 3, 5), torch.ones(2, 4))
assert y.shape == (2, 3, 5)
try:
    scaper_crossval.against_scaper("missing", "fg", "bg")
except ImportError:
    pass
else:
    raise AssertionError("against_scaper ran without scaper")
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


def test_every_jax_module_has_its_port():
    """Each module of the JAX package has a module of the same path in
    the port, but for the two Pallas kernel files, whose kernels are
    ported into lookoncetohear_tpu_torch/csrc/ (beside the flat norms'
    kernel, which replaces no Pallas kernel)."""
    def modules(pkg):
        return {str(p.relative_to(ROOT / pkg))
                for p in (ROOT / pkg).rglob("*.py")}
    missing = modules("lookoncetohear_tpu") - modules(
        "lookoncetohear_tpu_torch")
    assert missing == {"ops/pallas_attention.py", "ops/pallas_lstm.py"}
    assert sorted(p.name for p in (ROOT / "lookoncetohear_tpu_torch" /
                                   "csrc").glob("*.cu")) == [
        "attn_step.cu", "bilstm_scan.cu", "flat_norm.cu", "ring_int8_step.cu"]


def test_dvector_cli_runs_with_jax_blocked(tmp_path):
    """The d-vector precompute's embednet backend with JAX unimportable:
    a tiny EmbedNet saved as the trainer saves it (npz under the name
    best.ckpt), two utterances, on the CPU; each embedding is the net's
    output on the file's mono audio duplicated to both ears."""
    code = f"""
import sys
for m in ("jax", "jaxlib", "flax", "optax", "lookoncetohear_tpu"):
    sys.modules[m] = None
import json, os
import numpy as np, torch
from lookoncetohear_tpu_torch.data.audio_io import write_wav
from lookoncetohear_tpu_torch.data.prep import dvector_embeddings as dv
from lookoncetohear_tpu_torch.models.net import EmbedNet
from lookoncetohear_tpu_torch.weights import save_npz
tmp = {str(tmp_path)!r}
mp = dict(embed_dim=32, num_ch=2, n_fft=64, stride=32, num_blocks=1)
cfg = os.path.join(tmp, "embed.json")
with open(cfg, "w") as f:
    json.dump({{"pl_module_args": {{
        "model": "lookoncetohear_tpu.models.net.EmbedNet",
        "model_params": mp}}}}, f)
torch.manual_seed(0)
net = EmbedNet(**mp, device="cpu").eval()
os.makedirs(os.path.join(tmp, "run"))
save_npz(os.path.join(tmp, "run", "best.ckpt"), net)
spk = os.path.join(tmp, "src", "test-clean", "61")
os.makedirs(spk)
g = np.random.default_rng(0)
wavs = {{"61-0-0.wav": 0.3 * g.standard_normal(4000),
         "61-0-1.wav": 0.3 * g.standard_normal((2, 6000))}}
for name, a in wavs.items():
    write_wav(os.path.join(spk, name), a.astype(np.float32), 16000)
dv.main(["--backend", "embednet", "--embednet_config", cfg,
         "--embednet_run_dir", os.path.join(tmp, "run"), "--root_dir",
         os.path.join(tmp, "src"), "--output_dir", os.path.join(tmp, "out"),
         "--device", "cpu"])
got = np.load(os.path.join(tmp, "out", "test-clean", "61.npz"))
assert sorted(got.files) == sorted(wavs)
for name, a in wavs.items():
    mono = np.atleast_2d(a.astype(np.float32)).mean(0)
    with torch.no_grad():
        want = net(torch.from_numpy(np.stack([mono, mono])[None]))[0]
    np.testing.assert_allclose(got[name], want.numpy(), rtol=1e-5,
                               atol=1e-6)
assert not any(m.startswith(("jax", "flax")) for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
