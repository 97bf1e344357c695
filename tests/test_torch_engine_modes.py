"""The port's engine modes on the CPU (the card's CUDA-graph step is held
to the eager step by tests/test_torch_cuda.py and chip_smoke.py):
throughput mode (`step_pipelined` + `drain`) against `step`, the
benchmarks' keys against the JAX engine's, the static buffers a CUDA
graph needs (every carried tensor written in place), and the port's
entry module importing without JAX.

Small model (D=16, 2 blocks, H=16, 2 heads, chunk 32 + pad 16, window
5), float32: throughput mode runs the same steps in the same order, so
its outputs equal `step`'s exactly.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = dict(embed_dim=32, stft_chunk_size=32, stft_pad_size=16,
             num_ch=2, D=16, L=2, I=1, J=1, B=2, H=16,
             local_atten_len=5, use_attn=True, lookahead=True,
             chunk_causal=True)
C = SMALL["stft_chunk_size"]
KV_DTYPES = [None, torch.int8]
# the keys of the JAX engine's reports (lookoncetohear_tpu/serve/engine.py
# `benchmark` and `benchmark_device`)
JAX_BENCHMARK_KEYS = {"p50_ms_incl_transport", "p99_ms_incl_transport",
                      "rtf_incl_transport", "transport_inclusive", "streams"}
JAX_DEVICE_KEYS = {"device_p50_ms", "device_p99_ms", "device_best_ms", "rtf",
                   "streams"}


@pytest.fixture(scope="module")
def net():
    torch.manual_seed(0)
    return Net(**SMALL, device="cpu")


def _engine(net, kv_dtype=None, n=2):
    eng = StreamingEngine(net, max_streams=n, kv_dtype=kv_dtype,
                          device="cpu")
    emb = np.random.default_rng(11).standard_normal(
        (n, SMALL["embed_dim"])).astype(np.float32)
    for s in range(n):
        eng.add_stream(s, emb[s])
    return eng


def _chunks(n_steps, n=2, seed=12):
    return np.random.default_rng(seed).standard_normal(
        (n_steps, n, 2, C)).astype(np.float32)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES, ids=str)
@pytest.mark.parametrize("depth", [1, 3, 8])
def test_pipelined_matches_sequential(net, kv_dtype, depth):
    """Throughput mode returns exactly the sequential outputs, in order,
    `depth` calls late; `drain` returns the rest (mirrors the JAX
    package's tests/test_serve.py test of the same name)."""
    xs = _chunks(6)
    eng = _engine(net, kv_dtype)
    ref = [eng.step(x).numpy() for x in xs]
    eng2 = _engine(net, kv_dtype)
    got = []
    for i, x in enumerate(xs):
        y = eng2.step_pipelined(x, depth=depth)
        assert (y is None) == (i < depth)
        if y is not None:
            got.append(y)
    got.extend(eng2.drain())
    assert eng2.drain() == []
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_dtype", KV_DTYPES, ids=str)
def test_carried_tensors_are_written_in_place(net, kv_dtype):
    """A captured graph reads and writes fixed buffers: every carried
    tensor (state leaves, input tail, embeddings) stays the same tensor
    through masked and all-primed steps, attach and detach."""
    eng = _engine(net, kv_dtype, n=3)
    eng.remove_stream(2)
    before = [t.data_ptr() for t in eng._carried() + [eng.embeds]]
    xs = _chunks(4, n=3)
    eng.step(xs[0])                                   # masked
    eng.add_stream(2, np.ones(SMALL["embed_dim"], np.float32))
    for x in xs[1:]:
        eng.step(x)                                   # masked, then primed
    assert eng.primed.all()
    after = [t.data_ptr() for t in eng._carried() + [eng.embeds]]
    assert after == before
    assert not eng.cuda_graph                         # CPU: always eager


def test_benchmarks_report_the_jax_engines_keys(net):
    eng = _engine(net)
    rep = eng.benchmark(n_iters=3, warmup=1)
    assert set(rep) == JAX_BENCHMARK_KEYS
    assert rep["streams"] == 2 and rep["transport_inclusive"] is True
    assert np.isfinite(rep["rtf_incl_transport"])
    dev = eng.benchmark_device(n_short=2, n_long=4, repeats=2)
    assert set(dev) == JAX_DEVICE_KEYS
    assert dev["streams"] == 2 and np.isfinite(dev["rtf"])


@pytest.mark.parametrize("kv_dtype", KV_DTYPES, ids=str)
def test_benchmark_device_leaves_the_live_state(net, kv_dtype):
    eng = _engine(net, kv_dtype)
    xs = _chunks(3)
    eng.step(xs[0])
    eng.step(xs[1])
    before = [t.clone() for t in eng._carried()]
    eng.benchmark_device(n_short=1, n_long=3, repeats=1)
    for t, b in zip(eng._carried(), before):
        assert torch.equal(t, b)
    ref = _engine(net, kv_dtype)
    for x in xs:
        want = ref.step(x)
    assert torch.equal(eng.step(xs[2]), want)


def test_entry_runs_on_the_cpu():
    from lookoncetohear_tpu_torch.entry import FLAGSHIP, entry
    rng_before = torch.random.get_rng_state()
    fn, (x, embeds) = entry(device="cpu")
    assert torch.equal(torch.random.get_rng_state(), rng_before)
    assert tuple(x.shape) == (2, 2, 16000)
    assert tuple(embeds.shape) == (2, 1, 256)
    y = fn(x, embeds)
    assert tuple(y.shape) == (2, 2, 16000) and torch.isfinite(y).all()
    # the parameters come from a fixed seed: a second entry() gives the
    # same forward on a random input
    fn2, _ = entry(device="cpu")
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal((1, 2, 4000), np.float32))
    er = torch.from_numpy(rng.standard_normal((1, 1, 256), np.float32))
    with torch.no_grad():
        assert torch.equal(fn(xr, er), fn2(xr, er))
    assert FLAGSHIP["H"] == 64 and FLAGSHIP["B"] == 3


def test_entry_imports_without_jax_and_needs_a_card():
    code = """
import sys
for m in ("jax", "jaxlib", "flax", "optax", "lookoncetohear_tpu"):
    sys.modules[m] = None
import torch
from lookoncetohear_tpu_torch import entry
if not torch.cuda.is_available():
    try:
        entry.entry()
    except RuntimeError as e:
        assert "no CUDA device" in str(e)
    else:
        raise AssertionError("entry() ran without a card")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
