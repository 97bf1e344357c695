"""The program's spans (`profiling.span`): off, one shared no-op context
and no record; under `torch.profiler`, the engine's, the trainer's and
the model's ranges nested as the layers are. On the card, the spans of
20 graph replays stay off the device's operations, add no kernel, and
sit on the kernels' clock.

Tiny model (D=8, 2 blocks, H=8, 2 heads, chunk 16 + pad 8, window 6),
float32, one torch thread: a few seconds in all.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from lookoncetohear_tpu_torch import profiling
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine

PACKAGE = Path(__file__).resolve().parent.parent / "lookoncetohear_tpu_torch"
TINY = dict(embed_dim=16, stft_chunk_size=16, stft_pad_size=8, num_ch=2,
            D=8, L=2, B=2, H=8, local_atten_len=6, use_attn=True,
            lookahead=True, chunk_causal=True)
MODEL_SPANS = {"net.encode", "block.intra", "block.inter", "block.attn",
               "net.decode"}
LAYERS = ("engine.", "train.", "net.", "block.")
# on the card, widths the kernels take (H=64, F=65), in the serving
# precision: bf16 with the int8 K/V ring
CARD = dict(TINY, embed_dim=32, stft_chunk_size=96, stft_pad_size=32, D=32,
            H=64, local_atten_len=5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(model=TINY, n=2, **kw):
    torch.manual_seed(0)
    net = Net(**model, device="cpu")
    eng = StreamingEngine(net, max_streams=n, **kw)
    rng = np.random.default_rng(0)
    for s in range(n):
        eng.add_stream(s, rng.standard_normal(
            model["embed_dim"]).astype(np.float32))
    return eng


def _chunks(n=2, seed=1, chunk=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 2, chunk)).astype(np.float32)


def _named(events, name):
    return sorted((e for e in events if e.name == name),
                  key=lambda e: e.time_range.start)


def _ancestors(ev):
    out, node = [], ev.cpu_parent
    while node is not None:
        out.append(node.name)
        node = node.cpu_parent
    return out


def test_span_off_is_one_shared_noop_and_leaves_no_record(monkeypatch):
    assert not autograd_profiler._is_profiler_enabled
    assert profiling.span("engine.step") is profiling.span("train.forward")
    opened = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: opened.append(name))
    eng = _engine(device="cpu")
    for _ in range(2):
        eng.step_pipelined(_chunks(), depth=1)
    eng.step(_chunks())
    assert opened == []


def test_the_profiler_flag_flips_under_torch_profiler():
    """`span` reads this flag: a torch that moves it must fail here, not
    drop every span silently."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(profiling.span("engine.step"),
                          torch.profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False


def test_engine_spans_nest_as_the_layers_do():
    eng = _engine(device="cpu")
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        assert eng.step_pipelined(_chunks(seed=1), depth=1) is None
        assert eng.step_pipelined(_chunks(seed=2), depth=1) is not None
    events = prof.events()
    steps = _named(events, "engine.step")
    assert len(steps) == 2
    second = steps[1]
    children = {e.name for e in events if e.cpu_parent is second}
    assert {"engine.input", "engine.eager_step", "engine.stage_out",
            "engine.fetch"} <= children
    # the mask changes once, when the streams become primed
    assert [e.cpu_parent for e in _named(events, "engine.mask")] == [second]
    for name in MODEL_SPANS:
        found = _named(events, name)
        assert found, name
        for e in found:
            assert "engine.eager_step" in _ancestors(e), name
    assert len(_named(events, "block.intra")) == 2 * TINY["B"]


def test_train_step_records_its_phases_in_order(tmp_path):
    from lookoncetohear_tpu_torch.train.tasks import TSETask
    from lookoncetohear_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    task = TSETask(model="lookoncetohear_tpu_torch.models.net.Net",
                   model_params=TINY, lr=1e-3)
    trainer = Trainer(task, str(tmp_path), grad_clip=1.0, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"mixture": torch.randn(2, 2, 800, generator=g),
             "target": torch.randn(2, 2, 800, generator=g),
             "embedding_gt": torch.randn(2, 1, 16, generator=g)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(batch, 0)
    events = prof.events()
    phases = sorted((e for e in events if e.name.startswith("train.")),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in phases] == ["train.forward", "train.backward",
                                        "train.clip", "train.optimizer"]
    for a, b in zip(phases, phases[1:]):
        assert a.time_range.end <= b.time_range.start
    for name in MODEL_SPANS:
        found = _named(events, name)
        assert found, name
        assert all("train.forward" in _ancestors(e) for e in found), name


def test_span_names_name_their_layer():
    """Every span of the package starts with its layer, never with the
    benchmark's own prefix (`bench.`), and never holds `BiLSTMScan`,
    which the training scans' roofline finds its ranges by."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        names |= set(re.findall(r'\bspan\("([^"]+)"\)', path.read_text()))
    assert MODEL_SPANS | {"engine.step", "engine.replay", "engine.fetch_wait",
                          "engine.input_wait", "train.optimizer"} <= names
    for name in names:
        assert name.startswith(LAYERS), name
        assert not name.startswith("bench.") and "BiLSTMScan" not in name


def _replays(eng, n, x):
    for _ in range(n):
        eng.step(x)
    torch.cuda.synchronize()


def _device_ops(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


@pytest.mark.cuda
def test_spans_over_graph_replays_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng = _engine(CARD, n=4, dtype=torch.bfloat16, kv_dtype=torch.int8,
                  device="cuda")
    x = torch.from_numpy(_chunks(n=4, chunk=CARD["stft_chunk_size"])).to(
        "cuda", torch.bfloat16)
    _replays(eng, 3, x)                     # primes, captures both graphs
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as on:
        _replays(eng, 20, x)
    with monkeypatch.context() as m:
        m.setattr(profiling, "record_function",
                  lambda name: contextlib.nullcontext())
        with profile(activities=acts) as off:
            _replays(eng, 20, x)
    cuda = torch.autograd.DeviceType.CUDA
    names = {e.name for e in on.events() if e.name.startswith(LAYERS)}
    assert {"engine.step", "engine.replay"} <= names
    assert not names & {e.name for e in _device_ops(on)}
    assert len(_device_ops(on)) == len(_device_ops(off)) > 0
    assert not any(e.name.startswith(LAYERS) for e in off.events())

    # one clock: the kernels of each graph launch (the CUDA runtime's
    # correlation id of its `cudaGraphLaunch`) start after the start of
    # the `engine.replay` span around that launch
    cpu = torch.autograd.DeviceType.CPU
    kineto = on.profiler.kineto_results.events()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in kineto if e.name() == "engine.replay"
                   and e.device_type() == cpu)
    launches = {e.correlation_id(): e.start_ns() for e in kineto
                if e.name() == "cudaGraphLaunch"}
    assert len(spans) == len(launches) == 20
    starts: dict = {}
    for e in kineto:
        if e.device_type() == cuda and not e.is_user_annotation() \
                and e.correlation_id() in launches:
            starts.setdefault(e.correlation_id(), []).append(e.start_ns())
    for corr, t in launches.items():
        (s0,) = [a for a, b in spans if a <= t <= b]
        assert starts.get(corr), "no kernel of a graph launch"
        assert min(starts[corr]) >= s0
