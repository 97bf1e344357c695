"""The readers of the program's spans (`lookoncetohear_tpu_torch`'s
`profiling.span`) on hand-made traces with known spans and kernels, and
their entries in the manifest."""

from types import SimpleNamespace

import pytest

from benchmark.harness.cell import BENCH_DIR, reader
from benchmark.harness.trace import Trace

SERVE = ["flagship.serve64", "net_default.serve64"]
TRAIN = ["net_default.train8x5s", "flagship.train8x5s"]
SPAN_METRICS = {"engine_own_ms.serve": ("engine", SERVE),
                "engine_launch_ms.serve": ("engine", SERVE),
                "idle_pending.serve": ("device", SERVE),
                "forward_ms.train": ("trainer", TRAIN),
                "update_ms.train": ("trainer", TRAIN),
                "update_host_ms.train": ("trainer", TRAIN)}


def serving():
    """Two calls of a pipelined engine, the second of which fetches,
    then a drain. Kernels busy 0-10, 30-40, 60-100, 110-120 (us): idle
    10-30, 40-60 and 100-110."""
    kernels = [("replay_k", 0.0, 10.0), ("replay_k", 30.0, 40.0),
               ("replay_k", 60.0, 100.0), ("replay_k", 110.0, 120.0)]
    host = [("bench.step_pipelined", 0.0, 20.0),
            ("engine.step", 1.0, 19.0),
            ("engine.input", 2.0, 8.0), ("engine.input_wait", 3.0, 7.0),
            ("engine.replay", 8.0, 10.0), ("engine.stage_out", 10.0, 12.0),
            ("bench.step_pipelined", 21.0, 70.0),
            ("engine.step", 22.0, 69.0),
            ("engine.input", 23.0, 25.0),
            ("engine.replay", 25.0, 28.0), ("engine.stage_out", 28.0, 29.0),
            ("engine.fetch", 29.0, 66.0),
            # 12 us of it over the idle 40-60, 0 over busy time
            ("engine.fetch_wait", 34.0, 52.0),
            # a wait outside any call (the drain): idle 100-108 under it
            ("engine.fetch", 98.0, 112.0),
            ("engine.fetch_wait", 99.0, 108.0)]
    return Trace(kernels, [(("engine.replay",), 60.0)], host)


def training():
    """Two traced steps; the backward's kernels are launched from
    autograd's thread, under none of the step's spans."""
    kernels = [("k", 0.0, 100.0)]
    launches = [(("aten::mm", "block.intra", "train.forward"), 30.0),
                (("aten::add", "train.forward"), 10.0),
                (("aten::mm", "autograd::engine::evaluate_function"), 50.0),
                (("aten::mul_", "train.clip"), 4.0),
                (("aten::_foreach_add_", "Optimizer.step#Adam.step",
                  "train.optimizer"), 6.0)]
    host = [("train.forward", 0.0, 20.0), ("train.backward", 20.0, 60.0),
            ("train.clip", 60.0, 63.0), ("train.optimizer", 63.0, 70.0),
            ("train.forward", 70.0, 80.0), ("train.backward", 80.0, 90.0),
            ("train.clip", 90.0, 91.0), ("train.optimizer", 91.0, 96.0)]
    return Trace(kernels, launches, host)


def ctx_of(trace, trace_steps=2):
    return {"trace": trace,
            "cell": SimpleNamespace(traffic={"trace_steps": trace_steps})}


def test_engine_own_work_subtracts_only_the_nested_waits():
    # the second call holds the fetch: 47 us less its one wait of 18;
    # the drain's wait, outside it, is not taken off
    assert reader("engine_own_ms.serve")(ctx_of(serving())) == \
        pytest.approx((47.0 - 18.0) / 1e3)


def test_engine_launch_is_the_mean_replay_span():
    assert reader("engine_launch_ms.serve")(ctx_of(serving())) == \
        pytest.approx((2.0 + 3.0) / 2 / 1e3)


def test_idle_pending_counts_only_idle_under_a_wait():
    # 50 us idle of the 120 us window; under a wait: 40-52 and 100-108
    # (the drain's); the input wait at 3-7 is over busy time
    tr = serving()
    share = reader("idle_pending.serve")(ctx_of(tr))
    assert share == pytest.approx(100.0 * (12.0 + 8.0) / 120.0)
    assert share <= reader("device_idle.serve")(ctx_of(tr))


def test_idle_pending_merges_overlapping_waits():
    tr = serving()
    tr.host.append(("engine.input_wait", 45.0, 55.0))
    assert reader("idle_pending.serve")(ctx_of(tr)) == \
        pytest.approx(100.0 * (15.0 + 8.0) / 120.0)


def test_training_readers_split_the_step():
    ctx = ctx_of(training())
    assert reader("forward_ms.train")(ctx) == pytest.approx(40.0 / 2 / 1e3)
    assert reader("update_ms.train")(ctx) == pytest.approx(10.0 / 2 / 1e3)
    assert reader("update_host_ms.train")(ctx) == \
        pytest.approx((3.0 + 7.0 + 1.0 + 5.0) / 2 / 1e3)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_readers_return_none_without_their_spans(metric):
    """No trace, or a trace of a program without spans (the benchmark's
    own ranges and the ops alone, as before the spans existed)."""
    read = reader(metric)
    assert read(ctx_of(None)) is None
    bare = Trace([("k", 0.0, 10.0), ("k", 20.0, 30.0)],
                 [(("aten::mm", "bench.train_step"), 20.0)],
                 [("bench.step_pipelined", 0.0, 30.0),
                  ("bench.train_step", 0.0, 30.0),
                  ("cudaEventSynchronize", 12.0, 18.0)])
    assert read(ctx_of(bare)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_manifest_entries_of_the_span_metrics(manifest, metric):
    (entry,) = [m for m in manifest["per_layer"] if m["name"] == metric]
    layer, cells = SPAN_METRICS[metric]
    assert (BENCH_DIR / "metrics" / f"{metric}.py").is_file()
    assert entry["source"] == "program_span"
    assert entry["layer"] == layer
    assert entry["workloads"] == cells
    assert entry["moves"] == ("rt_streams" if cells is SERVE
                              else "train_audio_rate")
