"""The trace arithmetic on a hand-made trace: busy and idle time, the
kernels of a CPU range (nested ranges counted once), kernels by name
and the idle gaps named by the host's innermost range; the readers
that share it, and traced serving and offline runs on the CPU."""

import time

import pytest

from benchmark.harness import offline, serve
from benchmark.harness.cell import reader, work
from benchmark.harness.trace import Trace
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny_cell


def make():
    kernels = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("scan<64>", 20.0, 30.0),
               ("k1", 35.0, 40.0)]
    launches = [(("aten::mm", "BiLSTMScanBackward",
                  "autograd::engine::evaluate_function: BiLSTMScanBackward"),
                 4.0),
                (("BiLSTMScan", "bench.train_step"), 10.0),
                (("aten::add", "bench.train_step"), 7.0)]
    host = [("bench.train_step", 0.0, 50.0), ("cudaSync", 12.0, 19.0),
            ("aten::add", 31.0, 34.0)]
    return Trace(kernels, launches, host)


def test_busy_and_window():
    tr = make()
    assert tr.window_us == 40.0
    assert tr.busy_us == 12.0 + 10.0 + 5.0


def test_ranges_count_each_launch_once():
    tr = make()
    assert tr.range_us("BiLSTMScan") == 14.0
    assert tr.range_us("bench.train_step") == 17.0


def test_by_name_and_matching():
    tr = make()
    assert tr.by_name() == {"k1": 15.0, "k2": 7.0, "scan<64>": 10.0}
    assert tr.matching(("scan<", "64>")) == [10.0]


def test_idle_gaps_named_by_the_innermost_host_range():
    tr = make()
    assert tr.idle_gaps() == {"cudaSync": 8.0, "aten::add": 5.0}
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", 15.0 / 1e6]
    assert b["idle_gaps"][0] == ["cudaSync", 8.0 / 1e6]


def test_device_idle_readers_agree():
    ctx = {"trace": make()}
    share = 100.0 * (1 - 27.0 / 40.0)
    assert reader("device_idle.serve")(ctx) == share
    assert reader("device_idle.train")(ctx) == share
    assert reader("device_idle.offline")(ctx) == share


def test_dispatch_reads_the_mean_host_span():
    read = reader("dispatch_ms.serve")
    assert abs(read({"host_spans_s": [0.001, 0.003]}) - 2.0) < 1e-12
    assert read({"host_spans_s": []}) is None


def test_traced_serving_run_compares_every_step(monkeypatch):
    """A traced run on the CPU (the profiler stubbed): the host-timed
    and traced steps after the window are compared too, and the host's
    share of a call is read."""
    def fake_capture(run_steps):
        run_steps()
        return make()
    monkeypatch.setattr(serve, "capture", fake_capture)
    r = run_cell(tiny_cell("flagship.serve64"), 2 ** 31 + 29, 0.3, True,
                 "cpu", time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["dispatch_ms.serve"]["value"] > 0
    assert "wall_over_busy.serve" in r["metrics"]
    assert r["attempted"] % 4 == 0


def test_wall_over_busy_reads_the_window_against_the_trace():
    cell = tiny_cell("flagship.serve64")
    steps = cell.traffic["trace_steps"]
    # 27 us busy over the traced steps; the window 10% slower a step
    ctx = {"trace": make(), "cell": cell, "steps": 1000,
           "window_s": 1000 * 1.1 * 27e-6 / steps}
    assert abs(reader("wall_over_busy.serve")(ctx) - 110.0) < 1e-9
    assert reader("wall_over_busy.serve")(dict(ctx, trace=None)) is None


def test_offline_b2_roofline_sums_each_launchs_least_time():
    """Two traced calls of 2 clips (frames 101 and 51 at the tiny STFT):
    each block's intra scan (F-3 steps over the frames of both clips)
    and inter scan (T-3 steps over both clips' F bins), 2 x 2 launches a
    call, 10 us each."""
    cell = tiny_cell("embed.enroll4x5s")
    mp = cell.config["model_params"]
    name = "void bilstm_scan_kernel<64, false>(float const*)"
    kernels = [(name, 20.0 * j, 20.0 * j + 10.0) for j in range(8)]
    least = {}

    def least_s(ops, nbytes):
        least[(ops, nbytes)] = 1e-6 * ops / 1e9
        return least[(ops, nbytes)]
    ctx = {"trace": Trace(kernels), "cell": cell, "work": work,
           "least_s": least_s, "traced_samples": [800, 400],
           "rows_per_step": 2}
    f = mp["n_fft"] // 2 + 1
    b2 = work("b2").work
    expect = 0.0
    for t in (101, 51):
        for shape in ((f - 3, 2, 2 * t, 64), (t - 3, 2, 2 * f, 64)):
            expect += 2 * 1e-6 * b2(*shape)[0] / 1e9
    share = reader("roofline.b2.offline")(ctx)
    assert share == pytest.approx(100.0 * expect / 80e-6)
    assert reader("roofline.b2.offline")(dict(ctx, trace=make())) is None


def test_offline_mfu_counts_every_call_of_the_window():
    cell = tiny_cell("embed.enroll4x5s")
    mp = cell.config["model_params"]
    fwd = work("embed_forward").forward
    ctx = {"cell": cell, "work": work, "window_s": 2.0,
           "window_samples": [800, 400, 800], "rows_per_step": 2}
    assert reader("step_mfu.offline")(ctx) == pytest.approx(
        100.0 * 2 * (2 * fwd(mp, 800) + fwd(mp, 400)) / 2.0
        / cell.peak_flops)


def test_traced_offline_run(monkeypatch):
    """A traced offline run on the CPU (the profiler stubbed): the pool's
    `trace_passes` passes are traced and their lengths reach the
    readers."""
    seen = []

    def fake_capture(run_calls):
        run_calls()
        return make()
    monkeypatch.setattr(offline, "capture", fake_capture)
    read = reader("step_mfu.offline")
    monkeypatch.setattr(
        "benchmark.harness.cell.reader",
        lambda name: (lambda ctx: seen.append(ctx) or read(ctx))
        if name == "step_mfu.offline" else reader(name))
    cell = tiny_cell("embed.enroll4x5s")
    r = run_cell(cell, 2 ** 31 + 31, 0.2, True, "cpu", time.perf_counter())
    assert r["correct"]
    assert set(r["metrics"]) == {"step_mfu.offline", "device_idle.offline"}
    pool = len(cell.traffic["lengths_s"]) // cell.traffic["batch"]
    assert sorted(seen[0]["traced_samples"]) == sorted(
        seen[0]["window_samples"][:pool] * cell.traffic["trace_passes"])
