"""The port's serving over several devices, profiling helpers, run ids,
launcher and demo, on the CPU:

  * `MultiDeviceEngine` over ["cpu", "cpu"] against one
    `StreamingEngine` over the same streams, at the float and the int8
    ring, through stream changes, over w + 3 steps: outputs within 1e-4
    of the single engine's peak (the same float32 arithmetic on half
    the batch; BLAS may sum in another order) and the engines' ring
    cursors equal after every step; `step_pipelined` + `drain` ==
    `step`;
  * `profiling`: a matmul's FLOPs = 2mnk exactly, the recorder's keys
    the JAX package's, a Chrome trace written;
  * `utils.get_run_id` as the JAX package's; the launcher's
    `--dry_run` script; the demo at random weights.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from lookoncetohear_tpu import profiling as jprof
from lookoncetohear_tpu import utils as jutils
from lookoncetohear_tpu_torch import launch, profiling, stream_demo
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.models.net import Net
from lookoncetohear_tpu_torch.serve.engine import (MultiDeviceEngine,
                                                   StreamingEngine)

TOL = 1e-4
TINY = dict(embed_dim=32, stft_chunk_size=32, stft_pad_size=16, num_ch=2,
            D=16, L=2, B=2, H=16, local_atten_len=5, use_attn=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cursors(eng):
    return [int(b["pos"]) for b in eng.state["blocks"] if "pos" in b]


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_engines_over_two_devices_match_one(kv_dtype):
    torch.manual_seed(0)
    net = Net(**TINY, device="cpu")
    sd = net.state_dict()
    n, steps = 4, TINY["local_atten_len"] + 3
    one = StreamingEngine(net, sd, max_streams=n, kv_dtype=kv_dtype,
                          device="cpu")
    two = MultiDeviceEngine(net, sd, max_streams=n, kv_dtype=kv_dtype,
                            devices=["cpu", "cpu"])
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    xs = rng.standard_normal((steps, n, 2, 32)).astype(np.float32)
    for s in (0, 1, 3):                    # slot 2 starts inactive
        one.add_stream(s, emb[s])
        two.add_stream(s, emb[s])
    peak = err = 0.0
    for i in range(steps):
        if i == 3:                         # a stream joins, one leaves
            for eng in (one, two):
                eng.add_stream(2, emb[2])
                eng.remove_stream(1)
        y1, y2 = one.step(xs[i]), two.step(xs[i])
        assert y2.shape == y1.shape == (n, 2, 32)
        peak = max(peak, y1.abs().max().item())
        err = max(err, (y1 - y2).abs().max().item())
        np.testing.assert_array_equal(two.primed, one.primed)
        np.testing.assert_array_equal(two.active, one.active)
        for eng in two.engines:
            assert _cursors(eng) == _cursors(one)
    assert peak > 0 and err <= TOL * peak, (err, peak)


def test_pipelined_split_engine_equals_step():
    torch.manual_seed(0)
    net = Net(**TINY, device="cpu")
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((6, 4, 2, 32)).astype(np.float32)
    engs = [MultiDeviceEngine(net, max_streams=4, devices=["cpu", "cpu"])
            for _ in range(2)]
    for eng in engs:
        for s in range(4):
            eng.add_stream(s, np.ones(32, np.float32) * (s + 1))
    want = [engs[0].step(x).numpy() for x in xs]
    got = [y for x in xs if (y := engs[1].step_pipelined(x, depth=2))
           is not None] + engs[1].drain()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_split_engine_checks_its_slots():
    net = Net(**TINY, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        MultiDeviceEngine(net, max_streams=5, devices=["cpu", "cpu"])
    eng = MultiDeviceEngine(net, max_streams=4, devices=["cpu", "cpu"])
    with pytest.raises(IndexError):
        eng.add_stream(4, np.zeros(32, np.float32))
    eng.add_stream(3, np.ones(32, np.float32))
    assert eng.engines[1].active.tolist() == [False, True]


def test_cost_analysis_counts_a_matmul():
    a, b = torch.ones(64, 128), torch.ones(128, 32)
    costs = profiling.cost_analysis(lambda a, b: a @ b, a, b)
    assert costs["flops"] == 2 * 64 * 128 * 32
    assert costs["bytes_accessed"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    net = Net(**TINY, device="cpu")
    with torch.no_grad():
        costs = profiling.cost_analysis(
            net, torch.zeros(1, 2, 640), torch.zeros(1, 1, 32))
    assert np.isfinite(costs["flops"]) and costs["flops"] > 1e6


def test_latency_recorder_keys_are_the_jax_packages():
    rec, jrec = profiling.LatencyRecorder(), jprof.LatencyRecorder()
    assert rec.summary() == jrec.summary() == {}
    for r in (rec, jrec):
        for _ in range(5):
            with r.measure():
                sum(range(1000))
    s = rec.summary()
    assert set(s) == set(jrec.summary())
    assert s["n"] == 5 and 0 <= s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]


def test_trace_and_step_time(tmp_path):
    x = torch.ones(32, 32)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        x @ x
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert profiling.device_step_time(lambda a: a @ a, (x,), 8) > 0


def test_get_run_id_is_the_jax_packages(tmp_path):
    rid = tutils.get_run_id(str(tmp_path / "run"))
    assert len(rid) == 8 and int(rid, 16) >= 0
    assert tutils.get_run_id(str(tmp_path / "run")) == rid
    assert jutils.get_run_id(str(tmp_path / "run")) == rid
    assert len(tutils.get_run_id()) == 8


def test_launcher_dry_run_writes_the_script(tmp_path, monkeypatch):
    answers = {"rev-parse": "abc123", "remote": "",
               "status": "", "rev-list": "0"}
    monkeypatch.setattr(launch, "_git",
                        lambda args, cwd: answers[args[0]])

    def no_launch(*a, **k):
        raise AssertionError("--dry_run launched the script")
    monkeypatch.setattr(launch.subprocess, "Popen", no_launch)
    lc = tmp_path / "launch.json"
    lc.write_text(json.dumps({"work_dir": str(tmp_path / "work"),
                              "nproc_per_node": 4, "max_restarts": 3,
                              "env": {"NCCL_DEBUG": "INFO"}}))
    exp = tmp_path / "exp.json"
    exp.write_text("{}")
    run_dir = tmp_path / "runs" / "tsh"
    script = launch.main(["--launch_config", str(lc), "--exp_config",
                          str(exp), "--run_dir", str(run_dir), "--dry_run"])
    monkeypatch.undo()
    text = open(script).read()
    assert (run_dir / "config.json").exists()
    assert "export LOOKONCE_DIST=auto" in text
    assert "export NCCL_DEBUG=INFO" in text
    assert "git checkout abc123" in text
    assert (f"torchrun --nproc_per_node 4 -m lookoncetohear_tpu_torch."
            f"trainer --config {run_dir}/config.json --run_dir {run_dir} "
            "--resume") in text
    assert "for i in $(seq 1 3); do" in text
    assert os.access(script, os.X_OK)
    assert subprocess.run(["bash", "-n", script]).returncode == 0


def test_demo_at_random_weights(tmp_path):
    out = stream_demo.run(["--device", "cpu", "--seconds", "0.3",
                           "--out_dir", str(tmp_path)])
    assert sorted(os.listdir(tmp_path)) == ["extracted.wav", "mixture.wav",
                                            "target.wav"]
    assert out["extracted"].shape == (2, 4736)      # 0.3 s in 128-chunks
    assert np.isfinite([out["si_snr_in"], out["si_snr_out"]]).all()
    assert out["si_snr_i"] == out["si_snr_out"] - out["si_snr_in"]
