"""The plain reference against the port's CPU path at a small size, run
through the harness as a cell runs (the same inputs, window, sample
and comparison), and its two LSTM forms against each other."""

import time

import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference.tfgridnet import Reference, dims
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny_cell


def run_tiny(cell, seed=2 ** 31 + 11):
    return run_cell(cell, seed, 0.3, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("kv_dtype", ["int8", None])
def test_serving_steps_match_the_port_in_float32(kv_dtype):
    """The flagship's streaming steps through the engine, in float32:
    with the int8 ring its quantization is the reference's, with the
    float ring the attention is exact."""
    cell = tiny_cell("flagship.serve64")
    cell.traffic.update(dtype="float32", kv_dtype=kv_dtype)
    r = run_tiny(cell)
    assert r["checks"]["out_err"]["value"] < 1e-4
    assert r["correct"] and r["attempted"] > 0


def test_default_net_serving_steps_match_the_port():
    r = run_tiny(tiny_cell("net_default.serve64"))
    assert r["checks"]["out_err"]["value"] < 1e-5


def test_bf16_serving_is_within_its_limit():
    r = run_tiny(tiny_cell("flagship.serve64"))
    c = r["checks"]["out_err"]
    assert 1e-4 < c["value"] < c["limit"]


@pytest.mark.parametrize("workload", ["flagship.train8x5s",
                                      "net_default.train8x5s"])
def test_training_steps_match_the_port(workload):
    r = run_tiny(tiny_cell(workload))
    for name, c in r["checks"].items():
        assert c["value"] < 1e-4, name
    assert r["correct"]


@pytest.mark.parametrize("workload", ["flagship.serve64",
                                      "net_default.serve64"])
def test_lstm_loop_matches_torch_lstm(workload):
    cell = tiny_cell(workload)
    mp = cell.config["model_params"]
    d = dims(mp)
    params = inputs.weights(mp, 3, "cpu")
    x = 0.1 * torch.randn(2, d["M"], 6 * d["hop"] + d["nfft"],
                          generator=torch.Generator().manual_seed(0))
    e = torch.nn.functional.normalize(torch.ones(2, d["E"]), dim=-1)
    outs = []
    for loop in (False, True):
        ref = Reference(mp, params, loop_lstm=loop)
        with torch.no_grad():
            outs.append(ref.frames(x, e, ref.init_state(2)))
    assert torch.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
