"""The plain references against the port's CPU path at a small size, run
through the harness as a cell runs (the same inputs, window, sample
and comparison), the separator's two LSTM forms against each other, and
the enrollment net's reference against the port's EmbedNet directly."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import offline_tfgridnet
from benchmark.reference.tfgridnet import Reference, dims, param_table
from benchmark.run import run_cell
from benchmark.tests.conftest import TINY_EMBED, tiny_cell
from lookoncetohear_tpu_torch.models.net import EmbedNet


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
    params = inputs.weights(param_table(mp), 3, "cpu")
    x = 0.1 * torch.randn(2, d["M"], 6 * d["hop"] + d["nfft"],
                          generator=torch.Generator().manual_seed(0))
    e = torch.nn.functional.normalize(torch.ones(2, d["E"]), dim=-1)
    outs = []
    for loop in (False, True):
        ref = Reference(mp, params, loop_lstm=loop)
        with torch.no_grad():
            outs.append(ref.frames(x, e, ref.init_state(2)))
    assert torch.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_offline_calls_match_the_port():
    """A tiny `embed.enroll4x5s` through the harness: every call on the
    checked utterances in the window against the reference. Float32 on
    both sides, the same operations in another order (an FFT against a
    DFT product, the scan's plain version against a step loop): d-vector
    entries of order 1 read ~1e-7 apart, so 1e-5 leaves room and still
    fails any lower precision."""
    r = run_tiny(tiny_cell("embed.enroll4x5s"))
    assert r["checks"]["dvec_err"]["value"] < 1e-5
    assert r["correct"] and r["attempted"] >= 4


PUBLISHED_EMBED = dict(embed_dim=256, num_ch=2, n_fft=128, stride=64,
                       num_blocks=3)


@pytest.mark.parametrize("mp", [PUBLISHED_EMBED,
                                dict(PUBLISHED_EMBED, **TINY_EMBED)],
                         ids=["published", "tiny"])
def test_embed_net_matches_the_reference(mp):
    """The port's EmbedNet and the reference on seeded weights and a
    binaural utterance whose ears differ throughout (the pool's enrolled
    voice is alike on both, so this is where a mix-up of microphones
    shows), in float32. The
    tolerance is as above: the d-vectors reach ~3 and read under 1e-6
    apart; a TF32 product would move them by ~1e-3."""
    params = inputs.weights(offline_tfgridnet.param_table(mp), 2 ** 31 + 3,
                            "cpu")
    model = EmbedNet(**mp, device="cpu")
    model.load_state_dict(params)
    rng = np.random.default_rng(4)
    x = inputs.binaural(rng, inputs._voices(rng, 2, 4000))
    x = torch.from_numpy(x.astype(np.float32))
    with torch.no_grad():
        y = model(x)
    ref = offline_tfgridnet.forward(mp, params, x)
    assert y.shape == (2, mp["embed_dim"])
    assert torch.allclose(y, ref, rtol=0, atol=1e-5)
    assert (y[0] - y[1]).abs().max() > 1e-2
