"""The work counts of `work/` against shapes worked by hand, and the
model's operations (`work/model_step.py`) against what
`torch.utils.flop_counter` counts over the plain reference."""

import copy
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import inputs
from benchmark.harness.cell import load_cell, work
from benchmark.reference import offline_tfgridnet
from benchmark.reference.tfgridnet import Reference, dims, param_table
from benchmark.tests.conftest import MANIFEST, TINY_EMBED, TINY_MODEL


def test_b2_by_hand():
    # T=2, D=1, N=1, H=1: 2 steps of (8 + 8) operations; xp 2x4, W 4,
    # ys 2, c_T 1 floats
    assert work("b2").work(2, 1, 1, 1) == (32.0, 4 * (8 + 4 + 2 + 1))
    # the flagship's serving step: 97 bins, both directions, 64 streams
    flops, nbytes = work("b2").work(97, 2, 64, 64)
    assert flops == 97 * 2 * 64 * (8 * 64 * 64 + 8 * 64)
    assert nbytes == 4 * (97 * 2 * 64 * 256 + 2 * 64 * 256
                          + 97 * 2 * 64 * 64 + 2 * 64 * 64)


def test_lstm_train_by_hand():
    # T=1, D=1, N=1, H=1: 24 + 28 operations; xp, dxp 4 each, dy, ys 1
    # each, W_hh and dW_hh 4 each, carries 4
    assert work("lstm_train").work(1, 1, 1, 1, False) == (52.0, 4 * 18)
    assert work("lstm_train").work(1, 1, 1, 1, True) == (52.0, 4 * 22)


def test_ring_int8_by_hand():
    # B=1, F=1, nh=1, e=1, vd=1, w=2, bf16: scores and sum 2*2*2, the
    # quantization 3*2, softmax 5*2; q,k,v in and out 2*4, one live slot
    # 2 bytes + 8 of scales, the slot written alike
    flops, nbytes = work("ring_int8").work(1, 1, 1, 1, 1, 2, 2)
    assert flops == 8 + 6 + 10
    assert nbytes == 8 + 10 + 10


def _flops(mp, frames, rows):
    d = dims(mp)
    params = inputs.weights(param_table(mp), 0, "cpu")
    ref = Reference(mp, params, loop_lstm=True)
    x = torch.zeros(rows, d["M"], (frames - 1) * d["hop"] + d["nfft"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.frames(x, torch.zeros(rows, d["E"]), ref.init_state(rows))
    return counter.get_total_flops()


@pytest.mark.parametrize("config", ["flagship", "net_default"])
@pytest.mark.parametrize("frames,rows", [(1, 3), (7, 2)])
def test_model_operations_match_the_flop_counter(config, frames, rows):
    mp = copy.deepcopy(load_cell(MANIFEST, f"{config}.serve64")
                       .config["model_params"])
    mp.update(TINY_MODEL, local_atten_len=4)
    if mp["use_attn"]:
        mp["L"] = 2
    counted = _flops(mp, frames, rows)
    assert counted == work("model_step").forward(mp, frames, rows)


def test_model_operations_at_the_flagship_step():
    """~4.3 GFLOP a 64-stream step (the issue's estimate): the order of
    magnitude is right."""
    mp = load_cell(MANIFEST, "flagship.serve64").config["model_params"]
    ops = work("model_step").forward(mp, 1, 64)
    assert 3e9 < ops < 6e9
    assert math.isclose(work("model_step").per_call(mp),
                        2 * 256 * 64 * 97)


@pytest.mark.parametrize("tiny", [False, True], ids=["published", "tiny"])
@pytest.mark.parametrize("samples", [1000, 2049])
def test_embed_operations_match_the_flop_counter(tiny, samples):
    """`work/embed_forward.py` against every product the flop counter
    sees in the enrollment net's reference (the STFT is a DFT product
    there), at the published sizes and the tiny ones."""
    mp = dict(load_cell(MANIFEST, "embed.enroll4x5s").config["model_params"])
    if tiny:
        mp.update(TINY_EMBED)
    params = inputs.weights(offline_tfgridnet.param_table(mp), 0, "cpu")
    x = torch.randn(1, mp["num_ch"], samples,
                    generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        offline_tfgridnet.forward(mp, params, x)
    assert counter.get_total_flops() == work("embed_forward").forward(
        mp, samples)


@pytest.mark.parametrize("seconds,frames,tflop,attention", [
    (5, 1251, 0.255, 0.23), (35, 8751, 4.24, 0.68)], ids=["5s", "35s"])
def test_embed_operations_by_length(seconds, frames, tflop, attention):
    """A 5 s enrollment (1,251 frames) is ~0.255 TFLOP, 23% of it the T x
    T attention's 37,440 T^2; a 35 s utterance ~4.24 TFLOP, 68% (counted
    by hand from the shapes)."""
    mp = load_cell(MANIFEST, "embed.enroll4x5s").config["model_params"]
    w = work("embed_forward")
    n = seconds * 16000
    t = w.frames(mp, n)
    assert t == frames
    ops = w.forward(mp, n)
    assert math.isclose(ops, tflop * 1e12, rel_tol=0.01)
    assert math.isclose(37440 * t * t / ops, attention, abs_tol=0.01)
