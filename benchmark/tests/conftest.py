"""Fixtures of the benchmark's tests: the manifest, small copies of its
cells for the CPU, and the `cuda` fixture, which skips a test when no
card is present (decided when the test runs, never at import)."""

import copy
from pathlib import Path

import pytest
import torch

from benchmark.harness.cell import load_cell, load_json

REPO = Path(__file__).resolve().parents[2]
MANIFEST = REPO / "BENCHMARK.json"

# the cells' shapes cut to what a CPU test holds: every kind of layer
# kept (attention heads where the configuration has them). EmbedNet's
# widths are its constructor's, not its configuration's; its STFT,
# d-vector and depth are cut as far as the separator's.
TINY_MODEL = dict(embed_dim=16, stft_chunk_size=16, stft_pad_size=8, D=8,
                  H=8, B=2, local_atten_len=6)
TINY_EMBED = dict(embed_dim=16, n_fft=16, stride=8, num_blocks=2)
TINY_TRAFFIC = {
    "serve": dict(streams=4, pool_chunks=16, warmup_steps=4, trace_steps=6,
                  sample_streams=2),
    "train": dict(batch=2, seconds_audio=0.1, trace_steps=1),
    # three calls of two clips, of fractions of a second and lengths
    # that differ: 9 to 41 frames of 8 samples
    "offline": dict(batch=2, lengths_s=[0.004, 0.004, 0.02, 0.02, 0.01,
                                        0.01])}


@pytest.fixture(scope="session")
def manifest():
    return load_json(MANIFEST)


def tiny_cell(workload: str):
    """The cell `workload` at a size the CPU runs in a second or two."""
    cell = copy.deepcopy(load_cell(MANIFEST, workload))
    mp = cell.config["model_params"]
    mp.update({k: v for k, v in {**TINY_MODEL, **TINY_EMBED}.items()
               if k in mp})
    if mp.get("use_attn"):
        mp["L"] = 2
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["kind"]])
    return cell


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
