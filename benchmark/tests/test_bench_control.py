"""On the card: the control (the reference in the precision below the
cell's, put in the program's place; `controls` of the loop of the
cell's kind) fails the cell's comparison, on three seeds, at the cells'
widths with fewer streams, frames or rows than a run, and at the
offline cell's own size. The readings the limits were set from come
from `controls/readings.py` at the cells' own size."""

import copy

import pytest

from benchmark.harness.cell import load_cell
from benchmark.tests.conftest import MANIFEST

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def fails(cell, checks):
    return any(v > cell.limits[k]["limit"] for k, v in checks.items())


def controls(cell, seed, attempted, device):
    return cell.loop.controls(cell, seed, cell.limits["control"], attempted,
                              device)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship.serve64",
                                      "net_default.serve64"])
def test_serving_control_is_not_correct(cuda, workload):
    cell = copy.deepcopy(load_cell(MANIFEST, workload))
    cell.traffic.update(streams=8, sample_streams=4)
    for seed in SEEDS:
        checks = controls(cell, seed, 600 * 8, cuda)["control"]
        assert fails(cell, checks), (seed, checks)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["flagship.train8x5s",
                                      "net_default.train8x5s"])
def test_training_control_and_half_batch_are_not_correct(cuda, workload):
    cell = copy.deepcopy(load_cell(MANIFEST, workload))
    cell.traffic.update(batch=2, seconds_audio=1.0)
    for seed in SEEDS:
        for kind, checks in controls(cell, seed, 0, cuda).items():
            assert fails(cell, checks), (seed, kind, checks)


@pytest.mark.cuda
def test_offline_control_is_not_correct(cuda):
    cell = load_cell(MANIFEST, "embed.enroll4x5s")
    for seed in SEEDS:
        checks = controls(cell, seed, 0, cuda)["control"]
        assert fails(cell, checks), (seed, checks)
