"""The seeded inputs. The existing configurations read what they read
before the loops found their model, task and reference by name: their
weights and training batches, drawn on the CPU at one fixed seed and at
the cells' own sizes, against digests recorded from the harness before
that change (SHA-256 of every tensor's bytes, in name order). And the
offline pool is four calls of four 5 s binaural scenes."""

import copy
import hashlib

import numpy as np
import pytest

from benchmark.harness import inputs, offline
from benchmark.harness.cell import load_cell
from benchmark.tests.conftest import MANIFEST

SEED = 2 ** 31 + 77
WEIGHTS = {
    "flagship":
        "36b5f47da9344c2d73ba73feeff4ce607adc0dc420f8869e17a5d540c1199258",
    "net_default":
        "7e2da47f05b073c543042d42975dd2a841ff08779a6dc876ab40d155039ff6b1"}
# both configurations' batches are TSETask's at 8 x 5 s with 256-d
# d-vectors: one digest
BATCHES = "ed55f5a475492e8e3ba8d7f033d74617a80e7661b5f82d83887dce976aa93285"


def digest(dicts) -> str:
    h = hashlib.sha256()
    for d in dicts:
        for k in sorted(d):
            h.update(k.encode())
            h.update(d[k].numpy().tobytes())
    return h.hexdigest()


def train_cell(config):
    return load_cell(MANIFEST, f"{config}.train8x5s")


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_seeded_weights_are_unchanged(config):
    cell = train_cell(config)
    mp = cell.config["model_params"]
    params = inputs.weights(cell.reference.param_table(mp), SEED, "cpu")
    assert digest([params]) == WEIGHTS[config]


@pytest.mark.parametrize("config", sorted(WEIGHTS))
def test_training_batches_are_unchanged(config):
    cell = train_cell(config)
    tr = cell.traffic
    batches = inputs.train_batches(
        SEED, tr["pool_batches"], tr["batch"], tr["seconds_audio"],
        cell.config["model_params"]["embed_dim"], "cpu")
    assert len(batches) == cell.traffic["pool_batches"]
    assert digest(batches) == BATCHES


def test_the_enrollment_pool_is_four_calls_of_four_5s_scenes():
    cell = load_cell(MANIFEST, "embed.enroll4x5s")
    lengths, pool = offline.pool_of(cell, 2 ** 31 + 5)
    assert lengths == [80000] * 4
    assert all(x.shape == (4, 2, 80000) and x.dtype == np.float32
               for x in pool)
    assert not np.array_equal(pool[0][0], pool[0][1])


def test_a_call_holds_clips_of_one_length():
    cell = copy.deepcopy(load_cell(MANIFEST, "embed.enroll4x5s"))
    cell.traffic["lengths_s"][1] = 4.0
    with pytest.raises(ValueError):
        offline.pool_of(cell, 1)
