"""A run with the timed path broken underneath comes out not correct:
the harness drives the program on the CPU at a small size (skipping
only its look for a card), with one fault planted in the program. The
faults a one-chip cell can have: a step that returns its state
unchanged, half of the batch left out (the mean taken over the rest),
an answer altered where it is produced (an offline call has no state:
it can have the last two, half of its batch embedded and given to
every clip)."""

import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.conftest import tiny_cell
from lookoncetohear_tpu_torch.models.net import EmbedNet
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.train.tasks import TSETask

SERVE = ["flagship.serve64", "net_default.serve64"]
TRAIN = ["flagship.train8x5s", "net_default.train8x5s"]


def run_tiny(workload):
    return run_cell(tiny_cell(workload), 2 ** 31 + 23, 0.3, False, "cpu",
                    time.perf_counter())


@pytest.mark.parametrize("workload", SERVE)
def test_serving_step_that_keeps_its_state(workload, monkeypatch):
    step = StreamingEngine._step_core

    def broken(self, all_primed):
        saved = [t.clone() for t in self._carried()]
        y = step(self, all_primed)
        for t, s in zip(self._carried(), saved):
            t.copy_(s)
        return y
    monkeypatch.setattr(StreamingEngine, "_step_core", broken)
    assert not run_tiny(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
def test_serving_answer_altered(workload, monkeypatch):
    step = StreamingEngine._step_core
    calls = []

    def broken(self, all_primed):
        y = step(self, all_primed)
        calls.append(1)
        return y + 1.0 if len(calls) == 6 else y
    monkeypatch.setattr(StreamingEngine, "_step_core", broken)
    assert not run_tiny(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_training_step_that_keeps_its_state(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert not run_tiny(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_training_on_half_the_batch(workload, monkeypatch):
    loss = TSETask.loss_and_metrics

    def broken(self, batch, epoch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return loss(self, half, epoch)
    monkeypatch.setattr(TSETask, "loss_and_metrics", broken)
    assert not run_tiny(workload)["correct"]


def test_offline_answer_altered(monkeypatch):
    """One entry of every d-vector moved by 1e-2, as it leaves the
    model."""
    forward = EmbedNet.forward

    def broken(self, x):
        y = forward(self, x).clone()
        y[:, 0] += 1e-2
        return y
    monkeypatch.setattr(EmbedNet, "forward", broken)
    r = run_tiny("embed.enroll4x5s")
    assert r["checks"]["dvec_err"]["value"] > 9e-3
    assert not r["correct"]


def test_offline_half_batch_left_out(monkeypatch):
    """The first half of each call's clips embedded, and their d-vectors
    given to the other half."""
    forward = EmbedNet.forward

    def broken(self, x):
        half = forward(self, x[:x.shape[0] // 2])
        return torch.cat([half, half])
    monkeypatch.setattr(EmbedNet, "forward", broken)
    assert not run_tiny("embed.enroll4x5s")["correct"]
