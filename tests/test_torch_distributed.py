"""Multi-process training in the port, on the CPU: the trainer CLI on a
2-process gloo group (`LOOKONCE_COORDINATOR` & co., as the JAX
package's `tests/test_distributed.py` drives it) against the same CLI
in one process, and a resume on a fresh 2-process group; the rank's
shard of an epoch against the JAX package's `shard_indices`; the batch
padding of `parallel.mesh`. A 1-process group (the collectives over one
rank, no DDP wrapper; the card's check in `chip_smoke.py`) logs the
plain run's metrics to 1e-5.

Tolerance: the JAX test's, rtol = atol = 2e-3 on every logged metric.
The global batches hold the same items (strided shards of one
permutation) and DDP averages the ranks' gradients, so the two runs
differ only in the order of float32 sums.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lookoncetohear_tpu.data.loader import shard_indices as jshard
from lookoncetohear_tpu.parallel.mesh import pad_batch_to as jpad
from lookoncetohear_tpu_torch.data.loader import shard_indices as tshard
from lookoncetohear_tpu_torch.parallel import distributed
from lookoncetohear_tpu_torch.parallel.mesh import pad_batch_to, rank_device
from test_trainer import TINY_TSE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3
TRIGGERS = ("LOOKONCE_COORDINATOR", "LOOKONCE_NUM_PROCESSES",
            "LOOKONCE_PROCESS_ID", "LOOKONCE_DIST")


def _config(tmp_path):
    """A tiny TSE config: 16 training items in batches of 4, and 9
    validation items in batches of 4, which two ranks split 5 / 4 into
    3 / 2 batches of 2 (the short rank feeds masked filler)."""
    data = dict(duration=0.5, embed_dim=64, n_speakers=4)
    cfg = dict(pl_module="lookoncetohear_tpu.train.tasks.TSETask",
               pl_module_args=TINY_TSE, epochs=2, batch_size=4,
               eval_batch_size=4, num_workers=0)
    for split, n in (("train", 16), ("val", 9), ("test", 9)):
        cfg[f"{split}_dataset"] = \
            "lookoncetohear_tpu.data.synthetic.SyntheticTSEDataset"
        cfg[f"{split}_data_args"] = dict(data, dset=split, n_samples=n)
    path = tmp_path / "tse.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_cli(cfg, run_dir, procs, *extra, group=None):
    """The trainer CLI in `procs` processes, in a gloo group when
    procs > 1 (or `group`); every rank must exit 0."""
    env = {k: v for k, v in os.environ.items() if k not in TRIGGERS}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    if procs > 1 if group is None else group:
        env.update(LOOKONCE_COORDINATOR=f"localhost:{_free_port()}",
                   LOOKONCE_NUM_PROCESSES=str(procs))
    cmd = [sys.executable, "-m", "lookoncetohear_tpu_torch.trainer",
           "--config", cfg, "--run_dir", str(run_dir), "--device", "cpu",
           *extra]
    ps = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True,
                           env=dict(env, LOOKONCE_PROCESS_ID=str(r)))
          for r in range(procs)]
    outs = []
    try:
        for p in ps:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in ps:
            p.kill()
    for r, (p, out) in enumerate(zip(ps, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"
    return outs


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_two_process_fit_matches_one_and_resumes(tmp_path):
    cfg = _config(tmp_path)
    one, two = tmp_path / "one", tmp_path / "two"
    _run_cli(cfg, one, 1)
    outs = _run_cli(cfg, two, 2)
    for r, out in enumerate(outs):
        assert f"torch.distributed (gloo): process {r}/2" in out, out
    rec1, rec2 = _metrics(one), _metrics(two)
    assert [r["epoch"] for r in rec1] == [0, 1]
    assert [r["epoch"] for r in rec2] == [0, 1]     # rank 0 alone logs
    for r1, r2 in zip(rec1, rec2):
        assert r1["step"] == r2["step"] == 4 * (r1["epoch"] + 1)
        for k in ("train/loss", "train/si_snr_i", "val/loss",
                  "val/si_snr_i", "val/snr_i"):
            assert np.isfinite(r2[k])
            np.testing.assert_allclose(r2[k], r1[k], rtol=TOL, atol=TOL,
                                       err_msg=f"{k}, epoch {r1['epoch']}")
    for name in ("last.ckpt", "best.ckpt", "ckpt_meta.json"):
        assert os.path.exists(two / name), name
    # a group of one (its collectives, no DDP wrapper) is the plain run
    outs = _run_cli(cfg, tmp_path / "group1", 1, group=True)
    assert "torch.distributed (gloo): process 0/1" in outs[0]
    for r1, r2 in zip(rec1, _metrics(tmp_path / "group1")):
        for k, v in r1.items():
            if k != "epoch_time_s":
                np.testing.assert_allclose(r2[k], v, rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    # a fresh group resumes from rank 0's checkpoint at epoch 2
    _run_cli(cfg, two, 2, "--resume", "--epochs", "3")
    rec = _metrics(two)
    assert [r["epoch"] for r in rec] == [0, 1, 2] and rec[-1]["step"] == 12


@pytest.mark.parametrize("n,seed,epoch,world", [
    (11, 3, 2, 2), (16, 42, 0, 2), (9, 0, 5, 3), (7, 1, 1, 1)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_rank_shards_are_the_jax_packages(n, seed, epoch, world, shuffle):
    got = [tshard(n, shuffle=shuffle, seed=seed, epoch=epoch,
                  process_index=r, process_count=world)
           for r in range(world)]
    for r, g in enumerate(got):
        np.testing.assert_array_equal(g, jshard(
            n, shuffle=shuffle, seed=seed, epoch=epoch, process_index=r,
            process_count=world))
    assert sorted(np.concatenate(got).tolist()) == list(range(n))


def test_one_process_defaults():
    for k in TRIGGERS:
        assert k not in os.environ
    assert not distributed.maybe_initialize("cpu")
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    assert distributed.is_primary()
    assert distributed.agree_count(7, "min") == 7
    assert distributed.sum_over_ranks([1, 2.5]) == [1.0, 2.5]
    assert rank_device("cpu") == torch.device("cpu")
    np.testing.assert_array_equal(
        tshard(5, shuffle=False, seed=0, epoch=0), np.arange(5))


@pytest.mark.parametrize("multiple", [1, 4, 5])
def test_pad_batch_to_is_the_jax_packages(multiple):
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((3, 2, 5)).astype(np.float32),
             "ids": np.arange(3), "scalar": np.float32(1.5),
             "nested": [rng.standard_normal((3,)), "name"]}
    got, n = pad_batch_to(batch, multiple)
    want, m = jpad(batch, multiple)
    assert n == m == 3
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]))
    np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
    np.testing.assert_array_equal(got["nested"][0],
                                  np.asarray(want["nested"][0]))
    assert got["nested"][1] == "name" and got["scalar"] == 1.5
    t, k = pad_batch_to({"x": torch.ones(3, 2)}, multiple)
    assert k == 3 and t["x"].shape[0] == -(-3 // multiple) * multiple
    assert t["x"][3:].abs().sum() == 0
