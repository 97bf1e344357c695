"""The render-ahead cache in the port (`data/prep/prerender.py`), on the
CPU: shards written by either package read back equal in the other and
equal to the live items' numeric fields; a render resumes, leaves no
partial shard behind a failure, and gives the same shards from a pool
of spawned workers; the CLI; and the trainer CLI with `--prerender`,
whose metrics equal the uncached run's exactly (the synthetic items
depend on (split, index) alone, so the cache holds the same arrays).
"""

import json
import os

import numpy as np
import pytest
import torch

from lookoncetohear_tpu.data.prep import prerender as jpre
from lookoncetohear_tpu.data.synthetic import SyntheticTSEDataset as JData
from lookoncetohear_tpu_torch import trainer as tcli
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.data.prep import prerender as tpre
from lookoncetohear_tpu_torch.data.synthetic import SyntheticTSEDataset \
    as TData
from lookoncetohear_tpu_torch.train.trainer import prerender_dir
from test_torch_data import same
from test_trainer import TINY_TSE

ARGS = dict(n_samples=5, duration=0.25, embed_dim=64, n_speakers=4)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small-op training loops run on one thread (several test workers
    share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numeric(item):
    """An item's fields as the cache keeps them."""
    inputs, targets = item
    keep_in = {k: np.asarray(inputs[k]) for k in tpre.DEVICE_KEYS_IN
               if k in inputs}
    keep_tgt = {k: np.asarray(targets[k]) for k in tpre.DEVICE_KEYS_TGT
                if k in targets}
    keep_tgt["embedding_neg"] = [np.asarray(x)
                                 for x in targets["embedding_neg"]]
    return keep_in, keep_tgt


def _sorted(item):
    inputs, targets = item
    return ({k: inputs[k] for k in sorted(inputs)},
            {k: targets[k] for k in sorted(targets)})


def test_schema_is_the_jax_packages():
    assert tpre.DEVICE_KEYS_IN == jpre.DEVICE_KEYS_IN
    assert tpre.DEVICE_KEYS_TGT == jpre.DEVICE_KEYS_TGT


@pytest.mark.parametrize("dset", ["val", "train"])
def test_shards_cross_read_between_the_packages(tmp_path, dset):
    t_dir, j_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    t_ds, j_ds = TData(dset=dset, **ARGS), JData(dset=dset, **ARGS)
    tpre.render_split(t_ds, t_dir)
    jpre.render_split(j_ds, j_dir)
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir)) == \
        [f"{i:08d}.npz" for i in range(5)]
    for i in range(5):
        want = _sorted(_numeric(t_ds[i]))
        # the port's shards through the JAX reader and vice versa
        same(_sorted(jpre.PrerenderedDataset(t_dir)[i]), want, f"{i} j<-t")
        same(_sorted(tpre.PrerenderedDataset(j_dir)[i]), want, f"{i} t<-j")
        same(_sorted(tpre.PrerenderedDataset(t_dir)[i]), want, f"{i} t<-t")
        with np.load(os.path.join(t_dir, f"{i:08d}.npz")) as a, \
                np.load(os.path.join(j_dir, f"{i:08d}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                same(a[k], b[k], f"{i} {k}")


class _Failing:
    """A dataset whose item `bad` raises (a crash mid-render)."""

    def __init__(self, ds, bad):
        self.ds, self.bad = ds, bad

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError("render failed")
        return self.ds[i]


def test_resume_and_atomic_writes(tmp_path):
    out = str(tmp_path / "val")
    ds = TData(dset="val", **ARGS)
    with pytest.raises(RuntimeError, match="render failed"):
        tpre.render_split(_Failing(ds, 3), out)
    assert sorted(os.listdir(out)) == [f"{i:08d}.npz" for i in range(3)]
    # a shard already there is kept as it is; a stray temporary file
    # (a write cut short) is never read as a shard
    first = os.path.join(out, "00000000.npz")
    mtime = os.stat(first).st_mtime_ns
    open(os.path.join(out, "00000004.tmp.npz"), "wb").close()
    tpre.render_split(ds, out, limit=4)
    assert len(tpre.PrerenderedDataset(out)) == 4
    tpre.render_split(ds, out)
    assert os.stat(first).st_mtime_ns == mtime
    cache = tpre.PrerenderedDataset(out)
    assert len(cache) == 5
    for i in range(5):
        same(_sorted(cache[i]), _sorted(_numeric(ds[i])), i)


def test_worker_pool_writes_the_same_shards(tmp_path):
    ds = TData(dset="val", **ARGS)
    tpre.render_split(ds, str(tmp_path / "serial"))
    tpre.render_split(ds, str(tmp_path / "pool"), num_workers=2)
    a, b = (tpre.PrerenderedDataset(str(tmp_path / d))
            for d in ("serial", "pool"))
    for i in range(len(ds)):
        same(a[i], b[i], i)


def _config(tmp_path, **extra):
    data = dict(duration=0.5, embed_dim=64, n_speakers=4)
    cfg = dict(pl_module="lookoncetohear_tpu.train.tasks.TSETask",
               pl_module_args=TINY_TSE, epochs=2, batch_size=4,
               eval_batch_size=4, num_workers=0, **extra)
    for split, n in (("train", 8), ("val", 6), ("test", 6)):
        cfg[f"{split}_dataset"] = \
            "lookoncetohear_tpu.data.synthetic.SyntheticTSEDataset"
        cfg[f"{split}_data_args"] = dict(data, dset=split, n_samples=n)
    path = tmp_path / "tse.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_cli_with_prerender_matches_uncached(tmp_path):
    cfg = _config(tmp_path)
    base = ["--config", cfg, "--device", "cpu"]
    cache = tmp_path / "cache"
    tcli.run(base + ["--run_dir", str(tmp_path / "plain")])
    tcli.run(base + ["--run_dir", str(tmp_path / "cached"),
                     "--prerender", str(cache)])
    assert sorted(os.listdir(cache)) == ["train", "val"]
    assert len(os.listdir(cache / "train")) == 8
    plain, cached = _metrics(tmp_path / "plain"), \
        _metrics(tmp_path / "cached")
    assert len(plain) == len(cached) == 2
    for a, b in zip(plain, cached):
        a.pop("epoch_time_s"), b.pop("epoch_time_s")
        assert a == b
    # a second run reads the cache as it is (its shards are not
    # rewritten); --test renders the test split there too
    mtime = os.stat(cache / "train" / "00000000.npz").st_mtime_ns
    tcli.run(base + ["--run_dir", str(tmp_path / "cached"), "--test",
                     "--prerender", str(cache)])
    assert os.stat(cache / "train" / "00000000.npz").st_mtime_ns == mtime
    assert len(os.listdir(cache / "test")) == 6
    assert np.isfinite(_metrics(tmp_path / "cached")[-1]["test/loss"])


def test_prerender_dir_precedence(monkeypatch, tmp_path):
    class A:
        prerender = None

    class H:
        pass
    monkeypatch.delenv("LOOKONCE_PRERENDER", raising=False)
    assert prerender_dir(A(), H()) is None
    monkeypatch.setenv("LOOKONCE_PRERENDER", "env")
    assert prerender_dir(A(), H()) == "env"
    H.prerender_dir = "cfg"
    assert prerender_dir(A(), H()) == "cfg"
    A.prerender = "flag"
    assert prerender_dir(A(), H()) == "flag"


def test_cli_and_config_paths(tmp_path, capsys):
    cfg = _config(tmp_path)
    out = str(tmp_path / "val")
    tpre.main(["--config", cfg, "--which", "val", "--out", out, "--num",
               "3", "--num_workers", "0"])
    assert "rendered 3 samples" in capsys.readouterr().out
    cls = tutils.import_attr(
        "lookoncetohear_tpu.data.prep.prerender.PrerenderedDataset")
    assert cls is tpre.PrerenderedDataset and len(cls(root=out)) == 3
    assert tutils.import_attr(
        "lookoncetohear_tpu_torch.data.prep.prerender") is tpre
