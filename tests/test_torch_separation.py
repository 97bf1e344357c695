"""The reference configs' training path on a micro-corpus, PyTorch port
vs the JAX package, on the CPU: `SeparationTask` over the offline
separator on a `SpeechSeparationDataset` batch, `TSETask` on a
`MixLibriSpeechNoisyEnroll` batch, and the port's trainer CLI on tiny
copies of `configs/tsh.json` and `configs/embed.json` re-pointed at the
corpus, with the configs' `pl_logger` writing the embedding tables.

Tolerances: the tasks' loss and metrics 1e-4 absolute in float32 and
every gradient 1e-4 of its tensor's peak in float64, as
`tests/test_torch_train.py` holds the other tasks (see its head); the
batches and the logged ground-truth tables exactly.
"""

import copy
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookoncetohear_tpu import utils as jutils
from lookoncetohear_tpu.data import dataset_variants as jvar
from lookoncetohear_tpu.data import datasets as jds
from lookoncetohear_tpu.data import loader as jloader
from lookoncetohear_tpu_torch import trainer as tcli
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.data import dataset_variants as tvar
from lookoncetohear_tpu_torch.data import datasets as tds
from lookoncetohear_tpu_torch.data import loader as tloader
from lookoncetohear_tpu_torch.train.trainer import to_device
from lookoncetohear_tpu_torch.weights import flatten_params, params_from_jax
from test_torch_data import make_corpus, same
from test_torch_train import _hold_task
from test_trainer import TINY_TSE

ROOT = os.path.join(os.path.dirname(__file__), "..")
CROP = 4000                     # samples of each separation item kept


@pytest.fixture(autouse=True)
def _one_thread():
    """The port's plain LSTM loops on one torch thread, as in
    tests/test_torch_train.py (several test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _data_args(corpus, dset):
    split = corpus[{"train": "train-clean-360", "val": "dev-clean",
                    "test": "test-clean"}[dset]]
    return dict(fg_dir=split["fg"], bg_dir=corpus["bg"],
                embed_dir=split["embed"], jams_dir=split["jams"],
                hrtf_list=corpus["catt"], hrtf_type="CATTRIR", dset=dset,
                sr=16000)


def _batches(corpus, name, n, **kw):
    """The first n val items of dataset `name`, collated by each package:
    (JAX batch, port batch), held equal."""
    args = dict(_data_args(corpus, "val"), **kw)
    jmod, tmod = (jds, tds) if name == "MixLibriSpeechNoisyEnroll" \
        else (jvar, tvar)
    jd, td = getattr(jmod, name)(**args), getattr(tmod, name)(**args)
    jb = jloader.collate([jd[i] for i in range(n)])
    tb = tloader.collate([td[i] for i in range(n)])
    same(tb, jb, name)
    return jb, tb


def test_separation_task_loss_and_grads_match_jax(corpus):
    """2 items of SpeechSeparationDataset cut to 0.25 s, through a
    one-block separator at n_fft 32."""
    jb, _ = _batches(corpus, "SpeechSeparationDataset", 2)
    inputs, targets = jb
    host = ({"mixture": inputs["mixture"][..., :CROP]},
            {k: targets[k][..., :CROP] for k in ("target1", "target2")})
    cfg = {"pl_module": "lookoncetohear_tpu.train.tasks.SeparationTask",
           "pl_module_args": dict(
               model="src.models.tfgridnet_orig.tfgridnet.Net",
               model_params=dict(num_ch=2, n_fft=32, stride=16,
                                 num_blocks=1), lr=1e-3)}
    _hold_task(cfg, host=host)


def test_tse_task_loss_on_a_corpus_batch_matches_jax(corpus):
    """Two val items of the reference configs' dataset, through a tiny
    separator conditioned on the corpus' 256-d d-vectors."""
    jb, tb = _batches(corpus, "MixLibriSpeechNoisyEnroll", 2)
    args = copy.deepcopy(TINY_TSE)
    args["model_params"].update(embed_dim=256, B=1)
    jtask = jutils.import_attr("lookoncetohear_tpu.train.tasks.TSETask")(
        **args)
    ttask = tutils.import_attr("src.ts_hear_embed_pl_module.PLModule")(
        **args)
    params = jax.jit(lambda key: jtask.init_params(key, jb))(
        jax.random.PRNGKey(0))
    ttask.model.load_state_dict(params_from_jax(flatten_params(params)),
                                strict=True)
    jd, td = jtask.device_batch(jb), ttask.device_batch(tb)
    same(td, jd, "device batch")
    jl, jm = jax.jit(jtask.loss_and_metrics)(
        params, {k: jnp.asarray(v) for k, v in jd.items()}, 0)
    with torch.no_grad():
        loss, metrics = ttask.loss_and_metrics(to_device(td, "cpu"), 0)
    assert sorted(metrics) == sorted(jm)
    for k, v in metrics.items():
        assert np.isfinite(v.item())
        np.testing.assert_allclose(v.item(), float(jm[k]), rtol=0,
                                   atol=1e-4, err_msg=k)


def _tiny_reference_config(tmp_path, corpus, which):
    """configs/{which}.json with the data directories re-pointed at the
    corpus, the CATT BRIRs in place of MultiCh (SOFA), a tiny model, and
    batches of 2 (train) and 3 (val) rendered in this process."""
    with open(os.path.join(ROOT, "configs", f"{which}.json")) as f:
        cfg = json.load(f)
    mp = cfg["pl_module_args"]["model_params"]
    if which == "tsh":
        mp.update(D=16, B=2, H=16, local_atten_len=10)
    else:
        mp.update(num_blocks=1)
    for dset in ("train", "val", "test"):
        args = cfg[f"{dset}_data_args"]
        args.update({k: v for k, v in _data_args(corpus, dset).items()
                     if k.endswith("_dir") or k.startswith("hrtf")})
    cfg.update(epochs=1, batch_size=2, eval_batch_size=3, num_workers=0)
    path = tmp_path / f"{which}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _table(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["speaker_id"] + [f"embed_{i}" for i in range(256)]
    return (np.array([int(r[0]) for r in rows[1:]]),
            np.array([[float(x) for x in r[1:]] for r in rows[1:]],
                     np.float32))


def test_cli_runs_the_tsh_config_and_logs_its_table(tmp_path, corpus):
    """One epoch (3 training batches, 2 validation batches) through the
    trainer CLI: finite metrics, checkpoints, and the pl_logger's table
    of the first validation batch: the conditioning d-vectors of the JAX
    package's first 3 val items."""
    run = str(tmp_path / "run")
    tcli.run(["--config", _tiny_reference_config(tmp_path, corpus, "tsh"),
              "--run_dir", run, "--device", "cpu"])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    assert rec["step"] == 3
    assert all(np.isfinite(v) for v in rec.values()
               if isinstance(v, float))
    for name in ("last.ckpt", "best.ckpt", "ckpt_meta.json"):
        assert os.path.exists(os.path.join(run, name)), name
    assert os.listdir(os.path.join(run, "embeddings")) == ["val_epoch0.csv"]
    ids, table = _table(os.path.join(run, "embeddings", "val_epoch0.csv"))
    jd = jds.MixLibriSpeechNoisyEnroll(**_data_args(corpus, "val"))
    want = [jd[i] for i in range(3)]
    np.testing.assert_array_equal(
        ids, [w[0]["enrollments_id"][0] for w in want])
    np.testing.assert_array_equal(
        table, np.stack([w[1]["embedding_gt"][0] for w in want]))


def test_embed_task_tables(tmp_path, corpus):
    """EmbedTask's tables through the logger: its predicted d-vectors
    each epoch, the ground truth's (`gt`) at the first only, one file
    per table and split."""
    _, tb = _batches(corpus, "MixLibriSpeechNoisyEnroll", 2)
    cfg = _tiny_reference_config(tmp_path, corpus, "embed")
    hp = tutils.Params(cfg)
    task = tutils.import_attr(hp.pl_module)(**hp.pl_module_args)
    logger = tutils.import_attr(hp.pl_logger)()
    batch = to_device(task.device_batch(tb), "cpu")
    for epoch in (0, 1):
        with torch.no_grad():
            tables = task.log_embeddings(batch, epoch == 0)
            pred = task.model(batch["enrollments"][:, 0])
        assert sorted(tables) == (["", "gt"] if epoch == 0 else [""])
        for name, emb in tables.items():
            logger.add(batch["enrollments_id"][:, 0], emb.numpy(), name)
        logger.flush(str(tmp_path), epoch, "val")
    d = tmp_path / "embeddings"
    assert sorted(os.listdir(d)) == ["val_epoch0.csv", "val_epoch1.csv",
                                     "val_gt_epoch0.csv"]
    ids, gt = _table(str(d / "val_gt_epoch0.csv"))
    np.testing.assert_array_equal(ids, tb[0]["enrollments_id"][:, 0])
    np.testing.assert_array_equal(gt, tb[1]["embedding_gt"][:, 0])
    ids, got = _table(str(d / "val_epoch1.csv"))
    np.testing.assert_allclose(got, pred.numpy(), rtol=1e-6, atol=0)
