"""The two-stage eval, PyTorch port vs the JAX package, on the CPU: the
SDR family, the embedding losses, the improvement and binaural metrics,
the synthetic test split and its collation, the eval CLI (`run`) on the
tiny configs of tests/test_eval_harness.py and at full width from the
committed checkpoints, and the serving-precision study.

Tolerances and why:
  * tensor losses and metrics: rtol 1e-5, atol 1e-6 (float32 reductions
    in another order; atol for values near 0);
  * ΔILD rtol 1e-12 and ΔITD exact: the same float64 numpy code, ITD an
    argmax over integer lags;
  * the dataset, `collate` and `_trim_duration`: bit-identical (the
    same numpy code and seeds);
  * eval CSVs: dB columns (si_snr_i, output_sisnr, delta_ild_db)
    1e-3 dB, embedding_sim 1e-5, the scene's metadata columns equal:
    the model's float32 output in another summation order, measured at
    ~2e-6 dB at full width;
  * the study's float32 scores 1e-3 dB for the same reason.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lookoncetohear_tpu import ts_hear_test as jcli
from lookoncetohear_tpu import utils as jutils
from lookoncetohear_tpu.data import loader as jloader
from lookoncetohear_tpu.data.synthetic import SyntheticTSEDataset as JDataset
from lookoncetohear_tpu.losses import embedding as jemb
from lookoncetohear_tpu.losses import sdr as jsdr
from lookoncetohear_tpu.metrics import binaural as jbin
from lookoncetohear_tpu.metrics.improvement import \
    metric_improvement as jimprove
from lookoncetohear_tpu.serve.engine import StreamingEngine as JEngine
from lookoncetohear_tpu.train.npz_ckpt import load_params, save_npz
from lookoncetohear_tpu_torch import eval_check, kv_quality
from lookoncetohear_tpu_torch import ts_hear_test as tcli
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.data import loader as tloader
from lookoncetohear_tpu_torch.data.synthetic import \
    SyntheticTSEDataset as TDataset
from lookoncetohear_tpu_torch.losses import embedding as temb
from lookoncetohear_tpu_torch.losses import sdr as tsdr
from lookoncetohear_tpu_torch.metrics import binaural as tbin
from lookoncetohear_tpu_torch.metrics.improvement import \
    metric_improvement as timprove
from test_eval_harness import TINY_EMBED_CFG, TINY_TSE_CFG

RESULTS = "docs/results_r5"
DB_TOL = {"si_snr_i": 1e-3, "output_sisnr": 1e-3, "delta_ild_db": 1e-3,
          "embedding_sim": 1e-5}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---- losses and metrics ------------------------------------------------------

def _pair(seed, shape=(3, 2, 1000)):
    target = _rand(shape, seed)
    return target + _rand(shape, seed + 1, 0.5), target


LOSSES = {
    "snr": lambda m, p, t: m.snr(p, t),
    "snr_zero_mean": lambda m, p, t: m.snr(p, t, zero_mean=True),
    "si_sdr": lambda m, p, t: m.si_sdr(p, t),
    "si_sdr_no_zero_mean": lambda m, p, t: m.si_sdr(p, t, zero_mean=False),
    "si_snr": lambda m, p, t: m.si_snr(p, t),
    "snr_loss": lambda m, p, t: m.snr_loss(p, t),
    "neg_sdr_snr": lambda m, p, t: m.neg_sdr(p, t),
    "neg_sdr_sisdr": lambda m, p, t: m.neg_sdr(p, t, "sisdr"),
    "neg_sdr_sdsdr": lambda m, p, t: m.neg_sdr(p, t, "sdsdr"),
    "neg_sdr_no_zero_mean": lambda m, p, t: m.neg_sdr(p, t, "sisdr",
                                                      zero_mean=False),
    "pairwise_neg_sisdr": lambda m, p, t: m.pairwise_neg_sisdr(p, t),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_sdr_family_matches_jax(name):
    pred, target = _pair(3)
    want = LOSSES[name](jsdr, jnp.asarray(pred), jnp.asarray(target))
    got = LOSSES[name](tsdr, torch.from_numpy(pred), torch.from_numpy(target))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


EMBEDDING = {
    "cosine_similarity": lambda m, a, b, y: m.cosine_similarity(a, b),
    "cosine_embedding_loss": lambda m, a, b, y: m.cosine_embedding_loss(
        a, b, y),
    "cosine_embedding_loss_margin_none": lambda m, a, b, y:
        m.cosine_embedding_loss(a, b, y, margin=0.5, reduction="none"),
}


@pytest.mark.parametrize("name", list(EMBEDDING))
def test_embedding_losses_match_jax(name):
    a, b = _rand((8, 64), 5), _rand((8, 64), 6)
    b[:2] = a[:2] * 2.0                 # cos 1
    y = np.array([1, -1] * 4, np.float32)
    want = EMBEDDING[name](jemb, *map(jnp.asarray, (a, b, y)))
    got = EMBEDDING[name](temb, *map(torch.from_numpy, (a, b, y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("metric", ["snr", "si_snr"])
def test_metric_improvement_matches_jax(metric):
    pred, target = _pair(7)
    mix = target + _rand(target.shape, 9)
    want = jimprove(getattr(jsdr, metric), *map(jnp.asarray,
                                                (mix, pred, target)))
    got = timprove(getattr(tsdr, metric), *map(torch.from_numpy,
                                               (mix, pred, target)))
    assert tuple(got.shape) == want.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _binaural_pair(seed, n=16000, sr=16000):
    """(est, gt) [3, 2, n] float64: noise bursts, the right ear delayed
    and attenuated per item, a silent second half in item 0 (the moving
    mode's RMS gate), est a perturbed, re-delayed copy of gt."""
    g = np.random.default_rng(seed)
    src = g.standard_normal((3, n + 40))
    lag = 20 - np.array([3, 7, 11])[:, None] + np.arange(n)
    gt = np.stack([src[:, 20:20 + n],
                   0.7 * np.take_along_axis(src, lag, axis=1)], 1)
    gt[0, :, n // 2:] = 0.0
    est = np.roll(gt, 2, axis=-1) * 0.9 + 0.05 * g.standard_normal(gt.shape)
    return est, gt, sr


@pytest.mark.parametrize("moving", [False, True])
def test_binaural_metrics_match_jax(moving):
    est, gt, sr = _binaural_pair(11)
    np.testing.assert_allclose(tbin.ild_diff(est, gt, sr, moving=moving),
                               jbin.ild_diff(est, gt, sr, moving=moving),
                               rtol=1e-12)
    got = tbin.itd_diff(est, gt, sr, moving=moving)
    want = jbin.itd_diff(est, gt, sr, moving=moving)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tbin.compute_itd(gt[:, 0], gt[:, 1], sr, 16),
        jbin.compute_itd(gt[:, 0], gt[:, 1], sr, 16))


# ---- the synthetic split and its batches -----------------------------------

def _assert_same(got, want, path="scene"):
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(got, dict):
        assert list(got) == list(want), path
        for k in got:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(got, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert got == want, path


DATA_ARGS = {
    "5k": dict(n_samples=256, n_speakers=128, duration=5.0, embed_dim=256),
    "tiny": TINY_TSE_CFG["test_data_args"] | {"n_samples": 8},
}


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("args", list(DATA_ARGS))
def test_synthetic_scenes_are_the_jax_packages(split, args):
    kw = {k: v for k, v in DATA_ARGS[args].items() if k != "dset"}
    jds, tds = JDataset(split, **kw), TDataset(split, **kw)
    assert len(tds) == len(jds)
    for idx in (0, 5):
        _assert_same(tds[idx], jds[idx])


def test_collate_is_the_jax_packages():
    kw = {k: v for k, v in DATA_ARGS["tiny"].items() if k != "dset"}
    jds, tds = JDataset("test", **kw), TDataset("test", **kw)
    got = tloader.collate([tds[i] for i in range(3)])
    want = jloader.collate([jds[i] for i in range(3)])
    _assert_same(got, want, "batch")
    # the nesting the CSV indexes
    assert got[0]["source_files"][1][2] == want[0]["source_files"][1][2]
    assert got[1]["embedding_neg"][1].shape == (3, 1, 64)


def test_batches_run_the_dataset_in_order():
    """The DataLoader, with worker processes, yields the collated scenes
    in order, the last batch short."""
    kw = {k: v for k, v in DATA_ARGS["tiny"].items() if k != "dset"}
    tds = TDataset("test", **(kw | {"n_samples": 6}))
    got = list(tloader.batches(tds, 4, num_workers=2))
    assert [b[0]["mixture"].shape[0] for b in got] == [4, 2]
    for b, lo in zip(got, (0, 4)):
        _assert_same(b, tloader.collate([tds[i] for i in
                                         range(lo, min(lo + 4, 6))]))


def test_stop_workers_leaves_no_helper_process():
    """After a loader with workers, `stop_workers` ends and reaps the
    fork server and the resource tracker; a second call does nothing."""
    from multiprocessing import forkserver, resource_tracker
    ds = torch.utils.data.TensorDataset(torch.arange(8.0))
    got = list(tloader.batches(ds, 4, num_workers=2))
    np.testing.assert_array_equal(
        np.concatenate([b[0] for b in got]), np.arange(8.0))
    pids = [forkserver._forkserver._forkserver_pid,
            resource_tracker._resource_tracker._pid]
    assert None not in pids
    tloader.stop_workers()
    tloader.stop_workers()
    assert forkserver._forkserver._forkserver_pid is None
    assert resource_tracker._resource_tracker._pid is None
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("n,silent", [(16000, 0), (32000, 8000), (1500, 0)])
def test_trim_duration_is_the_jax_clis(n, silent):
    x = np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
    x[:silent] = 0.0
    x2 = np.stack([x, 0.5 * x]).astype(np.float32)
    for a in (x, x2):
        assert tcli._trim_duration(a, 16000) == jcli._trim_duration(a, 16000)


# ---- config paths ----------------------------------------------------------

def test_import_attr_maps_the_configs_paths():
    from lookoncetohear_tpu_torch.models.net import EmbedNet, Net
    assert tutils.import_attr("lookoncetohear_tpu.models.net.Net") is Net
    assert tutils.import_attr(
        "lookoncetohear_tpu_torch.models.net.EmbedNet") is EmbedNet
    assert tutils.import_attr(
        "lookoncetohear_tpu.data.synthetic.SyntheticTSEDataset") is TDataset
    for path in ("lookoncetohear_tpu.data.dataset_variants."
                 "MixLibriSpeechMotion",
                 "lookoncetohear_tpu.data.prep.prerender",
                 "os.system"):
        with pytest.raises(ValueError, match=path.replace(".", r"\.")):
            tutils.import_attr(path)


# ---- the eval CLI ------------------------------------------------------------

def _write(tmp_path, cfg, name):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        json.dump(cfg, f)
    return p


def _args(config, run_dir, enroll_config=None, enroll_run_dir=None,
          **extra):
    return argparse.Namespace(
        config=config, run_dir=run_dir, enroll_config=enroll_config,
        enroll_run_dir=enroll_run_dir, dset="test", sample=False,
        num_workers=0, **extra)


def _jax_npz(tmp_path, cfg, name):
    """The JAX task's PRNGKey(0) init of `cfg`'s model, as a p// npz."""
    task = jutils.import_attr(cfg["pl_module"])(**cfg["pl_module_args"])
    ds = JDataset(**TINY_TSE_CFG["test_data_args"])
    params = task.init_params(jax.random.PRNGKey(0),
                              jloader.collate([ds[0]]))
    path = str(tmp_path / name)
    save_npz(path, params)
    return path


def _hold(got_csv, want_rows, tol=DB_TOL):
    res = eval_check.compare(eval_check.read_csv(got_csv), want_rows, tol)
    assert not res["failures"], eval_check.report(res)
    return res


@pytest.mark.parametrize("mode", ["two-stage", "oracle-binaural"])
def test_tiny_eval_matches_the_jax_cli(tmp_path, mode):
    """Both CLIs on the tiny configs from the same JAX-initialised npz
    weights: the CSVs agree row by row."""
    tsh = _write(tmp_path, TINY_TSE_CFG, "tsh.json")
    extra = dict(ckpt=_jax_npz(tmp_path, TINY_TSE_CFG, "tsh.npz"),
                 binaural=mode == "oracle-binaural")
    enroll, name = (None, None), "results_test_clean.csv"
    if mode == "two-stage":
        enroll = (_write(tmp_path, TINY_EMBED_CFG, "embed.json"),
                  str(tmp_path / "erun"))
        extra["enroll_ckpt"] = _jax_npz(tmp_path, TINY_EMBED_CFG, "emb.npz")
        name = "results_test_erun.csv"
    csvs = []
    for cli, sub, kw in ((jcli, "jax", {}),
                         (tcli, "port", {"device": "cpu"})):
        run_dir = str(tmp_path / sub)
        os.makedirs(run_dir)
        cli.run(_args(tsh, run_dir, *enroll, **extra, **kw))
        csvs.append(os.path.join(run_dir, name))
    res = _hold(csvs[1], eval_check.read_csv(csvs[0]))
    assert res["rows"] == 8
    assert ("delta_itd_us" in res["max_dev"]) == extra["binaural"]


def _cut_config(tmp_path, path, n):
    with open(path) as f:
        cfg = json.load(f)
    cfg["test_data_args"]["n_samples"] = n
    return _write(tmp_path, cfg, f"cut_{n}_{os.path.basename(path)}")


FULL = {
    "oracle": (None, None, None, "5k_oracle_results_test_clean.csv"),
    "two-stage": ("configs/embed_synthetic_5k.json", "runs/embed_r5_5k",
                  "checkpoints/embed_r5_5k_best.npz",
                  "5k_twostage_results_test_embed_r5_5k.csv"),
}


@pytest.mark.parametrize("mode", list(FULL))
def test_full_width_eval_reproduces_the_committed_csv(tmp_path, mode):
    """Scenes 0 and 1 of the 5k test split through the port's CLI on the
    CPU from the committed checkpoints: each row within 1e-3 dB of the
    JAX package's CSV (made by its CLI on a CPU)."""
    econfig, erun, eckpt, ref = FULL[mode]
    rows = tcli.run(_args(
        _cut_config(tmp_path, "configs/tsh_synthetic_5k.json", 2),
        str(tmp_path), econfig, erun, ckpt="checkpoints/tsh_r5_5k_best.npz",
        enroll_ckpt=eckpt, device="cpu"))
    assert len(rows) == 2
    name = "results_test_" + (os.path.basename(erun) if erun else "clean")
    _hold(str(tmp_path / f"{name}.csv"),
          eval_check.read_csv(os.path.join(RESULTS, ref))[:2])


def test_full_width_binaural_row_matches_the_jax_cli(tmp_path):
    """Row 0 of the 64-scene split with --binaural, tsh_r5_best.npz:
    the port against the JAX CLI on the CPU (every column, dB within
    1e-3), and against the committed results_test_clean.csv in every
    column that does not depend on the model. That CSV was made on a
    TPU, whose default float32 matmuls round their inputs to bf16: its
    dB columns sit ~0.07 dB from the float32 result of both packages."""
    config = _cut_config(tmp_path, "configs/tsh_synthetic.json", 1)
    ckpt = "checkpoints/tsh_r5_best.npz"
    csvs = []
    for cli, sub, kw in ((jcli, "jax", {}),
                         (tcli, "port", {"device": "cpu"})):
        run_dir = str(tmp_path / sub)
        os.makedirs(run_dir)
        cli.run(_args(config, run_dir, ckpt=ckpt, binaural=True, **kw))
        csvs.append(os.path.join(run_dir, "results_test_clean.csv"))
    _hold(csvs[1], eval_check.read_csv(csvs[0]))
    got = eval_check.read_csv(csvs[1])[0]
    want = eval_check.read_csv(os.path.join(RESULTS,
                                            "results_test_clean.csv"))[0]
    assert list(got) == list(want)
    model_free = [c for c in got if c not in DB_TOL]
    assert {c: got[c] for c in model_free} == {c: want[c] for c in model_free}


def test_cli_refuses_what_the_port_does_not_run(tmp_path):
    """--embed_from_wav, a checkpoint that is not a p// npz, and an
    existing results file are refused before any work."""
    tsh = _write(tmp_path, TINY_TSE_CFG, "tsh.json")
    run_dir = str(tmp_path)
    with pytest.raises(ValueError, match="resemblyzer"):
        tcli.run(_args(tsh, run_dir, embed_from_wav=True, device="cpu"))
    for ckpt in (None, str(tmp_path / "best.ckpt"), str(tmp_path)):
        with pytest.raises(ValueError, match="npz"):
            tcli.run(_args(tsh, run_dir, ckpt=ckpt, device="cpu"))
    open(tmp_path / "results_test_clean.csv", "w").close()
    with pytest.raises(FileExistsError):
        tcli.run(_args(tsh, run_dir, ckpt="x.npz", device="cpu"))
    assert tcli.parse_args(["--device", "cpu"]).num_workers == 8


# ---- the serving-precision study ------------------------------------------

def test_kv_quality_matches_a_jax_engine(tmp_path):
    """Two tiny scenes as 2 streams of one engine: the port's float32
    scores equal a JAX engine's on the same scenes within 1e-3 dB; the
    bf16 and bf16 + int8 scores are finite."""
    tsh = _write(tmp_path, TINY_TSE_CFG, "tsh.json")
    ckpt = _jax_npz(tmp_path, TINY_TSE_CFG, "tsh.npz")
    got = kv_quality.run(tsh, ckpt, n=2, device="cpu")
    assert list(got) == [p[0] for p in kv_quality.PRECISIONS]

    mix, tgt, emb = kv_quality.load_scenes(tutils.Params(tsh), 2)
    task = jutils.import_attr(TINY_TSE_CFG["pl_module"])(
        **TINY_TSE_CFG["pl_module_args"])
    eng = JEngine(task.model, load_params(ckpt), max_streams=2)
    for s in range(2):
        eng.add_stream(s, emb[s])
    chunk = TINY_TSE_CFG["pl_module_args"]["model_params"]["stft_chunk_size"]
    n = mix.shape[-1] - mix.shape[-1] % chunk
    est = np.concatenate([np.asarray(eng.step(mix[..., i:i + chunk]),
                                     np.float32)
                          for i in range(0, n, chunk)], -1)[..., chunk:]
    m = est.shape[-1]
    want = np.asarray(jsdr.si_snr(est, tgt[..., :m]).mean(-1)
                      - jsdr.si_snr(mix[..., :m], tgt[..., :m]).mean(-1))
    np.testing.assert_allclose(got["f32 / f32 K/V"], want, rtol=0, atol=1e-3)
    for v in got.values():
        assert v.shape == (2,) and np.isfinite(v).all()
