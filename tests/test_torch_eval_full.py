"""The eval CLI at full width, PyTorch port vs the JAX package, on the
CPU: scenes of the 5k synthetic test split through the port's CLI from
the committed checkpoints, held to the JAX package's committed CSVs, and
a row of the 64-scene split with --binaural held to the JAX CLI. The
rest of the eval's tests, and the helpers these share, are in
tests/test_torch_eval.py.

Tolerance: eval CSVs' dB columns (si_snr_i, output_sisnr, delta_ild_db)
1e-3 dB, embedding_sim 1e-5, the scene's metadata columns equal
(`DB_TOL`): the model's float32 output in another summation order,
measured at ~2e-6 dB at full width.
"""

import json
import os

import pytest

from lookoncetohear_tpu import ts_hear_test as jcli
from lookoncetohear_tpu_torch import eval_check
from lookoncetohear_tpu_torch import ts_hear_test as tcli
from test_torch_eval import DB_TOL, RESULTS, _args, _hold, _write


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
