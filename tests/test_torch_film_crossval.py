"""Two modules of the JAX package that need no download, ported: FiLM
(`ops/film.py`) and the scaper cross-validation harness
(`data/scaper_crossval.py`), each against the JAX module on the same
inputs on the CPU.

Tolerances: FiLM float32 atol 1e-5 (one product and one sum per
element); the harness's loudness report 1e-4 LUFS (the same BS.1770
arithmetic in numpy on the same rendered stems).
"""

import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.data import audio_io
from lookoncetohear_tpu.data import scaper_crossval as jax_crossval
from lookoncetohear_tpu.data.scene import generate_scene_specs
from lookoncetohear_tpu.ops.film import FiLM as JaxFiLM
from lookoncetohear_tpu_torch.data import scaper_crossval
from lookoncetohear_tpu_torch.ops.film import FiLM
from lookoncetohear_tpu_torch.weights import (flatten_params,
                                              params_from_jax,
                                              params_to_jax)

SR = 16000


@pytest.mark.parametrize("x_shape", [(3, 8, 5, 7), (3, 8, 11)])
def test_film_matches_jax(x_shape):
    """A seeded JAX FiLM's params load strictly into the port's (and go
    back exactly); gamma(cond) * x + beta(cond) on [B, C, *spatial]."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(x_shape).astype(np.float32)
    cond = rng.standard_normal((x_shape[0], 16)).astype(np.float32)
    jm = JaxFiLM(channels=x_shape[1])
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                     jnp.asarray(cond))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(cond)))
    flat = flatten_params(params)
    film = FiLM(16, x_shape[1])
    film.load_state_dict(params_from_jax(flat), strict=True)
    with torch.no_grad():
        got = film(torch.from_numpy(x), torch.from_numpy(cond)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    back = params_to_jax(film.state_dict())
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A tiny wav corpus (3 speakers, 1 noise label) and one scene spec
    generated from it, as tests/test_data.py builds them."""
    root = tmp_path_factory.mktemp("crossval")
    fg, bg = str(root / "fg"), str(root / "bg")
    rng = np.random.default_rng(3)
    for spk in ["101", "202", "303"]:
        d = os.path.join(fg, spk)
        os.makedirs(d)
        for k in range(2):
            t = np.arange(SR * 6) / SR
            f0 = 100 + 50 * int(spk) % 300
            x = 0.4 * np.sin(2 * np.pi * (f0 + 10 * k) * t)
            audio_io.write_wav(os.path.join(d, f"{spk}-0-{k}.wav"),
                               x.astype(np.float32), SR)
    d = os.path.join(bg, "tt")
    os.makedirs(d)
    audio_io.write_wav(os.path.join(d, "noise1.wav"),
                       (0.2 * rng.standard_normal(SR * 7)).astype(np.float32),
                       SR)
    out = str(root / "jams")
    generate_scene_specs(fg, bg, out, num_soundscapes=1, seed=11)
    return os.path.join(out, "00000000"), fg, bg


def test_self_consistency_matches_jax(scene):
    got = scaper_crossval.self_consistency(*scene)
    want = jax_crossval.self_consistency(*scene)
    assert len(got["events"]) == len(want["events"]) > 1
    for g, w in zip(got["events"], want["events"]):
        assert (g["role"], g["label"]) == (w["role"], w["label"])
        for k in ("target_lufs", "achieved_lufs", "abs_err_lufs"):
            assert abs(g[k] - w[k]) <= 1e-4, (k, g, w)
    assert abs(got["max_abs_err_lufs"] - want["max_abs_err_lufs"]) <= 1e-4
    assert got["max_abs_err_lufs"] < 0.5


def test_against_scaper_needs_scaper(scene, monkeypatch):
    """Without scaper (blocked here whether or not it is installed) the
    comparison raises ImportError, as the JAX module's does."""
    monkeypatch.setitem(sys.modules, "scaper", None)
    for mod in (scaper_crossval, jax_crossval):
        with pytest.raises(ImportError):
            mod.against_scaper(*scene)


def test_cli_report_and_exit_code(scene, monkeypatch, capsys):
    """The CLI prints the JAX CLI's JSON report (the scaper comparison
    reported as skipped) and exits 0, or 1 when a stem misses its target
    by more than --tol_lufs."""
    monkeypatch.setitem(sys.modules, "scaper", None)
    scene_dir, fg, bg = scene
    args = [scene_dir, "--fg_dir", fg, "--bg_dir", bg]
    reports = []
    for mod in (scaper_crossval, jax_crossval):
        assert mod.main(args) == 0
        reports.append(json.loads(capsys.readouterr().out))
    got, want = reports
    assert got.keys() == want.keys() == {"self_consistency",
                                         "against_scaper"}
    assert got["against_scaper"] == want["against_scaper"] == \
        "skipped: scaper not installed"
    assert abs(got["self_consistency"]["max_abs_err_lufs"]
               - want["self_consistency"]["max_abs_err_lufs"]) <= 1e-4
    assert scaper_crossval.main(args + ["--tol_lufs", "0"]) == 1
    capsys.readouterr()
