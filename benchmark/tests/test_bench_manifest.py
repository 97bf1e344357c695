"""BENCHMARK.json against the benchmark's schema: names and units,
the files each cell finds by name, and which metric each cell reports."""

import inspect
import json
import re

import pytest

from benchmark.harness.cell import BENCH_DIR, load_cell
from benchmark.tests.conftest import MANIFEST, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level(manifest):
    assert set(manifest) == KEYS
    assert MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(manifest["command"]) <= 32
    assert all(LINE.match(w) for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51


def test_names_units_and_lines(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("workload", [
    "flagship.serve64", "net_default.train8x5s", "net_default.serve64",
    "flagship.train8x5s", "embed.enroll4x5s"])
def test_cell_files_and_metrics(manifest, workload):
    cell = load_cell(MANIFEST, workload)
    kinds = {"serve": {"rt_streams", "chunk_p95_ms"},
             "train": {"train_audio_rate"},
             "offline": {"offline_audio_rate"}}[cell.traffic["kind"]]
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == kinds | {"setup_s"}
    # the loop of the kind, the classes and the reference it calls
    assert callable(cell.loop.run) and callable(cell.loop.controls)
    assert isinstance(cell.named("model"), type)
    if cell.traffic["kind"] == "train":
        assert isinstance(cell.named("task"), type)
        assert callable(cell.module("train_reference").steps)
    assert callable(cell.reference.param_table)
    assert cell.per_layer
    for m in cell.per_layer:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e, (m["name"], workload)
        assert LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert set(cell.limits) - {"control"}
    assert cell.limits["control"] in ("tf32", "fp8")


def test_config_files_under_paths(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in manifest["paths"])
        assert (REPO / f).is_file()


def test_configs_are_the_published_ones():
    """Uncut: the flagship is configs/tsh.json's model_params, the
    default Net is `Net.__init__`'s defaults, the enrollment net is
    configs/embed.json's model_params (`reduced` is empty)."""
    from lookoncetohear_tpu_torch.entry import FLAGSHIP
    from lookoncetohear_tpu_torch.models.net import Net
    flagship = json.loads((BENCH_DIR / "configs" / "flagship.json")
                          .read_text())
    assert flagship["model_params"] == FLAGSHIP
    default = json.loads((BENCH_DIR / "configs" / "net_default.json")
                         .read_text())
    sig = inspect.signature(Net.__init__).parameters
    for k, v in default["model_params"].items():
        assert sig[k].default == v, k
    embed = json.loads((BENCH_DIR / "configs" / "embed.json").read_text())
    published = json.loads((REPO / "configs" / "embed.json").read_text())
    assert embed["model_params"] == \
        published["pl_module_args"]["model_params"]
