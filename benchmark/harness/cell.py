"""A cell of `BENCHMARK.json` and everything found by its names: the
configuration's file and what it names (the port's `model` and `task`
classes by dotted path, its plain `reference` and `train_reference`
under `reference/`), the
traffic mix (`traffic/<traffic>.json`) and the loop of its `kind`
(`harness/<kind>.py`), the limits of its comparison
(`limits/<workload>.json`), the per-layer metrics' readers
(`metrics/<metric>.py`) and the table of peaks."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    peaks: dict = field(default_factory=dict)

    @property
    def peak_flops(self) -> float:
        """The card's peak for the precision the traffic states."""
        return float(self.peaks["flops"][self.traffic["dtype"]])

    @property
    def peak_bytes_s(self) -> float:
        return float(self.peaks["hbm_bytes_s"])

    @property
    def loop(self):
        """The module of the traffic's `kind`: `harness/<kind>.py`, whose
        `run` runs the cell and whose `controls` give its control's
        readings."""
        return importlib.import_module(
            f"benchmark.harness.{self.traffic['kind']}")

    @property
    def reference(self):
        """The configuration's plain reference (its `reference`)."""
        return self.module("reference")

    def module(self, key: str):
        """The module of `reference/` the configuration names under
        `key` ("reference"; "train_reference", the training steps): a
        file of the repository, `benchmark/reference/<name>.py`."""
        path = Path(self.config[key]).with_suffix("")
        if path.parent != Path("benchmark/reference"):
            raise ValueError(f"{self.config[key]}: a reference is a file "
                             f"of benchmark/reference/")
        return importlib.import_module(".".join(path.parts))

    def named(self, key: str):
        """The class the configuration names under `key` ("model",
        "task") by its dotted path."""
        module, _, name = self.config[key].rpartition(".")
        return getattr(importlib.import_module(module), name)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(manifest_path: Path, workload: str) -> Cell:
    """The cell `workload` of the manifest at `manifest_path`; file
    paths in the manifest are relative to its directory."""
    root = manifest_path.parent
    manifest = load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {manifest_path}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=workload, chips=int(w["chips"]), config=config,
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        end_to_end=[m for m in manifest["end_to_end"]
                    if applies(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if applies(m, workload)],
        peaks=load_json(BENCH_DIR / "peaks.json"))


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file, whose name may
    hold dots (`metrics/roofline.b2.serve.py`)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str):
    """The `read(ctx)` of a per-layer metric."""
    return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                       "bench_metric_" + metric.replace(".", "_")).read


def work(op: str):
    """The operation and byte counts of an op (`work/<op>.py`)."""
    return load_module(BENCH_DIR / "work" / f"{op}.py", "bench_work_" + op)
