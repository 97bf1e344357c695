"""Nothing the harness runs imports JAX or the JAX package, and the
reference imports none of those nor the port; compared by whole
top-level module names (the port's name begins with the JAX
package's)."""

import ast
import re
import subprocess
import sys

import pytest

from benchmark.harness.cell import BENCH_DIR
from benchmark.tests.conftest import REPO

JAX = {"jax", "jaxlib", "flax", "lookoncetohear_tpu"}
PORT = "lookoncetohear_tpu_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*parts):
    return sorted((BENCH_DIR.joinpath(*parts)).rglob("*.py"))


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_file_imports_jax(path):
    assert not imported_tops(path) & JAX


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert not tops & (JAX | {PORT})
    assert tops <= {"__future__", "contextlib", "math", "numpy", "torch",
                    "benchmark"}


def class_names(*paths):
    return {node.name for path in paths
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ClassDef)}


# what a configuration names: the port's model and task classes, and the
# modules of reference/
NAMED = class_names(*sorted((REPO / PORT / "models").glob("*.py")),
                    REPO / PORT / "train" / "tasks.py")
REFERENCES = {p.stem for p in BENCH_DIR.joinpath("reference").glob("*.py")
              if p.stem != "__init__"}


@pytest.mark.parametrize("path", sources("harness") + [BENCH_DIR / "run.py"],
                         ids=lambda p: p.name)
def test_the_harness_names_no_model_task_or_reference(path):
    """The loops and the runner find the model, the task and the
    reference by the configuration's names: none is written in them."""
    text = path.read_text()
    assert {"Net", "TSETask", "EmbedNet"} <= NAMED
    assert not set(re.findall(r"\w+", text)) & NAMED
    assert not set(re.findall(r"reference[./](\w+)", text)) & REFERENCES


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"], cwd=REPO, capture_output=True,
        text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a small cell on the CPU, in a process of its own:
    what it loads (the port, and what the port loads) holds no JAX."""
    loaded = loaded_after(
        "import time\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark.run import run_cell, forbidden_modules\n"
        "for w in ('flagship.serve64', 'flagship.train8x5s',\n"
        "          'embed.enroll4x5s'):\n"
        "    run_cell(tiny_cell(w), 5, 0.2, False, 'cpu',\n"
        "             time.perf_counter())\n"
        "assert not forbidden_modules()")
    assert PORT in loaded and not loaded & JAX


def test_the_reference_loads_no_program():
    loaded = loaded_after("import benchmark.reference.train, "
                          "benchmark.reference.tfgridnet, "
                          "benchmark.reference.offline_tfgridnet")
    assert not loaded & (JAX | {PORT})
