"""Config utilities (counterpart of `lookoncetohear_tpu/utils.py`): the
JSON -> attribute-bag `Params`, and `import_attr`, which maps the
dotted paths the committed configs name onto the port's classes.

The configs name the JAX package's classes
(`lookoncetohear_tpu.models.net.Net`, ...). `import_attr` resolves
those the port has (the models, the synthetic dataset, the TSE and
embedding training tasks and the plateau scheduler) and refuses every
other path, such as `SeparationTask`, with an error that names it.
"""

from __future__ import annotations

import contextlib
import importlib
import json

import torch

_JAX_PACKAGE = "lookoncetohear_tpu."
_PORT_PACKAGE = "lookoncetohear_tpu_torch."
# the JAX package's paths (without the package name) that the port has
_PORTED = frozenset({
    "models.net.Net",
    "models.net.EmbedNet",
    "data.synthetic.SyntheticTSEDataset",
    "train.tasks.TSETask",
    "train.tasks.EmbedTask",
    "train.schedule.ReduceLROnPlateau",
})


def import_attr(import_path: str):
    """The port's class for a config's dotted path, given under the JAX
    package's name or the port's."""
    for pkg in (_JAX_PACKAGE, _PORT_PACKAGE):
        if import_path.startswith(pkg) and \
                import_path[len(pkg):] in _PORTED:
            module, attr = (_PORT_PACKAGE
                            + import_path[len(pkg):]).rsplit(".", 1)
            return getattr(importlib.import_module(module), attr)
    raise ValueError(
        f"{import_path!r} has no counterpart in the PyTorch port; it "
        f"resolves {sorted(_JAX_PACKAGE + p for p in _PORTED)}")


class Params:
    """JSON-file-backed attribute bag."""

    def __init__(self, json_path: str):
        with open(json_path) as f:
            params = json.load(f)
        self.__dict__.update(params)


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN inside the block, restored after.
    cuDNN convolutions default to TF32, which moves float32 results by
    ~1e-3 relative."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
