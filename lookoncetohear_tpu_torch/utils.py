"""Config utilities (counterpart of `lookoncetohear_tpu/utils.py`): the
JSON -> attribute-bag `Params`, and `import_attr`, which maps the
dotted paths the configs name onto the port's classes.

The configs name the JAX package's classes
(`lookoncetohear_tpu.models.net.Net`, ...) or, in the reference's
configs (`configs/tsh.json`, `configs/embed.json`), the reference
codebase's `src.*` paths and torch's plateau scheduler, which the JAX
package maps through its compatibility registry. `import_attr` takes
all three forms, resolves each to the port's class where the port has
one, and refuses every other path with an error that names it.
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
    "models.net.OfflineSeparatorNet",
    "data.synthetic.SyntheticTSEDataset",
    "data.datasets.MixLibriSpeechNoisyEnroll",
    "data.dataset_variants.MixLibriSpeechNoisyEnrollWP",
    "data.dataset_variants.MixLibriSpeechNoisyEnrollDirectional",
    "data.dataset_variants.MixLibriSpeechCIPIC",
    "data.dataset_variants.MixLibriSpeechDM",
    "data.dataset_variants.SpeechSeparationDataset",
    "data.dataset_variants.OracleMixLibriSpeech",
    "train.tasks.TSETask",
    "train.tasks.EmbedTask",
    "train.tasks.SeparationTask",
    "train.tasks.EmbeddingTableLogger",
    "train.schedule.ReduceLROnPlateau",
})
# the reference configs' paths -> the JAX package's paths (without the
# package name), as the JAX package's `_COMPAT_REGISTRY` maps them
_COMPAT_REGISTRY = {
    "src.ts_hear_embed_pl_module.PLModule": "train.tasks.TSETask",
    "src.binaural_embed_pl_module.PLModule": "train.tasks.EmbedTask",
    "src.ts_hear_embed_pl_module.Logger":
        "train.tasks.EmbeddingTableLogger",
    "src.binaural_embed_pl_module.Logger":
        "train.tasks.EmbeddingTableLogger",
    "src.models.tfgridnet_realtime.net.Net": "models.net.Net",
    "src.models.tfgridnet_orig.tfgridnet.EmbedTFGridNet":
        "models.net.EmbedNet",
    "src.models.tfgridnet_orig.tfgridnet.Net":
        "models.net.OfflineSeparatorNet",
    "src.datasets.MixLibriSpeechNoisyEnrollNorm.MixLibriSpeechNoisyEnroll":
        "data.datasets.MixLibriSpeechNoisyEnroll",
    "src.datasets.MixLibriSpeechNoisyEnroll.MixLibriSpeechNoisyEnroll":
        "data.datasets.MixLibriSpeechNoisyEnroll",
    "src.datasets.MixLibriSpeechNoisyEnrollWP.MixLibriSpeechNoisyEnroll":
        "data.dataset_variants.MixLibriSpeechNoisyEnrollWP",
    "src.datasets.MixLibriSpeechNoisyEnrollDirectional."
    "MixLibriSpeechNoisyEnroll":
        "data.dataset_variants.MixLibriSpeechNoisyEnrollDirectional",
    "src.datasets.MixLibriSpeech.MixLibriSpeechCIPICDataset":
        "data.dataset_variants.MixLibriSpeechCIPIC",
    "src.datasets.MixLibriSpeechDM.MixLibriSpeechDM":
        "data.dataset_variants.MixLibriSpeechDM",
    "src.datasets.MixLibriSpeechMotion.MixLibriSpeechMotionDataset":
        "data.dataset_variants.MixLibriSpeechMotion",
    "src.datasets.SpeechSeparationDataset.SpeechSeparationDataset":
        "data.dataset_variants.SpeechSeparationDataset",
    "src.datasets.OracleMixLibriSpeech.OracleMixLibriSpeechDataset":
        "data.dataset_variants.OracleMixLibriSpeech",
    "torch.optim.lr_scheduler.ReduceLROnPlateau":
        "train.schedule.ReduceLROnPlateau",
}


def import_attr(import_path: str):
    """The port's class for a config's dotted path: a reference `src.*`
    path, or a path under the JAX package's name or the port's."""
    rel = _COMPAT_REGISTRY.get(import_path)
    if rel is None:
        for pkg in (_JAX_PACKAGE, _PORT_PACKAGE):
            if import_path.startswith(pkg):
                rel = import_path[len(pkg):]
    if rel in _PORTED:
        module, attr = (_PORT_PACKAGE + rel).rsplit(".", 1)
        return getattr(importlib.import_module(module), attr)
    target = f" (the JAX package's {_JAX_PACKAGE}{rel})" \
        if import_path in _COMPAT_REGISTRY else ""
    raise ValueError(
        f"{import_path!r}{target} has no counterpart in the PyTorch port; "
        f"it resolves {sorted(_JAX_PACKAGE + p for p in _PORTED)} and "
        "the reference configs' paths that map onto them")


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
