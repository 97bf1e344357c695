"""Config utilities (counterpart of `lookoncetohear_tpu/utils.py`): the
JSON -> attribute-bag `Params`, and `import_attr`, which maps the
dotted paths the configs name onto the port's classes, and
`get_run_id`.

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
import os
import uuid

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
    "data.dataset_variants.MixLibriSpeechMotion",
    "data.prep.prerender",
    "data.prep.prerender.PrerenderedDataset",
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
    """The port's class (or module) for a config's dotted path: a
    reference `src.*` path, or a path under the JAX package's name or
    the port's."""
    rel = _COMPAT_REGISTRY.get(import_path)
    if rel is None:
        for pkg in (_JAX_PACKAGE, _PORT_PACKAGE):
            if import_path.startswith(pkg):
                rel = import_path[len(pkg):]
    if rel in _PORTED:
        full = _PORT_PACKAGE + rel
        module, attr = full.rsplit(".", 1)
        mod = importlib.import_module(module)
        # a submodule is an attribute of its package only once imported
        return getattr(mod, attr) if hasattr(mod, attr) \
            else importlib.import_module(full)
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


def get_run_id(run_dir: str | None = None) -> str:
    """A unique run id, kept in run_dir/run_id.txt so that a resumed run
    keeps its id (a fresh one each call without run_dir)."""
    if run_dir is None:
        return uuid.uuid4().hex[:8]
    id_file = os.path.join(run_dir, "run_id.txt")
    if not os.path.exists(id_file):
        os.makedirs(run_dir, exist_ok=True)
        with open(id_file, "w") as f:
            f.write(uuid.uuid4().hex[:8])
    with open(id_file) as f:
        return f.read().strip()


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
