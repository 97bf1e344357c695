"""Portable .npz checkpoints (counterpart of
`lookoncetohear_tpu/train/npz_ckpt.py`).

Two key layouts inside one .npz:
  * params: the model's parameters in the JAX package's layout and
    names, "p//<k1>/<k2>/..." (`weights.params_to_jax`). The JAX
    package's `train/npz_ckpt.load_params` and `ts_hear_test --ckpt`
    read them, and `weights.load_checkpoint` loads them into the port.
  * full state (for `--resume`): the port's own training state under
    "f//" keys, "/"-joined paths of a nested dict: the Adam moments and
    step of every parameter (under "opt", then the parameter's name),
    the epoch, the step and the plateau scheduler's state. These keys are
    the port's, not the JAX package's (whose "f//" keys are optax
    pytree paths): the JAX package cannot resume from them, and the
    port cannot resume from its.
"""

from __future__ import annotations

import numpy as np
import torch

from lookoncetohear_tpu_torch import weights

FULL_PREFIX = "f//"
_SEP = "/"


def save_npz(path: str, model: torch.nn.Module, full_state=None) -> None:
    """Write the params (always) and the full state (if given) to
    `path` as given (no suffix added)."""
    weights.save_npz(path, model, None if full_state is None else {
        FULL_PREFIX + k: v
        for k, v in weights.flatten_params(full_state).items()})


def has_full_state(path: str) -> bool:
    with np.load(path, allow_pickle=False) as z:
        return any(k.startswith(FULL_PREFIX) for k in z.files)


def load_full_state(path: str) -> dict:
    """The "f//" entries as the nested dict they were saved from
    (leaves as numpy arrays)."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith(FULL_PREFIX):
                continue
            parts = key[len(FULL_PREFIX):].split(_SEP)
            cur = out
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            cur[parts[-1]] = z[key]
    if not out:
        raise ValueError(f"{path} holds no '{FULL_PREFIX}*' entries")
    return out
