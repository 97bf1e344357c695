"""Flax params / `p//` npz checkpoints -> the port's `state_dict`.

Counterpart of `lookoncetohear_tpu/train/npz_ckpt.py` (key format) and
`lookoncetohear_tpu/convert.py` (layout rules, run the other way). The
npz format is copied here, not imported: the JAX package's module
imports jax, which the GPU machine does not have.

Key format: a nested params dict flattened with '/'-joined keys, each
prefixed "p//" in the npz (e.g. "p//tfgridnet/blocks_0/attn_q/dense/
kernel"). Layout rules, flax -> torch:

  Dense kernel [in, out]            -> Linear.weight [out, in]
  nn.Conv kernel [kh, kw, in, out]  -> Conv2d.weight [out, in, kh, kw]
                                       (the deconv too: it is a VALID
                                       conv on the stored kernel)
  LSTM w_ih/w_hh/b_ih/b_hh          -> same name, same layout
  LayerNorm scale / bias            -> weight / bias
  PReLU alpha (1,)                  -> weight
"""

from __future__ import annotations

import numpy as np
import torch

PARAM_PREFIX = "p//"
_SEP = "/"


def flatten_params(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested params dict -> {"a/b/c": array} (no "p//" prefix)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_npz(path: str) -> dict[str, np.ndarray]:
    """The params entries of a `p//` npz checkpoint, prefix stripped."""
    with np.load(path, allow_pickle=False) as z:
        out = {k[len(PARAM_PREFIX):]: z[k] for k in z.files
               if k.startswith(PARAM_PREFIX)}
    if not out:
        raise ValueError(f"{path} holds no '{PARAM_PREFIX}*' entries")
    return out


def _torch_name(flax_key: str) -> str:
    parts = flax_key.split(_SEP)
    mod = []
    for p in parts[:-1]:
        head, _, idx = p.rpartition("_")
        # flax list submodules are named "<field>_<i>"
        mod.extend([head, idx] if head and idx.isdigit() else [p])
    leaf = parts[-1]
    if leaf in ("kernel", "scale", "alpha"):
        leaf = "weight"
    return ".".join(mod + [leaf])


def _torch_value(flax_key: str, arr: np.ndarray) -> np.ndarray:
    if flax_key.endswith("kernel"):
        if arr.ndim == 4:                       # [kh, kw, in, out]
            return np.transpose(arr, (3, 2, 0, 1))
        if arr.ndim == 2:                       # [in, out]
            return arr.T
        raise ValueError(f"{flax_key}: unexpected kernel rank {arr.ndim}")
    return arr


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat flax params ("p//" prefix optional) -> port `state_dict`
    of float32 CPU tensors."""
    sd = {}
    for key, arr in flat.items():
        if key.startswith(PARAM_PREFIX):
            key = key[len(PARAM_PREFIX):]
        arr = np.asarray(arr, np.float32)
        name = _torch_name(key)
        if name in sd:
            raise ValueError(f"two params map to {name!r}")
        # .copy(): C order, writable, independent of the npz buffer
        sd[name] = torch.from_numpy(_torch_value(key, arr).copy())
    return sd
