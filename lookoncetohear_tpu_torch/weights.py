"""Flax params / `p//` npz checkpoints <-> the port's `state_dict`.

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
  LayerNorm, GroupNorm1 scale / bias -> weight / bias
  PReLU alpha (1,)                  -> weight
  espnet norms' gamma / beta, the offline nets' ConvTranspose1d
  weight [in, out, k]               -> same name, same layout
  HeadConv1x1 kernel [C, out]       -> weight [out, C] (the Dense rule)

`params_to_jax` and `save_npz` run the rules the other way, so a model
the port trained loads in the JAX package (`train/npz_ckpt.load_params`,
`ts_hear_test --ckpt`).
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


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a `p//` npz checkpoint into `model` strictly: every key maps
    to a parameter of the same shape, and every parameter is loaded."""
    model.load_state_dict(params_from_jax(load_npz(path)), strict=True)
    return model


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


def _flax_key(torch_name: str, ndim: int) -> str:
    """The inverse of `_torch_name`, given the parameter's rank: a
    `weight` is an `alpha` under an `act` (PReLU), a `scale` under a
    `*norm` (LayerNorm, GroupNorm1), a `weight` of rank 3 (the offline
    nets' ConvTranspose1d) and a `kernel` otherwise."""
    parts = torch_name.split(".")
    mod = []
    for p in parts[:-1]:
        if p.isdigit():
            mod[-1] = f"{mod[-1]}_{p}"
        else:
            mod.append(p)
    leaf = parts[-1]
    if leaf == "weight":
        parent = mod[-1] if mod else ""
        if parent == "act":
            leaf = "alpha"
        elif parent.endswith("norm"):
            leaf = "scale"
        elif ndim != 3:
            leaf = "kernel"
    return _SEP.join(mod + [leaf])


def params_to_jax(state_dict) -> dict[str, np.ndarray]:
    """Port `state_dict` -> flat flax params {"a/b/kernel": float32
    array}, the exact inverse of `params_from_jax`."""
    out = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy().astype(np.float32)
        key = _flax_key(name, arr.ndim)
        if key.endswith("kernel"):
            arr = np.transpose(arr, (2, 3, 1, 0)) if arr.ndim == 4 else arr.T
        out[key] = np.ascontiguousarray(arr)
    return out


def save_npz(path: str, model: torch.nn.Module, extra=None) -> None:
    """Write the model's parameters as a `p//` npz checkpoint, plus the
    entries of `extra` ({key: array}), to `path` as given (numpy adds
    no suffix to an open file)."""
    entries = {PARAM_PREFIX + k: v
               for k, v in params_to_jax(model.state_dict()).items()}
    entries.update(extra or {})
    with open(path, "wb") as f:
        np.savez_compressed(f, **entries)
