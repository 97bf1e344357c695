"""The rank's device and batch padding (counterpart of
`lookoncetohear_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a ("data", "model") mesh and
lets GSPMD shard the batch and reduce the gradients. The port runs one
process per card instead (DDP in `train/trainer.py`): each rank holds
its own batch on its own device, so nothing here shards a tensor.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lookoncetohear_tpu_torch import resolve_device


def rank_device(device=None) -> torch.device:
    """`device` as a `torch.device`, with the card this process drives
    (`cuda:{LOCAL_RANK}`, LOCAL_RANK 0 when unset) when it names the
    card without an index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def pad_batch_to(batch, multiple: int):
    """Right-pad the leading axis of every array of a (nested) batch to
    a multiple of `multiple` with zeros; returns (padded batch, real
    count). Arrays whose leading axis is not the batch's pass through."""
    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        else:
            yield x

    b = next(int(x.shape[0]) for x in leaves(batch)
             if hasattr(x, "shape") and np.ndim(x) >= 1)
    pad = (-b) % multiple
    if pad == 0:
        return batch, b

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(leaf(v) for v in x)
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1 \
                and x.shape[0] == b:
            if isinstance(x, torch.Tensor):
                return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
        return x
    return leaf(batch), b
