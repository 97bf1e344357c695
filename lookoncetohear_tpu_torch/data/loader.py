"""Host-side batching (counterpart of `collate` in
`lookoncetohear_tpu/data/loader.py`): scenes are rendered by
`torch.utils.data.DataLoader` workers and collated into numpy batches.
Only the eval loop moves the numeric fields to the device; strings and
metadata stay host-side lists.

`collate` keeps the JAX package's nesting, which differs from
`torch.utils.data.default_collate`: a list field of per-sample lists
(e.g. `source_files`) becomes a list over positions of lists over the
batch, a tuple of strings a tuple of lists, and arrays are stacked as
numpy, never turned into tensors. The eval CSV indexes
`source_files[k + 1][i]`, `speaker_info[k][1][i]` and
`embedding_neg[j][i]` that way.
"""

from __future__ import annotations

import multiprocessing
from typing import Any

import numpy as np
import torch


def collate(samples: list) -> Any:
    """Batch a list of per-sample pytrees (dicts/lists/tuples of numpy
    arrays, scalars, or strings), torch-default-collate style."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            collate([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, str):
        return list(samples)
    arr = np.asarray(samples[0])
    if arr.dtype.kind in "OU":
        return list(samples)
    return np.stack([np.asarray(s) for s in samples])


def batches(dataset, batch_size: int = 4,
            num_workers: int = 0) -> torch.utils.data.DataLoader:
    """The dataset in order, `batch_size` scenes per `collate`d batch,
    rendered by `num_workers` worker processes (0: in this process).

    Workers come from a fork server: a fresh single-threaded process
    that imports torch and this package once, of which each worker is a
    fork. The caller may hold CUDA and threads, which a worker forked
    from it would inherit, and a spawned worker would import torch anew
    (on a host with slow disk reads, tens of seconds for 8 workers)."""
    ctx = None
    if num_workers > 0:
        ctx = multiprocessing.get_context("forkserver")
        # takes effect when the server starts, at the first loader
        ctx.set_forkserver_preload([__name__, type(dataset).__module__])
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, shuffle=False, drop_last=False,
        collate_fn=collate, num_workers=num_workers,
        multiprocessing_context=ctx)


def stop_workers() -> None:
    """Stop the fork server and the resource tracker that a loader with
    workers starts, and wait for both. Left alone, each exits only
    after its parent has (the fork server's interpreter, which holds
    torch, a second or more later), so a program that must leave no
    process behind calls this when it is done with its loaders."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
