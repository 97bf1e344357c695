"""Host-side batching (counterpart of `collate`, `shard_indices` and
`DataLoader` in `lookoncetohear_tpu/data/loader.py`; in a process group
each rank loads its own shard of every epoch):
scenes are rendered by `torch.utils.data.DataLoader` workers and
collated into numpy batches. Only the eval and training loops move the
numeric fields to the device; strings and metadata stay host-side
lists.

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


def shard_indices(n: int, *, shuffle: bool, seed: int, epoch: int,
                  process_index: int | None = None,
                  process_count: int | None = None) -> np.ndarray:
    """This rank's scenes of an epoch: every rank permutes the indices
    the same way (`default_rng((seed, epoch))`, when shuffling) and
    takes the strided slice [process_index::process_count], as the JAX
    package does. The rank and count default to the process group's
    (0 and 1 outside one)."""
    from lookoncetohear_tpu_torch.parallel import distributed
    if process_index is None:
        process_index = distributed.rank()
    if process_count is None:
        process_count = distributed.world_size()
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng((seed, epoch)).permutation(idx)
    return idx[process_index::process_count]


class DataLoader:
    """Epoch iterator: `shard_indices` (this rank's shard) -> batches of
    `batch_size` (the ragged tail dropped with `drop_last`) -> `collate`,
    rendered by `num_workers` fork-server workers as `batches` does.
    `set_epoch` picks the epoch's shuffle.

    The workers persist across epochs, as the JAX package's pool does:
    one `torch.utils.data.DataLoader` an instance, built at first use
    with `persistent_workers`, whose batch sampler reads the epoch and
    the `epoch_batches` cut at each pass. `close` stops them."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 0,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.epoch = 0
        self._max_batches = None
        self._loader = None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        return shard_indices(len(self.dataset), shuffle=self.shuffle,
                             seed=self.seed, epoch=self.epoch)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _index_batches(self) -> list:
        idx = self._indices()
        if self.drop_last:
            idx = idx[:len(idx) - len(idx) % self.batch_size]
        return [idx[i:i + self.batch_size].tolist()
                for i in range(0, len(idx), self.batch_size)]

    def epoch_batches(self, max_batches: int | None = None):
        """This epoch's first `max_batches` batches (all with None): only
        those are rendered."""
        self._max_batches = max_batches
        if self._loader is None:
            self._loader = batches(self.dataset, num_workers=self.num_workers,
                                   batch_sampler=_EpochSampler(self),
                                   persistent_workers=self.num_workers > 0)
        return iter(self._loader)

    def __iter__(self):
        return self.epoch_batches()

    def close(self) -> None:
        """Stop the worker processes, if any ran (a later pass starts
        new ones). Only a loader with workers keeps an iterator."""
        it = getattr(self._loader, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
        self._loader = None


class _EpochSampler:
    """The batch sampler of a `DataLoader`: at each pass the index
    batches of its current epoch, cut to its `max_batches`."""

    def __init__(self, dl: DataLoader):
        self.dl = dl

    def _batches(self) -> list:
        return self.dl._index_batches()[:self.dl._max_batches]

    def __iter__(self):
        return iter(self._batches())

    def __len__(self) -> int:
        return len(self._batches())


def batches(dataset, batch_size: int = 4, num_workers: int = 0,
            batch_sampler=None, persistent_workers: bool = False
            ) -> torch.utils.data.DataLoader:
    """The dataset in order, `batch_size` scenes per `collate`d batch
    (or the index lists of `batch_sampler`), rendered by `num_workers`
    worker processes (0: in this process), kept from one pass to the
    next with `persistent_workers`.

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
    order = dict(batch_size=batch_size) if batch_sampler is None \
        else dict(batch_sampler=batch_sampler)
    return torch.utils.data.DataLoader(
        dataset, collate_fn=collate, num_workers=num_workers,
        multiprocessing_context=ctx, persistent_workers=persistent_workers,
        **order)


def stop_workers() -> None:
    """Stop the fork server and the resource tracker that a loader with
    workers starts, and wait for both. Left alone, each exits only
    after its parent has (the fork server's interpreter, which holds
    torch, a second or more later), so a program that must leave no
    process behind calls this when it is done with its loaders."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
