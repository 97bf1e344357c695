"""The training loop (counterpart of
`lookoncetohear_tpu/train/trainer.py`), on one device a process.

Each step runs the task's loss on a batch moved to the device, its
backward (on the card every LSTM recurrence forward and backward is
a kernel of `csrc/bilstm_scan.cu`), an optional clip by
global norm as optax computes it, and `torch.optim.Adam` with optax's
defaults. The plateau scheduler writes the learning rate into the
optimizer's `param_groups` after each epoch's validation. Checkpoints
are npz files, last + top-5 on the task's monitor
(`train/checkpoint.py`). A config's `pl_logger` (the embedding-table
logger) gets the task's `log_embeddings` tables of every 5th evaluation
batch and writes them per split.

In a process group (`parallel/distributed.py`; torchrun or the
`LOOKONCE_*` variables) each rank drives one device. Above one rank the
task's model is wrapped in `DistributedDataParallel`, which averages
the gradients over the ranks, so a step is the step of
the global batch (each rank's loader batch is the config's batch over
the world size, from its own shard of the epoch's permutation). The
ranks agree on each epoch's batch count (the minimum for training, the
maximum for evaluation, where a rank whose shard ran out feeds masked
filler); the training metrics are averaged and the evaluation sums
reduced, weighted by their real row counts. Only rank 0 writes
metrics, checkpoints and tables, and the ranks wait for each
checkpoint. The `--prerender` cache is written by rank 0 while the
others wait.
"""

from __future__ import annotations

import json
import logging
import os
import random
import time

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from lookoncetohear_tpu_torch import utils
from lookoncetohear_tpu_torch.data.loader import DataLoader, stop_workers
from lookoncetohear_tpu_torch.parallel import distributed
from lookoncetohear_tpu_torch.parallel.mesh import rank_device
from lookoncetohear_tpu_torch.train import npz_ckpt
from lookoncetohear_tpu_torch.train.checkpoint import CheckpointManager
from lookoncetohear_tpu_torch.weights import load_checkpoint

# optax.adam's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class MetricsLogger:
    """JSON lines in run_dir/metrics.jsonl, echoed to the log; rank 0
    only."""

    def __init__(self, run_dir: str) -> None:
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def log(self, record: dict) -> None:
        if not distributed.is_primary():
            return
        record = {k: (float(v) if isinstance(v, (int, float, np.floating,
                                                 torch.Tensor)) else v)
                  for k, v in record.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        logging.info("%s", record)


def clip_by_global_norm(grads, max_norm: float) -> None:
    """Scale `grads` in place as `optax.clip_by_global_norm` does: by
    max_norm / norm when the global norm reaches max_norm (no epsilon,
    unlike `torch.nn.utils.clip_grad_norm_`)."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def to_device(batch: dict, device) -> dict:
    """The numeric numpy fields of a device batch as tensors on
    `device`, floats as float32; other fields as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "fiub":
            v = torch.from_numpy(np.ascontiguousarray(
                v.astype(np.float32) if v.dtype.kind == "f" else v))
            v = v.to(device, non_blocking=True)
        out[k] = v
    return out


class _DDP(DistributedDataParallel):
    """DDP that answers for the wrapped model's attributes and methods
    too (`_shifts_to_indices`, ...), so a task uses it as its model."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.module, name)


def ddp_wrap(model: torch.nn.Module, device: torch.device) -> _DDP:
    """`model` in DDP on `device` (a rank's one device); its buffers
    (windows, masks) are constants, so none is broadcast."""
    return _DDP(model, broadcast_buffers=False,
                device_ids=None if device.type == "cpu" else [device])


class Trainer:
    def __init__(self, task, run_dir: str, epochs: int = 100,
                 grad_clip: float | None = None,
                 limit_batches: float | int = 1.0, device=None,
                 table_logger=None) -> None:
        """limit_batches: a float is the fraction of each split per
        epoch, an int an absolute number of batches (Lightning's
        meaning: int 1 is one batch, float 1.0 the whole split).
        table_logger: the config's `pl_logger`, or None."""
        self.task = task
        self.table_logger = table_logger
        self.run_dir = run_dir
        self.epochs = epochs
        self.grad_clip = grad_clip
        self.limit_batches = limit_batches
        self.device = rank_device(device)
        self.model = task.model.to(self.device)
        self.world = distributed.world_size()
        if self.world > 1:
            task.model = ddp_wrap(self.model, self.device)
        os.makedirs(run_dir, exist_ok=True)
        self.logger = MetricsLogger(run_dir)
        self.ckpts = CheckpointManager(
            run_dir, task.monitor, task.monitor_mode, top_k=5)
        self.scheduler = None
        if getattr(task, "scheduler", None) is not None:
            sched_cls = utils.import_attr(task.scheduler)
            self.scheduler = sched_cls(lr=task.lr, **task.scheduler_params)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.opt = torch.optim.Adam(self.params, lr=task.lr,
                                    betas=ADAM_BETAS, eps=ADAM_EPS)

    # -- one step ------------------------------------------------------------

    def train_step(self, batch: dict, epoch: int) -> dict:
        """Loss, backward, clip, Adam on one device batch; returns the
        metrics as detached device scalars."""
        self.opt.zero_grad(set_to_none=True)
        loss, metrics = self.task.loss_and_metrics(batch, epoch)
        loss.backward()
        if self.grad_clip:
            clip_by_global_norm([p.grad for p in self.params
                                 if p.grad is not None], self.grad_clip)
        self.opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    def set_lr(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr

    # -- data ----------------------------------------------------------------

    def _n_batches(self, dl: DataLoader) -> int:
        limit, n = self.limit_batches, len(dl)
        if isinstance(limit, int) and not isinstance(limit, bool):
            return min(n, limit)
        return n if limit >= 1.0 else max(1, int(n * limit))

    def _device_batches(self, dl: DataLoader, pad_to: int | None = None):
        """Yield (device batch, number of real rows). With pad_to (eval),
        a ragged batch is padded to pad_to rows by repeating its last
        row, and `_mask` marks the real ones, so no sample is dropped
        and the masked means leave the padding out. In a process group
        every rank yields the agreed number of batches: a rank whose
        shard ran out repeats its last evaluation batch with every row
        masked out."""
        n_iters = distributed.agree_count(
            self._n_batches(dl), "max" if pad_to is not None else "min")
        last = None
        for batch in dl.epoch_batches(n_iters):
            db = self.task.device_batch(batch, train=pad_to is None)
            sizes = {v.shape[0] for v in db.values()
                     if isinstance(v, np.ndarray) and v.ndim > 0}
            if len(sizes) != 1:
                raise ValueError(
                    "device-batch arrays disagree on the leading (batch) "
                    f"dim: {sorted(sizes)} (keys: {sorted(db)})")
            (b,) = sizes
            if pad_to is not None:
                mask = np.zeros(pad_to, np.float32)
                mask[:b] = 1.0
                db = {k: np.concatenate([v, np.repeat(v[-1:], pad_to - b,
                                                      axis=0)])
                      if isinstance(v, np.ndarray) and v.ndim > 0 else v
                      for k, v in db.items()}
                db["_mask"] = mask
                last = db
            yield to_device(db, self.device), b
            n_iters -= 1
        for _ in range(n_iters):
            if last is None:
                raise RuntimeError("this rank has no evaluation batch to "
                                   "repeat: the split is smaller than the "
                                   "number of processes")
            yield to_device(dict(last, _mask=np.zeros_like(last["_mask"])),
                            self.device), 0

    # -- state ---------------------------------------------------------------

    def full_state(self, epoch: int, step: int) -> dict:
        names = {id(p): n for n, p in self.model.named_parameters()}
        opt = {names[id(p)]: {k: v.detach().cpu().numpy()
                              for k, v in self.opt.state[p].items()}
               for p in self.params if p in self.opt.state}
        return {"opt": opt, "epoch": epoch, "step": step,
                "sched": (self.scheduler.state_dict()
                          if self.scheduler else {})}

    def load_full_state(self, full: dict) -> tuple[int, int]:
        """Restore the optimizer and scheduler; returns (epoch, step)."""
        by_name = dict(self.model.named_parameters())
        for name, st in full.get("opt", {}).items():
            p = by_name[name]
            self.opt.state[p] = {
                k: (torch.tensor(float(v)) if k == "step" else
                    torch.from_numpy(np.asarray(v)).to(p.device))
                for k, v in st.items()}
        if self.scheduler and full.get("sched"):
            self.scheduler.load_state_dict(
                {k: np.asarray(v).item() for k, v in full["sched"].items()})
            self.set_lr(self.scheduler.lr)
        return int(full["epoch"]), int(full["step"])

    # -- main loops ----------------------------------------------------------

    @torch.no_grad()
    def _run_eval(self, dl: DataLoader, epoch: int, split: str = "val"):
        """Sample-weighted means over the split: each batch's masked
        means weighted by its number of real rows, summed over the
        ranks. Tables are kept in a single process only, as in the JAX
        package."""
        sums: dict = {}
        total = 0
        tables = self.table_logger is not None and hasattr(
            self.task, "log_embeddings") and self.world == 1
        for i, (batch, n) in enumerate(
                self._device_batches(dl, pad_to=dl.batch_size)):
            _, metrics = self.task.loss_and_metrics(batch, epoch)
            if tables and i % 5 == 0 and "enrollments_id" in batch:
                ids = batch["enrollments_id"][:n, 0].cpu().numpy()
                for name, emb in self.task.log_embeddings(
                        batch, epoch == 0).items():
                    self.table_logger.add(ids, emb[:n].cpu().numpy(), name)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v) * n
            total += n
        keys = sorted(sums)
        *values, total = distributed.sum_over_ranks(
            [sums[k] for k in keys] + [total])
        if self.table_logger is not None and distributed.is_primary():
            self.table_logger.flush(self.run_dir, epoch, split)
        return {f"{split}/{k}": v / max(total, 1)
                for k, v in zip(keys, values)}

    def fit(self, train_dl: DataLoader, val_dl: DataLoader,
            resume: bool = False, ckpt_path: str | None = None):
        """Train for the remaining epochs; returns the model."""
        start_epoch, step = 0, 0
        if getattr(self.task, "init_ckpt", None):
            load_checkpoint(self.model, self.task.init_ckpt)
        if ckpt_path is None and resume and self.ckpts.has_last():
            ckpt_path = self.ckpts.last_path
        if ckpt_path:
            # a full state resumes exactly; params alone warm-start at
            # epoch 0 with a fresh optimizer
            load_checkpoint(self.model, ckpt_path)
            if npz_ckpt.has_full_state(ckpt_path):
                epoch, step = self.load_full_state(
                    npz_ckpt.load_full_state(ckpt_path))
                start_epoch = epoch + 1
                logging.info("resumed from %s at epoch %d", ckpt_path,
                             start_epoch)
            else:
                logging.info("warm-started params from %s", ckpt_path)

        for epoch in range(start_epoch, self.epochs):
            train_dl.set_epoch(epoch)
            t0 = time.time()
            self.model.train()
            # metrics summed on the device, fetched once an epoch
            sums: dict = {}
            n_batches = 0
            for batch, _ in self._device_batches(train_dl):
                metrics = self.train_step(batch, epoch)
                n_batches += 1
                step += 1
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
            keys = sorted(sums)
            means = distributed.sum_over_ranks(
                [float(sums[k]) / max(n_batches, 1) for k in keys])
            record = {f"train/{k}": v / self.world
                      for k, v in zip(keys, means)}
            self.model.eval()
            record.update(self._run_eval(val_dl, epoch, "val"))
            record.update(epoch=epoch, step=step,
                          lr=self.opt.param_groups[0]["lr"],
                          epoch_time_s=round(time.time() - t0, 2))
            self.logger.log(record)

            if self.scheduler is not None and "val/loss" in record:
                self.set_lr(self.scheduler.step(record["val/loss"]))

            if distributed.is_primary():
                state = self.full_state(epoch, step)
                self.ckpts.save_last(self.model, state, epoch, step)
                mon = record.get(self.task.monitor)
                if mon is not None:
                    self.ckpts.save_best(self.model, state, mon, epoch,
                                         step)
            distributed.barrier()
        return self.model

    def test(self, test_dl: DataLoader, ckpt_path: str | None = None) -> dict:
        if ckpt_path is None:
            ckpt_path = self.ckpts.best_checkpoint() or (
                self.ckpts.last_path if self.ckpts.has_last() else None)
        if ckpt_path:
            load_checkpoint(self.model, ckpt_path)
            logging.info("testing with %s", ckpt_path)
        self.model.eval()
        record = self._run_eval(test_dl, epoch=0, split="test")
        self.logger.log(record)
        return record


def build_task(hparams, seed: int = 42):
    """The config's task, its model's parameters drawn by the modules'
    default initializers from a CPU generator seeded with `seed` (the
    global generator is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return utils.import_attr(hparams.pl_module)(
            **hparams.pl_module_args)


def prerender_dir(args, hparams) -> str | None:
    """The render-ahead cache's directory: `--prerender`, else the
    config's `prerender_dir`, else `LOOKONCE_PRERENDER`, else None."""
    return (getattr(args, "prerender", None)
            or getattr(hparams, "prerender_dir", None)
            or os.environ.get("LOOKONCE_PRERENDER"))


def main(args, hparams) -> None:
    """The JAX package's `train.trainer.main` control flow: the global
    `random` and `np.random` seeded with 42 (the training datasets draw
    from them when rendered in this process), task, `pl_logger` and
    trainer from the config, loaders of the config's datasets (each
    rank's batch the config's over the world size), then `fit` or
    (`--test`) `test`. With a prerender directory each split is
    rendered there once (`data/prep/prerender.py`, by rank 0 with the
    config's workers, the others waiting) and read from it. TF32 is off
    throughout, as in the eval CLI."""
    device = rank_device(getattr(args, "device", None))
    random.seed(42)
    np.random.seed(42)
    task = build_task(hparams)
    table_logger = None
    if getattr(hparams, "pl_logger", None):
        table_logger = utils.import_attr(hparams.pl_logger)()
    trainer = Trainer(task, args.run_dir, epochs=hparams.epochs,
                      grad_clip=getattr(hparams, "grad_clip", None),
                      limit_batches=args.frac, device=device,
                      table_logger=table_logger)
    num_workers = min(getattr(hparams, "num_workers", 4), os.cpu_count())
    cache = prerender_dir(args, hparams)
    loaders = []

    def make_dl(which, batch_size, shuffle):
        ds = utils.import_attr(getattr(hparams, f"{which}_dataset"))(
            **getattr(hparams, f"{which}_data_args"))
        if cache:
            from lookoncetohear_tpu_torch.data.prep.prerender import (
                PrerenderedDataset, render_split)
            out = os.path.join(cache, which)
            if distributed.is_primary():
                t0 = time.time()
                render_split(ds, out, num_workers=num_workers)
                logging.info("prerender %s -> %s (%.1f s)", which, out,
                             time.time() - t0)
            distributed.barrier()
            ds = PrerenderedDataset(out)
        # val/test keep the ragged tail, padded and masked by the eval
        loaders.append(DataLoader(
            ds, max(1, batch_size // trainer.world), shuffle=shuffle,
            seed=42, num_workers=num_workers, drop_last=(which == "train")))
        return loaders[-1]

    try:
        with utils.full_float32():
            if args.test:
                trainer.test(make_dl("test", hparams.eval_batch_size, False),
                             ckpt_path=args.ckpt)
                return
            trainer.fit(make_dl("train", hparams.batch_size, True),
                        make_dl("val", hparams.eval_batch_size, False),
                        resume=args.resume, ckpt_path=args.ckpt)
    finally:
        for dl in loaders:
            dl.close()
        if num_workers > 0:
            stop_workers()
