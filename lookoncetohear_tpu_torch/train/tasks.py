"""Training tasks (counterpart of `lookoncetohear_tpu/train/tasks.py`).

* `TSETask`: loss = mean -SNR(output, target); metrics SNRi / SI-SNRi
  against the first and last mixture channels; monitor val/si_snr_i
  (max); optional direction-of-arrival cross-entropy (`dir_loss`).
* `EmbedTask`: cosine embedding loss (margin) of the d-vector against
  the clean one, plus negatives against the other speakers once the
  epoch reaches `neg_loss_start_epoch`; monitor val/loss (min).

A task owns its model, built on the CPU (the trainer moves it to its
device). `device_batch` assembles a host batch of numpy arrays;
`loss_and_metrics(batch, epoch)` takes that batch as tensors on the
model's device and returns (loss, {name: scalar tensor}).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from lookoncetohear_tpu_torch import utils
from lookoncetohear_tpu_torch.losses import (cosine_embedding_loss, si_snr,
                                             snr)
from lookoncetohear_tpu_torch.metrics.improvement import metric_improvement


def masked_mean(per_sample: torch.Tensor, mask) -> torch.Tensor:
    """Mean of per-sample values [B] over the real rows: eval batches
    come padded to a fixed size with `_mask` 1.0 on real rows and 0.0
    on padding; mask=None (training) is a plain mean."""
    if mask is None:
        return per_sample.mean()
    return (per_sample * mask).sum() / mask.sum().clamp_min(1.0)


class Task:
    monitor: str
    monitor_mode: str
    model: nn.Module
    lr: float
    scheduler: str | None
    scheduler_params: dict
    init_ckpt: str | None

    def device_batch(self, batch, train: bool = False) -> Dict[str, Any]:
        """Host-side batch assembly. `train=True` on training batches
        only: a task may augment those, never val/test batches."""
        raise NotImplementedError

    def loss_and_metrics(self, batch, epoch: int) -> tuple:
        raise NotImplementedError


def _with_ids(out: dict, inputs) -> dict:
    """Speaker ids ride along, as in the JAX package (its val-epoch
    embedding tables read them; no loss does)."""
    if isinstance(inputs, dict) and "enrollments_id" in inputs:
        out["enrollments_id"] = np.asarray(inputs["enrollments_id"],
                                           np.int32)
    return out


def _model(path: str, params: dict) -> nn.Module:
    return utils.import_attr(path)(**params, device="cpu")


class TSETask(Task):
    """Target-speech-extraction task."""

    def __init__(self, model: str, model_params: dict, lr: float,
                 init_ckpt: str | None = None, dir_loss: bool = False,
                 embed_model: str | None = None,
                 embed_model_params: dict | None = None,
                 scheduler: str | None = None,
                 scheduler_params: dict | None = None,
                 embed_aug_std: float = 0.0) -> None:
        self.model = _model(model, model_params)
        self.embed_model = None
        if embed_model is not None:
            self.embed_model = _model(embed_model, embed_model_params or {})
        self.lr = lr
        self.dir_loss = dir_loss
        self.init_ckpt = init_ckpt
        # Conditioning-embedding augmentation (training batches only):
        # Gaussian direction noise on the ground-truth d-vector with its
        # norm restored, so the separator trains on the angle error a
        # predicted d-vector has at eval; E[cos] ~ 1/sqrt(1 + std^2).
        self.embed_aug_std = float(embed_aug_std)
        self._aug_rng = np.random.default_rng(0xE3B)
        self.scheduler = scheduler
        self.scheduler_params = scheduler_params or {}
        self.monitor = "val/si_snr_i"
        self.monitor_mode = "max"

    def device_batch(self, batch, train: bool = False):
        inputs, targets = batch
        out = {
            "mixture": inputs["mixture"],
            "target": targets["target"],
            "embedding_gt": targets["embedding_gt"],
        }
        if train and self.embed_aug_std > 0.0:
            e = np.asarray(out["embedding_gt"], np.float32)
            n = self._aug_rng.standard_normal(e.shape).astype(np.float32)
            norm = np.linalg.norm(e, axis=-1, keepdims=True)
            rms = norm / np.sqrt(e.shape[-1])
            e2 = e + self.embed_aug_std * rms * n
            n2 = np.linalg.norm(e2, axis=-1, keepdims=True)
            out["embedding_gt"] = e2 * (norm / np.maximum(n2, 1e-12))
        if self.dir_loss:
            out["tgt_shift"] = inputs["tgt_shift"]
        return _with_ids(out, inputs)

    def loss_and_metrics(self, batch, epoch: int):
        target = batch["target"]
        mask = batch.get("_mask")
        metrics = {}
        if self.dir_loss:
            out, dir_logits = self.model(batch["mixture"],
                                         batch["embedding_gt"], dir=True)
            gt_idx = self.model._shifts_to_indices(batch["tgt_shift"])
            logits = dir_logits.mean(dim=1)                 # [B, n_bins]
            d_loss = masked_mean(nn.functional.cross_entropy(
                logits, gt_idx, reduction="none"), mask)
            # bins are linear in the ITD shift, so the azimuth is the
            # arcsin of the normalized shift; dir_error_bins is the raw
            # bin distance
            pred_idx = logits.argmax(dim=-1)
            half = (logits.shape[-1] - 1) / 2.0

            def bin_to_deg(idx):
                u = ((idx - half) / half).clamp(-1.0, 1.0)
                return torch.arcsin(u) * (180.0 / math.pi)

            metrics["dir_loss"] = d_loss
            metrics["dir_error_bins"] = masked_mean(
                (pred_idx - gt_idx).abs().float(), mask)
            metrics["dir_error"] = masked_mean(
                (bin_to_deg(pred_idx) - bin_to_deg(gt_idx)).abs(), mask)
        else:
            out = self.model(batch["mixture"], batch["embedding_gt"])
            d_loss = 0.0
        # snr -> [B, C]; mean over channels -> [B]; masked mean
        loss = -masked_mean(snr(out, target).mean(dim=-1), mask) + d_loss
        mix = batch["mixture"][:, [0, -1]]
        metrics.update({
            "loss": loss,
            "snr_i": masked_mean(
                metric_improvement(snr, mix, out, target), mask),
            "si_snr_i": masked_mean(
                metric_improvement(si_snr, mix, out, target), mask),
        })
        return loss, metrics


class EmbedTask(Task):
    """Binaural-enrollment embedding task."""

    def __init__(self, model: str, model_params: dict, lr: float,
                 scheduler: str | None = None,
                 scheduler_params: dict | None = None,
                 margin: float = 0.5, neg_loss_start_epoch: int = 10,
                 init_ckpt: str | None = None) -> None:
        self.model = _model(model, model_params)
        self.lr = lr
        self.margin = margin
        self.neg_loss_start_epoch = neg_loss_start_epoch
        self.init_ckpt = init_ckpt
        self.scheduler = scheduler
        self.scheduler_params = scheduler_params or {}
        self.monitor = "val/loss"
        self.monitor_mode = "min"

    def device_batch(self, batch, train: bool = False):
        inputs, targets = batch
        neg = targets.get("embedding_neg", [])
        if isinstance(neg, (list, tuple)):
            # batch-major [B, K, 1, E]
            neg = np.stack([np.asarray(x) for x in neg], axis=1) if neg \
                else np.zeros(
                    np.asarray(targets["embedding_gt"]).shape[:1] + (0,),
                    np.float32)
        return _with_ids({
            "enrollments": inputs["enrollments"],
            "embedding_gt": targets["embedding_gt"],
            "embedding_neg": neg,
        }, inputs)

    def loss_and_metrics(self, batch, epoch: int):
        emb = self.model(batch["enrollments"][:, 0])
        emb_gt = batch["embedding_gt"][:, 0]
        mask = batch.get("_mask")
        ones = torch.ones(emb.shape[0], device=emb.device)
        pos = masked_mean(cosine_embedding_loss(
            emb, emb_gt, ones, self.margin, reduction="none"), mask)
        loss = pos
        negs = batch["embedding_neg"]
        if negs.shape[1] and epoch >= self.neg_loss_start_epoch:
            for k in range(negs.shape[1]):
                loss = loss + masked_mean(cosine_embedding_loss(
                    emb, negs[:, k, 0], -ones, self.margin,
                    reduction="none"), mask)
        return loss, {"loss": loss, "pos_loss": pos}
