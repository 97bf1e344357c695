"""Improvement metrics (SNRi / SI-SNRi) on tensors (counterpart of
`lookoncetohear_tpu/metrics/improvement.py`): per sample, the mean over
channels of metric(pred, target) - metric(mixture, target)."""

from __future__ import annotations

import torch


def metric_improvement(metric, mixture: torch.Tensor, pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """mixture/pred/target: [B, C, T] -> per-sample improvement [B]."""
    return (metric(pred, target) - metric(mixture, target)).mean(-1)
