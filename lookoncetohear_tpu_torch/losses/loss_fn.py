"""The name-dispatched loss registry on tensors (counterpart of
`lookoncetohear_tpu/losses/loss_fn.py`): the same names and reshape,
(B, C, T) inputs flattened to (B*C, T) rows before the row-wise loss,
then mean-reduced.
"""

from __future__ import annotations

from typing import Any

import torch

from lookoncetohear_tpu_torch.losses.sdr import neg_sdr, pairwise_neg_sisdr
from lookoncetohear_tpu_torch.losses.spectral import (
    L1_Mel, MultiResolutionMelSpecLoss)


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _snr_sdsdr(est, gt):
    """Elementwise max(SD-SDR, SNR) loss."""
    return torch.maximum(neg_sdr(est, gt, "sdsdr"),
                         neg_sdr(est, gt, "snr")).mean()


def _fused(est, gt):
    """SI-SDR + SNR."""
    return (neg_sdr(est, gt, "sisdr") + neg_sdr(est, gt, "snr")).mean()


def _sisdr_with_sum(est, gt, noise_estimate, mixture):
    """SI-SDR + L1 mixture consistency. est / gt come row-flattened;
    noise_estimate / mixture as (B, C, T)."""
    return (neg_sdr(est, gt, "sisdr").mean()
            + (_rows(noise_estimate) + est - _rows(mixture)).abs().mean())


def _pit_sisdr(est, gt, est1, est2, gt1, gt2, reduce=True):
    """2-source PIT SI-SDR: (loss, est1, est2) with the estimates
    reordered to the targets' order. est1 / est2 / gt1 / gt2: (B, C, T).
    reduce=False gives the loss per sample [B] (mean over channels)
    instead of the scalar mean."""
    b, c, t = est1.shape
    e = torch.stack([est1, est2], dim=2).reshape(b * c, 2, t)
    g = torch.stack([gt1, gt2], dim=2).reshape(b * c, 2, t)
    pw = pairwise_neg_sisdr(e, g)                  # [B*C, 2 est, 2 tgt]
    # two permutations: identity (0->0, 1->1) and swap
    loss_id = pw[:, 0, 0] + pw[:, 1, 1]
    loss_sw = pw[:, 1, 0] + pw[:, 0, 1]
    swap = (loss_sw < loss_id)[:, None, None]
    reordered = torch.where(swap, e.flip(1), e).reshape(b, c, 2, t)
    per_sample = torch.minimum(loss_id, loss_sw).reshape(b, c).mean(
        dim=1) / 2.0
    loss = per_sample.mean() if reduce else per_sample
    return loss, reordered[:, :, 0], reordered[:, :, 1]


class LossFn:
    """Callable loss with the (est, gt, **kwargs) contract; est / gt:
    (B, C, T)."""

    def __init__(self, name: str = "snr", **kwargs: Any) -> None:
        self.name = name
        if name in ("sisdr", "snr", "sdsdr"):
            self._fn = lambda e, g: neg_sdr(e, g, name).mean()
        elif name == "snr_sdsdr":
            self._fn = _snr_sdsdr
        elif name == "sisdr_with_sum":
            self._fn = _sisdr_with_sum
        elif name == "fused":
            self._fn = _fused
        elif name == "pit_sisdr":
            self._fn = _pit_sisdr
        elif name == "mel":
            self._fn = MultiResolutionMelSpecLoss()
        elif name == "l1_mel":
            self._fn = L1_Mel()
        elif name == "cdpam":
            # the pretrained weights load from `weights=` or
            # $LOOKONCE_CDPAM_WEIGHTS (losses/cdpam.py). A random
            # network's distance means nothing perceptually, so as a
            # training loss it needs allow_random=True
            from lookoncetohear_tpu_torch.losses.cdpam import CDPAM
            allow_random = bool(kwargs.pop("allow_random", False))
            fn = CDPAM(**kwargs)
            if not fn.pretrained and not allow_random:
                raise ValueError(
                    "LossFn('cdpam') without pretrained weights: set "
                    "$LOOKONCE_CDPAM_WEIGHTS (or pass weights=...), or "
                    "opt in explicitly with allow_random=True to "
                    "optimize a random-net distance")
            self._fn = fn
        else:
            raise AssertionError(
                f"Invalid loss function used: Loss {name} not found")

    def __call__(self, est, gt, **kwargs):
        if est is not None:
            est = _rows(est)
        if gt is not None:
            gt = _rows(gt)
        return self._fn(est, gt, **kwargs)
