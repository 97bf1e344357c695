"""SNR / SI-SDR family on tensors (counterpart of
`lookoncetohear_tpu/losses/sdr.py`, same eps placement).

Two numeric conventions coexist and both are kept:

* torchmetrics convention (the training tasks' loss and the SNRi /
  SI-SNRi metrics): `snr` does NOT zero-mean; `si_snr` zero-means.
* asteroid `SingleSrcNegSDR` convention (the pluggable loss zoo):
  zero-means both signals for every sdr_type, eps=1e-8 inside the ratio
  and the log.

All functions reduce over the last axis (time); leading axes are batch.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _zero_mean(x: torch.Tensor) -> torch.Tensor:
    return x - x.mean(-1, keepdim=True)


def snr(pred: torch.Tensor, target: torch.Tensor,
        zero_mean: bool = False) -> torch.Tensor:
    """Signal-to-noise ratio in dB (torchmetrics signal_noise_ratio).

    snr = 10 log10( ||t||^2 / ||t - p||^2 ). Shapes [..., T] -> [...].
    """
    if zero_mean:
        pred, target = _zero_mean(pred), _zero_mean(target)
    num = (target ** 2).sum(-1)
    den = ((target - pred) ** 2).sum(-1)
    return 10.0 * torch.log10(num / (den + _EPS) + _EPS)


def si_sdr(pred: torch.Tensor, target: torch.Tensor,
           zero_mean: bool = True) -> torch.Tensor:
    """Scale-invariant SDR in dB (torchmetrics SI-SDR/SI-SNR; the two
    are identical functions there). Shapes [..., T] -> [...]."""
    if zero_mean:
        pred, target = _zero_mean(pred), _zero_mean(target)
    alpha = ((pred * target).sum(-1, keepdim=True) + _EPS) / (
        (target ** 2).sum(-1, keepdim=True) + _EPS)
    s_target = alpha * target
    noise = pred - s_target
    return 10.0 * torch.log10(((s_target ** 2).sum(-1) + _EPS)
                              / ((noise ** 2).sum(-1) + _EPS))


# torchmetrics' scale_invariant_signal_noise_ratio == SI-SDR(zero_mean).
si_snr = si_sdr


def snr_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The TSE training loss: mean negative (non-scale-invariant) SNR."""
    return -snr(pred, target).mean()


def neg_sdr(est: torch.Tensor, target: torch.Tensor, sdr_type: str = "snr",
            zero_mean: bool = True) -> torch.Tensor:
    """asteroid SingleSrcNegSDR: negative SDR per row, [..., T] -> [...].

    sdr_type: 'snr' | 'sisdr' | 'sdsdr'.
    """
    if zero_mean:
        est, target = _zero_mean(est), _zero_mean(target)
    if sdr_type in ("sisdr", "sdsdr"):
        dot = (est * target).sum(-1, keepdim=True)
        s_energy = (target ** 2).sum(-1, keepdim=True) + _EPS
        scaled_target = dot * target / s_energy
    else:
        scaled_target = target
    if sdr_type in ("sdsdr", "snr"):
        e_noise = est - target
    else:
        e_noise = est - scaled_target
    ratio = (scaled_target ** 2).sum(-1) / ((e_noise ** 2).sum(-1) + _EPS)
    return -10.0 * torch.log10(ratio + _EPS)


def pairwise_neg_sisdr(est: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """asteroid PairwiseNegSDR('sisdr'): est/target [B, S, T] ->
    pairwise loss matrix [B, S_est, S_tgt]."""
    e = _zero_mean(est)[:, :, None, :]             # [B, S_est, 1, T]
    t = _zero_mean(target)[:, None, :, :]          # [B, 1, S_tgt, T]
    dot = (e * t).sum(-1, keepdim=True)
    s_energy = (t ** 2).sum(-1, keepdim=True) + _EPS
    s_target = dot * t / s_energy
    e_noise = e - s_target
    ratio = (s_target ** 2).sum(-1) / ((e_noise ** 2).sum(-1) + _EPS)
    return -10.0 * torch.log10(ratio + _EPS)
