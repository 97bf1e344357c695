"""Binaural spatial-cue metrics: ΔILD and ΔITD (counterpart of
`lookoncetohear_tpu/metrics/binaural.py`, with `numpy.fft` in place of
`scipy.fft`).

Host-side numpy (eval only): ILD as the L/R energy ratio in dB; ITD via
cross-correlation argmax within ±1 ms; `moving=True` evaluates per
250 ms frame with RMS-gated chunks.
"""

from __future__ import annotations

import numpy as np
from numpy.fft import irfft, rfft


def chunk_and_mask(est: np.ndarray, gt: np.ndarray, sr: int,
                   moving_frame_width_ms: float = 250,
                   rms_threshold: float = 1e-3):
    """Split (*, 2, T) into C frames of width FW, zero-padding the tail;
    mask = frames whose louder ear's RMS clears the threshold.

    Returns (est [C, *, 2, FW], gt [C, *, 2, FW], mask [C, *]).
    """
    fw = int(round(1e-3 * moving_frame_width_ms * sr))
    c = 1 + (gt.shape[-1] - 1) // fw
    if gt.shape[-1] % fw != 0:
        pad = fw - (gt.shape[-1] % fw)
        widths = [(0, 0)] * (gt.ndim - 1) + [(0, pad)]
        gt = np.pad(gt, widths)
        est = np.pad(est, widths)
    gt = np.stack(np.split(gt, c, axis=-1))  # (C, *, 2, FW)
    est = np.stack(np.split(est, c, axis=-1))
    chunk_rms = np.sqrt(np.mean(gt ** 2, axis=-1)).max(axis=-1)
    return est, gt, chunk_rms >= rms_threshold


def compute_ild(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Interaural level difference in dB over the last (time) axis."""
    return 10.0 * np.log10(np.sum(left ** 2, axis=-1)
                           / np.sum(right ** 2, axis=-1))


def ild_diff(est: np.ndarray, gt: np.ndarray, sr: int | None = None,
             moving: bool = False) -> np.ndarray:
    """|ILD(est) − ILD(gt)| (dB). est/gt: (*, 2, T)."""
    if moving:
        assert sr is not None, "moving=True needs sr for chunking"
        est, gt, mask = chunk_and_mask(est, gt, sr)
    ild_est = compute_ild(est[..., 0, :], est[..., 1, :])
    ild_gt = compute_ild(gt[..., 0, :], gt[..., 1, :])
    if moving:
        # (C, *) -> per-batch mean over voiced chunks
        n = mask.shape[-1] if mask.ndim > 1 else 1
        out_e, out_g = [], []
        for i in range(n):
            out_e.append(np.mean(ild_est[mask[..., i], i]))
            out_g.append(np.mean(ild_gt[mask[..., i], i]))
        ild_est, ild_gt = np.array(out_e), np.array(out_g)
    return np.abs(ild_est - ild_gt)


def axiswise_xcorr(a: np.ndarray, b: np.ndarray, axis: int = -1,
                   phat: bool = False) -> np.ndarray:
    """Circular cross-correlation via rFFT, optional PHAT weighting."""
    fa = rfft(a, axis=axis)
    fb = rfft(b, axis=axis)
    r = fa * np.conjugate(fb)
    if phat:
        r = r / np.abs(r)
    return irfft(r, axis=axis)


def compute_itd(left: np.ndarray, right: np.ndarray, sr: int,
                t_max: int | None = None) -> np.ndarray:
    """ITD in microseconds: argmax |xcorr| within ±t_max samples."""
    corr = axiswise_xcorr(left, right, axis=-1)
    mid = corr.shape[-1] // 2
    if t_max is None or t_max > mid:
        t_max = mid
    cc = np.concatenate([corr[..., -t_max:], corr[..., :t_max + 1]],
                        axis=-1)
    tau = np.argmax(np.abs(cc), axis=-1) - t_max
    return tau / sr * 1e6


def itd_diff(est: np.ndarray, gt: np.ndarray, sr: int,
             moving: bool = False) -> np.ndarray:
    """|ITD(est) − ITD(gt)| (µs), searched within ±1 ms."""
    t_max = int(round(1e-3 * sr))
    if moving:
        est, gt, mask = chunk_and_mask(est, gt, sr)
    itd_est = compute_itd(est[..., 0, :], est[..., 1, :], sr, t_max)
    itd_gt = compute_itd(gt[..., 0, :], gt[..., 1, :], sr, t_max)
    if moving:
        n = mask.shape[-1] if mask.ndim > 1 else 1
        out = np.zeros(n)
        for i in range(n):
            out[i] = np.mean(np.abs(itd_est[mask[..., i], i]
                                    - itd_gt[mask[..., i], i]))
        return out
    return np.abs(itd_est - itd_gt)
