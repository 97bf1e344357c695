"""Multi-resolution spectral losses on tensors (counterpart of
`lookoncetohear_tpu/losses/spectral.py`), auraloss's as the reference
configures them:

* `MultiResolutionMelSpecLoss`: MultiResolutionSTFTLoss (fft 1024 /
  2048 / 8192, hops 256 / 512 / 2048, mel scale with 128 bins at 16 kHz,
  A-weighting prefilter); per resolution spectral convergence plus
  log-magnitude L1, averaged.
* `L1_Mel`: SumAndDifferenceSTFTLoss (fft 64 / 128 / 256 / 1024, hops
  128 / 256 / 512 / 2048) on (L + R, L - R) of stereo pairs, plus
  waveform L1.

The STFT is the port's centered STFT (`ops/stft.py::stft_center`,
`torch.fft`); the mel filterbank and the A-weighting are built in numpy
once per shape.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lookoncetohear_tpu_torch.ops import stft as stft_ops

_EPS = 1e-8


# ---------------------------------------------------------------------------
# Mel filterbank (librosa-compatible: slaney scale + slaney norm, the
# auraloss default)
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    mel)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f)


@functools.lru_cache(maxsize=None)
def _mel_filterbank_np(sr: int, n_fft: int, n_mels: int, fmin: float,
                       fmax: float | None) -> np.ndarray:
    if fmax is None:
        fmax = sr / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                     n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)              # [n_mels, n_freqs]


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, device=None) -> torch.Tensor:
    """librosa.filters.mel (slaney, norm='slaney'): [n_mels, n_freqs]."""
    return torch.from_numpy(_mel_filterbank_np(sr, n_fft, n_mels, fmin,
                                               fmax)).to(device)


@functools.lru_cache(maxsize=None)
def _a_weighting_np(sr: int, n_fft: int) -> np.ndarray:
    f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    f = np.maximum(f, 1e-6)
    f2 = f ** 2
    ra = (12194.0 ** 2 * f2 ** 2) / (
        (f2 + 20.6 ** 2)
        * np.sqrt((f2 + 107.7 ** 2) * (f2 + 737.9 ** 2))
        * (f2 + 12194.0 ** 2))
    a_db = 20.0 * np.log10(ra) + 2.0
    return (10.0 ** (a_db / 20.0)).astype(np.float32)


def a_weighting(sr: int, n_fft: int, device=None) -> torch.Tensor:
    """auraloss's perceptual (A-weighting) prefilter as a magnitude
    weighting of the STFT's bins: [n_fft // 2 + 1]."""
    return torch.from_numpy(_a_weighting_np(sr, n_fft)).to(device)


def stft_loss(est: torch.Tensor, gt: torch.Tensor, n_fft: int, hop: int,
              mel_bins: int | None = None, sr: int = 16000,
              perceptual_weighting: bool = False) -> torch.Tensor:
    """One resolution: spectral convergence + log-magnitude L1
    (auraloss STFTLoss, w_sc = w_log_mag = 1)."""
    m_est = stft_ops.stft_center(est, n_fft, hop).abs()   # [..., T, F]
    m_gt = stft_ops.stft_center(gt, n_fft, hop).abs()
    if perceptual_weighting:
        w = a_weighting(sr, n_fft, est.device).to(m_est.dtype)
        m_est, m_gt = m_est * w, m_gt * w
    if mel_bins is not None:
        fb = mel_filterbank(sr, n_fft, mel_bins, device=est.device).to(
            m_est.dtype)
        m_est = torch.einsum("...tf,mf->...tm", m_est, fb)
        m_gt = torch.einsum("...tf,mf->...tm", m_gt, fb)
    sc = torch.linalg.vector_norm(m_gt - m_est) / (
        torch.linalg.vector_norm(m_gt) + _EPS)
    log_mag = (torch.log(m_gt + _EPS) - torch.log(m_est + _EPS)).abs().mean()
    return sc + log_mag


def multi_resolution_stft_loss(
        est: torch.Tensor, gt: torch.Tensor,
        fft_sizes=(1024, 2048, 8192), hop_sizes=(256, 512, 2048),
        mel_bins: int | None = None, sr: int = 16000,
        perceptual_weighting: bool = False) -> torch.Tensor:
    return torch.stack([
        stft_loss(est, gt, n, h, mel_bins=mel_bins, sr=sr,
                  perceptual_weighting=perceptual_weighting)
        for n, h in zip(fft_sizes, hop_sizes)]).mean()


class MultiResolutionMelSpecLoss:
    """auraloss MultiResolutionSTFTLoss (mel, 128 bins, A-weighted).
    est, gt: [B*C, T]."""

    def __call__(self, est, gt):
        return multi_resolution_stft_loss(
            est, gt, fft_sizes=(1024, 2048, 8192),
            hop_sizes=(256, 512, 2048), mel_bins=128, sr=16000,
            perceptual_weighting=True)


class L1_Mel:
    """auraloss SumAndDifferenceSTFTLoss + waveform L1. est, gt: [B*C, T]
    with C even (stereo pairs interleaved, as the (B, C, T) rows come)."""

    def __call__(self, est, gt):
        t = est.shape[-1]
        e = est.reshape(-1, 2, t)
        g = gt.reshape(-1, 2, t)
        kw = dict(fft_sizes=(64, 128, 256, 1024),
                  hop_sizes=(128, 256, 512, 2048), sr=16000)
        l1 = 0.5 * (multi_resolution_stft_loss(e[:, 0] + e[:, 1],
                                               g[:, 0] + g[:, 1], **kw)
                    + multi_resolution_stft_loss(e[:, 0] - e[:, 1],
                                                 g[:, 0] - g[:, 1], **kw))
        return l1 + (est - gt).abs().mean()
