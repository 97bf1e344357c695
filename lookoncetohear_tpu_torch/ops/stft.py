"""Filterbank STFT of the streaming separator (counterpart of the
filterbank half of `lookoncetohear_tpu/ops/stft.py`).

Analysis = framing (no centering) + a windowed real-DFT matrix;
synthesis = the transposed filterbank + overlap-add. Both are matmuls
over frames. The filterbank formula is copied from the JAX module
(asteroid_filterbanks STFTFB semantics), so both packages build the
same float32 matrix.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _stft_filterbank_np(n_fft: int, kernel_size: int, stride: int):
    """The (2*(n_fft//2+1), kernel_size) analysis filterbank: DFT-of-
    identity rows scaled by 1 / (0.5 * sqrt(kernel_size * n_fft /
    stride)), DC and Nyquist rows divided by sqrt(2), all rows times
    the sqrt-Hann window `np.hanning(kernel_size + 1)[:-1] ** 0.5`."""
    cutoff = n_fft // 2 + 1
    window = np.hanning(kernel_size + 1)[:-1] ** 0.5
    dft = np.fft.fft(np.eye(n_fft))
    dft = dft / (0.5 * np.sqrt(kernel_size * n_fft / stride))
    lpad = (n_fft - kernel_size) // 2
    dft = dft[:, lpad:lpad + kernel_size]
    filters = np.vstack([np.real(dft[:cutoff]), np.imag(dft[:cutoff])])
    filters[0, :] /= np.sqrt(2)
    filters[n_fft // 2, :] /= np.sqrt(2)
    filters = filters * window
    return filters.astype(np.float32)


def stft_filterbank(n_fft: int, kernel_size: int, stride: int,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """Analysis/synthesis filterbank [2*(n_fft//2+1), kernel]."""
    return torch.tensor(_stft_filterbank_np(n_fft, kernel_size, stride),
                        device=device, dtype=dtype)


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., N] -> [..., T, frame_len], T = (N - frame_len)//hop + 1."""
    return x.unfold(-1, frame_len, hop)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Sum overlapping frames: [..., T, L] -> [..., (T-1)*hop + L]."""
    *batch, t, frame_len = frames.shape
    out_len = (t - 1) * hop + frame_len
    n_chunks = -(-frame_len // hop)
    pad_frame = n_chunks * hop - frame_len
    if pad_frame:
        frames = torch.nn.functional.pad(frames, (0, pad_frame))
    frames = frames.reshape(*batch, t, n_chunks, hop)
    out = frames.new_zeros((*batch, out_len + n_chunks * hop))
    for c in range(n_chunks):
        # stream c holds samples [t*hop + c*hop, t*hop + (c+1)*hop)
        stream = frames[..., :, c, :].reshape(*batch, t * hop)
        out[..., c * hop:c * hop + t * hop] += stream
    return out[..., :out_len]


def fb_encode(x: torch.Tensor, n_fft: int, stride: int,
              fb: torch.Tensor | None = None) -> torch.Tensor:
    """[..., N] audio -> [..., 2*(n_fft//2+1), T] stacked (real, imag).
    `fb` may pass a prebuilt filterbank (any dtype; cast to x's)."""
    if fb is None:
        fb = stft_filterbank(n_fft, n_fft, stride, x.device)
    frames = frame_signal(x, n_fft, stride)               # [..., T, K]
    return torch.einsum("...tk,fk->...ft", frames, fb.to(x.dtype))


def fb_decode(spec: torch.Tensor, n_fft: int, stride: int,
              fb: torch.Tensor | None = None) -> torch.Tensor:
    """[..., 2F, T] -> [..., (T-1)*stride + n_fft] audio."""
    if fb is None:
        fb = stft_filterbank(n_fft, n_fft, stride, spec.device)
    frames = torch.einsum("...ft,fk->...tk", spec, fb.to(spec.dtype))
    return overlap_add(frames, stride)


def fb_decode_frame(spec_frame: torch.Tensor, n_fft: int,
                    stride: int) -> torch.Tensor:
    """Single-frame synthesis: [..., 2F] -> [..., n_fft] (no OLA)."""
    fb = stft_filterbank(n_fft, n_fft, stride, spec_frame.device,
                         spec_frame.dtype)
    return torch.einsum("...f,fk->...k", spec_frame, fb)


# ---------------------------------------------------------------------------
# Centered STFT (torch.stft / espnet STFTEncoder semantics)
# ---------------------------------------------------------------------------


def hann_window(win_length: int, device=None) -> torch.Tensor:
    """Periodic Hann in float32, computed in float64 and rounded as the
    JAX package does (torch.hann_window's values to one rounding)."""
    n = torch.arange(win_length, dtype=torch.float64, device=device)
    return (0.5 * (1.0 - torch.cos(2.0 * np.pi * n / win_length))).float()


def stft_center(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered STFT: reflect pad by n_fft//2, periodic Hann, one-sided
    rfft. x: [..., N] -> complex [..., T, F], T = N//hop + 1, F =
    n_fft//2 + 1 (frames-major, like espnet's encoder output)."""
    pad = n_fft // 2
    lead = x.shape[:-1]
    x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad),
                                mode="reflect").reshape(*lead, -1)
    frames = frame_signal(x, n_fft, hop) * hann_window(n_fft, x.device)
    return torch.fft.rfft(frames, dim=-1)


def istft_center(spec: torch.Tensor, n_fft: int, hop: int,
                 length: int | None = None) -> torch.Tensor:
    """Inverse of `stft_center`: windowed irfft, overlap-add, division by
    the window envelope (floored at 1e-11), center trim, and a cut to
    `length` samples when given. spec: complex [..., T, F]."""
    w = hann_window(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * w
    out = overlap_add(frames, hop)
    env = overlap_add((w * w).expand(spec.shape[-2], n_fft), hop)
    out = out / torch.clamp(env, min=1e-11)
    out = out[..., n_fft // 2:]
    return out if length is None else out[..., :length]
