"""Colored noise (counterpart of `lookoncetohear_tpu/data/augmentations.py`;
only the generator the synthetic scenes use is copied).

The 1/f^beta synthesis follows Timmer & Koenig (1995): draw independent
complex-Gaussian spectral amplitudes with std ∝ f^(-beta/2),
inverse-rFFT, normalize to unit variance. All randomness flows through
an explicit numpy Generator, so the val/test splits are deterministic
and equal to the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np


def powerlaw_psd_gaussian(exponent: float, size, fmin: float = 0.0,
                          rng: np.random.Generator | None = None) -> np.ndarray:
    """Unit-variance Gaussian noise with S(f) ∝ (1/f)^exponent along
    the last axis."""
    if rng is None:
        rng = np.random.default_rng()
    if np.isscalar(size):
        size = (int(size),)
    size = tuple(int(s) for s in size)
    n = size[-1]

    f = np.fft.rfftfreq(n)
    # Low-frequency cutoff: flatten the spectrum below fmin (>= 1/n).
    fmin = max(fmin, 1.0 / n)
    s_scale = f.copy()
    cutoff_idx = np.sum(s_scale < fmin)
    if cutoff_idx and cutoff_idx < len(s_scale):
        s_scale[:cutoff_idx] = s_scale[cutoff_idx]
    s_scale = s_scale ** (-exponent / 2.0)
    s_scale[0] = 0.0 if exponent > 0 else s_scale[0]

    # Expected output std for normalization (DC excluded; Nyquist bin
    # of an even-length rFFT is real, hence half weight).
    w = s_scale[1:].copy()
    if n % 2 == 0:
        w[-1] = w[-1] * np.sqrt(0.5)
    sigma = 2.0 * np.sqrt(np.sum(w ** 2)) / n

    shape = size[:-1] + (len(f),)
    sr = rng.normal(size=shape) * s_scale
    si = rng.normal(size=shape) * s_scale
    si[..., 0] = 0.0
    if n % 2 == 0:
        si[..., -1] = 0.0
        sr[..., -1] = sr[..., -1] * np.sqrt(2.0)
    out = np.fft.irfft(sr + 1j * si, n=n, axis=-1) / sigma
    return out
