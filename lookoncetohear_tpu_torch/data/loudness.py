"""ITU-R BS.1770-4 integrated loudness (LUFS), host-side numpy
(counterpart of `lookoncetohear_tpu/data/loudness.py`).

A scene spec's `snr` means: the event's integrated loudness lands at
`ref_db + snr` (scaper's convention). The meter: K-weighting (shelving
+ high-pass biquads) -> mean square over 400 ms blocks with 75%
overlap -> absolute -70 LUFS gate -> relative -10 LU gate, as
pyloudnorm (scaper's meter) computes it.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def _k_weighting_coeffs(sr: float):
    """BS.1770 stage-1 shelving + stage-2 high-pass biquad coefficients
    for arbitrary sample rate (bilinear-transform design, as in
    pyloudnorm's IIRfilter)."""
    # Stage 1: +4 dB high-shelf, f0=1681.97 Hz, Q=0.7072, G=3.99984 dB
    db, f0, q = 3.999843853973347, 1681.974450955533, 0.7071752369554196
    k = np.tan(np.pi * f0 / sr)
    vh = 10.0 ** (db / 20.0)
    vb = vh ** 0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_shelf = np.array([(vh + vb * k / q + k * k) / a0,
                        2.0 * (k * k - vh) / a0,
                        (vh - vb * k / q + k * k) / a0])
    a_shelf = np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                        (1.0 - k / q + k * k) / a0])
    # Stage 2: high-pass, f0=38.14 Hz, Q=0.5003
    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    b_hp = np.array([1.0, -2.0, 1.0]) / a0
    a_hp = np.array([1.0, 2.0 * (k * k - 1.0) / a0,
                     (1.0 - k / q + k * k) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


# Per-channel weights: L, R, C, Ls, Rs (BS.1770 table 3).
_CHANNEL_G = np.array([1.0, 1.0, 1.0, 1.41, 1.41])


def integrated_loudness(audio: np.ndarray, sr: int) -> float:
    """Integrated loudness in LUFS. audio: [N] or [C, N] float."""
    x = np.atleast_2d(np.asarray(audio, dtype=np.float64))
    (bs, as_), (bh, ah) = _k_weighting_coeffs(sr)
    y = lfilter(bh, ah, lfilter(bs, as_, x, axis=-1), axis=-1)

    t_g = 0.4  # 400 ms gating block
    step = int(round(t_g * sr * 0.25))  # 75% overlap
    block = int(round(t_g * sr))
    n = y.shape[-1]
    if n < block:
        z = np.mean(y ** 2, axis=-1)
        g = _CHANNEL_G[: y.shape[0]]
        return float(-0.691 + 10 * np.log10(np.sum(g * z) + 1e-30))

    n_blocks = (n - block) // step + 1
    idx = np.arange(block)[None, :] + step * np.arange(n_blocks)[:, None]
    z = np.mean(y[:, idx] ** 2, axis=-1)  # [C, n_blocks]
    g = _CHANNEL_G[: y.shape[0]][:, None]
    lk = -0.691 + 10 * np.log10(np.sum(g * z, axis=0) + 1e-30)  # [n_blocks]

    gated = lk > -70.0
    if not gated.any():
        return -np.inf
    z_avg = np.sum(g * z[:, gated], axis=0).mean()
    rel_thresh = -0.691 + 10 * np.log10(z_avg + 1e-30) - 10.0
    gated = gated & (lk > rel_thresh)
    if not gated.any():
        return -np.inf
    z_avg = np.sum(g[:, 0][:, None] * z[:, gated], axis=0).mean()
    return float(-0.691 + 10 * np.log10(z_avg + 1e-30))


def gain_to_target(audio: np.ndarray, sr: int, target_lufs: float) -> float:
    """Scalar gain that moves `audio` to `target_lufs` (scaper's
    get_integrated_lufs + dB gain logic)."""
    lufs = integrated_loudness(audio, sr)
    if not np.isfinite(lufs):
        return 1.0
    return float(10.0 ** ((target_lufs - lufs) / 20.0))
