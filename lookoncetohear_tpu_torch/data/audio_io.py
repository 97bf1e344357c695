"""Audio file IO and resampling, host-side numpy (counterpart of
`lookoncetohear_tpu/data/audio_io.py`):

* wav through scipy.io.wavfile (every common encoding -> float32 in
  [-1, 1]);
* flac / ogg through `soundfile` where it is installed (LibriSpeech is
  flac; without libsndfile, convert the corpus to wav first);
* resampling by polyphase filtering (scipy.signal.resample_poly), the
  windowed-sinc family torchaudio.functional.resample uses.
"""

from __future__ import annotations

import math
import os

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

_PCM_SCALE = {np.dtype(np.int16): 1 << 15, np.dtype(np.int32): 1 << 31,
              np.dtype(np.uint8): 1 << 7}


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read an audio file -> (audio [C, N] float32, sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        sr, data = wavfile.read(path)
        if data.dtype in _PCM_SCALE:
            scale = _PCM_SCALE[data.dtype]
            if data.dtype == np.uint8:
                data = data.astype(np.int16) - 128
            data = data.astype(np.float32) / scale
        else:
            data = data.astype(np.float32)
        if data.ndim == 1:
            data = data[None, :]
        else:
            data = data.T
        return np.ascontiguousarray(data), int(sr)
    try:  # optional: flac / ogg
        import soundfile
    except ImportError:
        raise ImportError(
            f"reading {ext} requires the optional `soundfile` package "
            "(libsndfile); pre-convert to wav or install it") from None
    data, sr = soundfile.read(path, dtype="float32", always_2d=True)
    return np.ascontiguousarray(data.T), int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write float32 audio [C, N] (or [N]) as 32-bit float wav."""
    if audio.ndim == 2:
        audio = audio.T
    wavfile.write(path, sr, audio.astype(np.float32))


def resample(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if orig_sr == new_sr:
        return audio
    g = math.gcd(int(orig_sr), int(new_sr))
    return resample_poly(audio, new_sr // g, orig_sr // g, axis=-1).astype(
        audio.dtype, copy=False)
