"""Self-contained synthetic TSE scenes — no external corpora
(counterpart of `lookoncetohear_tpu/data/synthetic.py`, copied: the
same numpy code and seeds, so every field of every scene equals the
JAX package's bit for bit).

Generates deterministic binaural target-speech-extraction scenes with
the exact (inputs, targets) schema of the real dataset:

* "Speakers" are harmonic tones: speaker s has a fixed fundamental and
  spectral envelope; utterances vary by amplitude/vibrato modulation.
* Spatialization is an analytic spherical-head model: azimuth ->
  fractional-sample ITD (Woodworth) + frequency-flat ILD. Enrollment
  scenes place the target face-to-face (azimuth ~ 0).
* `embedding_gt` is a fixed per-speaker 256-d unit vector; negatives
  are the other speakers' vectors.

Determinism: every field derives from (split, idx) through
np.random.default_rng.
"""

from __future__ import annotations

import numpy as np

from lookoncetohear_tpu_torch.data.augmentations import powerlaw_psd_gaussian

_SPLIT_SEEDS = {"train": 1_000_003, "val": 2_000_003, "test": 3_000_003}


def _np_si_snr(pred: np.ndarray, target: np.ndarray) -> float:
    """torchmetrics SI-SNR, numpy, mean over channels (copied from
    `lookoncetohear_tpu/data/datasets.py`)."""
    pred = pred - pred.mean(-1, keepdims=True)
    target = target - target.mean(-1, keepdims=True)
    alpha = (np.sum(pred * target, -1, keepdims=True) + 1e-8) / (
        np.sum(target ** 2, -1, keepdims=True) + 1e-8)
    s = alpha * target
    e = pred - s
    return float(np.mean(10 * np.log10(
        (np.sum(s ** 2, -1) + 1e-8) / (np.sum(e ** 2, -1) + 1e-8))))


def _speaker_embedding(spk: int, dim: int = 256) -> np.ndarray:
    v = np.random.default_rng(910_000 + spk).standard_normal(dim)
    return (v / np.linalg.norm(v)).astype(np.float32)


def _speaker_profile(spk: int):
    """Per-speaker vocal 'anatomy', continuous so any speaker count
    yields distinct voices. f0 is log-uniform over ~85-320 Hz; two
    formant-like resonances shape the harmonic envelope; vibrato rate/
    depth and AM rate are speaker traits."""
    rng = np.random.default_rng(880_000 + spk)
    f0 = 85.0 * 2.0 ** rng.uniform(0.0, 1.9)
    env = rng.uniform(0.2, 1.0, size=12) / np.arange(1, 13)
    formants = rng.uniform(300.0, 3000.0, size=2)
    form_bw = rng.uniform(150.0, 500.0, size=2)
    form_gain = rng.uniform(1.0, 4.0, size=2)
    vib_rate = rng.uniform(3.0, 7.0)
    vib_depth = rng.uniform(0.004, 0.02)
    am_rate = rng.uniform(1.5, 3.5)
    return f0, env, formants, form_bw, form_gain, vib_rate, \
        vib_depth, am_rate


def _utterance(spk: int, utt_seed: int, n: int, sr: int) -> np.ndarray:
    """A 'voice': harmonics of a per-speaker f0, shaped by per-speaker
    formant resonances, modulated per utterance."""
    rng = np.random.default_rng(700_000 + 131 * spk + utt_seed)
    (f0, env, formants, form_bw, form_gain, vib_rate, vib_depth,
     am_rate) = _speaker_profile(spk)
    t = np.arange(n) / sr
    vib = 1.0 + vib_depth * np.sin(
        2 * np.pi * rng.uniform(0.8, 1.2) * vib_rate * t
        + rng.uniform(0, 2 * np.pi))
    phase0 = rng.uniform(0, 2 * np.pi, size=12)
    sig = np.zeros(n)
    for h in range(12):
        f = f0 * (h + 1)
        if f >= sr / 2:
            break
        a = env[h]
        for fc, bw, g in zip(formants, form_bw, form_gain):
            a = a * (1.0 + g * np.exp(-((f - fc) ** 2)
                                      / (2.0 * bw ** 2)))
        sig += a * np.sin(2 * np.pi * f * np.cumsum(vib) / sr
                          + phase0[h])
    # syllable-ish amplitude modulation
    am = 0.55 + 0.45 * np.sin(
        2 * np.pi * rng.uniform(0.8, 1.2) * am_rate * t
        + rng.uniform(0, 2 * np.pi))
    sig = sig * am
    return (sig / (np.abs(sig).max() + 1e-9)).astype(np.float32)


def _binauralize(src: np.ndarray, azimuth_rad: float,
                 sr: int) -> np.ndarray:
    """Fractional-delay ITD + flat ILD panning: [N] -> [2, N]."""
    itd = 0.00066 * np.sin(azimuth_rad)  # seconds, + = left leads
    ild_db = 6.0 * np.sin(azimuth_rad)  # + = left louder
    n = len(src)
    spec = np.fft.rfft(src)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    half = itd / 2.0
    left = np.fft.irfft(spec * np.exp(2j * np.pi * f * half), n)
    right = np.fft.irfft(spec * np.exp(-2j * np.pi * f * half), n)
    gl = 10.0 ** (+ild_db / 40.0)
    gr = 10.0 ** (-ild_db / 40.0)
    return np.stack([gl * left, gr * right]).astype(np.float32)


def _pink(shape, rng: np.random.Generator) -> np.ndarray:
    return powerlaw_psd_gaussian(1.0, shape, rng=rng).astype(np.float32)


class SyntheticTSEDataset:
    """Deterministic synthetic scenes with the real dataset's schema."""

    def __init__(self, dset: str = "train", n_samples: int = 100,
                 n_speakers: int = 16, sr: int = 16000,
                 duration: float = 5.0, embed_dim: int = 256,
                 noise_gain: float = 0.05, num_enroll: int = 1) -> None:
        assert dset in ("train", "val", "test")
        self.dset = dset
        self.n_samples = n_samples
        self.n_speakers = n_speakers
        self.sr = sr
        self.n = int(round(duration * sr))
        self.embed_dim = embed_dim
        self.noise_gain = noise_gain
        self.embeddings = np.stack([
            _speaker_embedding(s, embed_dim) for s in range(n_speakers)])

    def __len__(self) -> int:
        return self.n_samples

    def _scene(self, rng, spks, azimuths, utt_seeds, gains, noise_seed):
        events = []
        for spk, az, us, g in zip(spks, azimuths, utt_seeds, gains):
            mono = _utterance(spk, us, self.n, self.sr) * g
            events.append(_binauralize(mono, az, self.sr))
        noise = self.noise_gain * _pink(
            (2, self.n), np.random.default_rng(noise_seed))
        return events, noise

    def __getitem__(self, idx: int):
        seed = _SPLIT_SEEDS[self.dset] + idx
        rng = np.random.default_rng(seed)
        n_spk = int(rng.integers(2, 4))
        spks = rng.choice(self.n_speakers, size=n_spk, replace=False)
        azimuths = rng.uniform(-np.pi / 2, np.pi / 2, size=n_spk)
        utt_seeds = rng.integers(0, 10_000, size=n_spk)
        gains = rng.uniform(0.4, 0.9, size=n_spk)

        events, noise = self._scene(
            rng, spks, azimuths, utt_seeds, gains, noise_seed=seed * 7 + 1)
        mixture = np.sum(events, axis=0) + noise
        norm = np.abs(mixture).max()
        if norm > 1.0:
            events = [e / norm for e in events]
            noise = noise / norm
            mixture = mixture / norm

        tgt_idx = int(rng.integers(0, n_spk))
        target = events[tgt_idx]
        tgt_spk = int(spks[tgt_idx])

        # enrollment scene: same speakers, target face-to-face
        e_az = rng.uniform(-np.pi / 2, np.pi / 2, size=n_spk)
        e_az[tgt_idx] = rng.uniform(-0.05, 0.05)
        e_us = rng.integers(10_000, 20_000, size=n_spk)
        e_events, e_noise = self._scene(
            rng, spks, e_az, e_us, gains, noise_seed=seed * 7 + 2)
        enroll = np.sum(e_events, axis=0) + e_noise
        e_norm = np.abs(enroll).max()
        if e_norm > 1.0:
            e_events = [e / e_norm for e in e_events]
            enroll = enroll / e_norm
        enroll_clean = e_events[tgt_idx]

        emb_gt = self.embeddings[tgt_spk]
        emb_neg = [self.embeddings[int(spks[i])][None]
                   for i in range(n_spk) if i != tgt_idx]
        while len(emb_neg) < 2:  # fixed count for stacking
            emb_neg.append(np.zeros_like(emb_neg[-1]))

        # ---- metadata fields, key-for-key with the real dataset ------
        # Per-sample analyses in ts_hear_test key on these (input-SNR
        # bins, speaker columns), so the synthetic corpus populates them
        # all: NaN/None placeholders would silently blank those axes.
        mixture_sisnr = _np_si_snr(target, mixture)
        enroll_sisnr = _np_si_snr(enroll, enroll_clean)
        max_shift = 16
        corr = np.correlate(
            target[0], target[1, max_shift:-max_shift], mode="valid")
        tgt_shift = int(np.argmax(corr)) - max_shift

        def _uttname(spk, us):
            return f"synth-{int(spk)}-{int(us)}.flac"

        # source_files mirrors jams.events: [bg] + one per fg event,
        # padded with "None" to 3 fg slots
        source_files = ["synthetic_pink_noise"] + [
            _uttname(s, u) for s, u in zip(spks, utt_seeds)]
        while len(source_files) < 4:
            source_files.append("None")
        e_source_files = ["synthetic_pink_noise"] + [
            _uttname(s, u) for s, u in zip(spks, e_us)]
        while len(e_source_files) < 4:
            e_source_files.append("None")
        target_source_file = _uttname(tgt_spk, utt_seeds[tgt_idx])
        enroll_clean_path = _uttname(tgt_spk, e_us[tgt_idx])

        # one embedding per fg slot (zeros for the "None" pad)
        mixture_embeddings = [
            self.embeddings[int(s)].astype(np.float32) for s in spks]
        while len(mixture_embeddings) < 3:
            mixture_embeddings.append(
                np.zeros(self.embed_dim, np.float32))

        def _spk_info(s):
            return f"F0={_speaker_profile(int(s))[0]:.0f}Hz"

        # [(target, info)] + one entry per non-target fg slot: fixed
        # length 3 for any 2-3 spk scene
        speaker_info = [(str(tgt_spk), _spk_info(tgt_spk))]
        for i, s in enumerate(spks):
            if i != tgt_idx:
                speaker_info.append((str(int(s)), _spk_info(s)))
        while len(speaker_info) < 3:
            speaker_info.append(("None", "None"))

        # anechoic = the un-spatialized mono utterance (the real
        # dataset stores the pre-simulation event audio, [1, 1, N])
        enroll_anechoic = _utterance(tgt_spk, int(e_us[tgt_idx]),
                                     self.n, self.sr) * gains[tgt_idx]

        inputs = {
            "mixture": mixture.astype(np.float32),
            "mixture_sisnr": np.float32(mixture_sisnr),
            "mixture_embeddings": mixture_embeddings,
            "enrollments": enroll[None].astype(np.float32),
            "enrollments_clean": enroll_clean[None].astype(np.float32),
            "enrollments_clean_anechoic":
                enroll_anechoic[None, None].astype(np.float32),
            "enrollments_clean_path": [enroll_clean_path],
            "enrollments_id": np.array([tgt_spk], np.int64),
            "enrollments_source_files": e_source_files,
            "enrollments_sisnr": np.float32(enroll_sisnr),
            "tgt_ang_vel": np.float32(0.0),
            "tgt_enroll_error": np.float32(0.0),
            "tgt_shift": np.int64(tgt_shift),
            "tgt_idx": np.int64(tgt_idx),
            "target_source_file": target_source_file,
            "source_files": source_files,
            "speaker_info": speaker_info,
        }
        targets = {
            "target": target.astype(np.float32),
            "embedding_gt": emb_gt[None],
            "embedding_neg": [e.astype(np.float32) for e in emb_neg],
            "tgt_spk_idx": np.int64(tgt_spk),
        }
        return inputs, targets
