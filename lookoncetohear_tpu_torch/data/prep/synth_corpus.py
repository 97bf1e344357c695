"""A synthetic corpus in the layout the reference configs read
(`configs/tsh.json`, `configs/embed.json`), for smoke runs and tests
where LibriSpeech, WHAM! and the BRIR sets are not at hand:

    <root>/data/MixLibriSpeech/
        librispeech_scaper_fmt/<split>/<spk>/<spk>-0-<utt>.wav
        librispeech_dvector_embeddings/<split>/<spk>.npz
        wham_noise/{tr,cv,tt}/noise<k>.wav
        LibriSpeech/SPEAKERS.TXT
    <root>/data/CATT_RIRs/Binaural/16k/<room>/CATT_<room>_<az>.wav

for the splits train-clean-360, dev-clean and test-clean. Voices are
harmonic tones with a per-speaker pitch and syllable-rate envelope,
noise is white, d-vectors are seeded Gaussians, and the BRIRs of every
room of the CATT sets' three splits (azimuths -90..90 step 5) are
impulse pairs whose interaural delay follows the azimuth, with a noise
tail that decays 60 dB over the room's reverberation time (the room
names it: `0_7s` is 0.7 s), RT60 + 50 ms long. All wav, so nothing
needs h5py or soundfile. The scene specs
are made afterwards, by `generate_jams` run from <root>:

    python3 -m lookoncetohear_tpu_torch.data.prep.synth_corpus ROOT
    (cd ROOT && python3 -m lookoncetohear_tpu_torch.data.prep.generate_jams \\
        --only dev-clean --num 10)
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lookoncetohear_tpu_torch.data.audio_io import write_wav
from lookoncetohear_tpu_torch.data.spatializer import CATTRIRSimulator

# LibriSpeech split -> its WHAM! noise label
SPLITS = {"train-clean-360": "tr", "dev-clean": "cv", "test-clean": "tt"}
CATT_DIR = os.path.join("data", "CATT_RIRs", "Binaural", "16k")
BASE = os.path.join("data", "MixLibriSpeech")
SR = 16000
EMBED_DIM = 256               # the d-vectors' width
SEED = 0
EARLY_S = 0.05                # a BRIR's length beyond its room's RT60


def voice(f0: float, rate: float, n: int) -> np.ndarray:
    """A synthetic voice: three harmonics of f0 under a syllable-rate
    envelope, n samples at SR."""
    t = np.arange(n) / SR
    x = sum(np.sin(2 * np.pi * h * f0 * t) / h for h in (1, 2, 3))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rate * t)
    return (0.3 * x * env).astype(np.float32)


def _brir(az: int, rt60: float, n: int,
          rng: np.random.Generator) -> np.ndarray:
    """[2, n]: an impulse per ear and a noise tail 60 dB down after
    `rt60` s, the far ear's impulse later by the azimuth's interaural
    delay (up to ~0.6 ms, 10 samples at 16 kHz; n must exceed it) and up
    to 3 dB quieter."""
    itd = int(round(abs(np.sin(np.deg2rad(az))) * 0.0006 * SR))
    t = np.arange(1, n) / SR
    decay = 10 ** (-3 * t / max(rt60, EARLY_S))
    ir = np.zeros((2, n), np.float32)
    near, far = (1, 0) if az > 0 else (0, 1)
    ir[near, 0] = 1.0
    ir[far, itd] = 10 ** (-3.0 * abs(az) / 90 / 20)
    ir[:, 1:] += 0.05 * decay * rng.standard_normal((2, n - 1))
    return ir


def write_corpus(root: str, n_speakers: int = 8, n_utts: int = 3,
                 seconds: float = 6.0, ir_len: int | None = None) -> dict:
    """Write the corpus under `root`; returns its directories: for each
    split `fg`, `embed` and `jams` (to be filled by generate_jams), and
    `bg` and `catt`. `ir_len` cuts every BRIR to that many samples
    (None: RT60 + EARLY_S, the room's own length)."""
    rng = np.random.default_rng(SEED)
    base = os.path.join(root, BASE)
    n = int(seconds * SR)
    info = ["; synthetic speakers"] * 12
    out: dict = {"bg": os.path.join(base, "wham_noise"),
                 "catt": os.path.join(root, CATT_DIR)}
    for s, (split, label) in enumerate(SPLITS.items()):
        fg = os.path.join(base, "librispeech_scaper_fmt", split)
        emb_dir = os.path.join(base, "librispeech_dvector_embeddings",
                               split)
        os.makedirs(emb_dir, exist_ok=True)
        for k in range(n_speakers):
            spk = str(1000 * (s + 1) + 7 * k)
            os.makedirs(os.path.join(fg, spk), exist_ok=True)
            info.append(f"{spk} | {'FM'[k % 2]} | {split} | 1.00 | s{k}")
            embs = {}
            for u in range(n_utts):
                name = f"{spk}-0-{u}.wav"
                write_wav(os.path.join(fg, spk, name),
                          voice(90 + 23 * k + 4 * u, 3 + 0.7 * k, n), SR)
                embs[name] = rng.standard_normal(EMBED_DIM).astype(
                    np.float32)
            np.savez(os.path.join(emb_dir, f"{spk}.npz"), **embs)
        noise_dir = os.path.join(out["bg"], label)
        os.makedirs(noise_dir, exist_ok=True)
        for j in range(2):
            write_wav(os.path.join(noise_dir, f"noise{j}.wav"),
                      (0.1 * rng.standard_normal(n + SR)).astype(
                          np.float32), SR)
        out[split] = dict(
            fg=fg, embed=emb_dir,
            jams=os.path.join(base, "jams", split))
    os.makedirs(os.path.join(base, "LibriSpeech"), exist_ok=True)
    with open(os.path.join(base, "LibriSpeech", "SPEAKERS.TXT"), "w") as f:
        f.write("\n".join(info) + "\n")
    c = CATTRIRSimulator
    for room in c.TRAIN_ROOMS + c.VAL_ROOMS + c.TEST_ROOMS:
        rt60 = float(room.rstrip("s").replace("_", "."))
        n_ir = ir_len or int(round((rt60 + EARLY_S) * SR))
        os.makedirs(os.path.join(out["catt"], room), exist_ok=True)
        for az in range(-90, 95, 5):
            write_wav(os.path.join(out["catt"], room,
                                   f"CATT_{room}_{az}.wav"),
                      _brir(az, rt60, n_ir, rng), SR)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("root", help="directory to write data/ under")
    write_corpus(p.parse_args(argv).root)


if __name__ == "__main__":
    main()
