"""The MixLibriSpeech dataset (counterpart of
`lookoncetohear_tpu/data/datasets.py`), on the scaper-free renderer
(`scene.py`) and the spatializers (`spatializer.py`).

The RNG discipline is the JAX package's: train draws from the
module-global `random` stream; val/test derive every random choice from
a fresh `random.Random(idx)` (noise scale, target, enrollment scene) and
`random.Random(idx + 123)` (enrollment noise), so val/test items are the
JAX package's bit for bit, and train items are under the same `random`
and `np.random` seeds.

Each item renders TWO scenes, the mixture and an enrollment of the same
speaker placed face to face, with one spatializer seed. Moving sources
(`use_motion`, `CIPIC_MOTION`) render through the native renderer
(`motion.py`).
"""

from __future__ import annotations

import logging
import os
import random
from pathlib import Path

import numpy as np

from lookoncetohear_tpu_torch.data import audio_io
from lookoncetohear_tpu_torch.data.augmentations import (
    generate_brown_noise, generate_pink_noise, generate_white_noise)
from lookoncetohear_tpu_torch.data.scene import render_scene
from lookoncetohear_tpu_torch.data import spatializer as sp


# The per-sample schema. The synthetic split emits the same keys, so the
# eval CSV's input-SNR and speaker columns read either.
INPUT_KEYS = frozenset({
    "mixture", "mixture_sisnr", "mixture_embeddings",
    "enrollments", "enrollments_clean", "enrollments_clean_anechoic",
    "enrollments_clean_path", "enrollments_id",
    "enrollments_source_files", "enrollments_sisnr",
    "tgt_ang_vel", "tgt_enroll_error", "tgt_shift", "tgt_idx",
    "target_source_file", "source_files", "speaker_info",
})
TARGET_KEYS = frozenset({
    "target", "embedding_gt", "embedding_neg", "tgt_spk_idx",
})


def _np_si_snr(pred: np.ndarray, target: np.ndarray) -> float:
    """torchmetrics SI-SNR, numpy, mean over channels."""
    pred = pred - pred.mean(-1, keepdims=True)
    target = target - target.mean(-1, keepdims=True)
    alpha = (np.sum(pred * target, -1, keepdims=True) + 1e-8) / (
        np.sum(target ** 2, -1, keepdims=True) + 1e-8)
    s = alpha * target
    e = pred - s
    return float(np.mean(10 * np.log10(
        (np.sum(s ** 2, -1) + 1e-8) / (np.sum(e ** 2, -1) + 1e-8))))


def _load_embedding_map(embed_dir: str, spk_id: str) -> dict:
    """Load `<embed_dir>/<spk>.pt` (torch pickle) or `.npz`."""
    pt = os.path.join(embed_dir, f"{spk_id}.pt")
    if os.path.exists(pt):
        import torch
        m = torch.load(pt, map_location="cpu", weights_only=False)
        return {k: np.asarray(v) for k, v in m.items()}
    npz = os.path.join(embed_dir, f"{spk_id}.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            return dict(z)
    raise FileNotFoundError(f"no embedding file for speaker {spk_id} "
                            f"in {embed_dir}")


def make_simulator(hrtf_type: str, hrtf_list, sr: int, dset: str,
                   use_motion: bool = False,
                   motion_use_piecewise_arcs: bool = False):
    """The spatializer a config's `hrtf_type` names. `MultiCh` and the
    SOFA sets (CIPIC, APL, RRBRIR, CIPIC_MOTION) need h5py; ASH, CATTRIR
    and PRA are wav sets. `use_motion` moves `MultiCh`'s CIPIC sources
    (`motion.CIPICMotionSimulator`); `CIPIC_MOTION` is that simulator
    alone."""
    if hrtf_type == "CIPIC":
        return sp.CIPICSimulator(hrtf_list, sr)
    if hrtf_type == "APL":
        return sp.APLSimulator(hrtf_list, sr)
    if hrtf_type == "ASH":
        return sp.ASHSimulator(hrtf_list, sr, dset=dset)
    if hrtf_type == "CATTRIR":
        return sp.CATTRIRSimulator(hrtf_list, sr, dset=dset)
    if hrtf_type == "RRBRIR":
        return sp.RRBRIRSimulator(hrtf_list, sr)
    if hrtf_type == "PRA":
        return sp.PRASimulator(hrtf_list, sr, dset=dset)
    if hrtf_type == "MultiCh":
        if use_motion:
            from lookoncetohear_tpu_torch.data.motion import \
                CIPICMotionSimulator

            def cipic_type(sofa, fs):
                return CIPICMotionSimulator(
                    sofa, fs, use_piecewise_arcs=motion_use_piecewise_arcs)
        else:
            cipic_type = sp.CIPICSimulator
        return sp.MultiChSimulator(hrtf_list, sr, cipic_type, dset=dset)
    if hrtf_type == "CIPIC_MOTION":
        from lookoncetohear_tpu_torch.data.motion import CIPICMotionSimulator
        return CIPICMotionSimulator(hrtf_list, sr)
    raise NotImplementedError(hrtf_type)


class MixLibriSpeechNoisyEnroll:
    """The train/val/test dataset of the reference configs. The default
    `variant='norm'` rescales only a mixture that clips; `'base'`
    always peak-normalizes."""

    def __init__(self, fg_dir, bg_dir, embed_dir, jams_dir, hrtf_list,
                 dset, sr=None, resample_rate=None, num_enroll=1,
                 enroll_len=5, hrtf_type="CIPIC", noise_scale=(3.0, 10.0),
                 max_shift=16, use_motion=False,
                 motion_use_piecewise_arcs=False, augment=False,
                 max_white_noise_level=1e-2, max_pink_noise_level=5e-2,
                 max_brown_noise_level=5e-2, variant="norm") -> None:
        assert dset in ("train", "val", "test")
        assert num_enroll == 1, "Only 1 enrollment is supported"
        self.fg_dir, self.bg_dir = fg_dir, bg_dir
        self.embed_dir, self.jams_dir = embed_dir, jams_dir
        self.dset = dset
        self.noise_scale = noise_scale
        self.max_shift = max_shift
        self.augment = augment
        self.aug_levels = (max_white_noise_level, max_pink_noise_level,
                           max_brown_noise_level)
        self.variant = variant
        self.sr = resample_rate if resample_rate is not None else sr
        self.file_sr = sr
        self.enroll_len = enroll_len * self.sr

        logging.info("Loading dataset: %s sr=%s", dset, self.sr)
        self.samples = sorted(Path(jams_dir).glob("[0-9]*"))
        self.simulator = make_simulator(
            hrtf_type, hrtf_list, sr, dset, use_motion,
            motion_use_piecewise_arcs)

        # speaker -> scene-index map from the mixture.txt sidecars
        self.speaker_map: dict = {}
        for i, d in enumerate(self.samples):
            with open(os.path.join(d, "mixture.txt")) as f:
                for line in f:
                    spk = int(line.strip().split("\t")[2])
                    self.speaker_map.setdefault(spk, []).append(i)

        self.speaker_ids = sorted(
            int(x) for x in os.listdir(fg_dir)
            if os.path.isdir(os.path.join(fg_dir, x)))
        self.speaker_info = self._speaker_info()

    def _speaker_info(self) -> dict:
        """LibriSpeech SPEAKERS.TXT -> {id: sex}; empty when absent."""
        path = os.path.join(self.fg_dir, "..", "..", "LibriSpeech",
                            "SPEAKERS.TXT")
        info = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f.readlines()[12:]:
                    parts = [p.strip() for p in line.split("|")]
                    if len(parts) >= 2:
                        info[parts[0]] = parts[1]
        return info

    def _embedding(self, filename: str) -> np.ndarray:
        spk = filename.split("-")[0]
        emb = _load_embedding_map(self.embed_dir, spk)[filename]
        return np.asarray(emb, np.float32).reshape(-1)

    def __len__(self) -> int:
        return len(self.samples)

    def _aug_noise(self, shape) -> np.ndarray:
        w, p, b = self.aug_levels
        rng = np.random.default_rng(random.getrandbits(32))
        return (generate_white_noise(shape, w, rng)
                + generate_pink_noise(shape, p, rng)
                + generate_brown_noise(shape, b, rng))

    def _maybe_resample(self, x: np.ndarray) -> np.ndarray:
        if self.file_sr is not None and self.sr != self.file_sr:
            return audio_io.resample(x, self.file_sr, self.sr)
        return x

    def __getitem__(self, idx: int):
        sample_dir = str(self.samples[idx])
        _, jams, ann_list, event_audio = render_scene(
            sample_dir, self.fg_dir, self.bg_dir)

        multi_ch_seed = idx if self.dset != "train" \
            else random.randrange(1, 100000)
        res = self.simulator.simulate(event_audio[1:], event_audio[0],
                                      multi_ch_seed)
        if len(res) == 2:
            events, noise = res
            ang_vels = [0.0, 0.0, 0.0]
        else:
            events, noise, ang_vels = res

        # noise gain
        if self.dset == "train":
            nscale = random.uniform(*self.noise_scale) \
                if not np.isscalar(self.noise_scale) else self.noise_scale
        else:
            _rng = random.Random(idx)
            nscale = _rng.uniform(*self.noise_scale) \
                if not np.isscalar(self.noise_scale) else self.noise_scale
        noise = noise * nscale
        if self.augment and self.dset == "train" and random.random() < 0.7:
            noise = noise + self._aug_noise(noise.shape)

        norm = np.abs(sum(events) + noise).max()
        if norm > 1.0 or self.variant == "base":
            events = [e / norm for e in events]
            noise = noise / norm
        mixture = sum(events) + noise

        if self.dset == "train":
            tgt_idx = random.randrange(len(events))
        else:
            tgt_idx = random.Random(idx).randrange(len(events))
        target = events[tgt_idx]
        tgt_id = str(ann_list[tgt_idx][-1])
        tgt_ang_vel = float(ang_vels[tgt_idx]) * (180.0 / np.pi)

        input_sisnr = _np_si_snr(target, mixture)
        corr = np.correlate(
            target[0], target[1, self.max_shift:-self.max_shift],
            mode="valid")
        tgt_shift = int(np.argmax(corr)) - self.max_shift

        tgt_spk_idx = self.speaker_ids.index(int(tgt_id)) \
            if int(tgt_id) in self.speaker_ids else -1

        source_files = [e.source_file for e in jams.events]
        if len(source_files) == 3:
            source_files.append("None")
        target_source_file = jams.events[tgt_idx + 1].source_file

        source_embeddings = []
        for sf in source_files[1:]:
            if sf == "None":
                source_embeddings.append(
                    np.zeros_like(source_embeddings[-1]))
            else:
                source_embeddings.append(
                    self._embedding(os.path.basename(sf)))

        other_info = []
        for sf in source_files[1:]:
            if sf == "None":
                other_info.append(("None", "None"))
                continue
            spk = os.path.basename(sf).split("-")[0]
            if spk != tgt_id:
                other_info.append((spk, self.speaker_info.get(spk, "?")))
        speaker_info = [(tgt_id, self.speaker_info.get(tgt_id, "?"))] \
            + other_info

        # ---- enrollment scene -----------------------------------------
        if self.dset == "train":
            enroll_id = random.choice(self.speaker_map[int(tgt_id)])
        else:
            enroll_id = random.Random(idx).choice(
                self.speaker_map[int(tgt_id)])
        enroll_dir = str(self.samples[enroll_id])
        with open(os.path.join(enroll_dir, "mixture.txt")) as f:
            enroll_spks = [int(line.strip().split("\t")[2]) for line in f]
        _, e_jams, _, e_event_audio = render_scene(
            enroll_dir, self.fg_dir, self.bg_dir)
        e_source_files = [e.source_file for e in e_jams.events]
        if len(e_source_files) == 3:
            e_source_files.append("None")

        enroll_target_idx = enroll_spks.index(int(tgt_id))
        enroll_clean_path = e_jams.events[enroll_target_idx + 1].source_file
        enroll_clean_anechoic = e_event_audio[enroll_target_idx + 1]

        embedding_gt = self._embedding(os.path.basename(enroll_clean_path))
        embedding_neg = []
        for sf in e_source_files[1:]:
            if sf == "None":
                embedding_neg.append(np.zeros_like(embedding_neg[-1]))
                continue
            fn = os.path.basename(sf)
            if fn.split("-")[0] != tgt_id:
                embedding_neg.append(self._embedding(fn))

        e_res = self.simulator.simulate(
            e_event_audio[1:], e_event_audio[0], multi_ch_seed,
            face_to_face_idx=enroll_target_idx)
        if len(e_res) == 2:
            e_events, e_noise = e_res
            enroll_errors = [0.0, 0.0, 0.0]
        else:
            e_events, e_noise, enroll_errors = e_res
        tgt_enroll_error = float(enroll_errors[enroll_target_idx]) \
            * (180.0 / np.pi)

        if self.dset == "train":
            e_nscale = random.uniform(*self.noise_scale) \
                if not np.isscalar(self.noise_scale) else self.noise_scale
        else:
            _rng = random.Random(idx + 123)
            e_nscale = _rng.uniform(*self.noise_scale) \
                if not np.isscalar(self.noise_scale) else self.noise_scale
        e_all = [e_noise * e_nscale] + list(e_events)
        if self.augment and self.dset == "train" and random.random() < 0.7:
            e_all[0] = e_all[0] + self._aug_noise(e_all[0].shape)

        e_norm = np.abs(sum(e_all)).max()
        if e_norm > 1.0 or self.variant == "base":
            e_all = [e / e_norm for e in e_all]
        enroll_clean = e_all[enroll_target_idx + 1]
        enroll = sum(e_all)
        enroll_sisnr = _np_si_snr(enroll, enroll_clean)

        mixture = self._maybe_resample(mixture)
        target = self._maybe_resample(target)
        enroll = self._maybe_resample(enroll)

        inputs = {
            "mixture": mixture.astype(np.float32),
            "mixture_sisnr": np.float32(input_sisnr),
            "mixture_embeddings": source_embeddings,
            "enrollments": enroll[None].astype(np.float32),
            "enrollments_clean": enroll_clean[None].astype(np.float32),
            "enrollments_clean_anechoic":
                enroll_clean_anechoic[None, None].astype(np.float32),
            "enrollments_clean_path": [enroll_clean_path],
            "enrollments_id": np.array([int(tgt_id)], np.int64),
            "enrollments_source_files": e_source_files,
            "enrollments_sisnr": np.float32(enroll_sisnr),
            "tgt_ang_vel": np.float32(tgt_ang_vel),
            "tgt_enroll_error": np.float32(tgt_enroll_error),
            "tgt_shift": np.int64(tgt_shift),
            "tgt_idx": np.int64(tgt_idx),
            "target_source_file": target_source_file,
            "source_files": source_files,
            "speaker_info": speaker_info,
        }
        targets = {
            "target": target.astype(np.float32),
            "embedding_gt": embedding_gt[None],
            "embedding_neg": [e[None] for e in embedding_neg],
            "tgt_spk_idx": np.int64(tgt_spk_idx),
        }
        return inputs, targets
