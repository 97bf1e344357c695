"""The other MixLibriSpeech datasets (counterpart of
`lookoncetohear_tpu/data/dataset_variants.py`):

* `MixLibriSpeechNoisyEnrollWP`: volume randomization, always
  peak-normalized, a >2-channel target cut to its outer pair, optional
  mono clean-enrollment passthrough.
* `MixLibriSpeechNoisyEnrollDirectional`: the target itself placed face
  to face in the mixture; the label is its first channel.
* `MixLibriSpeechCIPIC`: clean enrollment (clean LibriSpeech utterances
  and their precomputed d-vectors).
* `MixLibriSpeechMotion`: `MixLibriSpeechCIPIC` with moving sources
  (the CIPIC motion simulator, `motion.py`).
* `MixLibriSpeechDM`: train-only dynamic mixing (scenes made per item,
  no jams files).
* `SpeechSeparationDataset`: 2-speaker pairs for PIT separation.
* `OracleMixLibriSpeech`: every source returned, the target first.
"""

from __future__ import annotations

import os
import random

import numpy as np

from lookoncetohear_tpu_torch.data import audio_io
from lookoncetohear_tpu_torch.data.datasets import (
    MixLibriSpeechNoisyEnroll, _load_embedding_map, make_simulator)
from lookoncetohear_tpu_torch.data.scene import (Event, Scene,
                                                 render_scene, save_scene)


class MixLibriSpeechNoisyEnrollWP(MixLibriSpeechNoisyEnroll):
    """Volume-perturbed variant. noise_scale here is a scalar range R:
    gain = 1 + U[0,1)*(R-1)."""

    def __init__(self, *args, skip_enrollment_simulation=False,
                 randomize_volume=False, min_volume_peak=0.2,
                 noise_scale=1.0, **kwargs):
        super().__init__(*args, noise_scale=noise_scale,
                         variant="base", **kwargs)
        self.skip_enrollment_simulation = skip_enrollment_simulation
        self.randomize_volume = randomize_volume
        self.min_volume_peak = min_volume_peak

    def _noise_gain(self, idx: int, enroll: bool) -> float:
        r = self.noise_scale
        if np.isscalar(r):
            if self.dset == "train":
                return 1 + random.random() * (r - 1)
            return 1 + random.Random(idx + 123).random() * (r - 1)
        if self.dset == "train":
            return random.uniform(*r)
        return random.Random(idx + (123 if enroll else 0)).uniform(*r)

    def __getitem__(self, idx):
        inputs, targets = super().__getitem__(idx)
        mixture, target = inputs["mixture"], targets["target"]
        if target.shape[0] > 2:
            target = target[[0, -1]]
        if self.randomize_volume:
            if self.dset == "train":
                vol = random.uniform(self.min_volume_peak, 1)
            else:
                vol = random.Random(idx).uniform(self.min_volume_peak, 1)
            target = target * vol
            mixture = mixture * vol
        if self.skip_enrollment_simulation:
            # mono clean enrollment passthrough
            clean = inputs["enrollments_clean_anechoic"][0]
            inputs["enrollments"] = clean.astype(np.float32)
        inputs["mixture"] = mixture.astype(np.float32)
        targets["target"] = target.astype(np.float32)
        return inputs, targets


class MixLibriSpeechNoisyEnrollDirectional(MixLibriSpeechNoisyEnroll):
    """Directional TSE: no enrollment branch; the target source is
    pinned face-to-face in the *mixture* and the label is its first
    channel."""

    def __getitem__(self, idx):
        sample_dir = str(self.samples[idx])
        _, jams, ann_list, event_audio = render_scene(
            sample_dir, self.fg_dir, self.bg_dir)

        if self.dset == "train":
            tgt_idx = random.randrange(len(event_audio) - 1)
        else:
            tgt_idx = random.Random(idx).randrange(len(event_audio) - 1)

        multi_ch_seed = idx if self.dset != "train" \
            else random.randrange(1, 100000)
        events, noise = self.simulator.simulate(
            event_audio[1:], event_audio[0], multi_ch_seed,
            face_to_face_idx=tgt_idx)[:2]

        norm = np.abs(sum(events) + noise).max()
        events = [e / norm for e in events]
        noise = noise / norm
        mixture = sum(events) + noise

        target = events[tgt_idx]
        tgt_id = str(ann_list[tgt_idx][-1])
        tgt_spk_idx = self.speaker_ids.index(int(tgt_id)) \
            if int(tgt_id) in self.speaker_ids else -1

        source_files = [e.source_file for e in jams.events]
        if len(source_files) == 3:
            source_files.append("None")
        speaker_info = [(tgt_id, self.speaker_info.get(tgt_id, "?"))]
        for sf in source_files[1:]:
            if sf == "None":
                speaker_info.append(("None", "None"))
                continue
            spk = os.path.basename(sf).split("-")[0]
            if spk != tgt_id:
                speaker_info.append((spk, self.speaker_info.get(spk, "?")))

        inputs = {
            "mixture": self._maybe_resample(mixture).astype(np.float32),
            "source_files": source_files,
            "speaker_info": speaker_info,
        }
        targets = {
            "target": self._maybe_resample(target[:1]).astype(np.float32),
            "tgt_spk_idx": np.int64(tgt_spk_idx),
        }
        return inputs, targets


class MixLibriSpeechCIPIC(MixLibriSpeechNoisyEnroll):
    """Clean-enrollment ancestor: enrollment audio = `num_enroll` clean
    utterances of the target speaker, embeddings from the d-vector
    files."""

    def __init__(self, *args, num_enroll=1, **kwargs):
        kwargs.setdefault("hrtf_type", "CIPIC")
        super().__init__(*args, num_enroll=1, variant="base", **kwargs)
        self.num_enroll_clean = num_enroll

    def _clean_enrollments(self, idx, tgt_id):
        embed_map = _load_embedding_map(self.embed_dir, tgt_id)
        items = sorted(embed_map.items())
        rng = random if self.dset == "train" else random.Random(idx)
        picked = rng.sample(items, self.num_enroll_clean)
        embed_paths = [os.path.join(self.fg_dir, tgt_id, name)
                       for name, _ in picked]
        embeds = np.stack([np.asarray(e, np.float32).reshape(-1)
                           for _, e in picked])
        enrollments = []
        for p in embed_paths:
            audio, sr = audio_io.read_audio(p)
            audio = self._maybe_resample(
                audio_io.resample(audio, sr, self.sr)
                if sr != self.sr else audio)
            n = self.enroll_len
            if audio.shape[-1] < n:
                audio = np.pad(audio, [(0, 0), (0, n - audio.shape[-1])])
            enrollments.append(audio[..., :n])
        return np.stack(enrollments), embeds, embed_paths

    def __getitem__(self, idx):
        sample_dir = str(self.samples[idx])
        _, jams, ann_list, event_audio = render_scene(
            sample_dir, self.fg_dir, self.bg_dir)
        multi_ch_seed = idx if self.dset != "train" \
            else random.randrange(1, 100000)
        events, noise = self.simulator.simulate(
            event_audio[1:], event_audio[0], multi_ch_seed)[:2]
        norm = np.abs(sum(events) + noise).max()
        events = [e / norm for e in events]
        noise = noise / norm
        mixture = sum(events) + noise

        if self.dset == "train":
            tgt_idx = random.randrange(len(events))
        else:
            tgt_idx = random.Random(idx).randrange(len(events))
        target = events[tgt_idx]
        tgt_id = str(ann_list[tgt_idx][-1])
        tgt_spk_idx = self.speaker_ids.index(int(tgt_id)) \
            if int(tgt_id) in self.speaker_ids else -1

        enrollments, embeds, embed_paths = self._clean_enrollments(
            idx, tgt_id)

        source_files = [e.source_file for e in jams.events]
        if len(source_files) == 3:
            source_files.append("None")
        speaker_info = [(tgt_id, self.speaker_info.get(tgt_id, "?"))]
        for sf in source_files[1:]:
            if sf == "None":
                speaker_info.append(("None", "None"))
                continue
            spk = os.path.basename(sf).split("-")[0]
            if spk != tgt_id:
                speaker_info.append((spk, self.speaker_info.get(spk, "?")))

        inputs = {
            "mixture": self._maybe_resample(mixture).astype(np.float32),
            "embeds": embeds,
            "enrollments": enrollments.astype(np.float32),
            "source_files": source_files,
            "speaker_info": speaker_info,
            "embed_paths": embed_paths,
        }
        targets = {
            "target": self._maybe_resample(target).astype(np.float32),
            "tgt_spk_idx": np.int64(tgt_spk_idx),
        }
        return inputs, targets


class MixLibriSpeechMotion(MixLibriSpeechCIPIC):
    """Moving sources under the clean-enrollment scheme: `hrtf_type`
    CIPIC_MOTION unless given."""

    def __init__(self, *args, motion_use_piecewise_arcs=False, **kwargs):
        kwargs["hrtf_type"] = kwargs.get("hrtf_type", "CIPIC_MOTION")
        kwargs["use_motion"] = True
        kwargs["motion_use_piecewise_arcs"] = motion_use_piecewise_arcs
        super().__init__(*args, **kwargs)


class MixLibriSpeechDM(MixLibriSpeechCIPIC):
    """Dynamic mixing: scenes synthesized on the fly per __getitem__
    (no jams dir), train-style randomness only."""

    def __init__(self, fg_dir, bg_dir, embed_dir, hrtf_list,
                 dset="train", sr=16000, resample_rate=None,
                 num_enroll=1, enroll_len=5, hrtf_type="CIPIC",
                 n_samples=100000, num_events_min=2, num_events_max=3,
                 duration=5.0, snr_min=15.0, snr_max=25.0,
                 ref_db=-25.0, bg_label="tr") -> None:
        # bypass the jams-scan init: build only what DM needs
        self.fg_dir, self.bg_dir, self.embed_dir = fg_dir, bg_dir, embed_dir
        self.dset = dset
        self.sr = resample_rate if resample_rate is not None else sr
        self.file_sr = sr
        self.enroll_len = enroll_len * self.sr
        self.num_enroll_clean = num_enroll
        self.n_samples = n_samples
        self.spec = dict(num_events_min=num_events_min,
                         num_events_max=num_events_max, duration=duration,
                         snr_min=snr_min, snr_max=snr_max, ref_db=ref_db,
                         bg_label=bg_label)
        self.simulator = make_simulator(hrtf_type, hrtf_list, sr, dset)
        self.speaker_ids = sorted(
            int(x) for x in os.listdir(fg_dir)
            if os.path.isdir(os.path.join(fg_dir, x)))
        self.speaker_info = self._speaker_info()
        self._fg_files = {
            str(s): sorted(os.listdir(os.path.join(fg_dir, str(s))))
            for s in self.speaker_ids}
        bg_dir_l = os.path.join(bg_dir, bg_label)
        self._bg_files = sorted(os.listdir(bg_dir_l))

    def __len__(self):
        return self.n_samples

    def _make_scene(self, tmp_dir: str) -> str:
        sp = self.spec
        n_ev = np.random.randint(sp["num_events_min"],
                                 sp["num_events_max"] + 1)
        labs = random.sample([str(s) for s in self.speaker_ids],
                             k=n_ev)
        scene = Scene(duration=sp["duration"], sr=self.file_sr,
                      ref_db=sp["ref_db"])
        scene.events.append(Event(
            role="background", label=sp["bg_label"],
            source_file=os.path.join(self.bg_dir, sp["bg_label"],
                                     random.choice(self._bg_files)),
            event_duration=sp["duration"]))
        for lab in labs:
            scene.events.append(Event(
                role="foreground", label=lab,
                source_file=os.path.join(self.fg_dir, lab,
                                         random.choice(self._fg_files[lab])),
                event_time=0.0, event_duration=sp["duration"],
                snr=random.uniform(sp["snr_min"], sp["snr_max"])))
        save_scene(scene, tmp_dir)
        return tmp_dir

    def __getitem__(self, idx):
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            scene_dir = self._make_scene(td)
            _, jams, ann_list, event_audio = render_scene(scene_dir)

        seed = random.randrange(1, 100000)
        events, noise = self.simulator.simulate(
            event_audio[1:], event_audio[0], seed)[:2]
        norm = np.abs(sum(events) + noise).max()
        events = [e / norm for e in events]
        noise = noise / norm
        mixture = sum(events) + noise
        tgt_idx = random.randrange(len(events))
        target = events[tgt_idx]
        tgt_id = str(ann_list[tgt_idx][-1])
        enrollments, embeds, embed_paths = self._clean_enrollments(
            idx, tgt_id)
        inputs = {
            "mixture": self._maybe_resample(mixture).astype(np.float32),
            "embeds": embeds,
            "enrollments": enrollments.astype(np.float32),
            "embed_paths": embed_paths,
        }
        targets = {
            "target": self._maybe_resample(target).astype(np.float32)}
        return inputs, targets


class SpeechSeparationDataset(MixLibriSpeechNoisyEnroll):
    """2-speaker separation pairs for PIT training."""

    def __init__(self, *args, use_bg=True, **kwargs):
        super().__init__(*args, variant="base", **kwargs)
        self.use_bg = use_bg

    def __getitem__(self, idx):
        sample_dir = str(self.samples[idx])
        _, jams, ann_list, event_audio = render_scene(
            sample_dir, self.fg_dir, self.bg_dir)

        chosen = [0, 1]
        if self.dset == "train":
            chosen = random.sample(range(len(event_audio) - 1), k=2)
        event_audio = [event_audio[0], event_audio[chosen[0] + 1],
                       event_audio[chosen[1] + 1]]
        ann_list = [ann_list[chosen[0]], ann_list[chosen[1]]]

        multi_ch_seed = idx if self.dset != "train" \
            else random.randrange(1, 100000)
        events, noise = self.simulator.simulate(
            event_audio[1:], event_audio[0], multi_ch_seed)[:2]
        if not self.use_bg:
            noise = noise * 0
        norm = np.abs(sum(events) + noise).max()
        events = [e / norm for e in events]
        noise = noise / norm
        mixture = sum(events) + noise

        tgt_idx = np.random.randint(2) if self.dset == "train" else 0
        inputs = {
            "mixture": self._maybe_resample(mixture).astype(np.float32),
            "speaker_ids": [str(a[-1]) for a in ann_list],
        }
        targets = {
            "target1": self._maybe_resample(events[0]).astype(np.float32),
            "target2": self._maybe_resample(events[1]).astype(np.float32),
            "tgt_idx": np.int64(tgt_idx),
        }
        return inputs, targets


class OracleMixLibriSpeech(MixLibriSpeechNoisyEnroll):
    """Oracle-selection baseline: all spatialized sources returned,
    target swapped to index 0."""

    def __getitem__(self, idx):
        sample_dir = str(self.samples[idx])
        _, jams, ann_list, event_audio = render_scene(
            sample_dir, self.fg_dir, self.bg_dir)
        multi_ch_seed = idx if self.dset != "train" \
            else random.randrange(1, 100000)
        events, noise = self.simulator.simulate(
            event_audio[1:], event_audio[0], multi_ch_seed)[:2]
        norm = np.abs(sum(events) + noise).max()
        events = [e / norm for e in events]
        noise = noise / norm
        mixture = sum(events) + noise

        if self.dset == "train":
            tgt_idx = random.randrange(len(events))
        else:
            tgt_idx = random.Random(idx).randrange(len(events))

        sources = [self._maybe_resample(s) for s in events + [noise]]
        # pad to fixed count (2-3 speakers + noise) for collation
        while len(sources) < 4:
            sources.append(np.zeros_like(sources[0]))
        sources = np.stack(sources)
        tgt = sources[tgt_idx].copy()
        sources[tgt_idx] = sources[0]
        sources[0] = tgt

        inputs = {
            "mixture": self._maybe_resample(mixture).astype(np.float32),
            "sources": sources.astype(np.float32),
        }
        targets = {"target": tgt.astype(np.float32)}
        return inputs, targets
