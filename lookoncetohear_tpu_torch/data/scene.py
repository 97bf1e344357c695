"""Scene specs and their renderer, the scaper replacement (counterpart
of `lookoncetohear_tpu/data/scene.py`).

* `generate_scene_specs` writes one spec per scene: a background file
  and 2-3 distinct speakers, each a 5 s event at snr U[snr_min,
  snr_max] relative to ref_db, seeded.
* `render_scene` re-renders a spec's audio as scaper.generate_from_jams
  does: every source is sliced, loudness-measured (BS.1770,
  `loudness.py`) and gained so the background sits at `ref_db` LUFS and
  each event at `ref_db + snr`.

A spec is JAMS JSON (namespace "scaper"), so scaper's specs and the JAX
package's parse here and the other way round; a sidecar `mixture.txt`
(onset / offset / label, tab-separated) is written as scaper does,
because the datasets read their speaker map from it.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field

import numpy as np

from lookoncetohear_tpu_torch.data import audio_io
from lookoncetohear_tpu_torch.data.loudness import gain_to_target


@dataclass
class Event:
    role: str  # 'background' | 'foreground'
    label: str
    source_file: str
    source_time: float = 0.0
    event_time: float = 0.0
    event_duration: float = 5.0
    snr: float = 0.0


@dataclass
class Scene:
    duration: float
    sr: int
    ref_db: float
    events: list = field(default_factory=list)  # [bg, fg1, fg2, ...]


def _jams_obs(ev: Event):
    return {
        "time": ev.event_time,
        "duration": ev.event_duration,
        "confidence": 1.0,
        "value": {
            "label": ev.label, "source_file": ev.source_file,
            "source_time": ev.source_time, "event_time": ev.event_time,
            "event_duration": ev.event_duration, "snr": ev.snr,
            "role": ev.role, "pitch_shift": None, "time_stretch": None,
        },
    }


def save_scene(scene: Scene, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    jams = {
        "annotations": [{
            "namespace": "scaper",
            "data": [_jams_obs(e) for e in scene.events],
            "sandbox": {"scaper": {
                "duration": scene.duration, "sr": scene.sr,
                "ref_db": scene.ref_db,
            }},
        }],
        "file_metadata": {"duration": scene.duration},
    }
    with open(os.path.join(out_dir, "mixture.jams"), "w") as f:
        json.dump(jams, f, indent=1)
    with open(os.path.join(out_dir, "mixture.txt"), "w") as f:
        for e in scene.events:
            if e.role == "foreground":
                f.write(f"{e.event_time}\t{e.event_time + e.event_duration}"
                        f"\t{e.label}\n")


def load_scene(scene_dir: str) -> Scene:
    """Parse mixture.jams (ours or real scaper's)."""
    with open(os.path.join(scene_dir, "mixture.jams")) as f:
        jams = json.load(f)
    ann = jams["annotations"][0]
    sandbox = ann.get("sandbox", {}).get("scaper", {})
    scene = Scene(
        duration=float(sandbox.get("duration", 5.0)),
        sr=int(sandbox.get("sr", 16000)),
        ref_db=float(sandbox.get("ref_db", -25.0)))
    for obs in ann["data"]:
        v = obs["value"]
        scene.events.append(Event(
            role=v["role"], label=str(v["label"]),
            source_file=v["source_file"],
            source_time=float(v.get("source_time", 0.0) or 0.0),
            event_time=float(v.get("event_time", 0.0) or 0.0),
            event_duration=float(v["event_duration"]),
            snr=float(v.get("snr", 0.0) or 0.0)))
    # background first, like scaper's annotation ordering
    scene.events.sort(key=lambda e: 0 if e.role == "background" else 1)
    return scene


def _load_slice(path: str, sr: int, t0: float, dur: float) -> np.ndarray:
    audio, file_sr = audio_io.read_audio(path)
    audio = audio.mean(axis=0)  # mono
    audio = audio_io.resample(audio, file_sr, sr)
    i0 = int(round(t0 * sr))
    n = int(round(dur * sr))
    clip = audio[i0:i0 + n]
    if len(clip) < n:  # tile short sources (scaper loops backgrounds)
        reps = -(-n // max(len(clip), 1))
        clip = np.tile(clip, reps)[:n]
    return clip.astype(np.float32)


def render_scene(scene_dir: str, fg_dir: str | None = None,
                 bg_dir: str | None = None):
    """Re-render a scene spec -> (mixture [N], scene, ann_list,
    event_audio), scaper.generate_from_jams's contract as the datasets
    read it: event_audio[0] is the background, then one mono array per
    event; ann_list rows are [onset, offset, label]. fg_dir / bg_dir
    re-root the stored source paths when the data moved."""
    scene = load_scene(scene_dir)
    sr, n = scene.sr, int(round(scene.duration * scene.sr))
    event_audio, ann_list = [], []
    for ev in scene.events:
        path = ev.source_file
        if not os.path.isabs(path) or not os.path.exists(path):
            root = bg_dir if ev.role == "background" else fg_dir
            if root is not None:
                # stored paths look like <root>/<label>/<file>; rebase
                # onto the provided root at the label component.
                parts = path.replace("\\", "/").split("/")
                if ev.label in parts:
                    path = os.path.join(root,
                                        *parts[parts.index(ev.label):])
                else:
                    path = os.path.join(root, os.path.basename(path))
        dur = scene.duration if ev.role == "background" \
            else ev.event_duration
        clip = _load_slice(path, sr, ev.source_time, dur)
        target_lufs = scene.ref_db + (0.0 if ev.role == "background"
                                      else ev.snr)
        clip = clip * gain_to_target(clip, sr, target_lufs)
        buf = np.zeros(n, np.float32)
        off = 0 if ev.role == "background" else int(round(ev.event_time
                                                          * sr))
        m = min(len(clip), n - off)
        buf[off:off + m] = clip[:m]
        event_audio.append(buf)
        if ev.role == "foreground":
            ann_list.append([ev.event_time,
                             ev.event_time + ev.event_duration, ev.label])
    mixture = np.sum(event_audio, axis=0)
    return mixture, scene, ann_list, event_audio


def generate_scene_specs(
        foreground: str, background: str, output_dir: str,
        num_soundscapes: int, seed: int, bg_labels=None,
        num_events_min: int = 2, num_events_max: int = 3,
        duration: float = 5.0, event_duration_min: float = 5.0,
        event_duration_max: float = 5.0, ref_db: float = -25.0,
        snr_min: float = 15.0, snr_max: float = 25.0,
        sr: int = 16000) -> None:
    """Per scene, a background file and 2-3 distinct speakers, each a
    5 s event at snr ~ U[snr_min, snr_max]."""
    rng = random.Random(seed)
    np_rng = np.random.default_rng(seed)

    fg_labels = sorted(
        d for d in os.listdir(foreground)
        if os.path.isdir(os.path.join(foreground, d)))
    if bg_labels is None:
        bg_labels = sorted(
            d for d in os.listdir(background)
            if os.path.isdir(os.path.join(background, d)))
    fg_files = {
        lab: sorted(os.listdir(os.path.join(foreground, lab)))
        for lab in fg_labels}
    bg_files = {
        lab: sorted(os.listdir(os.path.join(background, lab)))
        for lab in bg_labels}

    for i in range(num_soundscapes):
        scene = Scene(duration=duration, sr=sr, ref_db=ref_db)
        bg_lab = rng.choice(bg_labels)
        scene.events.append(Event(
            role="background", label=bg_lab,
            source_file=os.path.join(background, bg_lab,
                                     rng.choice(bg_files[bg_lab])),
            event_duration=duration))
        n_events = int(np_rng.integers(num_events_min, num_events_max + 1))
        labs = rng.sample(fg_labels, k=min(n_events, len(fg_labels)))
        for lab in labs:
            edur = rng.uniform(event_duration_min, event_duration_max)
            etime = min(rng.uniform(0.0, 1.0), max(duration - edur, 0.0))
            scene.events.append(Event(
                role="foreground", label=lab,
                source_file=os.path.join(foreground, lab,
                                         rng.choice(fg_files[lab])),
                event_time=etime, event_duration=edur,
                snr=rng.uniform(snr_min, snr_max)))
        save_scene(scene, os.path.join(output_dir, "%08d" % i))
