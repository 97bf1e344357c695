"""Cross-validation harness: the scaper-free renderer against real
scaper (counterpart of `lookoncetohear_tpu/data/scaper_crossval.py`).

The training distribution depends on `data/scene.py::render_scene`
matching `scaper.generate_from_jams`'s loudness semantics (background
at ref_db LUFS, each foreground event at ref_db + snr LUFS, BS.1770
integrated loudness):

* `self_consistency(scene_dir, ...)`: render with the port's renderer
  and measure every event stem with the BS.1770 meter
  (`data/loudness.py`); the achieved LUFS must hit the spec target.
  Runs anywhere.
* `against_scaper(scene_dir, ...)`: render the same jams with real
  scaper and compare per-event LUFS and waveforms. Raises ImportError
  where scaper is not installed; the CLI reports that as a skip.

CLI: python -m lookoncetohear_tpu_torch.data.scaper_crossval <scene_dir>
     [--fg_dir D] [--bg_dir D] [--tol_lufs 0.5]
Prints a JSON report; exit 1 on a mismatch beyond --tol_lufs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from lookoncetohear_tpu_torch.data.loudness import integrated_loudness
from lookoncetohear_tpu_torch.data.scene import render_scene


def _event_targets(scene):
    """Spec LUFS target per event, scaper semantics: background pinned
    to ref_db, each foreground at ref_db + its snr."""
    return [scene.ref_db + (0.0 if ev.role == "background" else ev.snr)
            for ev in scene.events]


def self_consistency(scene_dir: str, fg_dir: str | None = None,
                     bg_dir: str | None = None) -> dict:
    """Measure each rendered event stem's integrated loudness against
    its spec target. Returns {"events": [...], "max_abs_err_lufs": x}.
    """
    _, scene, _, event_audio = render_scene(scene_dir, fg_dir, bg_dir)
    targets = _event_targets(scene)
    rows, errs = [], []
    for ev, tgt, audio in zip(scene.events, targets, event_audio):
        got = integrated_loudness(audio, scene.sr)
        err = abs(got - tgt)
        errs.append(err)
        rows.append({"role": ev.role, "label": ev.label,
                     "target_lufs": tgt, "achieved_lufs": got,
                     "abs_err_lufs": err})
    return {"events": rows, "max_abs_err_lufs": float(max(errs))}


def against_scaper(scene_dir: str, fg_dir: str, bg_dir: str) -> dict:
    """Render the same jams with real scaper and with our renderer;
    compare per-event LUFS (both measured with OUR meter, so the
    comparison isolates the renderer) and waveform agreement.

    Raises ImportError when scaper is not installed; the CLI reports
    that as a skip.
    """
    import os

    import scaper  # noqa: F401  (hard requirement of this path)

    jams_path = os.path.join(scene_dir, "mixture.jams")
    mixture_ours, scene, _, events_ours = render_scene(
        scene_dir, fg_dir, bg_dir)
    _, _, _, events_ref = scaper.generate_from_jams(
        jams_path, fg_path=fg_dir, bg_path=bg_dir)

    rows = []
    for i, (ours, ref) in enumerate(zip(events_ours, events_ref)):
        ref = np.asarray(ref, np.float32).reshape(-1)[: len(ours)]
        l_ours = integrated_loudness(ours, scene.sr)
        l_ref = integrated_loudness(ref, scene.sr)
        denom = float(np.max(np.abs(ref)) + 1e-9)
        rows.append({
            "event": i,
            "lufs_ours": l_ours, "lufs_scaper": l_ref,
            "lufs_diff": abs(l_ours - l_ref),
            "max_rel_sample_diff":
                float(np.max(np.abs(ours[: len(ref)] - ref)) / denom),
        })
    return {"events": rows,
            "max_lufs_diff": max(r["lufs_diff"] for r in rows),
            "max_rel_sample_diff":
                max(r["max_rel_sample_diff"] for r in rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("scene_dir")
    p.add_argument("--fg_dir", default=None)
    p.add_argument("--bg_dir", default=None)
    p.add_argument("--tol_lufs", type=float, default=0.5)
    args = p.parse_args(argv)

    report = {"self_consistency": self_consistency(
        args.scene_dir, args.fg_dir, args.bg_dir)}
    try:
        report["against_scaper"] = against_scaper(
            args.scene_dir, args.fg_dir, args.bg_dir)
    except ImportError:
        report["against_scaper"] = "skipped: scaper not installed"

    print(json.dumps(report, indent=1))
    bad = report["self_consistency"]["max_abs_err_lufs"] > args.tol_lufs
    if isinstance(report["against_scaper"], dict):
        bad = bad or (report["against_scaper"]["max_lufs_diff"]
                      > args.tol_lufs)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
