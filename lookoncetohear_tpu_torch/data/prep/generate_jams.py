"""Scene specs for the three MixLibriSpeech splits (counterpart of
`lookoncetohear_tpu/data/prep/generate_jams.py`): 10k test / 5k dev /
100k train 5 s scenes, 2-3 speakers at snr U[15, 25] over WHAM! noise
at ref -25 dB, seeds 1 / 2 / 42. Run from the directory that holds
`data/MixLibriSpeech/`:

    python3 -m lookoncetohear_tpu_torch.data.prep.generate_jams \\
        [--only test-clean] [--num N]
"""

from __future__ import annotations

import argparse

from lookoncetohear_tpu_torch.data.scene import generate_scene_specs

DATASETS = [
    dict(foreground="data/MixLibriSpeech/librispeech_scaper_fmt/test-clean",
         background="data/MixLibriSpeech/wham_noise", bg_labels=["tt"],
         output_dir="data/MixLibriSpeech/jams/test-clean",
         num_soundscapes=10000, seed=1),
    dict(foreground="data/MixLibriSpeech/librispeech_scaper_fmt/dev-clean",
         background="data/MixLibriSpeech/wham_noise", bg_labels=["cv"],
         output_dir="data/MixLibriSpeech/jams/dev-clean",
         num_soundscapes=5000, seed=2),
    dict(foreground="data/MixLibriSpeech/"
                    "librispeech_scaper_fmt/train-clean-360",
         background="data/MixLibriSpeech/wham_noise", bg_labels=["tr"],
         output_dir="data/MixLibriSpeech/jams/train-clean-360",
         num_soundscapes=100000, seed=42),
]

COMMON = dict(num_events_min=2, num_events_max=3, duration=5.0,
              event_duration_min=5.0, event_duration_max=5.0,
              ref_db=-25.0, snr_min=15.0, snr_max=25.0, sr=16000)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", type=str, default=None,
                        help="substring filter on output_dir")
    parser.add_argument("--num", type=int, default=None,
                        help="override scene count (smoke runs)")
    args = parser.parse_args(argv)
    for spec in DATASETS:
        if args.only and args.only not in spec["output_dir"]:
            continue
        if args.num is not None:
            spec = dict(spec, num_soundscapes=args.num)
        print(f"Generating {spec['num_soundscapes']} scenes -> "
              f"{spec['output_dir']}")
        generate_scene_specs(**spec, **COMMON)


if __name__ == "__main__":
    main()
