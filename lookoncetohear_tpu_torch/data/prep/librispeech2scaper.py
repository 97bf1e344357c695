"""LibriSpeech -> the scaper layout, as a farm of symlinks (counterpart
of `lookoncetohear_tpu/data/prep/librispeech2scaper.py`):
`<root>/LibriSpeech/<subset>/<speaker>/<chapter>/*.flac` ->
`<root>/librispeech_scaper_fmt/<subset>/<speaker>/*.flac`.

    python3 -m lookoncetohear_tpu_torch.data.prep.librispeech2scaper \\
        [--root_dir data/MixLibriSpeech]
"""

from __future__ import annotations

import argparse
import os


def convert(root_dir: str, dsets=None) -> None:
    if dsets is None:
        dsets = ["train-clean-100", "train-clean-360", "dev-clean",
                 "test-clean"]
    for dset in dsets:
        dset_dir = os.path.join("LibriSpeech", dset)
        src_root = os.path.join(root_dir, dset_dir)
        if not os.path.isdir(src_root):
            print(f"skipping missing subset {dset}")
            continue
        print(f"Processing {dset}...")
        for speaker in sorted(os.listdir(src_root)):
            out_dir = os.path.join(root_dir, "librispeech_scaper_fmt",
                                   dset, speaker)
            assert not os.path.exists(out_dir), \
                f"Output directory already exists: {out_dir}"
            os.makedirs(out_dir)
            speaker_dir = os.path.join(dset_dir, speaker)
            for chapter in sorted(os.listdir(
                    os.path.join(root_dir, speaker_dir))):
                chapter_dir = os.path.join(speaker_dir, chapter)
                for audio in sorted(os.listdir(
                        os.path.join(root_dir, chapter_dir))):
                    if not audio.endswith(".flac"):
                        continue
                    rel = os.path.join("..", "..", "..", chapter_dir,
                                       audio)
                    os.symlink(rel, os.path.join(out_dir, audio))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str,
                        default="data/MixLibriSpeech")
    convert(parser.parse_args(argv).root_dir)


if __name__ == "__main__":
    main()
