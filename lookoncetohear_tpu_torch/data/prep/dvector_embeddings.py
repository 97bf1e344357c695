"""Per-utterance speaker d-vector precompute (counterpart of
`lookoncetohear_tpu/data/prep/dvector_embeddings.py`, same flags and
output): walks `root_dir/<split>/<speaker>/<utterance>` in sorted order
and writes one `<speaker>.npz` (and `.pt`, a `torch.save` of the same
numpy arrays) per speaker under `output_dir/<split>/`, mapping each
utterance's file name to its embedding. These are the files the
datasets' `embed_dir` reads (`data/datasets.py:_load_embedding_map`).

    python3 -m lookoncetohear_tpu_torch.data.prep.dvector_embeddings \\
        --backend embednet --embednet_config configs/embed_synthetic_5k.json \\
        --embednet_run_dir RUN --root_dir ROOT --output_dir OUT [--device cpu]

Backends:
  resemblyzer — resemblyzer's pretrained `VoiceEncoder` (the optional
      `resemblyzer` package and its weights);
  embednet    — the enrollment net of `--embednet_config` with the
      weights of `--embednet_run_dir/best.ckpt` (a `p//` npz or a
      reference Lightning checkpoint), mono audio duplicated to both
      ears, one utterance a call.
Runs on the GPU unless `--device cpu`. An output split directory that
exists is refused.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lookoncetohear_tpu_torch import resolve_device, utils
from lookoncetohear_tpu_torch.data import audio_io


def _save(embs: dict, out_base: str) -> None:
    np.savez(out_base + ".npz", **embs)
    torch.save({k: np.asarray(v) for k, v in embs.items()}, out_base + ".pt")


def _resemblyzer_encoder(device):
    try:
        from resemblyzer import VoiceEncoder, preprocess_wav
    except ImportError as e:
        raise ImportError(
            "backend 'resemblyzer' needs the optional resemblyzer "
            "package (pretrained VoiceEncoder); use --backend embednet "
            "with a trained enrollment checkpoint instead") from e
    enc = VoiceEncoder(device=device)

    def embed(path: str) -> np.ndarray:
        return enc.embed_utterance(preprocess_wav(path))
    return embed


def _embednet_encoder(config: str, run_dir: str, sr: int = 16000,
                      device=None):
    from lookoncetohear_tpu_torch.ts_hear_test import load_model
    model = load_model(utils.Params(config), run_dir, None, device)

    @torch.no_grad()
    def embed(path: str) -> np.ndarray:
        audio, file_sr = audio_io.read_audio(path)
        audio = audio_io.resample(audio.mean(0), file_sr, sr)
        x = torch.from_numpy(np.stack([audio, audio])[None]).to(device)
        with utils.full_float32():
            return model(x)[0].cpu().numpy()
    return embed


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str,
                        default="data/MixLibriSpeech/"
                                "librispeech_scaper_fmt")
    parser.add_argument("--output_dir", type=str,
                        default="data/MixLibriSpeech/"
                                "librispeech_dvector_embeddings")
    parser.add_argument("--backend", type=str, default="resemblyzer",
                        choices=["resemblyzer", "embednet"])
    parser.add_argument("--embednet_config", type=str, default=None)
    parser.add_argument("--embednet_run_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card; 'cpu' runs "
                             "the plain versions of the kernels)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.backend == "resemblyzer":
        embed = _resemblyzer_encoder(device)
    else:
        embed = _embednet_encoder(args.embednet_config,
                                  args.embednet_run_dir, device=device)

    for dset in sorted(os.listdir(args.root_dir)):
        out_dset = os.path.join(args.output_dir, dset)
        if os.path.exists(out_dset):
            raise FileExistsError(f"{out_dset} exists")
        os.makedirs(out_dset)
        print(f"Processing {dset}...")
        for speaker in sorted(os.listdir(
                os.path.join(args.root_dir, dset))):
            embs = {}
            spk_dir = os.path.join(args.root_dir, dset, speaker)
            for audio in sorted(os.listdir(spk_dir)):
                embs[audio] = embed(os.path.join(spk_dir, audio))
            _save(embs, os.path.join(out_dset, speaker))


if __name__ == "__main__":
    main()
