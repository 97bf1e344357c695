"""TitaNet speaker-embedding precompute (counterpart of
`lookoncetohear_tpu/data/prep/nemo_embed.py`, same flags and output;
unused by the default configs): one `<speaker>.npz` per speaker under
`output_dir/<split>/`, mapping each utterance's file name to its
embedding. Needs the optional `nemo_toolkit` package and its
pretrained `titanet_large`. Runs on the GPU unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lookoncetohear_tpu_torch import resolve_device


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root_dir", type=str,
                        default="data/MixLibriSpeech/"
                                "librispeech_scaper_fmt")
    parser.add_argument("--output_dir", type=str,
                        default="data/MixLibriSpeech/"
                                "librispeech_titanet_embeddings")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    try:
        import nemo.collections.asr as nemo_asr
    except ImportError as e:
        raise ImportError(
            "nemo_embed needs the optional nemo_toolkit package "
            "(titanet_large); the default pipeline uses "
            "dvector_embeddings instead") from e

    model = nemo_asr.models.EncDecSpeakerLabelModel.from_pretrained(
        "titanet_large").to(device)
    model.eval()

    for dset in sorted(os.listdir(args.root_dir)):
        out_dset = os.path.join(args.output_dir, dset)
        if os.path.exists(out_dset):
            raise FileExistsError(f"{out_dset} exists")
        os.makedirs(out_dset)
        for speaker in sorted(os.listdir(
                os.path.join(args.root_dir, dset))):
            embs = {}
            spk_dir = os.path.join(args.root_dir, dset, speaker)
            for audio in sorted(os.listdir(spk_dir)):
                emb = model.get_embedding(os.path.join(spk_dir, audio))
                embs[audio] = np.asarray(emb.squeeze().cpu())
            np.savez(os.path.join(out_dset, speaker) + ".npz", **embs)


if __name__ == "__main__":
    main()
