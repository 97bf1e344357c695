"""Target speech hearing end to end, without a corpus (counterpart of
`examples/stream_demo.py`).

Builds a synthetic binaural scene (the synthetic test split's first
item: a target and an interfering voice in pink noise), enrolls the
target with the enrollment net, then extracts it with the streaming
engine 8 ms at a time. Writes the mixture, target and extracted wavs
and prints the SI-SNR improvement.

    python3 -m lookoncetohear_tpu_torch.stream_demo [--out_dir demo_out] \\
        [--tse_ckpt checkpoints/tsh_r5_5k_best.npz \\
         --embed_ckpt checkpoints/embed_r5_5k_best.npz] [--device cpu]

Checkpoints are the `p//` npz files (`weights.load_checkpoint`); without
them the networks run with seeded random weights, which exercises the
whole pipeline (enroll -> stream -> overlap-add) and reports a
near-zero or negative SI-SNRi.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from lookoncetohear_tpu_torch import resolve_device
from lookoncetohear_tpu_torch.data import audio_io
from lookoncetohear_tpu_torch.data.synthetic import SyntheticTSEDataset
from lookoncetohear_tpu_torch.losses import si_snr
from lookoncetohear_tpu_torch.models.net import EmbedNet, Net
from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
from lookoncetohear_tpu_torch.weights import load_checkpoint

SR = 16000
# the committed checkpoints' models (configs/tsh_synthetic_5k.json,
# configs/embed_synthetic_5k.json)
TSE_PARAMS = dict(embed_dim=256, stft_chunk_size=128, stft_pad_size=64,
                  num_ch=2, D=64, L=4, B=3, H=64, local_atten_len=50,
                  use_attn=True, lookahead=True, chunk_causal=True)
EMBED_PARAMS = dict(embed_dim=256, num_ch=2, n_fft=128, stride=64,
                    num_blocks=3)


def run(argv=None) -> dict:
    """The demo; returns the input and output SI-SNR (dB), the SI-SNRi
    and the extracted audio [2, N]."""
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--tse_ckpt", default=None)
    p.add_argument("--embed_ckpt", default=None)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    inputs, targets = SyntheticTSEDataset(
        dset="test", n_samples=1, duration=args.seconds)[0]
    mixture = inputs["mixture"]                     # [2, N]
    enroll = inputs["enrollments"][0]               # [2, N]
    target = targets["target"]

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        tse = Net(**TSE_PARAMS, device="cpu")
        emb_net = EmbedNet(**EMBED_PARAMS, device="cpu")
    if args.tse_ckpt:
        load_checkpoint(tse, args.tse_ckpt)
    if args.embed_ckpt:
        load_checkpoint(emb_net, args.embed_ckpt)

    with torch.no_grad():
        # 1. look once: enroll the target speaker
        embedding = emb_net.to(dev).eval()(
            torch.from_numpy(enroll[None]).to(dev))[0].cpu().numpy()
        print("enrolled; embedding norm", float(np.linalg.norm(embedding)))

        # 2. hear: stream the mixture 8 ms at a time
        engine = StreamingEngine(tse, max_streams=1, device=dev)
        engine.add_stream(0, embedding)
        chunk = TSE_PARAMS["stft_chunk_size"]
        n = mixture.shape[-1] - mixture.shape[-1] % chunk
        est = np.concatenate([
            engine.step(mixture[None, :, i:i + chunk])[0].cpu().numpy()
            for i in range(0, n, chunk)], axis=-1)

    # the engine emits each chunk one step late (it waits for the next
    # chunk's lookahead): align before scoring
    est_al = est[:, chunk:]
    m = est_al.shape[-1]
    tgt_al, mix_al = target[:, :m], mixture[:, :m]

    def score(x):
        return float(si_snr(torch.from_numpy(np.ascontiguousarray(x)),
                            torch.from_numpy(tgt_al)).mean())
    s_in, s_out = score(mix_al), score(est_al)
    print(f"input SI-SNR : {s_in:.2f} dB")
    print(f"output SI-SNR: {s_out:.2f} dB")
    print(f"SI-SNRi      : {s_out - s_in:.2f} dB")
    for name, a in (("mixture", mixture), ("target", target),
                    ("extracted", est)):
        audio_io.write_wav(os.path.join(args.out_dir, f"{name}.wav"),
                           a.astype(np.float32), SR)
    print("wavs written to", args.out_dir)
    return {"si_snr_in": s_in, "si_snr_out": s_out,
            "si_snr_i": s_out - s_in, "extracted": est}


if __name__ == "__main__":
    run()
