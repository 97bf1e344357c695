"""The training step's share of the card's peak: 3 x the forward's
model operations a step (`work/model_step.py`, the batch's whole
utterances) times the window's steps, over the window's seconds and the
peak of the precision the traffic states."""

import math


def read(ctx):
    cell = ctx["cell"]
    mp, tr = cell.config["model_params"], cell.traffic
    frames = math.ceil(tr["seconds_audio"] * 16000 / mp["stft_chunk_size"])
    ops = 3 * ctx["work"]("model_step").forward(mp, frames, tr["batch"])
    return 100.0 * ops * ctx["steps"] / ctx["window_s"] / cell.peak_flops
