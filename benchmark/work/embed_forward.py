"""The enrollment network's model operations (`EmbedNet` ->
`EmbedTFGridNet`, one utterance a row): every product, 2 per
multiply-add, from the configuration's shapes and the utterance's
length: the STFT (as the windowed DFT's product), the input conv, each
block's LSTM input projections and recurrent products in both
directions, its two ConvTranspose1d, the 1x1 head convs of Q, K, V and
of the concatenation, the T x T scores and weighted sum, and the
d-vector's projection. Norms, activations, softmax, the LSTM's cell
updates and copies are not counted (as `model_step.py`), nor is any
product an implementation adds."""

import math

# EmbedTFGridNet's constructor: channels, LSTM units, heads,
# approx_qk_dim, the unfold's kernel
from benchmark.reference.offline_tfgridnet import (
    CHANNELS, HEADS, HIDDEN, KERNEL, QK_DIM, frames)


def forward(mp: dict, samples: int, rows: int = 1) -> float:
    """Operations of one call on `rows` utterances of `samples`
    samples."""
    nfft, m = mp["n_fft"], mp["num_ch"]
    f, t = nfft // 2 + 1, frames(mp, samples)
    c, h, k = CHANNELS, HIDDEN, KERNEL
    e, vd = math.ceil(QK_DIM / f), c // HEADS
    ops = 2 * m * nfft * 2 * f * t                   # STFT
    ops += 2 * (2 * m * 9) * c * t * f               # conv
    # row-steps of one direction: intra over F-k+1 bins of each frame,
    # inter over T-k+1 frames of each bin
    steps = t * (f - k + 1) + f * (t - k + 1)
    block = 2 * 2 * steps * (c * k + h) * 4 * h      # BiLSTMs
    block += 2 * steps * 2 * h * c * k               # ConvTranspose1d
    block += 2 * t * f * c * (HEADS * (2 * e + vd) + c)   # head convs
    block += 2 * HEADS * t * t * f * (e + vd)        # scores, weighted sum
    ops += mp["num_blocks"] * block
    ops += 2 * t * c * f * mp["embed_dim"]           # d-vector projection
    return float(rows * ops)
