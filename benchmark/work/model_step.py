"""The separator's model operations (`Net` -> `StreamingTFGridNet`):
every product of the model, 2 per multiply-add, from the configuration's
shapes: the STFT filterbank, the input conv, the d-vector projection,
each block's LSTM input projections and recurrent products, its two
linears and, with attention heads, the Q/K/V projections, the scores
and weighted sum over w frames and the output projection; the deconv
and the synthesis filterbank. Norms, activations, softmax and copies
are not counted; nor is any product an implementation adds (the flat
LayerNorms' statistics as GEMMs, a split of a product)."""

import math


def per_frame(mp: dict) -> float:
    """Operations of one frame of one stream, the projection of the
    d-vector left out."""
    hop = mp["stft_chunk_size"]
    nfft = hop + mp["stft_pad_size"]
    f = nfft // 2 + 1
    m, c, h, s = mp["num_ch"], mp["D"], mp["H"], mp.get("num_src", 2)
    nh = mp["L"] if mp["use_attn"] else 0
    w = mp["local_atten_len"]
    ops = 2 * m * nfft * 2 * f                       # analysis
    ops += 2 * (2 * m * 9) * c * f                   # conv
    block = 2 * 2 * f * (c + h) * 4 * h              # intra BiLSTM
    block += 2 * f * 2 * h * c                       # intra linear
    block += 2 * f * (c + h) * 4 * h                 # inter LSTM
    block += 2 * f * h * c                           # inter linear
    if nh:
        e, vd = math.ceil(512 / f), c // nh
        block += 2 * f * c * nh * (2 * e + vd)       # Q, K, V
        block += 2 * nh * w * f * (e + vd)           # scores, weighted sum
        block += 2 * f * nh * vd * c                 # output projection
    ops += mp["B"] * block
    ops += 2 * (c * 9) * 2 * s * f                   # deconv
    ops += 2 * s * 2 * f * nfft                      # synthesis
    return float(ops)


def per_call(mp: dict) -> float:
    """Operations of the d-vector's projection, once a call and row."""
    hop = mp["stft_chunk_size"]
    f = (hop + mp["stft_pad_size"]) // 2 + 1
    return float(2 * mp["embed_dim"] * mp["D"] * f)


def forward(mp: dict, frames: int, rows: int) -> float:
    """Operations of one forward over `frames` frames of `rows` streams
    or utterances (a serving step: frames = 1)."""
    return rows * (frames * per_frame(mp) + per_call(mp))
