"""The training recurrence's share of its roofline: the least time of
the traced steps' scans (`work/lstm_train.py`, each block's intra-
frequency BiLSTM over the batch's frames and its inter-time LSTM over
the batch's bins, forward and backward) over the device time of every
kernel launched inside the `BiLSTMScan` op's forward and backward
ranges, the product of dW_hh included, by the trace's launch
correlation."""

import math

RANGE = "BiLSTMScan"


def read(ctx):
    tr, cell = ctx["trace"], ctx["cell"]
    if tr is None:
        return None
    device_us = tr.range_us(RANGE)
    if not device_us:
        return None
    mp, traffic = cell.config["model_params"], cell.traffic
    f = (mp["stft_chunk_size"] + mp["stft_pad_size"]) // 2 + 1
    frames = math.ceil(traffic["seconds_audio"] * 16000
                       / mp["stft_chunk_size"])
    b, h = traffic["batch"], mp["H"]
    w = ctx["work"]
    least = 0.0
    for shape in ((f, 2, b * frames, h, False), (frames, 1, b * f, h, True)):
        least += ctx["least_s"](*w("lstm_train").work(*shape))
    steps = traffic["trace_steps"] * mp["B"]
    return 100.0 * steps * least * 1e6 / device_us
