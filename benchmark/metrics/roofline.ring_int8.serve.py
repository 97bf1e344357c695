"""The int8 ring step's share of its roofline in the serving step: the
least time of its launches in the trace (`work/ring_int8.py`, every
stream's row of a block) over their device time, found by the kernel's
name (a graph replay has no CPU range around each launch)."""

import math

KERNEL = ("ring_int8_step_kernel",)


def read(ctx):
    tr, cell = ctx["trace"], ctx["cell"]
    mp = cell.config["model_params"]
    if tr is None:
        return None
    times = tr.matching(KERNEL)
    if not times:
        return None
    f = (mp["stft_chunk_size"] + mp["stft_pad_size"]) // 2 + 1
    nh = mp["L"]
    elem = 2 if cell.traffic["dtype"] == "bfloat16" else 4
    w = ctx["work"]
    flops, nbytes = w("ring_int8").work(
        ctx["rows_per_step"], f, nh, math.ceil(512 / f), mp["D"] // nh,
        mp["local_atten_len"], elem)
    least = ctx["least_s"](flops, nbytes)
    return 100.0 * len(times) * least * 1e6 / sum(times)
