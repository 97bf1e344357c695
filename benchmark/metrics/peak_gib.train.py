"""The card's allocated memory at its peak over the training window
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`), in
GiB."""


def read(ctx):
    peak = ctx.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
