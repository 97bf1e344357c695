"""The offline call's share of the card's peak: the model's operations
of every call of the window (`work/embed_forward.py` at each call's
clip length and batch), over the window's seconds and the peak of the
precision the traffic states."""


def read(ctx):
    cell = ctx["cell"]
    forward = ctx["work"]("embed_forward").forward
    mp = cell.config["model_params"]
    rows = ctx["rows_per_step"]
    ops = sum(forward(mp, n, rows) for n in ctx["window_samples"])
    return 100.0 * ops / ctx["window_s"] / cell.peak_flops
