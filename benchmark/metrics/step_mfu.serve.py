"""The serving step's share of the card's peak: the model's operations
a step (`work/model_step.py`, one frame of every stream) times the
window's steps, over the window's seconds and the peak of the precision
the traffic states."""


def read(ctx):
    cell = ctx["cell"]
    ops = ctx["work"]("model_step").forward(
        cell.config["model_params"], 1, ctx["rows_per_step"])
    return 100.0 * ops * ctx["steps"] / ctx["window_s"] / cell.peak_flops
