"""Device ms a training step of the kernels launched inside the
program's `train.clip` and `train.optimizer` spans (the clip by global
norm and Adam), by the trace's launch correlation."""

RANGES = ("train.clip", "train.optimizer")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not any(name in RANGES for name, _, _ in tr.host):
        return None
    return sum(tr.range_us(r) for r in RANGES) \
        / ctx["cell"].traffic["trace_steps"] / 1e3
