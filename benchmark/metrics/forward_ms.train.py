"""Device ms a training step of the kernels launched inside the
program's `train.forward` span (`zero_grad`, the model's forward and
the loss), by the trace's launch correlation."""

RANGE = "train.forward"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not any(name == RANGE for name, _, _ in tr.host):
        return None
    return tr.range_us(RANGE) / ctx["cell"].traffic["trace_steps"] / 1e3
