"""Host ms a training step inside the program's `train.clip` and
`train.optimizer` spans. Against `update_ms.train` (the device time of
their kernels) it says whether the update is bound by its launches."""

RANGES = ("train.clip", "train.optimizer")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    spans = [e - s for name, s, e in tr.host if name in RANGES]
    if not spans:
        return None
    return sum(spans) / ctx["cell"].traffic["trace_steps"] / 1e3
