"""Host ms of a graph launch: the mean duration of the traced
`engine.replay` spans (`CUDAGraph.replay`)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    spans = [e - s for name, s, e in tr.host if name == "engine.replay"]
    return sum(spans) / len(spans) / 1e3 if spans else None
