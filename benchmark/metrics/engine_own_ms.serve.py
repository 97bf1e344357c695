"""Host ms of the engine's own work in a serving call, measured inside
the program: the mean, over the traced `engine.step` spans that hold an
`engine.fetch`, of the span's duration less the `engine.input_wait` and
`engine.fetch_wait` spans inside it (the host waiting for the card).
So it holds the input's copy into the pinned ring, the mask's upload,
the graph's launch, the output's staging and the fetched output's
conversion."""

WAITS = ("engine.input_wait", "engine.fetch_wait")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    steps = [(s, e) for name, s, e in tr.host if name == "engine.step"]
    fetches = [(s, e) for name, s, e in tr.host if name == "engine.fetch"]
    waits = [(s, e) for name, s, e in tr.host if name in WAITS]
    own = []
    for s, e in steps:
        if any(s <= fs and fe <= e for fs, fe in fetches):
            own.append((e - s) - sum(we - ws for ws, we in waits
                                     if s <= ws and we <= e))
    return sum(own) / len(own) / 1e3 if own else None
