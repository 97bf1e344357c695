"""Share of the traced steps' span (first kernel's start to last
kernel's end) in which no kernel ran on the card. The training cells'
`device_idle.train` reads it the same way."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else 100.0 * (1 - tr.busy_us / tr.window_us)
