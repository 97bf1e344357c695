"""Share of the traced steps' span (first kernel's start to last
kernel's end, as `device_idle.serve`) in which no kernel ran while the
host was inside `engine.input_wait` or `engine.fetch_wait`: the card
idle with work already queued, such as gaps between a graph's kernels.
`device_idle.serve` less this is the idle the host caused, by not
having queued the next replay yet."""

WAITS = ("engine.input_wait", "engine.fetch_wait")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    waits = []
    for s, e in sorted((s, e) for name, s, e in tr.host if name in WAITS):
        if waits and s <= waits[-1][1]:
            waits[-1][1] = max(waits[-1][1], e)
        else:
            waits.append([s, e])
    if not waits:
        return None
    busy = tr.busy_intervals()
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])]
    # both lists are sorted and neither overlaps itself: one sweep
    pending, i = 0.0, 0
    for s, e in waits:
        while i < len(gaps) and gaps[i][1] <= s:
            i += 1
        j = i
        while j < len(gaps) and gaps[j][0] < e:
            pending += max(0.0, min(e, gaps[j][1]) - max(s, gaps[j][0]))
            j += 1
    return 100.0 * pending / tr.window_us
