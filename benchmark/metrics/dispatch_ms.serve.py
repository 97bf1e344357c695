"""Host ms a serving step: the mean span of a `step_pipelined` call
that fetches an output, timed after the window on calls made once the
step they fetch has finished. So it holds the host's own work (the
input's copy into the pinned ring, the graph's launch, the output's
copy and event, the fetched output's conversion) and none of the wait
for the card, which a call in the window spends most of its time in."""


def read(ctx):
    spans = ctx.get("host_spans_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
