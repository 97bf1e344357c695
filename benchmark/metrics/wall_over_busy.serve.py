"""The window's wall time a step over the device's busy time a traced
step, in %: near 100 when the card runs the graph's kernels back to
back, above it by the gaps that each replay adds. A serving process
has read either about 99% or about 108% (PERF.md): this names which
of the two a run's `rt_streams` came from. The traced busy time holds
the tracer's own cost, about 1% a kernel, so the reading can fall a
little under 100."""


def read(ctx):
    tr, steps = ctx["trace"], ctx.get("steps")
    if tr is None or not steps:
        return None
    busy_s = tr.busy_us / 1e6 / ctx["cell"].traffic["trace_steps"]
    return 100.0 * ctx["window_s"] / steps / busy_s
