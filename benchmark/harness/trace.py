"""Device time from a `torch.profiler` trace of a few steps: busy and idle
time, kernel time by name, the kernels launched inside a CPU range
(such as `BiLSTMScan`'s forward and `BiLSTMScanBackward`), and the
idle gaps named by what the host was doing.

The arithmetic follows `chip_smoke.py::profile_steps` (merged kernel
intervals over the span from the first kernel's start to the last
one's end). Some hosts' tracers drop a record of a cluster-launched
kernel (PERF.md); a dropped record lowers the busy time and the
time of its kernel a little, and the rooflines count their least time
over the records that came, so a lost record leaves a share as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# the prefix of the benchmark's own host ranges (`record_function`)
HOST_RANGE = "bench."


@dataclass
class Trace:
    """kernels: [(name, start_us, end_us)]; launches: [(names of the
    CPU op that launched kernels and of every range around it, device
    us of those kernels)]; host: [(name, start_us, end_us)] of the
    host's ranges, to name the idle gaps."""
    kernels: list
    launches: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_us(self) -> float:
        return max(e for _, _, e in self.kernels) - \
            min(s for _, s, _ in self.kernels)

    def busy_intervals(self) -> list:
        spans = sorted((s, e) for _, s, e in self.kernels)
        merged = [list(spans[0])]
        for s, e in spans[1:]:
            if s > merged[-1][1]:
                merged.append([s, e])
            else:
                merged[-1][1] = max(merged[-1][1], e)
        return merged

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def by_name(self) -> dict:
        out: dict = {}
        for name, s, e in self.kernels:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def matching(self, parts) -> list:
        """Durations (us) of the kernels whose name holds every string
        of `parts`."""
        return [e - s for name, s, e in self.kernels
                if all(p in name for p in parts)]

    def range_us(self, key: str) -> float:
        """Device us of the kernels launched inside CPU ranges whose
        name holds `key`, their nested ops included."""
        return sum(us for names, us in self.launches
                   if any(key in n for n in names))

    def idle_gaps(self) -> dict:
        """{host range: us of device idle time}: each gap between busy
        intervals is named by the innermost host range that covers its
        middle ("no host range" where none does)."""
        out: dict = {}
        busy = self.busy_intervals()
        host = sorted((s, e, name) for name, s, e in self.host)
        active, i = [], 0
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = max(active)[2] if active else "no host range"
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v / 1e6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(self.by_name()),
                "idle_gaps": top(self.idle_gaps())}


def capture(run_steps) -> Trace:
    """Trace `run_steps()` (which ends in a device sync) on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # a `record_function` range also shows on the device's timeline, as
    # one event over all it enqueued: no operation of the device
    kernels = [(ev.name, ev.time_range.start, ev.time_range.end)
               for ev in events if ev.device_type == cuda
               and not getattr(ev, "is_user_annotation", False)
               and not ev.name.startswith(HOST_RANGE)]
    if not kernels:
        raise RuntimeError("the profiler recorded no device operation")
    host, launches = [], []
    for ev in events:
        if ev.device_type == cuda:
            continue
        host.append((ev.name, ev.time_range.start, ev.time_range.end))
        launched = sum(k.duration for k in ev.kernels)
        if launched:
            names, node = [], ev
            while node is not None:
                names.append(node.name)
                node = node.cpu_parent
            launches.append((tuple(names), launched))
    return Trace(kernels, launches, host)
