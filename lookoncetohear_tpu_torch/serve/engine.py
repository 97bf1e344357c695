"""Multi-stream real-time serving engine (counterpart of
`lookoncetohear_tpu/serve/engine.py`).

N concurrent binaural streams ride the leading batch dimension of one
model step. The engine owns the per-stream speaker embeddings, the
model's streaming state (each leaf one tensor for the engine's life,
written in place), the previous chunk of every stream (each analysis
window is [previous chunk ; new chunk[:pad]]), and the active and
primed masks. Attaching a stream zeroes exactly its state slice.

A slot is primed once its tail holds a real chunk: before that its
window is a bogus [zeros ; chunk] pre-frame that must not touch its
state, so unprimed slots keep their old state and output zeros. The
ring cursor `pos` is one scalar shared by every stream and always
advances. The K/V ring is kept in the compute dtype by default, or as
int8 with `kv_dtype=torch.int8`; a step writes slot `pos` of every
row of it in place, so the engine puts back that slot of unprimed
rows.

On the card the step is a CUDA graph (the counterpart of the JAX
engine's `jax.jit(_step_core)`): one replay per step instead of a few
hundred eager launches. Two graphs are captured at their first use,
one for the all-primed step and one for the masked step; the host only
picks between them. A graph reads and writes static buffers only: the
chunk input, `embeds`, `input_tail`, the primed mask (uploaded when it
changes), every state leaf, and its output. Write those in place
(`add_stream` does); replacing a tensor of `state` leaves the graphs
on the old one. `cuda_graph=False` runs the same step eagerly, op by
op: the kernels' launch counters count only eager calls (a replay runs
no Python), and a profile then shows each op's launch. On the CPU the
step is always eager.

Under a `torch.profiler` session the engine records its spans
(`profiling.span`): `engine.step` around each call, and inside it
`engine.input` (> `engine.input_wait`, the wait for a pinned buffer),
`engine.mask`, `engine.replay` or `engine.eager_step`,
`engine.stage_out` and `engine.fetch` (> `engine.fetch_wait`).

`MultiDeviceEngine` stands for the JAX engine's `mesh=` path: one
engine per device (`devices=`), each over its slice of the streams,
stepped in lockstep with no collectives, since streams are independent.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from lookoncetohear_tpu_torch import resolve_device
from lookoncetohear_tpu_torch.models.streaming_tfgridnet import \
    ring_slot_leaves
from lookoncetohear_tpu_torch.profiling import span

# eager steps before a capture: they load the kernels' library, set the
# kernels' shared-memory attributes, allocate the int8 ring's arrival
# counters and pick cuBLAS/cuDNN algorithms, none of which a capture
# may do
WARMUP_STEPS = 2


def _batch_major(x: torch.Tensor, n: int) -> bool:
    return x.ndim > 0 and x.shape[0] == n


class StreamingEngine:
    def __init__(self, model, params=None, max_streams: int = 64,
                 dtype=torch.float32, kv_dtype=None, device=None,
                 cuda_graph: bool = True):
        """model: a `Net`; params: an optional state_dict loaded into a
        copy of it. The copy runs on `device` ("cuda" by default) with
        params and activations in `dtype`; the K/V ring is stored in
        `kv_dtype` (None: `dtype`; torch.int8: the int8 serving ring
        with float32 scales). On the card the step replays a CUDA graph
        unless cuda_graph=False."""
        self.device = resolve_device(device)
        self.model = copy.deepcopy(model)
        if params is not None:
            self.model.load_state_dict(params)
        self.model.to(device=self.device, dtype=dtype).eval()
        self.n = max_streams
        self.dtype = dtype
        self.chunk = model.stft_chunk_size
        self.nfft = model.nfft
        self.n_mics = model.num_ch
        self.embed_dim = model.embed_dim
        if self.nfft - self.chunk > self.chunk:
            raise ValueError("lookahead pad must not exceed the chunk size")
        self.state = self.model.init_state(max_streams, dtype, kv_dtype)

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)
        self.input_tail = zeros(max_streams, self.n_mics, self.chunk)
        self.embeds = zeros(max_streams, self.embed_dim)
        self.active = np.zeros(max_streams, bool)
        self.primed = np.zeros(max_streams, bool)
        # the step's static inputs: this step's chunks, the primed mask
        self._x_in = zeros(max_streams, self.n_mics, self.chunk)
        self._primed_dev = zeros(max_streams, dt=torch.bool)
        self._primed_host = np.zeros(max_streams, bool)
        self.cuda_graph = cuda_graph and self.device.type == "cuda"
        self._graphs: dict = {}         # all_primed -> (graph, static y)
        self._pinned_in = []            # [(host buffer, event)]
        self._pipeline: list = []       # in flight: (host buffer, event)
        self._pinned_out: list = []     # free host output buffers

    # -- stream management -------------------------------------------------

    def _carried(self):
        """Every tensor a step carries to the next one."""
        return [self.input_tail] + [tree[k] for tree, k in
                                    _leaves(self.state)]

    def add_stream(self, slot: int, embedding) -> None:
        """Claim `slot` for a new stream with its speaker d-vector; the
        slot's state is zeroed. The shared ring cursor is left alone."""
        if not 0 <= slot < self.n:
            raise IndexError(f"slot {slot} out of range")
        for tree, k in _leaves(self.state):
            if _batch_major(tree[k], self.n):
                tree[k][slot].zero_()
        self.input_tail[slot].zero_()
        self.embeds[slot] = torch.as_tensor(
            np.asarray(embedding), dtype=self.dtype, device=self.device)
        self.active[slot] = True
        self.primed[slot] = False

    def remove_stream(self, slot: int) -> None:
        self.active[slot] = False
        self.primed[slot] = False

    # -- the step -------------------------------------------------------------

    def _keep_unprimed(self, new_state, restore):
        """Unprimed rows keep their old state: batch-major leaves are
        selected row by row, the ring's slot `pos` is put back, and
        leaves without a batch dimension (the cursor) advance."""
        primed = self._primed_dev

        def keep(new, old):
            if not _batch_major(new, self.n) or new is old:
                return new
            m = primed.reshape((-1,) + (1,) * (new.ndim - 1))
            return torch.where(m, new, old)

        state = {k: keep(new_state[k], self.state[k])
                 for k in ("conv_buf", "deconv_buf", "istft_buf")}
        state["blocks"] = [
            {k: keep(nb[k], ob[k]) for k in nb}
            for nb, ob in zip(new_state["blocks"], self.state["blocks"])]
        for i, slot, axis, old in restore:
            blk = state["blocks"][i]
            for k, prev in old.items():
                m = primed.reshape((-1,) + (1,) * (prev.ndim - 1))
                cur = blk[k].index_select(axis, slot)
                blk[k].index_copy_(axis, slot, torch.where(m, cur, prev))
        return state

    def _step_core(self, all_primed: bool) -> torch.Tensor:
        """One step from the static buffers into the static buffers:
        reads `_x_in`, `_primed_dev`, `embeds` and the carried state,
        writes the carried state in place and returns y. Free of host
        syncs, so it can be captured."""
        pad = self.nfft - self.chunk
        window = torch.cat([self.input_tail, self._x_in[..., :pad]], dim=-1)
        # the step writes slot `pos` of EVERY row of the ring in place;
        # keep what unprimed rows held there, to put back after the step
        # (`pos` is read on the device)
        restore = []
        if not all_primed:
            for i, blk in enumerate(self.state["blocks"]):
                if "pos" in blk:
                    keys, axis = ring_slot_leaves(blk)
                    slot = blk["pos"].reshape(1).long()
                    restore.append((i, slot, axis, {
                        k: blk[k].index_select(axis, slot) for k in keys}))
        y, new_state = self.model.step(window, self.embeds, self.state)
        if not all_primed:
            new_state = self._keep_unprimed(new_state, restore)
            y = y * self._primed_dev.reshape(-1, 1, 1).to(y.dtype)
        # the ring leaves and `pos` were written in place; every other
        # leaf comes back as a new tensor
        for (old, k), (new, _) in zip(_leaves(self.state),
                                      _leaves(new_state)):
            if new[k] is not old[k]:
                old[k].copy_(new[k])
        self.input_tail.copy_(self._x_in)
        return y

    def _capture(self, all_primed: bool):
        """Capture the step's graph. The warm-up steps run for real, so
        the carried state is saved before them and put back after."""
        saved = [t.clone() for t in self._carried()]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step_core(all_primed)
        torch.cuda.current_stream(self.device).wait_stream(side)
        for t, s in zip(self._carried(), saved):
            t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = self._step_core(all_primed)
        self._graphs[all_primed] = (graph, y)
        return graph, y

    def _load_input(self, chunks, n_buffers: int = 2) -> None:
        """Copy `chunks` into the static input. From host memory on the
        card, the copy goes through a ring of at least `n_buffers` pinned
        buffers and does not wait for the card; a buffer is rewritten
        only after the copy that read it has finished, so the host waits
        only once the card is `n_buffers` steps behind."""
        with span("engine.input"):
            x = torch.as_tensor(chunks)
            if self.device.type != "cuda" or x.device.type != "cpu":
                self._x_in.copy_(x)
                return
            while len(self._pinned_in) < n_buffers:
                self._pinned_in.append(
                    (torch.empty_like(self._x_in, device="cpu").pin_memory(),
                     torch.cuda.Event()))
            self._pinned_in.append(self._pinned_in.pop(0))
            buf, done = self._pinned_in[-1]
            with span("engine.input_wait"):
                done.synchronize()
            buf.copy_(x)
            self._x_in.copy_(buf, non_blocking=True)
            done.record()

    def _upload_primed(self) -> bool:
        """Bring the device mask up to date (a copy only when it changed:
        a copy from host memory waits for the stream); True when every
        slot is primed."""
        primed = self.primed & self.active
        if not np.array_equal(primed, self._primed_host):
            self._primed_host = primed.copy()
            with span("engine.mask"):
                self._primed_dev.copy_(torch.from_numpy(primed))
        return bool(primed.all())

    def _run(self, chunks, n_in: int = 2) -> torch.Tensor:
        """One step; returns y, which a graph's next replay overwrites.
        `n_in`: pinned input buffers to rotate through (see
        `_load_input`)."""
        self._load_input(chunks, n_in)
        all_primed = self._upload_primed()
        if self.cuda_graph:
            graph, y = self._graphs.get(all_primed) or \
                self._capture(all_primed)
            with span("engine.replay"):
                graph.replay()
        else:
            with span("engine.eager_step"):
                y = self._step_core(all_primed)
        self.primed |= self.active
        return y

    @torch.no_grad()
    def step(self, chunks) -> torch.Tensor:
        """chunks: [max_streams, n_mics, chunk] new audio (inactive
        slots: anything, their output is zeroed). Returns separated
        audio [max_streams, n_srcs, chunk] on the engine's device,
        delayed by the model's algorithmic latency; a tensor of its own,
        which later steps leave alone."""
        with span("engine.step"):
            y = self._run(chunks)
            return y.clone() if self.cuda_graph else y

    @torch.no_grad()
    def step_pipelined(self, chunks, depth: int = 4):
        """Throughput mode: keep up to `depth` steps in flight.

        Enqueues this step and a non-blocking copy of its output into a
        pinned host buffer (with an event of its own), and returns the
        host result (a float32 numpy array) of the step `depth` calls
        ago, None until the pipeline fills. The host then waits only for
        that older step, so the transfers of step t-depth overlap the
        compute of step t. A host buffer is reused only after its result
        was fetched; host chunks rotate through depth + 1 pinned input
        buffers, so the input copies never hold the host back sooner."""
        with span("engine.step"):
            y = self._run(chunks, depth + 1)
            with span("engine.stage_out"):
                if self.device.type == "cuda":
                    buf = self._pinned_out.pop() if self._pinned_out else \
                        torch.empty(y.shape, dtype=y.dtype).pin_memory()
                    buf.copy_(y, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    buf, done = y.clone(), None
            self._pipeline.append((buf, done))
            if len(self._pipeline) > depth:
                return self._fetch(*self._pipeline.pop(0))
            return None

    def _fetch(self, buf, done) -> np.ndarray:
        with span("engine.fetch"):
            if done is not None:
                with span("engine.fetch_wait"):
                    done.synchronize()
                self._pinned_out.append(buf)
            return buf.to(torch.float32, copy=True).numpy()

    def drain(self):
        """Fetch every output still in flight (throughput mode tail), in
        order. Returns a list of [max_streams, n_srcs, chunk] arrays."""
        out = [self._fetch(buf, done) for buf, done in self._pipeline]
        self._pipeline.clear()
        return out

    # -- benchmarking ---------------------------------------------------------

    def benchmark(self, n_iters: int = 100, warmup: int = 20) -> dict:
        """Steady-state per-chunk latency: each step timed from its call
        to a fetch of one output element to the host, which waits for the
        step's work. "Transport" is that fetch: on a local card one
        device-to-host copy over PCIe and its synchronization (no
        network link, unlike the JAX package's proxied TPU), so these
        numbers sit close to the step's wall time. For device time alone
        use `benchmark_device`."""
        g = torch.Generator(device=self.device).manual_seed(0)
        x = torch.randn((self.n, self.n_mics, self.chunk), generator=g,
                        device=self.device).to(self.dtype)
        for _ in range(warmup):
            y = self.step(x)
        y[0, 0, -1].item()
        lat = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            y = self.step(x)
            y[0, 0, -1].item()                 # forced fetch = barrier
            lat.append(time.perf_counter() - t0)
        lat = np.asarray(lat)
        chunk_s = self.chunk / 16000.0
        return {
            "p50_ms_incl_transport": float(np.percentile(lat, 50) * 1e3),
            "p99_ms_incl_transport": float(np.percentile(lat, 99) * 1e3),
            "rtf_incl_transport": float(np.median(lat) / chunk_s),
            "transport_inclusive": True,
            "streams": self.n,
        }

    @torch.no_grad()
    def benchmark_device(self, n_short: int = 100, n_long: int = 500,
                         repeats: int = 4) -> dict:
        """Device time per chunk of the engine's all-primed step: runs of
        n_short and n_long steps (each step: a copy of its chunks into
        the static input, then the step), per-step time = the slope
        between the two lengths, so fixed costs cancel, as the JAX
        engine's scan at two lengths. On the card the steps are graph
        replays (eager steps with cuda_graph=False) between CUDA events;
        on the CPU eager steps timed by perf_counter. p50/p99 are over
        the per-repeat slopes. Runs from the live state and puts it, and
        the static input, back afterwards."""
        saved = [t.clone() for t in self._carried() + [self._x_in]]
        cuda = self.device.type == "cuda"
        g = torch.Generator(device=self.device).manual_seed(0)
        if self.cuda_graph:
            step = (self._graphs.get(True) or self._capture(True))[0].replay
        else:
            def step():
                self._step_core(True)

        def timed(n):
            xs = torch.randn((n, self.n, self.n_mics, self.chunk),
                             generator=g, device=self.device).to(self.dtype)

            def run():
                for x in xs:
                    self._x_in.copy_(x)
                    step()
            run()
            times = []
            for _ in range(repeats):
                if cuda:
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    torch.cuda.synchronize(self.device)
                    start.record()
                    run()
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    run()
                    times.append(time.perf_counter() - t0)
            return times

        try:
            ts, tl = timed(n_short), timed(n_long)
        finally:
            for t, s in zip(self._carried() + [self._x_in], saved):
                t.copy_(s)
        slopes = np.asarray(
            [(b - a) / (n_long - n_short) for a, b in zip(ts, tl)])
        chunk_s = self.chunk / 16000.0
        per = float(np.min(slopes))
        return {
            "device_p50_ms": float(np.percentile(slopes, 50) * 1e3),
            "device_p99_ms": float(np.percentile(slopes, 99) * 1e3),
            "device_best_ms": per * 1e3,
            "rtf": per / chunk_s,
            "streams": self.n,
        }


class MultiDeviceEngine:
    """`max_streams` streams split evenly over `devices` (a list of
    torch devices, e.g. ["cuda:0", "cuda:1"]; the same device may repeat):
    slot s lives on engine s // (max_streams / n) as its slot
    s % (max_streams / n). Every step steps every engine once on its
    slice of the chunks, so their shared ring cursors stay equal; each
    engine is a `StreamingEngine` with the given precision and graph
    options. The engines' launches are queued before any output is
    gathered, so engines on different cards run at the same time."""

    def __init__(self, model, params=None, max_streams: int = 64,
                 dtype=torch.float32, kv_dtype=None, devices=("cuda",),
                 cuda_graph: bool = True):
        n = len(devices)
        if n == 0 or max_streams % n:
            raise ValueError(f"max_streams {max_streams} must divide over "
                             f"the {n} devices")
        self.n = max_streams
        self.per = max_streams // n
        self.engines = [StreamingEngine(model, params, self.per, dtype,
                                        kv_dtype, device=d,
                                        cuda_graph=cuda_graph)
                        for d in devices]
        self.device = self.engines[0].device

    def _route(self, slot: int):
        if not 0 <= slot < self.n:
            raise IndexError(f"slot {slot} out of range")
        return self.engines[slot // self.per], slot % self.per

    def add_stream(self, slot: int, embedding) -> None:
        eng, s = self._route(slot)
        eng.add_stream(s, embedding)

    def remove_stream(self, slot: int) -> None:
        eng, s = self._route(slot)
        eng.remove_stream(s)

    @property
    def active(self) -> np.ndarray:
        return np.concatenate([e.active for e in self.engines])

    @property
    def primed(self) -> np.ndarray:
        return np.concatenate([e.primed for e in self.engines])

    def _slices(self, chunks) -> list:
        return [chunks[i * self.per:(i + 1) * self.per]
                for i in range(len(self.engines))]

    @torch.no_grad()
    def step(self, chunks) -> torch.Tensor:
        """chunks: [max_streams, n_mics, chunk]. Returns the separated
        audio of every stream [max_streams, n_srcs, chunk] on the first
        engine's device."""
        ys = [e.step(c) for e, c in zip(self.engines, self._slices(chunks))]
        return torch.cat([y.to(self.device) for y in ys])

    @torch.no_grad()
    def step_pipelined(self, chunks, depth: int = 4):
        """Throughput mode (`StreamingEngine.step_pipelined` on every
        engine): the host result [max_streams, n_srcs, chunk] of the step
        `depth` calls ago, None until the pipelines fill."""
        ys = [e.step_pipelined(c, depth)
              for e, c in zip(self.engines, self._slices(chunks))]
        return None if ys[0] is None else np.concatenate(ys)

    def drain(self) -> list:
        """Every output still in flight, in order, as host arrays."""
        return [np.concatenate(ys) for ys in
                zip(*(e.drain() for e in self.engines))]


def _leaves(state):
    """(dict, key) of every leaf of a streaming state, in a fixed order."""
    for k in ("conv_buf", "deconv_buf", "istft_buf"):
        yield state, k
    for blk in state["blocks"]:
        for k in sorted(blk):
            yield blk, k
