"""Multi-stream real-time serving engine (counterpart of
`lookoncetohear_tpu/serve/engine.py`).

N concurrent binaural streams ride the leading batch dimension of one
model step. The engine owns the per-stream speaker embeddings, the
model's streaming state, the previous chunk of every stream (each
analysis window is [previous chunk ; new chunk[:pad]]), and the active
and primed masks. Attaching a stream zeroes exactly its state slice.

A slot is primed once its tail holds a real chunk: before that its
window is a bogus [zeros ; chunk] pre-frame that must not touch its
state, so unprimed slots keep their old state and output zeros. The
ring cursor `pos` is one scalar shared by every stream and always
advances. The K/V ring is kept in the compute dtype by default, or as
int8 with `kv_dtype=torch.int8`; a step writes slot `pos` of every
row of it in place, so the engine puts back that slot of unprimed
rows.

`step_pipelined`, the benchmarks, multi-GPU serving and CUDA-graph
capture are not ported yet.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from lookoncetohear_tpu_torch import resolve_device
from lookoncetohear_tpu_torch.models.streaming_tfgridnet import \
    ring_slot_leaves


def _batch_major(x: torch.Tensor, n: int) -> bool:
    return x.ndim > 0 and x.shape[0] == n


class StreamingEngine:
    def __init__(self, model, params=None, max_streams: int = 64,
                 dtype=torch.float32, kv_dtype=None, device=None):
        """model: a `Net`; params: an optional state_dict loaded into a
        copy of it. The copy runs on `device` ("cuda" by default) with
        params and activations in `dtype`; the K/V ring is stored in
        `kv_dtype` (None: `dtype`; torch.int8: the int8 serving ring
        with float32 scales)."""
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
        self.input_tail = torch.zeros(
            (max_streams, self.n_mics, self.chunk), dtype=dtype,
            device=self.device)
        self.embeds = torch.zeros((max_streams, self.embed_dim),
                                  dtype=dtype, device=self.device)
        self.active = np.zeros(max_streams, bool)
        self.primed = np.zeros(max_streams, bool)
        self._primed_host = None
        self._primed_dev = None

    # -- stream management -------------------------------------------------

    def _leaves(self):
        yield from ((self.state, k) for k in
                    ("conv_buf", "deconv_buf", "istft_buf"))
        for blk in self.state["blocks"]:
            yield from ((blk, k) for k in blk)

    def add_stream(self, slot: int, embedding) -> None:
        """Claim `slot` for a new stream with its speaker d-vector; the
        slot's state is zeroed. The shared ring cursor is left alone."""
        if not 0 <= slot < self.n:
            raise IndexError(f"slot {slot} out of range")
        for tree, k in self._leaves():
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

    # -- inference ----------------------------------------------------------

    def _keep_unprimed(self, new_state, primed, restore):
        """Unprimed rows keep their old state: batch-major leaves are
        selected row by row, the ring's slot `pos` is put back, and
        leaves without a batch dimension (the cursor) advance."""
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

    @torch.no_grad()
    def step(self, chunks) -> torch.Tensor:
        """chunks: [max_streams, n_mics, chunk] new audio (inactive
        slots: anything, their output is zeroed). Returns separated
        audio [max_streams, n_srcs, chunk] on the engine's device,
        delayed by the model's algorithmic latency."""
        chunks = torch.as_tensor(chunks, dtype=self.dtype,
                                 device=self.device)
        primed_np = self.primed & self.active
        all_primed = bool(primed_np.all())
        if self._primed_dev is None or not np.array_equal(
                primed_np, self._primed_host):
            # upload only when the mask changes: a copy from host memory
            # waits for the stream, which would stall every step
            self._primed_host = primed_np.copy()
            self._primed_dev = torch.as_tensor(primed_np, device=self.device)
        primed = self._primed_dev
        pad = self.nfft - self.chunk
        window = torch.cat([self.input_tail, chunks[..., :pad]], dim=-1)
        # the step writes slot `pos` of EVERY row of the ring in place;
        # keep what unprimed rows held there, to put back after the step
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
            new_state = self._keep_unprimed(new_state, primed, restore)
        self.state = new_state
        self.input_tail = chunks.clone()
        self.primed |= self.active
        if all_primed:
            return y
        return y * primed.reshape(-1, 1, 1).to(y.dtype)
