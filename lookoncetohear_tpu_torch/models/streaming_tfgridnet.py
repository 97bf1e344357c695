"""Streaming causal TF-GridNet separator (counterpart of
`lookoncetohear_tpu/models/streaming_tfgridnet.py`).

One function of (x, embedding, state) serves the 8 ms streaming step
(T=1) and the full-utterance forward (T frames at once): filterbank
STFT encode -> causal 3x3 conv over a 2-frame `conv_buf` -> speaker
projection multiplied in before block 1 -> GridNet blocks
(intra-frequency BiLSTM, inter-time LSTM on the carried (h, c), causal
windowed attention over a K/V ring) -> causal deconv over
`deconv_buf` -> filterbank decode with a 1-frame `istft_buf` lookback.

The K/V ring of each block comes in two layouts, chosen by `kv_dtype`
when the state is made:
  * float32 or bfloat16 (the default: the compute dtype), head-major
    [B, nh, W-1, F*dim], cursor `pos` mod W-1. The step projects Q/K/V
    with three matmuls and per-head LayerNorms, attends over the ring
    and the current frame (`ops/attention.py::ring_attend`), then
    writes slot `pos`. The full-utterance forward runs the banded
    attention and leaves a time-ordered ring.
  * int8, the serving form: flat (f, head, dim) slots [B, WP, F*nh*dim]
    with per-(row, slot, head) scales, cursor mod w, fused QKV
    projection and flat LayerNorms (the JAX package's
    `_fused_qkv_enabled`/`_mxu_norms_enabled` defaults), through the
    write-first ring step (`ops/ring_step.py`). T=1 only.

State is a dict of tensors like the JAX pytree. At T=1 the ring leaves
of each block (k_buf, v_buf, the int8 scales, pos) are updated IN
PLACE; every other leaf, and every leaf of a T>1 pass, is returned
anew, so a T>1 pass writes no tensor that autograd saved. Unlike the
JAX package (`nn.remat`), no block is recomputed in the backward by
default: on an 80 GB H100 keeping the activations is the faster
training step (PERF.md). `remat=True` checkpoints every block of a T>1
pass that keeps a gradient (`torch.utils.checkpoint`), as the JAX
package does, for a model whose activations do not fit.

Under a `torch.profiler` session the forward records its sections as
spans (`profiling.span`): `net.encode` (STFT, conv and the speaker
projection), each block's `block.intra`, `block.inter` and
`block.attn`, and `net.decode` (deconv and synthesis).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lookoncetohear_tpu_torch.ops import stft as stft_ops
from lookoncetohear_tpu_torch.ops.attention import (
    causal_banded_attention_full, local_attention, ring_attend)
from lookoncetohear_tpu_torch.ops.lstm import LSTM
from lookoncetohear_tpu_torch.ops.norms import (LayerNorm, PReLU,
                                                flat_head_layer_norm,
                                                flat_layer_norm,
                                                head_segment_matrix)
from lookoncetohear_tpu_torch.ops.ring_step import ring_attend_int8_native
from lookoncetohear_tpu_torch.profiling import span



def ring_slot_leaves(block_state):
    """(keys, axis) of the ring leaves of one block whose slot `pos` a
    streaming step writes in place: the int8 ring's buffers and scales
    take the slot on axis 1, the float ring's buffers on axis 2."""
    if "k_scale" in block_state:
        return ("k_buf", "k_scale", "v_buf", "v_scale"), 1
    return ("k_buf", "v_buf"), 2


# the JAX package's TorchDense (x @ kernel + bias, kernel [in, out]) is
# nn.Linear with weight = kernel.T (`weights.py`)
TorchDense = nn.Linear


class AttnProjection(nn.Module):
    """Linear -> PReLU -> LayerNorm over the flattened frame, used for
    Q/K/V and the output projection of the attention."""

    def __init__(self, in_features: int, out_features: int,
                 norm_features: int):
        super().__init__()
        self.dense = TorchDense(in_features, out_features)
        self.act = PReLU()
        self.norm = LayerNorm(norm_features)

    def project(self, x):
        return self.act(self.dense(x))

    def normalize_flat(self, y_flat, seg, f: int, n_head: int, dim: int):
        """Per-head LayerNorm on the flat (f, head, dim) serving layout
        [B, f*n_head*dim]; the [f*dim] affine is shared by the heads."""
        sc = self.norm.weight.reshape(f, 1, dim).expand(f, n_head, dim)
        bi = self.norm.bias.reshape(f, 1, dim).expand(f, n_head, dim)
        return flat_head_layer_norm(y_flat, seg, float(f * dim),
                                    sc.reshape(-1), bi.reshape(-1),
                                    self.norm.eps)


class GridNetBlockStreaming(nn.Module):
    """One streaming GridNet block, at T=1 or over T frames."""

    def __init__(self, emb_dim: int, n_freqs: int, hidden: int,
                 n_head: int = 4, approx_qk_dim: int = 512,
                 local_atten_len: int = 50, use_attn: bool = True,
                 chunk_causal: bool = True, eps: float = 1e-5):
        super().__init__()
        c, h, f = emb_dim, hidden, n_freqs
        self.emb_dim, self.n_freqs, self.hidden = c, f, h
        self.n_head = n_head
        self.local_atten_len = local_atten_len
        self.use_attn = use_attn
        self.chunk_causal = chunk_causal
        self.e_dim = int(math.ceil(approx_qk_dim / f))
        self.v_dim = c // n_head if n_head else c
        e, vd, nh = self.e_dim, self.v_dim, n_head
        self.intra_norm = LayerNorm(c, eps)
        self.intra_rnn = LSTM(c, h, bidirectional=True)
        self.intra_linear = TorchDense(2 * h, c)
        self.inter_norm = LayerNorm(c, eps)
        self.inter_rnn = LSTM(c, h)
        self.inter_linear = TorchDense(h, c)
        if use_attn:
            self.attn_q = AttnProjection(c, e * nh, f * e)
            self.attn_k = AttnProjection(c, e * nh, f * e)
            self.attn_v = AttnProjection(c, vd * nh, f * vd)
            self.attn_proj = AttnProjection(nh * vd, c, f * c)
            self.register_buffer("seg_k", torch.from_numpy(
                head_segment_matrix(f * nh * e, nh, e)), persistent=False)
            self.register_buffer("seg_v", torch.from_numpy(
                head_segment_matrix(f * nh * vd, nh, vd)), persistent=False)

    # -- head-major projections (float ring, full-utterance forward) -------

    def _heads(self, proj: AttnProjection, x, dim: int):
        """Project, split heads, per-head [F*dim] LayerNorm: x [B, T, F,
        C] -> [B, nh, T, F*dim]."""
        b, t, f, _ = x.shape
        y = proj.project(x).reshape(b, t, f, self.n_head, dim)
        y = y.permute(0, 3, 1, 2, 4).reshape(b, self.n_head, t, f * dim)
        return proj.norm(y)

    def project_qkv(self, z):
        """z: [B, T, F, C] -> per-head normalized (q, k, v), each
        [B, nh, T, F*dim] (dim = e_dim for q/k, v_dim for v)."""
        return (self._heads(self.attn_q, z, self.e_dim),
                self._heads(self.attn_k, z, self.e_dim),
                self._heads(self.attn_v, z, self.v_dim))

    def output_projection(self, out):
        """Merged-heads attention output [B, T, F, nh*v_dim] ->
        pre-residual [B, T, F, C] (Linear + PReLU + LayerNorm over the
        flattened F*C frame)."""
        b, t, f, _ = out.shape
        c = self.emb_dim
        p = self.attn_proj.project(out)
        return self.attn_proj.norm(p.reshape(b, t, f * c)).reshape(b, t, f, c)

    @staticmethod
    def _merge_heads(out, b: int, nh: int, t: int, f: int, vd: int):
        """[B*nh, T, F*vd] head-major -> [B, T, F, nh*vd]: channel =
        head * v_dim + v."""
        out = out.reshape(b, nh, t, f, vd).permute(0, 2, 3, 1, 4)
        return out.reshape(b, t, f, nh * vd)

    # -- attention -----------------------------------------------------------

    def attention_section(self, z, state):
        """The streaming (T=1) attention: z [B, 1, F, C] -> pre-residual
        [B, 1, F, C]. Updates the ring leaves of `state` in place."""
        b, _, f, _ = z.shape
        if state["k_buf"].dtype == torch.int8:
            return self._attention_int8(z, state)
        nh, e, vd, w = self.n_head, self.e_dim, self.v_dim, \
            self.local_atten_len
        q, k, v = self.project_qkv(z)                 # [B, nh, 1, F*dim]
        kf = k.reshape(b * nh, f * e)
        vf = v.reshape(b * nh, f * vd)
        # views of the carried 4-D ring, not copies
        out = ring_attend(q.reshape(b * nh, f * e), kf, vf,
                          state["k_buf"].view(b * nh, w - 1, f * e),
                          state["v_buf"].view(b * nh, w - 1, f * vd))
        # attend, then write: the old slot `pos` was part of this step's
        # window. One slot of each row, in place, no host sync.
        pos = state["pos"]
        slot = pos.reshape(1).long()
        for key, x in (("k_buf", kf), ("v_buf", vf)):
            buf = state[key]
            buf.index_copy_(2, slot, x.reshape(b, nh, 1, -1).to(buf.dtype))
        pos.add_(1).remainder_(w - 1)
        return self.output_projection(self._merge_heads(out, b, nh, 1, f, vd))

    def _attention_int8(self, z, state):
        """The int8 ring in its serving form: one fused QKV matmul, flat
        per-head LayerNorms, the write-first ring step."""
        b, _, f, c = z.shape
        nh, e, vd = self.n_head, self.e_dim, self.v_dim
        projs = (self.attn_q, self.attn_k, self.attn_v)
        widths = (e * nh, e * nh, vd * nh)
        # one [C, 2*E*nh + V*nh] projection instead of three
        kern = torch.cat([p.dense.weight for p in projs], dim=0)
        bias = torch.cat([p.dense.bias for p in projs])
        alpha = torch.cat([p.act.weight.expand(wd)
                           for p, wd in zip(projs, widths)])
        y = nn.functional.linear(z, kern, bias)
        y = torch.where(y >= 0, y, alpha * y)
        qn = self.attn_q.normalize_flat(
            y[..., :e * nh].reshape(b, f * nh * e), self.seg_k, f, nh, e)
        kn = self.attn_k.normalize_flat(
            y[..., e * nh:2 * e * nh].reshape(b, f * nh * e), self.seg_k,
            f, nh, e)
        vn = self.attn_v.normalize_flat(
            y[..., 2 * e * nh:].reshape(b, f * nh * vd), self.seg_v,
            f, nh, vd)
        out = ring_attend_int8_native(
            qn, kn, vn, state["k_buf"], state["k_scale"], state["v_buf"],
            state["v_scale"], state["pos"], f=f, n_head=nh,
            w=self.local_atten_len)
        # out columns are (f, head*vd) == the merged-head channel order
        p = self.attn_proj.project(out.reshape(b, 1, f, nh * vd))
        pn = flat_layer_norm(p.reshape(b, f * c), self.attn_proj.norm.weight,
                             self.attn_proj.norm.bias, self.attn_proj.norm.eps)
        return pn.reshape(b, 1, f, c)

    def attention_full(self, z, state, new_state):
        """The full-utterance (T>1) attention: z [B, T, F, C] ->
        pre-residual [B, T, F, C]; puts the rewritten ring (and, in the
        offline branch, pos = 0) into `new_state`."""
        b, t, f, _ = z.shape
        nh, e, vd, w = self.n_head, self.e_dim, self.v_dim, \
            self.local_atten_len
        kvdt = state["k_buf"].dtype
        if kvdt == torch.int8:
            raise ValueError("the int8 K/V ring is a streaming-step (T=1) "
                             "serving feature")
        q, k, v = self.project_qkv(z)                 # [B, nh, T, F*dim]
        qf = q.reshape(b * nh, t, f * e)
        kf = k.reshape(b * nh, t, f * e)
        vf = v.reshape(b * nh, t, f * vd)
        k_buf = state["k_buf"].reshape(b * nh, w - 1, f * e).to(qf.dtype)
        v_buf = state["v_buf"].reshape(b * nh, w - 1, f * vd).to(vf.dtype)
        if self.chunk_causal:
            # the ring is read as time-ordered and `pos` is left alone,
            # as in the JAX package
            out, nk, nv = local_attention(qf, kf, vf, w, k_buf, v_buf)
        else:
            # offline: band over the real positions only; the pass
            # leaves a time-ordered ring whose oldest slot is 0
            out = causal_banded_attention_full(qf, kf, vf, w)
            nk = torch.cat([k_buf, kf], dim=1)[:, -(w - 1):]
            nv = torch.cat([v_buf, vf], dim=1)[:, -(w - 1):]
            new_state["pos"] = torch.zeros((), dtype=torch.int32,
                                           device=z.device)
        # contiguous: the ring kernel of the next step reads a flat view
        new_state["k_buf"] = nk.to(kvdt).reshape(
            b, nh, w - 1, f * e).contiguous()
        new_state["v_buf"] = nv.to(kvdt).reshape(
            b, nh, w - 1, f * vd).contiguous()
        return self.output_projection(self._merge_heads(out, b, nh, t, f, vd))

    def forward(self, x, state):
        """x: [B, C, T, F] -> ([B, C, T, F], new_state)."""
        b, c, t, f = x.shape
        # intra-frequency BiLSTM over the F bins of each frame; at T=1
        # the channel norms take the flat serving form
        with span("block.intra"):
            inp = x.permute(0, 2, 3, 1)                   # [B, T, F, C]
            if t == 1:
                y = flat_layer_norm(inp.reshape(b * f, c),
                                    self.intra_norm.weight,
                                    self.intra_norm.bias, self.intra_norm.eps)
            else:
                y = self.intra_norm(inp)
            y, _ = self.intra_rnn(y.reshape(b * t, f, c))  # [B*T, F, 2H]
            y = self.intra_linear(y).reshape(b, t, f, c) + inp

        # inter-time LSTM over T from the carried (h, c)
        with span("block.inter"):
            if t == 1:
                z = flat_layer_norm(y.reshape(b * f, c),
                                    self.inter_norm.weight,
                                    self.inter_norm.bias, self.inter_norm.eps)
            else:
                z = self.inter_norm(y)
            z = z.reshape(b, t, f, c).transpose(1, 2).reshape(b * f, t, c)
            h0 = state["h"].reshape(b * f, self.hidden)
            c0 = state["c"].reshape(b * f, self.hidden)
            z, (h_t, c_t) = self.inter_rnn(z, h0, c0)
            new_state = dict(state)
            new_state["h"] = h_t.reshape(b, f, self.hidden)
            new_state["c"] = c_t.reshape(b, f, self.hidden)
            z = self.inter_linear(z).reshape(b, f, t, c).transpose(1, 2) + y

        if self.use_attn:
            with span("block.attn"):
                if t == 1:
                    z = z + self.attention_section(z, new_state)
                else:
                    z = z + self.attention_full(z, state, new_state)
        return z.permute(0, 3, 1, 2), new_state


def init_stream_state(batch_size: int, *, n_srcs: int, n_fft: int,
                      n_imics: int, n_layers: int, lstm_hidden_units: int,
                      attn_n_head: int, attn_approx_qk_dim: int,
                      emb_dim: int, local_atten_len: int, use_attn: bool,
                      t_ksize: int = 3, istft_lookback: int = 1,
                      dtype=torch.float32, kv_dtype=None,
                      device=None) -> Dict[str, Any]:
    """Zero streaming state, the JAX package's pytree as a dict of
    tensors. kv_dtype=None stores the K/V ring in the compute dtype;
    torch.int8 selects the int8 serving ring."""
    f = n_fft // 2 + 1
    h, w, nh = lstm_hidden_units, local_atten_len, attn_n_head
    e = int(math.ceil(attn_approx_qk_dim / f))
    vd = emb_dim // nh if nh else emb_dim
    kv_dtype = dtype if kv_dtype is None else kv_dtype

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def block_state():
        s = {"h": zeros(batch_size, f, h), "c": zeros(batch_size, f, h)}
        if use_attn and kv_dtype == torch.int8:
            # write-first, padded to ceil(w/8)*8 slots like the JAX state
            wp = ((w + 7) // 8) * 8
            s["k_buf"] = zeros(batch_size, wp, f * nh * e, dt=torch.int8)
            s["v_buf"] = zeros(batch_size, wp, f * nh * vd, dt=torch.int8)
            s["k_scale"] = zeros(batch_size, wp, nh, dt=torch.float32)
            s["v_scale"] = zeros(batch_size, wp, nh, dt=torch.float32)
        elif use_attn:
            s["k_buf"] = zeros(batch_size, nh, w - 1, f * e, dt=kv_dtype)
            s["v_buf"] = zeros(batch_size, nh, w - 1, f * vd, dt=kv_dtype)
        if use_attn:
            s["pos"] = zeros(dt=torch.int32)
        return s

    return {
        "conv_buf": zeros(batch_size, 2 * n_imics, t_ksize - 1, f),
        "deconv_buf": zeros(batch_size, emb_dim, t_ksize - 1, f),
        "istft_buf": zeros(batch_size, n_srcs, 2 * f, istft_lookback),
        "blocks": [block_state() for _ in range(n_layers)],
    }


class StreamingTFGridNet(nn.Module):
    """Top-level streaming separator."""

    def __init__(self, n_srcs: int = 2, n_fft: int = 192, stride: int = 128,
                 n_imics: int = 2, n_layers: int = 3,
                 lstm_hidden_units: int = 64, attn_n_head: int = 4,
                 attn_approx_qk_dim: int = 512, emb_dim: int = 64,
                 spk_emb_dim: int = 256, local_atten_len: int = 50,
                 use_attn: bool = True, chunk_causal: bool = True,
                 eps: float = 1e-5, t_ksize: int = 3, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.n_srcs, self.n_fft, self.stride = n_srcs, n_fft, stride
        self.n_imics, self.n_layers = n_imics, n_layers
        self.lstm_hidden_units = lstm_hidden_units
        self.attn_n_head = attn_n_head
        self.attn_approx_qk_dim = attn_approx_qk_dim
        self.emb_dim, self.local_atten_len = emb_dim, local_atten_len
        self.use_attn, self.t_ksize = use_attn, t_ksize
        self.chunk_causal = chunk_causal
        self.istft_lookback = 1
        d = emb_dim
        f = self.n_freqs = n_fft // 2 + 1
        # causal input conv: the 2-frame conv_buf gives time causality
        self.conv = nn.Conv2d(2 * n_imics, d, (t_ksize, 3), padding=(0, 1))
        self.blocks = nn.ModuleList([
            GridNetBlockStreaming(d, f, lstm_hidden_units, attn_n_head,
                                  attn_approx_qk_dim, local_atten_len,
                                  use_attn, chunk_causal, eps)
            for _ in range(n_layers)])
        self.embed_proj_dense = TorchDense(spk_emb_dim, d * f)
        self.embed_proj_norm = LayerNorm(d * f, eps)
        # deconv: a VALID conv on the stored (pre-flipped) flax kernel
        self.deconv = nn.Conv2d(d, 2 * n_srcs, (t_ksize, 3), padding=(0, 1))
        self.register_buffer("fb", torch.from_numpy(
            stft_ops._stft_filterbank_np(n_fft, n_fft, stride)),
            persistent=False)

    def init_state(self, batch_size: int, dtype=torch.float32,
                   kv_dtype=None, device=None):
        return init_stream_state(
            batch_size, n_srcs=self.n_srcs, n_fft=self.n_fft,
            n_imics=self.n_imics, n_layers=self.n_layers,
            lstm_hidden_units=self.lstm_hidden_units,
            attn_n_head=self.attn_n_head,
            attn_approx_qk_dim=self.attn_approx_qk_dim,
            emb_dim=self.emb_dim, local_atten_len=self.local_atten_len,
            use_attn=self.use_attn, t_ksize=self.t_ksize,
            istft_lookback=self.istft_lookback, dtype=dtype,
            kv_dtype=kv_dtype,
            device=self.fb.device if device is None else device)

    def forward(self, x, spk_embedding, state, return_features: bool = False):
        """x: [B, M, N] audio of T frames, N = n_fft + (T-1)*stride
        (T=1: one streaming window); spk_embedding: [B, E]. Returns
        (audio [B, n_srcs, T*stride], new_state), delayed by one hop
        like the JAX package, and with `return_features` also the
        pre-deconv features [B, D, T, F] (for the direction head)."""
        b = x.shape[0]
        f, k = self.n_freqs, self.t_ksize - 1

        with span("net.encode"):
            spec = stft_ops.fb_encode(x, self.n_fft, self.stride, self.fb)
            batch = torch.cat([spec[:, :, :f], spec[:, :, f:]], dim=1)
            batch = batch.transpose(2, 3)                 # [B, 2M, T, F]
            t = batch.shape[2]
            new_state = dict(state)

            padded = torch.cat([state["conv_buf"], batch], dim=2)
            new_state["conv_buf"] = padded[:, :, -k:]
            h = self.conv(padded)                         # [B, D, T, F]

            emb = self.embed_proj_norm(self.embed_proj_dense(spk_embedding))
            emb = emb.reshape(b, self.emb_dim, f)[:, :, None, :]

        blocks = list(state["blocks"])
        for i, blk in enumerate(self.blocks):
            if i == 1:
                h = h * emb
            if self.remat and t > 1 and torch.is_grad_enabled():
                h, blocks[i] = checkpoint(blk, h, blocks[i],
                                          use_reentrant=False)
            else:
                h, blocks[i] = blk(h, blocks[i])
        new_state["blocks"] = blocks

        with span("net.decode"):
            padded = torch.cat([state["deconv_buf"], h], dim=2)
            new_state["deconv_buf"] = padded[:, :, -k:]
            y = self.deconv(padded)                       # [B, 2S, T, F]
            y = y.reshape(b, self.n_srcs, 2, t, f).transpose(3, 4)
            y = torch.cat([y[:, :, 0], y[:, :, 1]], dim=2)  # [B, S, 2F, T]

            y = torch.cat([state["istft_buf"], y], dim=3)
            new_state["istft_buf"] = y[..., -self.istft_lookback:]
            audio = stft_ops.fb_decode(y, self.n_fft, self.stride, self.fb)
            audio = audio[..., self.istft_lookback * self.stride:]
            audio = audio[..., :t * self.stride]
        if return_features:
            return audio, new_state, h
        return audio, new_state
