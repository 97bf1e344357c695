"""Streaming causal TF-GridNet separator, serving step (counterpart of
`lookoncetohear_tpu/models/streaming_tfgridnet.py`).

The port covers the 8 ms streaming step (T=1) with the int8 K/V ring in
its serving form: fused QKV projection and flat LayerNorms, which the
JAX package selects by default (`_fused_qkv_enabled`,
`_mxu_norms_enabled`). Per step: filterbank STFT encode -> causal 3x3
conv over a 2-frame `conv_buf` -> speaker projection multiplied in
before block 1 -> GridNet blocks (intra-frequency BiLSTM, inter-time
LSTM step, int8 ring attention) -> causal deconv over `deconv_buf` ->
filterbank decode with a 1-frame `istft_buf` lookback.

State is a dict of tensors like the JAX pytree. The ring leaves of each
block (k_buf, k_scale, v_buf, v_scale, pos) are updated in place by the
ring step (`ops/ring_step.py`); every other leaf is returned anew.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from lookoncetohear_tpu_torch.ops import stft as stft_ops
from lookoncetohear_tpu_torch.ops.lstm import LSTM
from lookoncetohear_tpu_torch.ops.norms import (LayerNorm, PReLU,
                                                flat_head_layer_norm,
                                                flat_layer_norm,
                                                head_segment_matrix)
from lookoncetohear_tpu_torch.ops.ring_step import ring_attend_int8_native

RING_KEYS = ("k_buf", "k_scale", "v_buf", "v_scale", "pos")


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
    """One streaming GridNet block at T=1."""

    def __init__(self, emb_dim: int, n_freqs: int, hidden: int,
                 n_head: int = 4, approx_qk_dim: int = 512,
                 local_atten_len: int = 50, use_attn: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        c, h, f = emb_dim, hidden, n_freqs
        self.emb_dim, self.n_freqs, self.hidden = c, f, h
        self.n_head = n_head
        self.local_atten_len = local_atten_len
        self.use_attn = use_attn
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

    def attention_section(self, z, state):
        """z: [B, 1, F, C] -> pre-residual [B, 1, F, C]; runs the int8
        ring step, which updates the ring leaves of `state` in place."""
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

    def forward(self, x, state):
        """x: [B, C, 1, F] -> ([B, C, 1, F], new_state)."""
        b, c, t, f = x.shape
        if t != 1:
            raise ValueError("the port runs the streaming step (T=1) only")
        # intra-frequency BiLSTM over the F bins
        inp = x.permute(0, 2, 3, 1)                       # [B, 1, F, C]
        y = flat_layer_norm(inp.reshape(b * f, c), self.intra_norm.weight,
                            self.intra_norm.bias, self.intra_norm.eps)
        y, _ = self.intra_rnn(y.reshape(b, f, c))  # [B, F, 2H]
        y = self.intra_linear(y).reshape(b, 1, f, c) + inp

        # inter-time LSTM, one step on the carried (h, c)
        z = flat_layer_norm(y.reshape(b * f, c), self.inter_norm.weight,
                            self.inter_norm.bias, self.inter_norm.eps)
        h0 = state["h"].reshape(b * f, self.hidden)
        c0 = state["c"].reshape(b * f, self.hidden)
        z, (h_t, c_t) = self.inter_rnn(z.reshape(b * f, 1, c), h0, c0)
        new_state = dict(state)
        new_state["h"] = h_t.reshape(b, f, self.hidden)
        new_state["c"] = c_t.reshape(b, f, self.hidden)
        z = self.inter_linear(z).reshape(b, 1, f, c) + y

        if self.use_attn:
            z = z + self.attention_section(z, new_state)
        return z.permute(0, 3, 1, 2), new_state


def init_stream_state(batch_size: int, *, n_srcs: int, n_fft: int,
                      n_imics: int, n_layers: int, lstm_hidden_units: int,
                      attn_n_head: int, attn_approx_qk_dim: int,
                      emb_dim: int, local_atten_len: int, use_attn: bool,
                      t_ksize: int = 3, istft_lookback: int = 1,
                      dtype=torch.float32, kv_dtype=None,
                      device=None) -> Dict[str, Any]:
    """Zero streaming state, the JAX package's pytree as a dict of
    tensors. Only the int8 ring (kv_dtype=torch.int8) is ported."""
    if use_attn and kv_dtype != torch.int8:
        raise NotImplementedError(
            "the port carries the int8 K/V ring only (kv_dtype=torch.int8)")
    f = n_fft // 2 + 1
    h, w, nh = lstm_hidden_units, local_atten_len, attn_n_head
    e = int(math.ceil(attn_approx_qk_dim / f))
    vd = emb_dim // nh if nh else emb_dim
    wp = ((w + 7) // 8) * 8

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def block_state():
        s = {"h": zeros(batch_size, f, h), "c": zeros(batch_size, f, h)}
        if use_attn:
            s["k_buf"] = zeros(batch_size, wp, f * nh * e, dt=torch.int8)
            s["v_buf"] = zeros(batch_size, wp, f * nh * vd, dt=torch.int8)
            s["k_scale"] = zeros(batch_size, wp, nh, dt=torch.float32)
            s["v_scale"] = zeros(batch_size, wp, nh, dt=torch.float32)
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
                 use_attn: bool = True, eps: float = 1e-5, t_ksize: int = 3):
        super().__init__()
        self.n_srcs, self.n_fft, self.stride = n_srcs, n_fft, stride
        self.n_imics, self.n_layers = n_imics, n_layers
        self.lstm_hidden_units = lstm_hidden_units
        self.attn_n_head = attn_n_head
        self.attn_approx_qk_dim = attn_approx_qk_dim
        self.emb_dim, self.local_atten_len = emb_dim, local_atten_len
        self.use_attn, self.t_ksize = use_attn, t_ksize
        self.istft_lookback = 1
        d = emb_dim
        f = self.n_freqs = n_fft // 2 + 1
        # causal input conv: the 2-frame conv_buf gives time causality
        self.conv = nn.Conv2d(2 * n_imics, d, (t_ksize, 3), padding=(0, 1))
        self.blocks = nn.ModuleList([
            GridNetBlockStreaming(d, f, lstm_hidden_units, attn_n_head,
                                  attn_approx_qk_dim, local_atten_len,
                                  use_attn, eps)
            for _ in range(n_layers)])
        self.embed_proj_dense = TorchDense(spk_emb_dim, d * f)
        self.embed_proj_norm = LayerNorm(d * f, eps)
        # deconv: a VALID conv on the stored (pre-flipped) flax kernel
        self.deconv = nn.Conv2d(d, 2 * n_srcs, (t_ksize, 3), padding=(0, 1))
        self.register_buffer("fb", torch.from_numpy(
            stft_ops._stft_filterbank_np(n_fft, n_fft, stride)),
            persistent=False)

    def init_state(self, batch_size: int, dtype=torch.float32,
                   kv_dtype=torch.int8, device=None):
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

    def forward(self, x, spk_embedding, state):
        """x: [B, M, n_fft] one analysis window; spk_embedding: [B, E].
        Returns (audio [B, n_srcs, stride], new_state), delayed by one
        hop like the JAX package."""
        b = x.shape[0]
        f, k = self.n_freqs, self.t_ksize - 1

        spec = stft_ops.fb_encode(x, self.n_fft, self.stride, self.fb)
        batch = torch.cat([spec[:, :, :f], spec[:, :, f:]], dim=1)
        batch = batch.transpose(2, 3)                     # [B, 2M, T, F]
        t = batch.shape[2]
        new_state = dict(state)

        padded = torch.cat([state["conv_buf"], batch], dim=2)
        new_state["conv_buf"] = padded[:, :, -k:]
        h = self.conv(padded)                             # [B, D, T, F]

        emb = self.embed_proj_norm(self.embed_proj_dense(spk_embedding))
        emb = emb.reshape(b, self.emb_dim, f)[:, :, None, :]

        blocks = list(state["blocks"])
        for i, blk in enumerate(self.blocks):
            if i == 1:
                h = h * emb
            h, blocks[i] = blk(h, blocks[i])
        new_state["blocks"] = blocks

        padded = torch.cat([state["deconv_buf"], h], dim=2)
        new_state["deconv_buf"] = padded[:, :, -k:]
        y = self.deconv(padded)                           # [B, 2S, T, F]
        y = y.reshape(b, self.n_srcs, 2, t, f).transpose(3, 4)
        y = torch.cat([y[:, :, 0], y[:, :, 1]], dim=2)    # [B, S, 2F, T]

        y = torch.cat([state["istft_buf"], y], dim=3)
        new_state["istft_buf"] = y[..., -self.istft_lookback:]
        audio = stft_ops.fb_decode(y, self.n_fft, self.stride, self.fb)
        audio = audio[..., self.istft_lookback * self.stride:]
        return audio[..., :t * self.stride], new_state
