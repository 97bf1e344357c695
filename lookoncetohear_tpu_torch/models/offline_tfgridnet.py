"""Offline TF-GridNet (espnet semantics) and the binaural enrollment
("look once") embedding network (counterpart of
`lookoncetohear_tpu/models/offline_tfgridnet.py`).

centered STFT -> Conv2d + GroupNorm -> N offline GridNet blocks
(unfold-k=4 BiLSTMs over frequency and over time, full multi-head time
attention) -> Linear(C*F -> 256) + LayerNorm -> mean over time.

Both unfolded BiLSTMs of a block go through the port's
`LSTM(bidirectional=True)`, i.e. `lstm_apply_bidir`: B2 for GPU
tensors in inference, the training kernels when a gradient is needed
(the JAX package runs the same recurrence through `lax.scan`). Unlike
the JAX package (`nn.remat`), no stage is recomputed in the backward
by default (PERF.md); a trunk's `remat` attribute checkpoints each
block while a gradient is kept. The T x T time attention is plain
matmuls and a softmax, in the input's dtype, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from lookoncetohear_tpu_torch.ops import stft as stft_ops
from lookoncetohear_tpu_torch.ops.lstm import LSTM
from lookoncetohear_tpu_torch.ops.norms import (EspnetLayerNorm4D,
                                                EspnetLayerNorm4DCF,
                                                GroupNorm1, LayerNorm, PReLU)

TorchDense = nn.Linear


def _unfold_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """torch F.unfold with kernel (k, 1), stride 1, on [B, C, L]:
    [B, L-k+1, C*k], the (C, k) pair flattened channel-major."""
    b, c, _ = x.shape
    win = x.unfold(2, k, 1)                         # [B, C, L-k+1, k]
    return win.permute(0, 2, 1, 3).reshape(b, win.shape[2], c * k)


class ConvTranspose1dK(nn.Module):
    """torch ConvTranspose1d(in, out, kernel_size=k, stride=1) on
    [B, L, in] -> [B, L+k-1, out]. `weight` [in, out, k] is the layout
    of both torch's module and the JAX package's parameter."""

    def __init__(self, in_features: int, out_features: int, k: int):
        super().__init__()
        bound = 1.0 / math.sqrt(out_features * k)
        self.weight = nn.Parameter(torch.empty(
            in_features, out_features, k).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out_features).uniform_(
            -bound, bound))

    def forward(self, x):
        y = nn.functional.conv_transpose1d(x.transpose(1, 2), self.weight,
                                           self.bias)
        return y.transpose(1, 2)


class HeadConv1x1(nn.Module):
    """Conv2d(C_in, C_out, 1) + PReLU + espnet LN4DCF((C_out, F)) on
    [B, C, T, F] (espnet's per-head attention projection). `weight`
    [out, C] is the JAX `kernel` [C, out] transposed."""

    def __init__(self, in_channels: int, out_channels: int, n_freqs: int,
                 eps: float = 1e-5):
        super().__init__()
        bound = 1.0 / math.sqrt(in_channels)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(out_channels).uniform_(
            -bound, bound))
        self.act = PReLU()
        self.norm = EspnetLayerNorm4DCF(out_channels, n_freqs, eps)

    def forward(self, x):
        y = torch.einsum("bctf,oc->botf", x, self.weight) \
            + self.bias[None, :, None, None]
        return self.norm(self.act(y))


class GridNetBlockOffline(nn.Module):
    """espnet2 GridNetBlock (offline, bidirectional, full attention) on
    [B, C, T, F]."""

    def __init__(self, emb_dim: int, emb_ks: int, emb_hs: int, n_freqs: int,
                 hidden: int, n_head: int = 4, approx_qk_dim: int = 512,
                 eps: float = 1e-5):
        super().__init__()
        if emb_hs != 1:
            raise ValueError("only the stride-1 unfold is supported")
        c, k, h = emb_dim, emb_ks, hidden
        self.emb_ks, self.n_head = k, n_head
        self.e_dim = int(math.ceil(approx_qk_dim / n_freqs))
        e, vd = self.e_dim, c // n_head
        self.intra_norm = EspnetLayerNorm4D(c, eps)
        self.intra_rnn = LSTM(c * k, h, bidirectional=True)
        self.intra_linear = ConvTranspose1dK(2 * h, c, k)
        self.inter_norm = EspnetLayerNorm4D(c, eps)
        self.inter_rnn = LSTM(c * k, h, bidirectional=True)
        self.inter_linear = ConvTranspose1dK(2 * h, c, k)

        def heads(dim):
            return nn.ModuleList(HeadConv1x1(c, dim, n_freqs, eps)
                                 for _ in range(n_head))
        self.attn_q, self.attn_k, self.attn_v = heads(e), heads(e), heads(vd)
        self.attn_concat_proj = HeadConv1x1(c, c, n_freqs, eps)

    def _intra(self, inp):
        """Intra-frequency BiLSTM stage: [B, C, T, F] -> same."""
        b, c, t, f = inp.shape
        y = self.intra_norm(inp).transpose(1, 2).reshape(b * t, c, f)
        y, _ = self.intra_rnn(_unfold_k(y, self.emb_ks))   # [BT, F-k+1, 2H]
        y = self.intra_linear(y)                            # [BT, F, C]
        return y.reshape(b, t, f, c).permute(0, 3, 1, 2) + inp

    def _inter(self, inp):
        """Inter-time BiLSTM stage: [B, C, T, F] -> same."""
        b, c, t, f = inp.shape
        z = self.inter_norm(inp).permute(0, 3, 1, 2).reshape(b * f, c, t)
        z, _ = self.inter_rnn(_unfold_k(z, self.emb_ks))   # [BF, T-k+1, 2H]
        z = self.inter_linear(z)                            # [BF, T, C]
        return z.reshape(b, f, t, c).permute(0, 3, 2, 1) + inp

    def _attn(self, z):
        """Full multi-head time attention stage: [B, C, T, F] -> same."""
        b, c, t, f = z.shape
        nh, e = self.n_head, self.e_dim
        vd = c // nh

        def flat(mods, dim):
            # [B, nh, dim, T, F] -> [B, nh, T, dim*F]: espnet flattens
            # (dim, F) dim-major
            hs = torch.stack([m(z) for m in mods], dim=1)
            return hs.transpose(2, 3).reshape(b, nh, t, dim * f)
        q, k, v = flat(self.attn_q, e), flat(self.attn_k, e), \
            flat(self.attn_v, vd)
        scores = torch.matmul(q, k.transpose(-1, -2)) \
            * float(1.0 / math.sqrt(e * f))
        out = torch.matmul(torch.softmax(scores, dim=-1), v)  # [B,nh,T,V*F]
        out = out.reshape(b, nh, t, vd, f).transpose(2, 3)
        out = self.attn_concat_proj(out.reshape(b, nh * vd, t, f))
        return out + z

    def forward(self, x):
        """x: [B, C, T, F] -> [B, C, T, F]."""
        return self._attn(self._inter(self._intra(x)))


class OfflineTFGridNetTrunk(nn.Module):
    """Shared trunk: centered STFT -> conv -> N offline blocks. Returns
    [B, C, T, F] features; std-normalizing the input is the caller's
    job."""

    def __init__(self, n_fft: int = 128, stride: int = 64, n_imics: int = 2,
                 n_layers: int = 3, lstm_hidden_units: int = 64,
                 attn_n_head: int = 4, attn_approx_qk_dim: int = 512,
                 emb_dim: int = 64, emb_ks: int = 4, emb_hs: int = 1,
                 eps: float = 1e-5):
        super().__init__()
        self.remat = False
        self.n_fft, self.stride, self.emb_dim = n_fft, stride, emb_dim
        f = n_fft // 2 + 1
        self.conv = nn.Conv2d(2 * n_imics, emb_dim, 3, padding=1)
        self.conv_norm = GroupNorm1(emb_dim, eps)
        self.blocks = nn.ModuleList(
            GridNetBlockOffline(emb_dim, emb_ks, emb_hs, f,
                                lstm_hidden_units, attn_n_head,
                                attn_approx_qk_dim, eps)
            for _ in range(n_layers))

    def forward(self, x):
        """x: [B, M, N] std-normalized audio -> [B, C, T, F]."""
        spec = stft_ops.stft_center(x, self.n_fft, self.stride)  # [B,M,T,F]
        h = self.conv_norm(self.conv(torch.cat([spec.real, spec.imag], 1)))
        for blk in self.blocks:
            h = checkpoint(blk, h, use_reentrant=False) \
                if self.remat and torch.is_grad_enabled() else blk(h)
        return h


def std_normalize(x):
    """(x / its std over (mics, samples), unbiased like torch.std, the
    std) for x [B, M, N]."""
    std = torch.std(x, dim=(1, 2), keepdim=True)
    return x / std, std


class EmbedTFGridNet(nn.Module):
    """Binaural enrollment network -> 256-d speaker d-vector."""

    def __init__(self, embed_dim: int = 256, n_fft: int = 128,
                 stride: int = 64, n_imics: int = 2, n_layers: int = 3,
                 emb_dim: int = 64, lstm_hidden_units: int = 64,
                 eps: float = 1e-5):
        super().__init__()
        self.trunk = OfflineTFGridNetTrunk(
            n_fft=n_fft, stride=stride, n_imics=n_imics, n_layers=n_layers,
            emb_dim=emb_dim, lstm_hidden_units=lstm_hidden_units, eps=eps)
        self.embed_proj_dense = TorchDense(emb_dim * (n_fft // 2 + 1),
                                           embed_dim)
        self.embed_proj_norm = LayerNorm(embed_dim, eps)

    def forward(self, x):
        """x: [B, M, N] noisy binaural enrollment -> [B, embed_dim]."""
        h = self.trunk(std_normalize(x)[0])                # [B, C, T, F]
        b, c, t, f = h.shape
        h = h.transpose(1, 2).reshape(b, t, c * f)          # C-major
        return self.embed_proj_norm(self.embed_proj_dense(h)).mean(dim=1)
