"""Public model wrappers (counterpart of
`lookoncetohear_tpu/models/net.py`), with the same config field names
as the JAX package and the reference's `model_params` JSON:

  * `Net`, the streaming separator, and `mod_pad`: `step` (one 8 ms
    chunk), `predict` and `forward` (the JAX `__call__`: a whole
    utterance, with the optional direction-of-arrival head);
  * `EmbedNet`, the enrollment net (noisy binaural snippet -> d-vector);
  * `OfflineSeparatorNet`, the offline 2-source separator.

`Net.forward`, `EmbedNet.forward` and `OfflineSeparatorNet.forward` are
differentiable (the training tasks call them); their inference callers
run them under `torch.no_grad()` or `torch.inference_mode()`.
`Net.predict` and `Net.step`, which no training path calls, keep no
graph.
"""

from __future__ import annotations

import torch
from torch import nn

from lookoncetohear_tpu_torch import resolve_device
from lookoncetohear_tpu_torch.models.offline_tfgridnet import (
    EmbedTFGridNet, OfflineTFGridNetTrunk, std_normalize)
from lookoncetohear_tpu_torch.models.streaming_tfgridnet import \
    StreamingTFGridNet
from lookoncetohear_tpu_torch.ops import stft as stft_ops


def mod_pad(x: torch.Tensor, chunk_size: int, pad: tuple[int, int]):
    """Pad the last axis to a whole number of chunks, then by (left,
    right) more. Returns (padded x, the number of samples added to
    make whole chunks)."""
    mod = (-x.shape[-1]) % chunk_size
    x = torch.nn.functional.pad(x, (0, mod))
    return torch.nn.functional.pad(x, tuple(pad)), mod


class Net(nn.Module):
    """Streaming TSE network. Built on `device` ("cuda" by default;
    raises without a card unless device="cpu" is passed)."""

    def __init__(self, stft_chunk_size: int = 160, stft_pad_size: int = 120,
                 embed_dim: int = 256, num_ch: int = 2, D: int = 64,
                 B: int = 6, I: int = 1, J: int = 1, L: int = 0,
                 H: int = 128, use_attn: bool = False, lookahead: bool = True,
                 local_atten_len: int = 100, chunk_causal: bool = False,
                 num_src: int = 2, dir_head: bool = False,
                 n_dir_bins: int = 33, device=None):
        super().__init__()
        if I != 1 or J != 1:
            raise ValueError("streaming TF-GridNet uses emb_ks=emb_hs=1")
        self.stft_chunk_size, self.stft_pad_size = stft_chunk_size, \
            stft_pad_size
        self.embed_dim, self.num_ch, self.num_src = embed_dim, num_ch, \
            num_src
        self.lookahead, self.chunk_causal = lookahead, chunk_causal
        self.tfgridnet = StreamingTFGridNet(
            n_srcs=num_src, n_fft=self.nfft, stride=stft_chunk_size,
            n_imics=num_ch, n_layers=B, lstm_hidden_units=H,
            attn_n_head=L, attn_approx_qk_dim=512, emb_dim=D,
            spk_emb_dim=embed_dim, local_atten_len=local_atten_len,
            use_attn=use_attn, chunk_causal=chunk_causal)
        # optional direction-of-arrival head: per-frame logits over
        # n_dir_bins from the frequency mean of the pre-deconv features
        self.dir_head, self.n_dir_bins = dir_head, n_dir_bins
        if dir_head:
            self.dir_proj = nn.Linear(D, n_dir_bins)
        self.to(resolve_device(device))

    def _shifts_to_indices(self, shifts):
        """L/R cross-correlation shifts (the dataset's tgt_shift, within
        +-16 samples) -> direction bins in [0, n_dir_bins), linear in
        the shift."""
        max_shift = 16
        s = shifts.clamp(-max_shift, max_shift)
        idx = torch.round((s + max_shift) * (self.n_dir_bins - 1)
                          / (2 * max_shift))
        return idx.to(torch.int64)

    @property
    def nfft(self) -> int:
        return self.stft_chunk_size + self.stft_pad_size

    @property
    def device(self) -> torch.device:
        return self.tfgridnet.fb.device

    def init_state(self, batch_size: int, dtype=torch.float32,
                   kv_dtype=None):
        """Zero streaming state on the model's device; kv_dtype=None
        keeps the K/V ring in `dtype`, torch.int8 selects the int8
        serving ring."""
        return self.tfgridnet.init_state(batch_size, dtype, kv_dtype)

    @torch.no_grad()
    def predict(self, x, embed, state, pad: bool = True):
        """x: [B, M, N']; embed: [B, E]. Returns (y [B, S, N'], state).

        With pad=True, x is padded to whole chunks plus the lookahead
        `stft_pad_size` and the output trimmed back to N' samples; with
        pad=False, x must hold whole frames. Keeps no graph; `forward`
        is the differentiable call."""
        return self._separate(x, embed, state, pad)

    def _separate(self, x, embed, state, pad: bool, features: bool = False):
        n_in = x.shape[-1]
        if pad:
            x, _ = mod_pad(x, self.stft_chunk_size,
                           (0, self.stft_pad_size if self.lookahead else 0))
        y, *rest = self.tfgridnet(x, embed, state, return_features=features)
        return ((y[..., :n_in] if pad else y), *rest)

    def forward(self, x, embeds, state=None, pad: bool = True,
                dir: bool = False):
        """x: [B, M, N]; embeds: [B, n_enroll, E], of which the first
        enrollment is used. Returns separated audio [B, S, N], and with
        dir=True also per-frame direction logits [B, T, n_dir_bins].
        Without a state, starts from a fresh one in x's dtype."""
        embeds = embeds[:, 0]
        if state is None:
            state = self.init_state(x.shape[0], x.dtype)
        if not dir:
            return self._separate(x, embeds, state, pad)[0]
        if not self.dir_head:
            raise ValueError("construct Net with dir_head=True")
        y, _, feats = self._separate(x, embeds, state, True, features=True)
        # [B, D, T, F] -> frequency mean [B, T, D] -> logits
        return y, self.dir_proj(feats.mean(dim=3).transpose(1, 2))

    @torch.no_grad()
    def step(self, x_chunk, embed, state):
        """One 8 ms streaming step: x_chunk [B, M, nfft] is the current
        chunk plus lookahead; returns ([B, S, chunk], state). The ring
        leaves of `state` are updated in place."""
        return self.tfgridnet(x_chunk, embed, state)


class EmbedNet(nn.Module):
    """Enrollment network with the reference constructor signature
    (configs/embed*.json model_params). Built on `device` ("cuda" by
    default; raises without a card unless device="cpu" is passed)."""

    def __init__(self, embed_dim: int = 256, num_ch: int = 2,
                 n_fft: int = 128, stride: int = 64, num_blocks: int = 3,
                 device=None):
        super().__init__()
        self.net = EmbedTFGridNet(embed_dim=embed_dim, n_fft=n_fft,
                                  stride=stride, n_imics=num_ch,
                                  n_layers=num_blocks)
        self.to(resolve_device(device))

    def forward(self, x):
        """x: [B, M, N] noisy binaural enrollment -> [B, embed_dim]."""
        return self.net(x)


class OfflineSeparatorNet(nn.Module):
    """Offline 2-source separator (the reference's tfgridnet_orig `Net`):
    trunk features -> 3x3 conv to (real, imag) per source -> centered
    iSTFT, rescaled by the input's std."""

    def __init__(self, num_ch: int = 1, n_fft: int = 128, stride: int = 64,
                 num_blocks: int = 6, n_srcs: int = 2, device=None):
        super().__init__()
        self.n_fft, self.stride, self.n_srcs = n_fft, stride, n_srcs
        self.trunk = OfflineTFGridNetTrunk(
            n_fft=n_fft, stride=stride, n_imics=num_ch,
            n_layers=num_blocks, lstm_hidden_units=64)
        self.deconv = nn.Conv2d(self.trunk.emb_dim, 2 * n_srcs, 3,
                                padding=1)
        self.to(resolve_device(device))

    def forward(self, x):
        """x: [B, M, N] -> [B, n_srcs, N]."""
        xn, std = std_normalize(x)
        y = self.deconv(self.trunk(xn))                  # [B, 2S, T, F]
        b, _, t, f = y.shape
        y = y.reshape(b, self.n_srcs, 2, t, f)
        spec = torch.complex(y[:, :, 0], y[:, :, 1])     # [B, S, T, F]
        audio = stft_ops.istft_center(spec, self.n_fft, self.stride,
                                      length=x.shape[-1])
        return audio * std
