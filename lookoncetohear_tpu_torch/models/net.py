"""Public streaming model wrapper (counterpart of `Net` in
`lookoncetohear_tpu/models/net.py`), with the same config field names
as the JAX package and the reference's `model_params` JSON.

Only the streaming step is ported; full-utterance `predict`/`__call__`,
the direction head and the enrollment nets wait for later slices.
"""

from __future__ import annotations

import torch
from torch import nn

from lookoncetohear_tpu_torch import resolve_device
from lookoncetohear_tpu_torch.models.streaming_tfgridnet import \
    StreamingTFGridNet


class Net(nn.Module):
    """Streaming TSE network. Built on `device` ("cuda" by default;
    raises without a card unless device="cpu" is passed)."""

    def __init__(self, stft_chunk_size: int = 160, stft_pad_size: int = 120,
                 embed_dim: int = 256, num_ch: int = 2, D: int = 64,
                 B: int = 6, I: int = 1, J: int = 1, L: int = 0,
                 H: int = 128, use_attn: bool = False, lookahead: bool = True,
                 local_atten_len: int = 100, chunk_causal: bool = False,
                 num_src: int = 2, device=None):
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
            use_attn=use_attn)
        self.to(resolve_device(device))

    @property
    def nfft(self) -> int:
        return self.stft_chunk_size + self.stft_pad_size

    @property
    def device(self) -> torch.device:
        return self.tfgridnet.fb.device

    def init_state(self, batch_size: int, dtype=torch.float32,
                   kv_dtype=torch.int8):
        return self.tfgridnet.init_state(batch_size, dtype, kv_dtype)

    @torch.no_grad()
    def step(self, x_chunk, embed, state):
        """One 8 ms streaming step: x_chunk [B, M, nfft] is the current
        chunk plus lookahead; returns ([B, S, chunk], state). The ring
        leaves of `state` are updated in place."""
        return self.tfgridnet(x_chunk, embed, state)
