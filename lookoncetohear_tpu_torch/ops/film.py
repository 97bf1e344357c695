"""FiLM conditioning layer (counterpart of `lookoncetohear_tpu/ops/film.py`,
the reference's src/models/tfgridnet_realtime/film.py, which the
reference separator imports but its default config does not use).

out = gamma(cond) * x + beta(cond), gamma and beta two Linear maps of
the conditioning vector: the JAX package's corrected semantics (the
reference's bias path reuses the gamma conv). Parameters load under the
JAX names through `weights.py` (`gamma/kernel` -> `gamma.weight`).
"""

from __future__ import annotations

import torch
from torch import nn


class FiLM(nn.Module):
    """x: [B, C, *spatial], cond: [B, E] -> x modulated per channel."""

    def __init__(self, cond_dim: int, channels: int):
        super().__init__()
        self.channels = channels
        self.gamma = nn.Linear(cond_dim, channels)
        self.beta = nn.Linear(cond_dim, channels)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[0], self.channels) + (1,) * (x.ndim - 2)
        return self.gamma(cond).reshape(shape) * x + \
            self.beta(cond).reshape(shape)
