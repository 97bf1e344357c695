"""Normalization layers (counterpart of
`lookoncetohear_tpu/ops/norms.py`).

`flat_head_layer_norm` and `flat_layer_norm` are the serving forms of
the streaming step: the statistics are the one-pass E[x^2] - mu^2 in
float32 over the flat [B, D] projection layout, cast back to the input
dtype, as in the JAX package.

`EspnetLayerNorm4D`, `EspnetLayerNorm4DCF` and `GroupNorm1` are the
offline TF-GridNet's norms on [B, C, T, F]: biased variance, eps inside
the square root, affine parameters shaped like the JAX package's
(`gamma`/`beta` [1, C, 1, 1] or [1, C, 1, F]; GroupNorm1's flax
`scale`/`bias` load as `weight`/`bias`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
# The JAX package's LayerNorm (flax scale/bias) and PReLU (one shared
# slope `alpha`, init 0.25) are written to match these two; the
# weights' names map in `weights.py`.
from torch.nn import LayerNorm, PReLU

__all__ = ["LayerNorm", "PReLU", "EspnetLayerNorm4D", "EspnetLayerNorm4DCF",
           "GroupNorm1", "head_segment_matrix", "flat_head_layer_norm",
           "flat_layer_norm"]


def normalize(x, dims, eps: float):
    """(x - mean) / sqrt(biased var + eps) over `dims`."""
    var, mu = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return (x - mu) / torch.sqrt(var + eps)


class _AffineNorm4D(nn.Module):
    """Normalize [B, C, T, F] over `dims`, then scale and shift by
    parameters of `shape`."""

    dims: tuple = ()

    def __init__(self, shape, eps: float, names=("gamma", "beta")):
        super().__init__()
        self.eps = eps
        self._names = names
        self.register_parameter(names[0], nn.Parameter(torch.ones(shape)))
        self.register_parameter(names[1], nn.Parameter(torch.zeros(shape)))

    def forward(self, x):
        scale, shift = (getattr(self, n) for n in self._names)
        return normalize(x, self.dims, self.eps) * scale + shift


class EspnetLayerNorm4D(_AffineNorm4D):
    """espnet LayerNormalization4D: over C, (C,)-affine."""

    dims = (1,)

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__((1, channels, 1, 1), eps)


class EspnetLayerNorm4DCF(_AffineNorm4D):
    """espnet LayerNormalization4DCF: over (C, F), (C, F)-affine."""

    dims = (1, 3)

    def __init__(self, channels: int, freqs: int, eps: float = 1e-5):
        super().__init__((1, channels, 1, freqs), eps)


class GroupNorm1(_AffineNorm4D):
    """torch GroupNorm(1, C): over (C, T, F), per-channel affine."""

    dims = (1, 2, 3)

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__((1, channels, 1, 1), eps, ("weight", "bias"))


def head_segment_matrix(d_flat: int, n_head: int, dim: int) -> np.ndarray:
    """[D, nh] 0/1 float32: flat (f, head, dim) column d belongs to head
    (d % (n_head*dim)) // dim."""
    col = np.arange(d_flat)
    head = (col % (n_head * dim)) // dim
    return (head[:, None] == np.arange(n_head)[None, :]).astype(np.float32)


def flat_head_layer_norm(y_flat, seg, n_per_head: float, scale_flat,
                         bias_flat, eps: float):
    """Per-(row, head) LayerNorm on flat (f, head, dim) columns.

    y_flat: [B, D]; seg: [D, nh] 0/1; scale/bias_flat: [D]. Returns
    y_flat's dtype."""
    x = y_flat.float()
    seg = seg.float()
    mu = (x @ seg) / n_per_head                           # [B, nh]
    m2 = ((x * x) @ seg) / n_per_head
    inv = torch.rsqrt(torch.clamp(m2 - mu * mu, min=0.0) + eps)
    xn = (x - mu @ seg.T) * (inv @ seg.T)
    return (xn * scale_flat + bias_flat).to(y_flat.dtype)


def flat_layer_norm(x_flat, scale_flat, bias_flat, eps: float):
    """Whole-row LayerNorm on [B, D], one-pass float32 statistics."""
    d = x_flat.shape[-1]
    x = x_flat.float()
    mu = x.sum(-1, keepdim=True) / d
    m2 = (x * x).sum(-1, keepdim=True) / d
    inv = torch.rsqrt(torch.clamp(m2 - mu * mu, min=0.0) + eps)
    xn = (x - mu) * inv
    return (xn * scale_flat + bias_flat).to(x_flat.dtype)
