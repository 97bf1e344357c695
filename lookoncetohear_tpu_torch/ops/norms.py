"""Normalization layers of the streaming serving step (counterpart of
the serving half of `lookoncetohear_tpu/ops/norms.py`).

`flat_head_layer_norm` and `flat_layer_norm` are the serving forms: the
statistics are the one-pass E[x^2] - mu^2 in float32 over the flat
[B, D] projection layout, cast back to the input dtype, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch
# The JAX package's LayerNorm (flax scale/bias) and PReLU (one shared
# slope `alpha`, init 0.25) are written to match these two; the
# weights' names map in `weights.py`.
from torch.nn import LayerNorm, PReLU

__all__ = ["LayerNorm", "PReLU", "head_segment_matrix",
           "flat_head_layer_norm", "flat_layer_norm"]


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
