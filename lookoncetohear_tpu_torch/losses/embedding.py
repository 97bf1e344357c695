"""Cosine similarity and the contrastive embedding loss on tensors
(counterpart of `lookoncetohear_tpu/losses/embedding.py`).

torch.nn.CosineEmbeddingLoss semantics, as the embedding task uses it
(margin 0.5): positive pairs against the clean d-vector, negative pairs
against the other speakers' d-vectors.
"""

from __future__ import annotations

import torch


def _cos(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    num = (a * b).sum(-1)
    den = torch.linalg.vector_norm(a, dim=-1) * \
        torch.linalg.vector_norm(b, dim=-1)
    return num / den.clamp_min(eps)


def cosine_embedding_loss(emb: torch.Tensor, other: torch.Tensor,
                          y: torch.Tensor, margin: float = 0.0,
                          reduction: str = "mean") -> torch.Tensor:
    """torch.nn.CosineEmbeddingLoss.

    emb, other: [B, E]; y: [B] of +1 / -1.
    loss_i = 1 - cos(e_i, o_i)              if y_i == 1
           = max(0, cos(e_i, o_i) - margin) if y_i == -1
    reduction: 'mean' -> scalar; 'none' -> per-sample [B].
    """
    cos = _cos(emb, other)
    per_sample = torch.where(y > 0, 1.0 - cos, (cos - margin).clamp_min(0.0))
    if reduction == "none":
        return per_sample
    return per_sample.mean()


def cosine_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain cosine similarity over the last axis (the eval metric)."""
    return _cos(a, b)
