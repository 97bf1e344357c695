"""Plain PyTorch reference of the training step of `TSETask` with
`Trainer` (the first steps from given weights): the separator's
whole-utterance forward, the loss mean over rows of -SNR averaged over
the output channels (torchmetrics' SNR: not zero-meaned, eps 1e-8), the
gradient by autograd, an optional clip by global norm as optax does
it, and Adam (optax's defaults, written out)."""

from __future__ import annotations

import torch

from benchmark.reference import precision
from benchmark.reference.tfgridnet import Reference

EPS = 1e-8
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def snr(pred, target):
    num = (target ** 2).sum(-1)
    den = ((target - pred) ** 2).sum(-1)
    return 10.0 * torch.log10(num / (den + EPS) + EPS)


def loss_fn(ref: Reference, batch: dict, rows=None):
    """-mean SNR of the separated output against the target; `rows`
    limits the batch (a fault of the check's tests and controls)."""
    x, t, e = batch["mixture"], batch["target"], batch["embedding_gt"]
    if rows is not None:
        x, t, e = x[rows], t[rows], e[rows]
    out = ref.utterance(x, e[:, 0])
    return -snr(out, t).mean(dim=-1).mean()


def steps(mp: dict, params: dict, batches: list, lr: float,
          grad_clip=None, mode: str = "f32", rows=None) -> dict:
    """len(batches) steps from `params` ({name: float32 tensor}; not
    changed). Returns {"losses": [float], "grad_norms": {name: norm of
    the first step's gradient}, "change_norms": {name: norm of the
    parameters' change over all the steps}}. `rows` plants the fault of
    half the batch left out."""
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in leaves.items()}
    v = {n: torch.zeros_like(p) for n, p in leaves.items()}
    names = sorted(leaves)
    losses, grad_norms = [], None
    with precision(mode):
        ref = Reference(mp, leaves, mode=mode)
        for k, batch in enumerate(batches, start=1):
            loss = loss_fn(ref, batch, rows)
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            grads = dict(zip(names, grads))
            if grad_clip:
                norm = torch.sqrt(sum((g ** 2).sum() for g in grads.values()))
                if norm >= grad_clip:
                    grads = {n: g * (grad_clip / norm)
                             for n, g in grads.items()}
            losses.append(float(loss.detach()))
            if grad_norms is None:
                grad_norms = {n: float(g.norm()) for n, g in grads.items()}
            b1, b2 = BETAS
            with torch.no_grad():
                for n, g in grads.items():
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[n] / (1 - b1 ** k)
                    vhat = v[n] / (1 - b2 ** k)
                    leaves[n] -= lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
            del loss, grads
    change = {n: float((leaves[n].detach() - params[n]).norm())
              for n in names}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}

