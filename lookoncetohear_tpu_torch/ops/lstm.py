"""LSTM pieces of the streaming step and of training (counterpart of
`lookoncetohear_tpu/ops/lstm.py`), torch.nn.LSTM parameter layout:
gate order i, f, g, o; w_ih [4H, I], w_hh [4H, H], two bias vectors.

Every recurrence over T > 1 goes through `ops/bilstm_scan.py`: B2 for
an inference BiLSTM, and the differentiable `bilstm_scan_train`
(state-saving forward and backward kernels on the card, which take the
projections [B, T, D*4H] and return y [B, T, D*H] as they are) for a
BiLSTM that needs a gradient and for the one-direction LSTM from a
carried state. The T = 1 serving step is plain ops (`lstm_step`). The
kernels take H = 64 and H = 128 (the reference's default `Net`); at
H = 128 only without a gradient on the card (no backward kernel yet).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from lookoncetohear_tpu_torch.ops.bilstm_scan import (bilstm_scan,
                                                      bilstm_scan_train)


class LSTMParams(NamedTuple):
    w_ih: torch.Tensor  # [4H, I]
    w_hh: torch.Tensor  # [4H, H]
    b_ih: torch.Tensor  # [4H]
    b_hh: torch.Tensor  # [4H]


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_step(params: LSTMParams, x_t, h, c):
    """One LSTM timestep: x_t [B, I], h/c [B, H] -> (h, c)."""
    gates = x_t @ params.w_ih.T + (params.b_ih + params.b_hh) \
        + h @ params.w_hh.T
    return _cell(gates, c)


def lstm_apply(params: LSTMParams, x, h0=None, c0=None):
    """One direction over x [B, T, I] from carried (h0, c0).

    Returns (outputs [B, T, H], (hT, cT)); carries follow the dtype of
    the input projection, as in the JAX package. T = 1 is the serving
    step (`lstm_step`); a longer T is one `bilstm_scan_train` call with
    D = 1, in inference and training alike."""
    b, t_len, _ = x.shape
    hidden = params.w_hh.shape[1]
    x_proj = x @ params.w_ih.T + (params.b_ih + params.b_hh)
    h = x_proj.new_zeros((b, hidden)) if h0 is None else h0.to(x_proj.dtype)
    c = x_proj.new_zeros((b, hidden)) if c0 is None else c0.to(x_proj.dtype)
    if t_len == 1:
        h, c = _cell(x_proj[:, 0] + h @ params.w_hh.T, c)
        return h[:, None], (h, c)
    ys, c_t = bilstm_scan_train(x_proj, params.w_hh.T[None], h[None],
                                c[None])
    ys = ys.to(x_proj.dtype)                              # [B, T, H]
    return ys, (ys[:, -1], c_t[0].to(x_proj.dtype))


def bidir_scan_inputs(fwd: LSTMParams, bwd: LSTMParams, x):
    """B2's inputs for x [B, T, I]: xp [T, 2, B, 4H], the input
    projections with both biases, direction 1 time-flipped, and w_hh
    [2, H, 4H] (transposed)."""
    xp_f = x @ fwd.w_ih.T + (fwd.b_ih + fwd.b_hh)
    xp_b = x.flip(1) @ bwd.w_ih.T + (bwd.b_ih + bwd.b_hh)
    w_hh = torch.stack([fwd.w_hh.T, bwd.w_hh.T], dim=0)     # [2, H, 4H]
    return torch.stack([xp_f, xp_b], dim=0).permute(2, 0, 1, 3), w_hh


def lstm_apply_bidir(fwd: LSTMParams, bwd: LSTMParams, x):
    """Bidirectional LSTM, both directions in one loop over T.

    x: [B, T, I] -> (y [B, T, 2H], ((hT_f, hT_b), (cT_f, cT_b))). The
    recurrence runs in float32 and is cast back to x's dtype. Without a
    gradient to keep it goes through `bilstm_scan` (B2 for GPU tensors;
    `bidir_scan_inputs`), with one through the differentiable
    `bilstm_scan_train`, whose layouts are the model's: one GEMM makes
    both directions' projections [B, T, 8H], and the scan returns y as
    it is. Either runs its plain version for CPU tensors
    (`ops/bilstm_scan.py`)."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in (*fwd, *bwd)))
    if not needs_grad:
        ys, c_t = bilstm_scan(*bidir_scan_inputs(fwd, bwd, x))
        ys = ys.to(x.dtype)
        h_t = ys[-1]
        c_t = c_t.to(x.dtype)
        y = torch.cat([ys[:, 0].transpose(0, 1),
                       ys[:, 1].transpose(0, 1).flip(1)], dim=-1)
        return y, ((h_t[0], h_t[1]), (c_t[0], c_t[1]))
    hidden = fwd.w_hh.shape[1]
    xp = x @ torch.cat([fwd.w_ih, bwd.w_ih]).T + torch.cat(
        [fwd.b_ih + fwd.b_hh, bwd.b_ih + bwd.b_hh])
    y, c_t = bilstm_scan_train(xp, torch.stack([fwd.w_hh.T, bwd.w_hh.T]))
    y, c_t = y.to(x.dtype), c_t.to(x.dtype)
    # the backward direction ends at time 0
    return y, ((y[:, -1, :hidden], y[:, 0, hidden:]), (c_t[0], c_t[1]))


class LSTM(nn.Module):
    """Single-layer LSTM with the flax module's parameter names
    (w_ih_l0, ..., and *_reverse for the backward direction)."""

    def __init__(self, in_features: int, hidden: int,
                 bidirectional: bool = False):
        super().__init__()
        self.bidirectional = bidirectional
        bound = 1.0 / hidden ** 0.5
        sfx = ["_l0", "_l0_reverse"] if bidirectional else ["_l0"]
        for s in sfx:
            for name, shape in (("w_ih", (4 * hidden, in_features)),
                                ("w_hh", (4 * hidden, hidden)),
                                ("b_ih", (4 * hidden,)),
                                ("b_hh", (4 * hidden,))):
                self.register_parameter(name + s, nn.Parameter(
                    torch.empty(shape).uniform_(-bound, bound)))

    def params(self, suffix: str = "_l0") -> LSTMParams:
        return LSTMParams(*(getattr(self, n + suffix)
                            for n in ("w_ih", "w_hh", "b_ih", "b_hh")))

    def forward(self, x, h0=None, c0=None):
        if self.bidirectional:
            return lstm_apply_bidir(self.params(),
                                    self.params("_l0_reverse"), x)
        return lstm_apply(self.params(), x, h0, c0)
