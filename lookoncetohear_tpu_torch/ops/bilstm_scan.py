"""LSTM recurrences: the CUDA kernels (`csrc/bilstm_scan.cu`) and their
plain PyTorch versions.

* `bilstm_scan` (B2, inference): both directions of a BiLSTM from a
  zero state, replacing the Pallas kernel
  `lookoncetohear_tpu/ops/pallas_lstm.py::bilstm_scan_pallas`. Contract:
  xp [T, 2, B, 4H] pre-projected inputs with biases, direction 1
  already time-flipped; w_hh [2, H, 4H] (transposed). Returns (ys
  [T, 2, B, H], c_T [2, B, H]).
* `bilstm_scan_train` (training and the inter-time LSTM): the same
  recurrence over D = 1 or 2 directions from an optional (h0, c0)
  [D, B, H], as a `torch.autograd.Function` (`BiLSTMScan`) whose
  forward saves every cell state and whose backward is a kernel of its
  own. They stand for the differentiated `lax.scan` of
  `lookoncetohear_tpu/ops/lstm.py` (`_lstm_scan`, `_chunked_scan`):
  the TPU kernel has no gradient.

Everything runs in float32 on the card. A wrapper launches its kernel
for CUDA tensors and uses the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from lookoncetohear_tpu_torch import _build

# the hidden width the kernels are instantiated for (W_hh's slices live
# in each thread's registers): the model's H
KERNEL_HIDDEN = 64


def bilstm_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                          dtype=torch.float32, h0=None, c0=None,
                          with_cs: bool = False):
    """Plain PyTorch version of the forward: a loop over T, the D
    directions of xp [T, D, B, 4H] and w_hh [D, H, 4H] at once, from
    (h0, c0) [D, B, H] (None: zero), in `dtype` (float32 as the
    kernels; float64 to measure how far each float32 version drifts
    from the exact recurrence). Returns (ys [T, D, B, H], c_T
    [D, B, H]), and with `with_cs` also cs [T, D, B, H], every step's
    cell state (what the training forward saves)."""
    xp = xp.to(dtype)
    w_hh = w_hh.to(dtype)
    t_len, nd, b, g4 = xp.shape
    hidden = g4 // 4
    h = xp.new_zeros((nd, b, hidden)) if h0 is None else h0.to(dtype)
    c = xp.new_zeros((nd, b, hidden)) if c0 is None else c0.to(dtype)
    ys, cs = [], []
    for t in range(t_len):
        gates = xp[t] + torch.bmm(h, w_hh)          # [D, B, 4H]
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
        cs.append(c)
    if with_cs:
        return torch.stack(ys), c, torch.stack(cs)
    return torch.stack(ys), c


def bilstm_scan_backward_reference(xp, w_hh, h0, c0, ys, cs, dys, dc_t):
    """Plain PyTorch version of the backward kernel: an explicit reverse
    loop that recomputes each step's gates from h_{t-1} (ys[t-1] or h0)
    and returns (dxp [T, D, B, 4H], dh0, dc0 [D, B, H]). h0, c0, dys
    and dc_t may be None (zero). dW_hh is not part of it (see
    `scan_weight_grad`)."""
    t_len, nd, b, g4 = xp.shape
    hidden = g4 // 4
    zero = xp.new_zeros((nd, b, hidden))
    w_t = w_hh.transpose(1, 2)                      # [D, 4H, H]
    dh_next = zero
    dc_next = zero if dc_t is None else dc_t
    dxp = torch.empty_like(xp)
    for t in range(t_len - 1, -1, -1):
        h_prev = ys[t - 1] if t > 0 else (zero if h0 is None else h0)
        c_prev = cs[t - 1] if t > 0 else (zero if c0 is None else c0)
        gates = xp[t] + torch.bmm(h_prev, w_hh)
        i, f, g, o = gates.split(hidden, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        tc = torch.tanh(cs[t])
        dh = dh_next if dys is None else dys[t] + dh_next
        dc = dc_next + dh * o * (1.0 - tc * tc)
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g * g),
                            dh * tc * o * (1.0 - o)], dim=-1)
        dxp[t] = dgates
        dh_next = torch.bmm(dgates, w_t)
        dc_next = dc * f
    return dxp, dh_next, dc_next


def scan_weight_grad(dxp, ys, h0):
    """dW_hh [D, H, 4H] = sum over t and b of h_{t-1}^T dgates_t
    (h_{t-1} = ys[t-1], or h0 / zero at t=0): one batched product per
    (step, direction), then a sum over the steps. As a single product
    over T*B rows the output is only [H, 4H], 16 tiles of cuBLAS's
    32 x 32: 16 blocks on a 132-SM card (~8.6 ms at the TSE intra
    shape on an H100)."""
    first = torch.zeros_like(ys[:1]) if h0 is None else h0[None]
    h_prev = torch.cat([first, ys[:-1]])            # [T, D, B, H]
    return torch.matmul(h_prev.transpose(2, 3), dxp).sum(0)


def _check(xp, w_hh, name, directions=(1, 2), **states):
    """Raise on what the kernels do not take; returns (T, D, B, H)."""
    if xp.dim() != 4:
        raise ValueError(f"{name}: xp must be [T, D, B, 4H], got "
                         f"{tuple(xp.shape)}")
    t_len, nd, b, g4 = xp.shape
    hidden = g4 // 4
    if xp.device.type != "cuda" or w_hh.device != xp.device:
        raise ValueError(f"{name} needs its tensors on one GPU")
    if nd not in directions or g4 != 4 * hidden or t_len < 1 \
            or tuple(w_hh.shape) != (nd, hidden, g4):
        raise ValueError(f"{name}: bad shapes xp {tuple(xp.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    for key, (v, shape) in states.items():
        if v is not None and (v.device != xp.device
                              or v.dtype != torch.float32
                              or tuple(v.shape) != shape
                              or not v.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous float32 "
                             f"{list(shape)} on xp's GPU")
    if xp.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 xp and w_hh")
    if not (xp.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if hidden != KERNEL_HIDDEN:
        raise ValueError(f"{name} takes H={KERNEL_HIDDEN}, not {hidden}")
    return t_len, nd, b, hidden


def _ptr(t):
    return None if t is None else t.data_ptr()


def bilstm_scan_cuda(xp: torch.Tensor, w_hh: torch.Tensor):
    """Launch B2 on the current stream (no sync). Inference only: it
    refuses inputs that need a gradient, which it could not give."""
    if torch.is_grad_enabled() and (xp.requires_grad or w_hh.requires_grad):
        raise RuntimeError(
            "bilstm_scan_cuda is inference only and would drop the "
            "gradient of xp / w_hh; use bilstm_scan_train")
    t_len, _, b, hidden = _check(xp, w_hh, "bilstm_scan_cuda", (2,))
    ys = torch.empty((t_len, 2, b, hidden), device=xp.device,
                     dtype=torch.float32)
    c_t = torch.empty((2, b, hidden), device=xp.device, dtype=torch.float32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_scan_f32(xp.data_ptr(), w_hh.data_ptr(), ys.data_ptr(),
                             c_t.data_ptr(), t_len, b, hidden, stream)
    _build.check(rc, "bilstm_scan_f32")
    bilstm_scan_cuda.launches += 1
    return ys, c_t


bilstm_scan_cuda.launches = 0


def bilstm_scan_train_cuda(xp, w_hh, h0=None, c0=None, save_cs=True):
    """Launch the state-saving forward: (ys, c_T, cs) as
    `bilstm_scan_reference(..., with_cs=True)`; without `save_cs` (a
    pass that keeps no gradient) cs is not written and comes back
    None."""
    t_len, nd, b, hidden = xp.shape[0], xp.shape[1], xp.shape[2], \
        xp.shape[3] // 4
    _check(xp, w_hh, "bilstm_scan_train_cuda", h0=(h0, (nd, b, hidden)),
           c0=(c0, (nd, b, hidden)))
    ys = torch.empty((t_len, nd, b, hidden), device=xp.device,
                     dtype=torch.float32)
    cs = torch.empty_like(ys) if save_cs else None
    c_t = torch.empty((nd, b, hidden), device=xp.device, dtype=torch.float32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_scan_train_f32(
        xp.data_ptr(), w_hh.data_ptr(), _ptr(h0), _ptr(c0), ys.data_ptr(),
        _ptr(cs), c_t.data_ptr(), t_len, nd, b, hidden, stream)
    _build.check(rc, "bilstm_scan_train_f32")
    bilstm_scan_train_cuda.launches += 1
    return ys, c_t, cs


bilstm_scan_train_cuda.launches = 0


def bilstm_scan_bwd_cuda(xp, w_hh, h0, c0, ys, cs, dys, dc_t):
    """Launch the backward: (dxp, dh0, dc0) as
    `bilstm_scan_backward_reference`."""
    t_len, nd, b, hidden = xp.shape[0], xp.shape[1], xp.shape[2], \
        xp.shape[3] // 4
    seq, state = (t_len, nd, b, hidden), (nd, b, hidden)
    _check(xp, w_hh, "bilstm_scan_bwd_cuda", h0=(h0, state),
           c0=(c0, state), ys=(ys, seq), cs=(cs, seq), dys=(dys, seq),
           dc_t=(dc_t, state))
    if ys is None or cs is None:
        raise ValueError("bilstm_scan_bwd_cuda needs the forward's ys and cs")
    dxp = torch.empty_like(xp)
    dh0 = torch.empty(state, device=xp.device, dtype=torch.float32)
    dc0 = torch.empty_like(dh0)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_scan_bwd_f32(
        xp.data_ptr(), w_hh.data_ptr(), _ptr(h0), _ptr(c0), ys.data_ptr(),
        cs.data_ptr(), _ptr(dys), _ptr(dc_t), dxp.data_ptr(),
        dh0.data_ptr(), dc0.data_ptr(), t_len, nd, b, hidden, stream)
    _build.check(rc, "bilstm_scan_bwd_f32")
    bilstm_scan_bwd_cuda.launches += 1
    return dxp, dh0, dc0


bilstm_scan_bwd_cuda.launches = 0


class BiLSTMScan(torch.autograd.Function):
    """(xp, w_hh, h0, c0) -> (ys, c_T), differentiable in all four. On
    the card the forward and backward are the kernels (plus one matmul
    for dW_hh); on the CPU their plain versions, in the inputs' dtype."""

    @staticmethod
    def forward(ctx, xp, w_hh, h0, c0):
        if xp.device.type == "cpu":
            ys, c_t, cs = bilstm_scan_reference(xp, w_hh, xp.dtype, h0, c0,
                                                with_cs=True)
        else:
            ys, c_t, cs = bilstm_scan_train_cuda(xp, w_hh, h0, c0)
        ctx.save_for_backward(xp, w_hh, h0, c0, ys, cs)
        return ys, c_t

    @staticmethod
    def backward(ctx, dys, dc_t):
        xp, w_hh, h0, c0, ys, cs = ctx.saved_tensors
        if xp.device.type == "cpu":
            dxp, dh0, dc0 = bilstm_scan_backward_reference(
                xp, w_hh, h0, c0, ys, cs, dys, dc_t)
        else:
            dxp, dh0, dc0 = bilstm_scan_bwd_cuda(
                xp, w_hh, h0, c0, ys, cs,
                None if dys is None else dys.contiguous(),
                None if dc_t is None else dc_t.contiguous())
        dw = scan_weight_grad(dxp, ys, h0) if ctx.needs_input_grad[1] \
            else None
        return (dxp, dw, dh0 if ctx.needs_input_grad[2] else None,
                dc0 if ctx.needs_input_grad[3] else None)


def bilstm_scan_train(xp, w_hh, h0=None, c0=None):
    """The differentiable recurrence: xp [T, D, B, 4H], w_hh [D, H, 4H],
    optional (h0, c0) [D, B, H] -> (ys [T, D, B, H], c_T [D, B, H]).
    On the card everything is cast to contiguous float32 first. When no
    input needs a gradient it runs the forward alone, and on the card
    saves no cell states."""
    needs_grad = torch.is_grad_enabled() and any(
        v is not None and v.requires_grad for v in (xp, w_hh, h0, c0))
    if xp.device.type == "cpu":
        if not needs_grad:
            return bilstm_scan_reference(xp, w_hh, xp.dtype, h0, c0)
        return BiLSTMScan.apply(xp, w_hh, h0, c0)
    xp, w_hh = xp.float().contiguous(), w_hh.float().contiguous()
    h0 = None if h0 is None else h0.float().contiguous()
    c0 = None if c0 is None else c0.float().contiguous()
    if not needs_grad:
        return bilstm_scan_train_cuda(xp, w_hh, h0, c0, save_cs=False)[:2]
    return BiLSTMScan.apply(xp, w_hh, h0, c0)


def bilstm_scan(xp: torch.Tensor, w_hh: torch.Tensor):
    """B2 for GPU tensors, the plain version for CPU tensors: (ys,
    c_T)."""
    if xp.device.type == "cpu":
        return bilstm_scan_reference(xp, w_hh)
    return bilstm_scan_cuda(xp.float().contiguous(),
                            w_hh.float().contiguous())
