"""Fused bidirectional LSTM recurrence: the CUDA kernel
(`csrc/bilstm_scan.cu`, replacing the Pallas kernel
`lookoncetohear_tpu/ops/pallas_lstm.py::bilstm_scan_pallas`) and its
plain PyTorch version.

Contract of both: xp [T, 2, B, 4H] pre-projected inputs with biases,
direction 1 already time-flipped; w_hh [2, H, 4H] (transposed). Zero
initial state, everything in float32. Returns (ys [T, 2, B, H], c_T
[2, B, H]). Inference only.
"""

from __future__ import annotations

import torch

from lookoncetohear_tpu_torch import _build

# the hidden width the kernel is instantiated for (a W_hh column of H
# floats lives in each thread's registers): the model's H
KERNEL_HIDDEN = 64


def bilstm_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor):
    """Plain PyTorch version: a loop over T, both directions at once."""
    xp = xp.float()
    w_hh = w_hh.float()
    t_len, _, b, g4 = xp.shape
    hidden = g4 // 4
    h = xp.new_zeros((2, b, hidden))
    c = xp.new_zeros((2, b, hidden))
    ys = []
    for t in range(t_len):
        gates = xp[t] + torch.bmm(h, w_hh)          # [2, B, 4H]
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), c


def bilstm_scan_cuda(xp: torch.Tensor, w_hh: torch.Tensor):
    """Launch the CUDA kernel on the current stream (no sync)."""
    t_len, two, b, g4 = xp.shape
    hidden = g4 // 4
    if xp.device.type != "cuda" or w_hh.device != xp.device:
        raise ValueError("bilstm_scan_cuda needs both tensors on one GPU")
    if xp.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise TypeError("bilstm_scan_cuda takes float32 xp and w_hh")
    if two != 2 or g4 != 4 * hidden or tuple(w_hh.shape) != (2, hidden, g4):
        raise ValueError(f"bad shapes xp {tuple(xp.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    if not (xp.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("bilstm_scan_cuda takes contiguous tensors")
    if hidden != KERNEL_HIDDEN:
        raise ValueError(f"bilstm_scan_cuda takes H={KERNEL_HIDDEN}, "
                         f"not {hidden}")
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


def bilstm_scan(xp: torch.Tensor, w_hh: torch.Tensor):
    """The kernel for GPU tensors, the plain version for CPU tensors."""
    if xp.device.type == "cpu":
        return bilstm_scan_reference(xp, w_hh)
    return bilstm_scan_cuda(xp.float().contiguous(),
                            w_hh.float().contiguous())
