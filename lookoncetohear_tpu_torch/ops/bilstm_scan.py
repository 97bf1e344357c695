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
  [D, N, H], in the models' own layouts: xp [N, T, D*4H] as one GEMM
  makes it, y [N, T, D*H] as the LSTM returns it, direction 1 running
  backwards in time inside the kernels. A `torch.autograd.Function`
  (`BiLSTMScan`) whose forward saves every cell state (at H = 128 also
  every step's activated gates, in place of xp) and whose backward is a
  kernel of its own. They stand for the differentiated
  `lax.scan` of `lookoncetohear_tpu/ops/lstm.py` (`_lstm_scan`,
  `_chunked_scan`): the TPU kernel has no gradient.

The kernels (`csrc/bilstm_scan.cu`) take H = 64 (a block a row tile)
and H = 128 (B2 and the training forward: a cluster of C = 4 or 8 CTAs
a tile of R = 8 or 16 rows, W_hh's gate columns split over the cluster,
the product on the tensor cores in TF32 with three products; the
backward on clusters of 8 CTAs, from the gates the forward saved, its dh
carried by a reduce-scatter over the cluster). Every other width is
refused.

Everything runs in float32 on the card. A wrapper launches its kernel
for CUDA tensors and uses the plain version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lookoncetohear_tpu_torch import _build

# the hidden widths the kernels are instantiated for (B2 and the training
# forward), and the backward's
KERNEL_WIDTHS = (64, 128)
BACKWARD_WIDTHS = (64, 128)
# the widths at which `BiLSTMScan` saves the forward's activated gates
# and not xp (the same bytes), so that the backward reads them instead
# of recomputing them (the H = 64 backward recomputes them from xp and y)
GATES_SAVED_AT = (128,)
# rows a block of each training kernel may take, and the relative time
# of one wave of its blocks (every SM running as many as fit) a step:
# fitted to `python3 -m lookoncetohear_tpu_torch.scan_sweep` on an H100
# over the training, full-forward and eval scan shapes, where it picks
# the fastest tile of each kernel at each shape
TRAIN_TILE_COST = {"fwd": {4: 2.1, 8: 3.75, 16: 6.4},
                   "bwd": {4: 3.1, 8: 5.6, 16: 10.5}}
# the same for the H = 128 kernels (B2 and the training forward): the
# tile (R rows, a cluster of C CTAs) -> the relative time of a step of one
# wave of its clusters (as many as the card holds at once), fitted to
# `scan_sweep` on an H100 at the default Net's B2, full-forward, eval and
# training scans, where these costs pick the fastest tile
H128_TILE_COST = {(8, 8): 1.0, (16, 8): 1.6, (8, 4): 1.04, (16, 4): 1.8}
# the same for the H = 128 backward, whose clusters are of 8 CTAs (two an
# SM): fitted to `scan_sweep --h128` on an H100 at the default Net's
# training scans
H128_BWD_TILE_COST = {(8, 8): 1.0, (16, 8): 1.43}


def h128_tiles(kernel: str) -> dict:
    """The tile cost table of the H = 128 `kernel` ("b2", "fwd" or
    "bwd")."""
    return H128_BWD_TILE_COST if kernel == "bwd" else H128_TILE_COST


def bilstm_scan_reference(xp: torch.Tensor, w_hh: torch.Tensor,
                          dtype=torch.float32, h0=None, c0=None,
                          with_cs: bool = False, with_gates: bool = False):
    """Plain PyTorch version of the forward: a loop over T, the D
    directions of xp [T, D, B, 4H] and w_hh [D, H, 4H] at once, from
    (h0, c0) [D, B, H] (None: zero), in `dtype` (float32 as the
    kernels; float64 to measure how far each float32 version drifts
    from the exact recurrence). Returns (ys [T, D, B, H], c_T
    [D, B, H]), with `with_cs` then cs [T, D, B, H], every step's cell
    state (what the training forward saves), and with `with_gates` then
    the activated gates [T, D, B, 4H] (sigmoid(i), sigmoid(f), tanh(g),
    sigmoid(o) in xp's order: what the training forward at H = 128 also
    saves)."""
    xp = xp.to(dtype)
    w_hh = w_hh.to(dtype)
    t_len, nd, b, g4 = xp.shape
    hidden = g4 // 4
    h = xp.new_zeros((nd, b, hidden)) if h0 is None else h0.to(dtype)
    c = xp.new_zeros((nd, b, hidden)) if c0 is None else c0.to(dtype)
    ys, cs, acts = [], [], []
    for t in range(t_len):
        gates = xp[t] + torch.bmm(h, w_hh)          # [D, B, 4H]
        i, f, g, o = gates.split(hidden, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        cs.append(c)
        if with_gates:
            acts.append(torch.cat([i, f, g, o], dim=-1))
    out = (torch.stack(ys), c)
    if with_cs:
        out += (torch.stack(cs),)
    if with_gates:
        out += (torch.stack(acts),)
    return out


def _cell_backward(i, f, g, o, c_prev, c, dh, dc_next):
    """One step of the backward from the activated gates: (dgates
    [.., 4H], dc_prev) for dh = dL/dh_t and dc_next the carried dL/dc_t,
    c_prev and c the cell states c_{t-1} and c_t."""
    tc = torch.tanh(c)
    dc = dc_next + dh * o * (1.0 - tc * tc)
    dgates = torch.cat([dc * g * i * (1.0 - i),
                        dc * c_prev * f * (1.0 - f),
                        dc * i * (1.0 - g * g),
                        dh * tc * o * (1.0 - o)], dim=-1)
    return dgates, dc * f


def bilstm_scan_backward_reference(xp, w_hh, h0, c0, ys, cs, dys, dc_t,
                                   matmul=torch.bmm):
    """Plain PyTorch version of the backward kernel at H = 64: an explicit
    reverse loop that recomputes each step's gates from h_{t-1} (ys[t-1]
    or h0) and returns (dxp [T, D, B, 4H], dh0, dc0 [D, B, H]). h0, c0,
    dys and dc_t may be None (zero). dW_hh is not part of it (see
    `scan_weight_grad`). `matmul` forms both products (h_prev W and
    dgates W^T)."""
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
        gates = xp[t] + matmul(h_prev, w_hh)
        i, f, g, o = gates.split(hidden, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        dh = dh_next if dys is None else dys[t] + dh_next
        dxp[t], dc_next = _cell_backward(i, f, torch.tanh(g), o, c_prev,
                                         cs[t], dh, dc_next)
        dh_next = matmul(dxp[t], w_t)
    return dxp, dh_next, dc_next


def bilstm_scan_gates_backward_reference(gates, w_hh, c0, cs, dys, dc_t,
                                         matmul=torch.bmm):
    """Plain PyTorch version of the backward kernel at H = 128: the reverse
    loop of `bilstm_scan_backward_reference` from the forward's activated
    gates [T, D, B, 4H] (`bilstm_scan_reference(..., with_gates=True)`)
    instead of recomputing them, so it needs neither xp nor ys nor h0:
    one product a step (dgates W^T, by `matmul`). Returns (dxp, dh0,
    dc0); c0, dys and dc_t may be None (zero)."""
    t_len, nd, b, g4 = gates.shape
    hidden = g4 // 4
    zero = gates.new_zeros((nd, b, hidden))
    w_t = w_hh.transpose(1, 2)                      # [D, 4H, H]
    dh_next = zero
    dc_next = zero if dc_t is None else dc_t
    dxp = torch.empty_like(gates)
    for t in range(t_len - 1, -1, -1):
        c_prev = cs[t - 1] if t > 0 else (zero if c0 is None else c0)
        dh = dh_next if dys is None else dys[t] + dh_next
        dxp[t], dc_next = _cell_backward(*gates[t].split(hidden, dim=-1),
                                         c_prev, cs[t], dh, dc_next)
        dh_next = matmul(dxp[t], w_t)
    return dxp, dh_next, dc_next


def scan_layout(a, nd):
    """[N, T, D*K] -> the scan layout [T, D, N, K] of B2 and the loops,
    direction 1 time-flipped, contiguous (the loops take a step's slice
    at a time)."""
    n, t_len, dk = a.shape
    a = a.reshape(n, t_len, nd, dk // nd).permute(1, 2, 0, 3)
    if nd == 2:
        a = torch.stack([a[:, 0], a[:, 1].flip(0)], 1)
    return a.contiguous()


def _from_scan(a):
    """The inverse of `scan_layout`: [T, D, N, K] -> [N, T, D*K],
    contiguous as the kernels' outputs."""
    t_len, nd, n, k = a.shape
    if nd == 2:
        a = torch.stack([a[:, 0], a[:, 1].flip(0)], 1)
    return a.permute(2, 0, 1, 3).reshape(n, t_len, nd * k).contiguous()


def bilstm_train_reference(xp, w_hh, dtype=torch.float32, h0=None, c0=None,
                           with_cs=False, with_gates=False):
    """Plain version of the training forward in the models' layouts:
    xp [N, T, D*4H], w_hh [D, H, 4H], (h0, c0) [D, N, H] (None: zero),
    direction 1 over time T-1..0. Returns (y [N, T, D*H], c_T
    [D, N, H]), with `with_cs` then cs [N, T, D*H] and with `with_gates`
    then the activated gates [N, T, D*4H] in xp's layout (the tensor the
    H = 128 training forward writes); the loop of `bilstm_scan_reference`
    on permuted copies."""
    out = bilstm_scan_reference(scan_layout(xp, w_hh.shape[0]), w_hh,
                                dtype, h0, c0, with_cs, with_gates)
    return (_from_scan(out[0]), out[1], *map(_from_scan, out[2:]))


def bilstm_train_backward_reference(xp, w_hh, h0, c0, y, cs, dy, dc_t,
                                    matmul=torch.bmm):
    """Plain version of the H = 64 training backward in the models'
    layouts (as `bilstm_train_reference`; dy [N, T, D*H]): (dxp
    [N, T, D*4H], dh0, dc0 [D, N, H]), through
    `bilstm_scan_backward_reference`."""
    nd = w_hh.shape[0]
    dxp, dh0, dc0 = bilstm_scan_backward_reference(
        scan_layout(xp, nd), w_hh, h0, c0, scan_layout(y, nd),
        scan_layout(cs, nd), None if dy is None else scan_layout(dy, nd),
        dc_t, matmul)
    return _from_scan(dxp), dh0, dc0


def bilstm_train_gates_backward_reference(gates, w_hh, c0, cs, dy, dc_t,
                                          matmul=torch.bmm):
    """Plain version of the H = 128 training backward in the models'
    layouts: from the forward's activated gates [N, T, D*4H]
    (`bilstm_train_reference(..., with_gates=True)`), c0 [D, N, H] or
    None, cs, dy [N, T, D*H] (or None) and dc_t -> (dxp [N, T, D*4H],
    dh0, dc0 [D, N, H]), through `bilstm_scan_gates_backward_reference`.
    The same function as `bilstm_train_backward_reference` on the same
    forward, with one product a step instead of two."""
    nd = w_hh.shape[0]
    dxp, dh0, dc0 = bilstm_scan_gates_backward_reference(
        scan_layout(gates, nd), w_hh, c0, scan_layout(cs, nd),
        None if dy is None else scan_layout(dy, nd), dc_t, matmul)
    return _from_scan(dxp), dh0, dc0


def scan_weight_grad(dxp, y, h0, nd):
    """dW_hh [D, H, 4H] = sum over rows and steps of h_prev^T dgates, in
    the models' layouts (dxp [N, T, D*4H], y [N, T, D*H], h0 [D, N, H]
    or None). h_prev of direction 0 at time t is y at t-1 (h0 at t =
    0); of direction 1, which runs backwards, y at t+1 (h0 at t = T-1).
    One batched product over the steps ([H, N] @ [N, 4H] each, on views
    of y and dxp), then a sum: as a single product over T*N rows the
    output is only [H, 4H], 16 tiles of cuBLAS's 32 x 32, 16 blocks on
    a 132-SM card (~8.6 ms at the TSE intra shape on an H100)."""
    hidden = y.shape[2] // nd
    out = []
    for d in range(nd):
        dx = dxp[..., 4 * hidden * d:4 * hidden * (d + 1)]
        yd = y[..., hidden * d:hidden * (d + 1)]
        # (h_prev, dgates) of every step but the first, and the first's
        h_prev, dg, dg0 = (yd[:, :-1], dx[:, 1:], dx[:, 0]) if d == 0 \
            else (yd[:, 1:], dx[:, :-1], dx[:, -1])
        w = torch.matmul(h_prev.permute(1, 2, 0), dg.transpose(0, 1)).sum(0)
        out.append(w if h0 is None else w + h0[d].T @ dg0)
    return torch.stack(out)


def check_width(hidden: int, name: str, widths=KERNEL_WIDTHS) -> None:
    """Raise unless a kernel of `name` is built for the hidden width."""
    if hidden not in widths:
        raise ValueError(f"{name} takes "
                         f"{' or '.join(f'H={h}' for h in widths)}, "
                         f"not {hidden}")


def _check(xp, w_hh, name, g4, widths=KERNEL_WIDTHS, **states):
    """Raise on what the kernels do not take: xp and w_hh float32,
    contiguous, on one GPU, gate width g4 = 4H with H in `widths`; each
    state (tensor or None, shape) contiguous float32 of its shape on
    xp's GPU."""
    if xp.device.type != "cuda" or w_hh.device != xp.device:
        raise ValueError(f"{name} needs its tensors on one GPU")
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
    check_width(g4 // 4, name, widths)


def _ptr(t):
    return None if t is None else t.data_ptr()


def bilstm_scan_cuda(xp: torch.Tensor, w_hh: torch.Tensor):
    """Launch B2 on the current stream (no sync). Inference only: it
    refuses inputs that need a gradient, which it could not give. At
    H = 128 it launches `bilstm_scan_h128_cuda`'s kernel, whose counter
    counts it; `bilstm_scan_cuda.launches` counts the H = 64 kernel."""
    if torch.is_grad_enabled() and (xp.requires_grad or w_hh.requires_grad):
        raise RuntimeError(
            "bilstm_scan_cuda is inference only and would drop the "
            "gradient of xp / w_hh; use bilstm_scan_train")
    if xp.dim() != 4:
        raise ValueError(f"bilstm_scan_cuda: xp must be [T, 2, B, 4H], got "
                         f"{tuple(xp.shape)}")
    t_len, nd, b, g4 = xp.shape
    hidden = g4 // 4
    _check(xp, w_hh, "bilstm_scan_cuda", g4)
    if nd != 2 or g4 != 4 * hidden or t_len < 1 \
            or tuple(w_hh.shape) != (2, hidden, g4):
        raise ValueError(f"bilstm_scan_cuda: bad shapes xp {tuple(xp.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    if hidden == 128:
        return bilstm_scan_h128_cuda(xp, w_hh)
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


def h128_gate_perm() -> torch.Tensor:
    """The order in which the H = 128 kernels take W_hh's 512 gate
    columns: column 32 b + 8 gate + i of the kernel's order is gate `gate`
    (i, f, g, o) of hidden unit 8 b + i, i.e. original column 128 gate +
    8 b + i. A CTA of a cluster of C owns units [128 q / C, 128 (q + 1) /
    C) and so the contiguous columns [512 q / C, 512 (q + 1) / C) of this
    order; an m-pair of the tensor-core product (32 columns, 8 units)
    then leaves a lane holding i, f, g and o of one unit and row. The
    kernels apply it as they load W_hh, once a launch."""
    j = torch.arange(512)
    return (j % 32 // 8) * 128 + (j // 32) * 8 + j % 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32`: on the bit pattern, add half a unit
    of the 13 dropped bits to the magnitude and clear them (infinities
    and NaNs kept)."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    bits = bits & 0xFFFFFFFF
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    special = mag >= 0x7F800000
    mag = torch.where(special, mag, (mag + 0x1000) & 0x7FFFE000)
    out = sign | mag
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32).reshape(x.shape)


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the H = 128 kernels form it on the tensor cores: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), then hi hi +
    (hi lo + lo hi) in float32 (lo lo, 2^-22 of a product, dropped)."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a.float() - a_hi), tf32_round(b.float() - b_hi)
    return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)


def bilstm_scan_tf32x3_reference(xp, w_hh, h0=None, c0=None,
                                 gate_perm=None):
    """Plain PyTorch emulation of the H = 128 kernels' arithmetic in the
    scan layout of `bilstm_scan_reference` (xp [T, D, B, 4H], w_hh
    [D, H, 4H], (h0, c0) [D, B, H] or None): the recurrent product by
    `tf32x3_matmul`, the rest in float32. With `gate_perm` (as
    `h128_gate_perm`) the product is taken against W_hh's columns in
    that order and its gates are put back before the cell update, as the
    kernels do. Returns (ys [T, D, B, H], c_T [D, B, H])."""
    xp, w_hh = xp.float(), w_hh.float()
    t_len, nd, b, g4 = xp.shape
    hidden = g4 // 4
    inv = None
    if gate_perm is not None:
        w_hh = w_hh[..., gate_perm]
        inv = torch.argsort(gate_perm)
    h = xp.new_zeros((nd, b, hidden)) if h0 is None else h0.float()
    c = xp.new_zeros((nd, b, hidden)) if c0 is None else c0.float()
    ys = []
    for t in range(t_len):
        prod = tf32x3_matmul(h, w_hh)
        gates = xp[t] + (prod if inv is None else prod[..., inv])
        i, f, g, o = gates.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys), c


def bilstm_train_backward_tf32x3_reference(gates, w_hh, c0, cs, dy, dc_t,
                                           matmul=tf32x3_matmul):
    """Plain PyTorch emulation of the H = 128 backward kernel's
    arithmetic in the models' layouts of
    `bilstm_train_gates_backward_reference` (everything in float32): the
    carry dgates W^T by `tf32x3_matmul` (`matmul`, to try another
    product), from the forward's saved gates. Returns (dxp, dh0, dc0)."""
    f32 = (lambda v: None if v is None else v.float())  # noqa: E731
    return bilstm_train_gates_backward_reference(
        *map(f32, (gates, w_hh, c0, cs, dy, dc_t)), matmul=matmul)


@functools.lru_cache(maxsize=None)
def _h128_facts(device, kernel: str) -> dict:
    """{(R, C): clusters of the tile the card holds at once} of the
    H = 128 `kernel` ("b2", "fwd" or "bwd") on the device."""
    lib = _build.load_library()
    out = {}
    for r, c in h128_tiles(kernel):
        info = (ctypes.c_int * 6)()
        _build.check(lib.bilstm_h128_info(r, c, ("b2", "fwd", "bwd").index(
            kernel), info), "bilstm_h128_info")
        out[(r, c)] = info[4]
    return out


def h128_waves(n: int, nd: int, tile, held: dict) -> int:
    """Waves of clusters of the tile (R, C) for n rows and nd directions,
    when the card holds held[tile] of them at once."""
    r, _ = tile
    return -(-nd * -(-n // r) // max(1, held[tile]))


def choose_tile_h128(n: int, nd: int, held: dict,
                     costs: dict = H128_TILE_COST) -> tuple:
    """The tile (R, C) of `costs` whose clusters run in the least time,
    taken as their waves times the tile's cost a wave; on a tie the
    first in sorted order (fewer rows, then smaller clusters)."""
    return min(sorted(costs), key=lambda tile: (
        h128_waves(n, nd, tile, held) * costs[tile]))


def tile_h128(n: int, nd: int, device, kernel: str) -> tuple:
    """(R, C) that a launch of the H = 128 `kernel` ("b2", "fwd" or
    "bwd") takes for n rows and nd directions on the device:
    `choose_tile_h128` with the card's occupancy."""
    return choose_tile_h128(n, nd, _h128_facts(device, kernel),
                            h128_tiles(kernel))


def bilstm_scan_h128_cuda(xp: torch.Tensor, w_hh: torch.Tensor):
    """Launch B2 at H = 128 (`csrc/bilstm_scan.cu`) on the current stream:
    xp [T, 2, B, 512], w_hh [2, 128, 512] float32, contiguous, on one GPU
    -> (ys [T, 2, B, 128], c_T [2, B, 128]). Inference only, as
    `bilstm_scan_cuda`, which checks its inputs and calls this."""
    t_len, _, b, _ = xp.shape
    ys = torch.empty((t_len, 2, b, 128), device=xp.device,
                     dtype=torch.float32)
    c_t = torch.empty((2, b, 128), device=xp.device, dtype=torch.float32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_scan_h128_f32(xp.data_ptr(), w_hh.data_ptr(),
                                  ys.data_ptr(), c_t.data_ptr(), t_len, b,
                                  *tile_h128(b, 2, xp.device, "b2"), stream)
    _build.check(rc, "bilstm_scan_h128_f32")
    bilstm_scan_h128_cuda.launches += 1
    return ys, c_t


bilstm_scan_h128_cuda.launches = 0


def _train_shapes(xp, w_hh, name):
    """(N, T, D, H) of the training kernels' inputs xp [N, T, D*4H] and
    w_hh [D, H, 4H]; raises on other shapes."""
    if xp.dim() != 3 or w_hh.dim() != 3:
        raise ValueError(f"{name}: xp must be [N, T, D*4H] and w_hh "
                         f"[D, H, 4H], got {tuple(xp.shape)}, "
                         f"{tuple(w_hh.shape)}")
    n, t_len, dg = xp.shape
    nd, hidden, g4 = w_hh.shape
    if nd not in (1, 2) or g4 != 4 * hidden or dg != nd * g4 or n < 1 \
            or t_len < 1:
        raise ValueError(f"{name}: bad shapes xp {tuple(xp.shape)} "
                         f"w_hh {tuple(w_hh.shape)}")
    return n, t_len, nd, hidden


@functools.lru_cache(maxsize=None)
def _card_facts(device, kernel: str) -> tuple:
    """(SMs, {R: resident blocks of the tile per SM}) of `kernel` on the
    device, from the occupancy the kernels report."""
    lib = _build.load_library()
    resident = {}
    for r in TRAIN_TILE_COST[kernel]:
        out = (ctypes.c_int * 5)()
        _build.check(lib.bilstm_train_info(r, kernel == "bwd", out),
                     "bilstm_train_info")
        resident[r] = out[4]
    return (torch.cuda.get_device_properties(device).multi_processor_count,
            resident)


def tile_rows(n: int, nd: int, device, kernel: str) -> int:
    """Rows a block of the training `kernel` ("fwd" or "bwd") takes for n
    rows and nd directions: the tile whose grid runs in the least time,
    taken as its waves on the busiest SM times its cost a wave
    (TRAIN_TILE_COST); on a tie the smaller tile."""
    sms, resident = _card_facts(device, kernel)
    cost = TRAIN_TILE_COST[kernel]

    def time(r):
        per_sm = -(-nd * -(-n // r) // sms)
        return -(-per_sm // resident[r]) * cost[r]
    return min(sorted(cost), key=time)


def bilstm_scan_train_cuda(xp, w_hh, h0=None, c0=None, save_cs=True,
                           save_gates=False):
    """Launch the state-saving forward: (y, c_T, cs) as
    `bilstm_train_reference(..., with_cs=True)`; without `save_cs` (a
    pass that keeps no gradient) cs is not written and comes back
    None. With `save_gates` (H = 128 only) it also returns the activated
    gates, as `bilstm_train_reference(..., with_gates=True)`. At H = 128
    it launches `bilstm_train_fwd_h128_cuda`'s kernel, whose counter
    counts it; `bilstm_scan_train_cuda.launches` counts the H = 64
    kernel."""
    n, t_len, nd, hidden = _train_shapes(xp, w_hh, "bilstm_scan_train_cuda")
    _check(xp, w_hh, "bilstm_scan_train_cuda", 4 * hidden,
           h0=(h0, (nd, n, hidden)), c0=(c0, (nd, n, hidden)))
    if hidden == 128:
        return bilstm_train_fwd_h128_cuda(xp, w_hh, h0, c0, save_cs,
                                          save_gates)
    if save_gates:
        raise ValueError("bilstm_scan_train_cuda saves the gates at H=128 "
                         "only")
    y = torch.empty((n, t_len, nd * hidden), device=xp.device,
                    dtype=torch.float32)
    cs = torch.empty_like(y) if save_cs else None
    c_t = torch.empty((nd, n, hidden), device=xp.device, dtype=torch.float32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_train_fwd_f32(
        xp.data_ptr(), w_hh.data_ptr(), _ptr(h0), _ptr(c0), y.data_ptr(),
        _ptr(cs), c_t.data_ptr(), t_len, nd, n, hidden,
        tile_rows(n, nd, xp.device, "fwd"), stream)
    _build.check(rc, "bilstm_train_fwd_f32")
    bilstm_scan_train_cuda.launches += 1
    return y, c_t, cs


bilstm_scan_train_cuda.launches = 0


def bilstm_train_fwd_h128_cuda(xp, w_hh, h0=None, c0=None, save_cs=True,
                               save_gates=False):
    """Launch the training forward at H = 128 (`csrc/bilstm_scan.cu`):
    (y, c_T, cs), and with `save_gates` the gates [N, T, D*512], as
    `bilstm_scan_train_cuda`, which checks its inputs and calls this."""
    n, t_len, dg = xp.shape
    nd = dg // 512
    y = torch.empty((n, t_len, nd * 128), device=xp.device,
                    dtype=torch.float32)
    cs = torch.empty_like(y) if save_cs else None
    gates = torch.empty_like(xp) if save_gates else None
    c_t = torch.empty((nd, n, 128), device=xp.device, dtype=torch.float32)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_train_fwd_h128_f32(
        xp.data_ptr(), w_hh.data_ptr(), _ptr(h0), _ptr(c0), y.data_ptr(),
        _ptr(cs), _ptr(gates), c_t.data_ptr(), t_len, nd, n,
        *tile_h128(n, nd, xp.device, "fwd"), stream)
    _build.check(rc, "bilstm_train_fwd_h128_f32")
    bilstm_train_fwd_h128_cuda.launches += 1
    return (y, c_t, cs) + ((gates,) if save_gates else ())


bilstm_train_fwd_h128_cuda.launches = 0


def bilstm_scan_bwd_cuda(xp, w_hh, h0, c0, y, cs, dy, dc_t):
    """Launch the H = 64 backward: (dxp, dh0, dc0) as
    `bilstm_train_backward_reference`, counted by
    `bilstm_scan_bwd_cuda.launches`. The H = 128 backward reads the
    forward's gates instead of xp and y: `bilstm_train_bwd_h128_cuda`."""
    n, t_len, nd, hidden = _train_shapes(xp, w_hh, "bilstm_scan_bwd_cuda")
    seq, state = (n, t_len, nd * hidden), (nd, n, hidden)
    _check(xp, w_hh, "bilstm_scan_bwd_cuda", 4 * hidden, BACKWARD_WIDTHS,
           h0=(h0, state), c0=(c0, state), y=(y, seq), cs=(cs, seq),
           dy=(dy, seq), dc_t=(dc_t, state))
    if y is None or cs is None:
        raise ValueError("bilstm_scan_bwd_cuda needs the forward's y and cs")
    if hidden == 128:
        raise ValueError("bilstm_scan_bwd_cuda: the backward at H=128 takes "
                         "the forward's gates (bilstm_train_bwd_h128_cuda)")
    dxp = torch.empty_like(xp)
    dh0 = torch.empty(state, device=xp.device, dtype=torch.float32)
    dc0 = torch.empty_like(dh0)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.bilstm_train_bwd_f32(
        xp.data_ptr(), w_hh.data_ptr(), _ptr(h0), _ptr(c0), y.data_ptr(),
        cs.data_ptr(), _ptr(dy), _ptr(dc_t), dxp.data_ptr(), dh0.data_ptr(),
        dc0.data_ptr(), t_len, nd, n, hidden,
        tile_rows(n, nd, xp.device, "bwd"), stream)
    _build.check(rc, "bilstm_train_bwd_f32")
    bilstm_scan_bwd_cuda.launches += 1
    return dxp, dh0, dc0


bilstm_scan_bwd_cuda.launches = 0


def bilstm_train_bwd_h128_cuda(gates, w_hh, c0, cs, dy, dc_t):
    """Launch the backward at H = 128 (`csrc/bilstm_scan.cu`) on the
    current stream: gates [N, T, D*512] and cs [N, T, D*128] as the
    training forward saved them (`bilstm_scan_train_cuda(...,
    save_gates=True)`), w_hh [D, 128, 512], c0 [D, N, 128], dy
    [N, T, D*128] and dc_t [D, N, 128] or None (zero), float32,
    contiguous, on one GPU -> (dxp, dh0, dc0) as
    `bilstm_train_gates_backward_reference`."""
    name = "bilstm_train_bwd_h128_cuda"
    n, t_len, nd, hidden = _train_shapes(gates, w_hh, name)
    seq, state = (n, t_len, nd * hidden), (nd, n, hidden)
    _check(gates, w_hh, name, 4 * hidden, (128,), c0=(c0, state),
           cs=(cs, seq), dy=(dy, seq), dc_t=(dc_t, state))
    if cs is None:
        raise ValueError(f"{name} needs the forward's cs")
    dxp = torch.empty_like(gates)
    dh0 = torch.empty(state, device=gates.device, dtype=torch.float32)
    dc0 = torch.empty_like(dh0)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    rc = lib.bilstm_train_bwd_h128_f32(
        gates.data_ptr(), w_hh.data_ptr(), _ptr(c0), cs.data_ptr(),
        _ptr(dy), _ptr(dc_t), dxp.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
        t_len, nd, n, *tile_h128(n, nd, gates.device, "bwd"), stream)
    _build.check(rc, "bilstm_train_bwd_h128_f32")
    bilstm_train_bwd_h128_cuda.launches += 1
    return dxp, dh0, dc0


bilstm_train_bwd_h128_cuda.launches = 0


class BiLSTMScan(torch.autograd.Function):
    """(xp, w_hh, h0, c0) -> (y, c_T) in the models' layouts,
    differentiable in all four. On the card the forward and backward
    are the kernels (plus the batched product of dW_hh); on the CPU
    their plain versions, in the inputs' dtype. At a width of
    GATES_SAVED_AT (H = 128) the forward saves its activated gates in
    place of xp (the same size; xp is nothing else's saved tensor) and the
    backward reads them, on the CPU as on the card: it saves (gates,
    w_hh, h0, c0, y, cs); elsewhere (xp, w_hh, h0, c0, y, cs)."""

    @staticmethod
    def forward(ctx, xp, w_hh, h0, c0):
        ctx.gated = w_hh.shape[-2] in GATES_SAVED_AT
        if xp.device.type == "cpu":
            out = bilstm_train_reference(xp, w_hh, xp.dtype, h0, c0,
                                         with_cs=True, with_gates=ctx.gated)
        else:
            out = bilstm_scan_train_cuda(xp, w_hh, h0, c0,
                                         save_gates=ctx.gated)
        y, c_t, cs = out[:3]
        ctx.save_for_backward(out[3] if ctx.gated else xp, w_hh, h0, c0, y,
                              cs)
        return y, c_t

    @staticmethod
    def backward(ctx, dy, dc_t):
        saved, w_hh, h0, c0, y, cs = ctx.saved_tensors
        if saved.device.type == "cpu":
            dxp, dh0, dc0 = (
                bilstm_train_gates_backward_reference(saved, w_hh, c0, cs,
                                                      dy, dc_t)
                if ctx.gated else bilstm_train_backward_reference(
                    saved, w_hh, h0, c0, y, cs, dy, dc_t))
        else:
            dy = None if dy is None else dy.contiguous()
            dc_t = None if dc_t is None else dc_t.contiguous()
            dxp, dh0, dc0 = (
                bilstm_train_bwd_h128_cuda(saved, w_hh, c0, cs, dy, dc_t)
                if ctx.gated else bilstm_scan_bwd_cuda(
                    saved, w_hh, h0, c0, y, cs, dy, dc_t))
        dw = scan_weight_grad(dxp, y, h0, w_hh.shape[0]) \
            if ctx.needs_input_grad[1] else None
        return (dxp, dw, dh0 if ctx.needs_input_grad[2] else None,
                dc0 if ctx.needs_input_grad[3] else None)


def bilstm_scan_train(xp, w_hh, h0=None, c0=None):
    """The differentiable recurrence in the models' layouts: xp
    [N, T, D*4H], w_hh [D, H, 4H], optional (h0, c0) [D, N, H] -> (y
    [N, T, D*H], c_T [D, N, H]), direction 1 over time T-1..0. On the
    card everything is cast to contiguous float32 first. When no input
    needs a gradient it runs the forward alone, and on the card saves
    no cell states."""
    needs_grad = torch.is_grad_enabled() and any(
        v is not None and v.requires_grad for v in (xp, w_hh, h0, c0))
    if xp.device.type == "cpu":
        if not needs_grad:
            return bilstm_train_reference(xp, w_hh, xp.dtype, h0, c0)
        return BiLSTMScan.apply(xp, w_hh, h0, c0)
    check_width(w_hh.shape[-2], "bilstm_scan_train")
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
