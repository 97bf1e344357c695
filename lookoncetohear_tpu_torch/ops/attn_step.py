"""Ring attention step over a float or int8 K/V history: the CUDA kernel
(`csrc/attn_step.cu`, replacing the Pallas kernels
`lookoncetohear_tpu/ops/pallas_attention.py::attention_step_pallas`
and `::attention_step_int8_pallas`), its plain PyTorch version, and the
dispatch `attention_step`.

Contract of both versions (the Pallas kernels' bodies):
  q_t/k_t [B, Dk], v_t [B, Dv], one type (float32 or bfloat16);
  k_buf [B, W1, Dk], v_buf [B, W1, Dv]: W1 ring slots, in q's type,
    in bfloat16 under a float32 q, or int8 with per-(row, slot) float32
    scales k_scale/v_scale [B, W1];
  s = (q . k_buf[j]) [* k_scale[j]] / sqrt(Dk) for each slot j and
    (q . k_t) / sqrt(Dk) for the current frame; softmax over the
    W1 + 1 scores; out = sum_j p_j [* v_scale[j]] v_buf[j] + p_cur v_t,
    computed in float32 and returned in q's type, [B, Dv].
The ring is only read; the caller writes its slot after the step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build

# (q dtype, ring dtype) -> the C entry of that instantiation
VARIANTS = {
    (torch.float32, torch.float32): "attn_step_f32",
    (torch.bfloat16, torch.bfloat16): "attn_step_bf16",
    (torch.float32, torch.bfloat16): "attn_step_f32_bf16kv",
    (torch.float32, torch.int8): "attn_step_f32_int8kv",
    (torch.bfloat16, torch.int8): "attn_step_bf16_int8kv",
}
# the kernel's constants (csrc/attn_step.cu), for the plan's mirror
_THREADS = 256
_WARPS = _THREADS // 32
_GRANULES = 2             # V granules per thread
_TILE_BYTES = 24 * 1024   # K or V bytes a tile aims at
_MAX_STAGES = 3
_BAR_BYTES = 64
# dynamic shared memory a block may take on the H100 (opt-in above 48 KB)
_MAX_SMEM = 232448


def _round16(x: int) -> int:
    return (x + 15) & ~15


def _granule(elem_bytes: int) -> int:
    """Ring elements in one V granule: 16 bytes, 8 bytes for int8."""
    return 8 if elem_bytes == 1 else 16 // elem_bytes


def _tile(w1: int, slot_bytes: int) -> tuple[int, int]:
    """(slots per tile, tiles): tiles of about _TILE_BYTES, the W1 slots
    spread evenly over them."""
    most = max(1, _TILE_BYTES // max(slot_bytes, 1))
    tiles = -(-w1 // most) if w1 > 0 else 0
    return (-(-w1 // tiles) if tiles else 1), tiles


class AttnPlan(NamedTuple):
    """How the kernel cuts a launch (`make_plan` in csrc/attn_step.cu):
    V columns per block and blocks per row; ring slots per K tile and K
    tiles, slots per V tile and V tiles, per row; shared-memory buffers
    and their bytes; the block's dynamic shared memory."""
    cols: int
    col_blocks: int
    kslots: int
    ktiles: int
    vslots: int
    vtiles: int
    stages: int
    cap: int
    smem: int


def attn_step_plan(w1: int, dk: int, dv: int, elem_bytes: int,
                   scaled: bool) -> AttnPlan:
    """The kernel's plan for W1 slots of Dk/Dv ring elements of
    `elem_bytes` bytes (`scaled`: an int8 ring with per-slot scales)."""
    cols_max = _GRANULES * _THREADS * _granule(elem_bytes)
    col_blocks = -(-dv // cols_max) if dv > cols_max else 1
    cols = min(dv, cols_max)
    kslots, ktiles = _tile(w1, dk * elem_bytes)
    vslots, vtiles = _tile(w1, cols * elem_bytes)
    cap = max(_round16(kslots * dk * elem_bytes) + 32,
              vslots * cols * elem_bytes)
    fixed = (_BAR_BYTES + _round16(4 * (w1 + 1)) + _round16(4 * dk)
             + 4 * cols + 4 * _WARPS
             + (2 * _round16(4 * w1) if scaled else 0))
    stages = max(1, min(_MAX_STAGES, ktiles + vtiles,
                        (_MAX_SMEM - fixed) // cap))
    return AttnPlan(cols, col_blocks, kslots, ktiles, vslots, vtiles,
                    stages, cap, fixed + stages * cap)


class KTile(NamedTuple):
    """What the kernel copies into a buffer for one K tile of a row's K
    span: bytes [start, end) of the tile's slots; the buffer's byte 0
    is address `base`; one bulk copy of [lo, hi) (none if hi <= lo);
    the ragged elements at `edges` (addresses), stored one by one."""
    start: int
    end: int
    base: int
    lo: int
    hi: int
    edges: tuple


def k_tile_copies(kb: int, w1: int, dk: int, elem_bytes: int,
                   slots: int) -> list[KTile]:
    """The K staging of one row whose K span starts at address `kb`, in
    tiles of `slots` slots (`issue` and `place_edges` in
    csrc/attn_step.cu): bulk copies stay inside the span's
    16-byte-aligned interior [a0, a1); the ragged head [kb, a0) and tail
    [a1, ke) go element by element into the tile that holds them."""
    ke = kb + w1 * dk * elem_bytes
    a0, a1 = _round16(kb), ke & ~15
    head_end = min(ke, a0)
    tail_beg = max(a1, head_end)
    edges = [a for a in range(kb, head_end, elem_bytes)] + \
        [a for a in range(tail_beg, ke, elem_bytes)]
    assert len(edges) <= 32   # warp 0's lanes hold them
    out = []
    for j0 in range(0, w1, slots):
        n = min(slots, w1 - j0)
        cs = kb + j0 * dk * elem_bytes
        ce = cs + n * dk * elem_bytes
        base = cs & ~15
        out.append(KTile(cs, ce, base, max(base, a0), min(_round16(ce), a1),
                          tuple(a for a in edges if cs <= a < ce)))
    return out


def _score_scale(dk: int) -> float:
    return float(1.0 / np.sqrt(dk))


def attention_step_reference(q_t, k_t, v_t, k_buf, v_buf, k_scale=None,
                             v_scale=None):
    """Plain PyTorch version; see the module docstring."""
    inv = _score_scale(q_t.shape[-1])
    q = q_t.float()
    s_hist = torch.einsum("bd,bwd->bw", q, k_buf.float())
    if k_scale is not None:
        s_hist = s_hist * k_scale
    s_hist = s_hist * inv
    s_cur = (k_t.float() * q).sum(-1) * inv
    m = torch.maximum(s_hist.amax(-1), s_cur)
    e_h = torch.exp(s_hist - m[:, None])
    e_c = torch.exp(s_cur - m)
    den = e_h.sum(-1) + e_c
    wgt = e_h if v_scale is None else e_h * v_scale
    out = torch.einsum("bw,bwd->bd", wgt, v_buf.float())
    out = out + e_c[:, None] * v_t.float()
    return (out / den[:, None]).to(q_t.dtype)


def attention_step_cuda(q_t, k_t, v_t, k_buf, v_buf, k_scale=None,
                        v_scale=None):
    """Launch the CUDA kernel on the current stream (no sync)."""
    b, dk = q_t.shape
    dv = v_t.shape[-1]
    w1 = k_buf.shape[1]
    dev = q_t.device
    int8 = k_buf.dtype == torch.int8
    tensors = [q_t, k_t, v_t, k_buf, v_buf]
    if int8:
        if k_scale is None or v_scale is None:
            raise ValueError("an int8 ring needs k_scale and v_scale")
        tensors += [k_scale, v_scale]
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales go with an int8 ring only")
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("attention_step_cuda needs all tensors on one GPU")
    name = VARIANTS.get((q_t.dtype, k_buf.dtype))
    if name is None or k_t.dtype != q_t.dtype or v_t.dtype != q_t.dtype \
            or v_buf.dtype != k_buf.dtype:
        raise TypeError(
            f"unsupported types: q/k_t/v_t {q_t.dtype}/{k_t.dtype}/"
            f"{v_t.dtype}, ring {k_buf.dtype}/{v_buf.dtype} (instantiated: "
            f"{', '.join(VARIANTS.values())})")
    if int8 and (k_scale.dtype != torch.float32
                 or v_scale.dtype != torch.float32):
        raise TypeError("the ring scales must be float32")
    if tuple(k_t.shape) != (b, dk) or tuple(v_t.shape) != (b, dv) \
            or tuple(k_buf.shape) != (b, w1, dk) \
            or tuple(v_buf.shape) != (b, w1, dv) \
            or (int8 and (tuple(k_scale.shape) != (b, w1)
                          or tuple(v_scale.shape) != (b, w1))):
        raise ValueError("ring shapes do not match q/k/v")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("attention_step_cuda takes contiguous tensors")
    vec = 16 // k_buf.element_size()
    if dk < 1 or dv % vec or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            f"Dk={dk} must be at least 1 and Dv={dv} a multiple of {vec} "
            "(V rows go by 16-byte copies), on 16-byte aligned storage")
    plan = attn_step_plan(w1, dk, dv, k_buf.element_size(), int8)
    if plan.smem > _MAX_SMEM:
        raise ValueError(f"Dk={dk}, Dv={dv} and {w1} slots need "
                         f"{plan.smem} bytes of shared memory, over the "
                         f"kernel's {_MAX_SMEM}")
    out = torch.empty_like(v_t)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(
        q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(), k_buf.data_ptr(),
        v_buf.data_ptr(), k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, out.data_ptr(), b, w1, dk, dv,
        _score_scale(dk), stream)
    _build.check(rc, name)
    attention_step_cuda.launches += 1
    attention_step_cuda.variant_launches[name] += 1
    return out


attention_step_cuda.launches = 0
attention_step_cuda.variant_launches = dict.fromkeys(VARIANTS.values(), 0)


def attention_step(q_t, k_t, v_t, k_buf, v_buf, k_scale=None, v_scale=None):
    """The kernel for GPU tensors, the plain version for CPU tensors."""
    step = attention_step_reference if q_t.device.type == "cpu" \
        else attention_step_cuda
    return step(q_t, k_t, v_t, k_buf, v_buf, k_scale, v_scale)
