"""Write-first int8 ring attention step: the CUDA kernel
(`csrc/ring_int8_step.cu`, replacing the Pallas kernel
`lookoncetohear_tpu/ops/pallas_attention.py::ring_attend_int8_step_pallas`),
its plain PyTorch version, and the dispatch `ring_attend_int8_native`.

Contract of both versions (the JAX package's `ring_attend_int8_native`):
  q_t/k_t [B, F*nh*E], v_t [B, F*nh*V] in the compute dtype, flat
    (f, head, dim) columns;
  k_buf [B, WP, F*nh*E] int8, k_scale [B, WP, nh] float32, and
    v_buf/v_scale alike, WP = ceil(w/8)*8 slots (w <= WP live);
  pos: int32 tensor of one element, the slot written this step.
The current frame is quantized per (row, head) and written into slot
`pos`; attention then runs over the live slots except `pos`, with the
current frame at full precision, in float32; out [B, F*nh*V] has q's
dtype. Unlike the JAX function, which returns new arrays, both versions
update k_buf, k_scale, v_buf, v_scale and pos IN PLACE (the JAX kernel
donates its ring the same way): only slot `pos` of each row is written,
and `pos` advances to (pos + 1) % w on the device, with no host sync.
"""

from __future__ import annotations

import numpy as np
import torch

from lookoncetohear_tpu_torch import _build
from lookoncetohear_tpu_torch.ops.attention import quantize_slot_native


# shared memory a block may use on the H100 (232,448 bytes), less the
# kernel's static shared arrays
_MAX_DYNAMIC_SMEM = 232448 - 1024


def _dims(q_t, v_t, k_buf, f, n_head):
    b, dk = q_t.shape
    dv = v_t.shape[-1]
    e = dk // (f * n_head)
    vd = dv // (f * n_head)
    if e * f * n_head != dk or vd * f * n_head != dv:
        raise ValueError(f"widths {dk}/{dv} are not F*nh*dim "
                         f"(F={f}, nh={n_head})")
    return b, dk, dv, k_buf.shape[1], e, vd


def _score_scale(f: int, e: int) -> float:
    # 1/sqrt of the per-head width F*e, not of the whole row
    return float(1.0 / np.sqrt(f * e))


def ring_attend_int8_step_reference(q_t, k_t, v_t, k_buf, k_scale, v_buf,
                                    v_scale, pos, *, f: int, n_head: int,
                                    w: int):
    """Plain PyTorch version; see the module docstring."""
    b, dk, dv, wp, e, vd = _dims(q_t, v_t, k_buf, f, n_head)
    nh = n_head
    inv = _score_scale(f, e)
    q = q_t.float()
    kt = k_t.float()
    vt = v_t.float()
    slot = pos.reshape(1).long()
    k8, ks = quantize_slot_native(kt, f, nh)
    v8, vs = quantize_slot_native(vt, f, nh)
    k_buf.index_copy_(1, slot, k8[:, None])
    v_buf.index_copy_(1, slot, v8[:, None])
    k_scale.index_copy_(1, slot, ks[:, None])
    v_scale.index_copy_(1, slot, vs[:, None])

    s4 = torch.einsum("bwfhe,bfhe->bwh",
                      k_buf.float().reshape(b, wp, f, nh, e),
                      q.reshape(b, f, nh, e))
    s4 = s4 * k_scale * inv
    widx = torch.arange(wp, device=q.device)[None, :, None]
    s4 = s4.masked_fill((widx == pos.reshape(())) | (widx >= w),
                        float("-inf"))
    s_cur = (kt * q).reshape(b, f, nh, e).sum(dim=(1, 3)) * inv
    m = torch.maximum(s4.amax(dim=1), s_cur)                   # [B, nh]
    e_h = torch.exp(s4 - m[:, None, :])
    e_c = torch.exp(s_cur - m)
    den = e_h.sum(dim=1) + e_c
    wgt = e_h * v_scale                                        # [B, WP, nh]
    g = torch.einsum("bwh,bwfhd->bfhd", wgt,
                     v_buf.float().reshape(b, wp, f, nh, vd))
    out = g + e_c[:, None, :, None] * vt.reshape(b, f, nh, vd)
    out = out / den[:, None, :, None]
    pos.add_(1).remainder_(w)
    return out.reshape(b, dv).to(q_t.dtype)


def ring_attend_int8_step_cuda(q_t, k_t, v_t, k_buf, k_scale, v_buf,
                               v_scale, pos, *, f: int, n_head: int, w: int):
    """Launch the CUDA kernel on the current stream (no sync)."""
    b, dk, dv, wp, e, vd = _dims(q_t, v_t, k_buf, f, n_head)
    dev = q_t.device
    tensors = (q_t, k_t, v_t, k_buf, k_scale, v_buf, v_scale, pos)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ring_attend_int8_step_cuda needs all tensors "
                         "on one GPU")
    if q_t.dtype not in (torch.float32, torch.bfloat16) or \
            k_t.dtype != q_t.dtype or v_t.dtype != q_t.dtype:
        raise TypeError("q/k/v must share float32 or bfloat16")
    if k_buf.dtype != torch.int8 or v_buf.dtype != torch.int8 or \
            k_scale.dtype != torch.float32 or \
            v_scale.dtype != torch.float32 or pos.dtype != torch.int32:
        raise TypeError("ring must be int8 with float32 scales, pos int32")
    if tuple(k_t.shape) != (b, dk) or tuple(k_buf.shape) != (b, wp, dk) \
            or tuple(v_buf.shape) != (b, wp, dv) \
            or tuple(k_scale.shape) != (b, wp, n_head) \
            or tuple(v_scale.shape) != (b, wp, n_head) or pos.numel() != 1:
        raise ValueError("ring shapes do not match q/k/v")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring_attend_int8_step_cuda takes contiguous "
                         "tensors")
    if n_head > 16 or 32 % n_head or vd % 16 or dk % 8 \
            or not 0 < w <= wp:
        raise ValueError(f"unsupported n_head={n_head}, v dim={vd}, "
                         f"Dk={dk} or w={w} (the kernel takes n_head a "
                         "power of 2 up to 16, a v dim that is a multiple "
                         "of 16, Dk a multiple of 8 and 0 < w <= WP)")
    # dynamic shared memory: w staged K slots + q, scores and partials
    smem = -(-w * dk // 16) * 16 + 4 * (dk + wp * n_head + 16 * n_head)
    if smem > _MAX_DYNAMIC_SMEM:
        raise ValueError(f"w={w} slots of Dk={dk} need {smem} bytes of "
                         f"shared memory, over {_MAX_DYNAMIC_SMEM}")
    out = torch.empty_like(v_t)
    lib = _build.load_library()
    fn = lib.ring_int8_step_f32 if q_t.dtype == torch.float32 \
        else lib.ring_int8_step_bf16
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q_t.data_ptr(), k_t.data_ptr(), v_t.data_ptr(),
            k_buf.data_ptr(), k_scale.data_ptr(), v_buf.data_ptr(),
            v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, dk, dv, wp, w, f, n_head, _score_scale(f, e), stream)
    _build.check(rc, "ring_int8_step")
    ring_attend_int8_step_cuda.launches += 1
    return out


ring_attend_int8_step_cuda.launches = 0


def ring_attend_int8_native(q_t, k_t, v_t, k_buf, k_scale, v_buf, v_scale,
                            pos, *, f: int, n_head: int, w: int):
    """One write-first step: the kernel for GPU tensors, the plain
    version for CPU tensors. Returns out."""
    step = ring_attend_int8_step_reference if q_t.device.type == "cpu" \
        else ring_attend_int8_step_cuda
    return step(q_t, k_t, v_t, k_buf, k_scale, v_buf, v_scale, pos,
                f=f, n_head=n_head, w=w)
