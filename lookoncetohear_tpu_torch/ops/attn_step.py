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
# dynamic shared memory a launch takes without an opt-in: q and the
# W1 + 1 scores in float32
_MAX_SMEM = 48 * 1024


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
    if dk % 2 or dv % vec or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            f"Dk={dk} must be even and Dv={dv} a multiple of {vec} (one "
            "16-byte load per V slot), on 16-byte aligned storage")
    if 4 * (dk + w1 + 1) > _MAX_SMEM:
        raise ValueError(f"Dk={dk} and {w1} slots exceed the kernel's "
                         f"{_MAX_SMEM} bytes of shared memory")
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
