"""Causal local (banded) attention (counterpart of
`lookoncetohear_tpu/ops/attention.py`).

Each time frame's query attends to `window` key/value slots
[t-window+1, t]; slots before the stream start are zero keys/values
(score 0, not -inf), the semantics of a zero-initialised K/V ring.

  * `local_attention`: full sequences, the two-chunk band (each query
    chunk of W frames against [previous chunk ++ own chunk]);
  * `causal_banded_attention_full`: the offline form, softmax over the
    in-band real positions only;
  * the streaming step over a head-major ring [B', W-1, D]: the shift
    form `local_attention_step` and the ring forms `ring_attend` /
    `local_attention_step_ring` (float or bfloat16 ring) and
    `ring_attend_int8` / `local_attention_step_ring_int8` (int8 ring
    with one scale per (row, slot)). Their attention always goes
    through `attention_step` (`ops/attn_step.py`): the CUDA kernel for
    GPU tensors, its plain version for CPU tensors;
  * the projection-native int8 ring of the serving step: its slot
    quantization here, the write-first step itself in
    `ops/ring_step.py` beside its CUDA kernel. That ring stores each
    slot as the projections emit it, flat (f, head, dim) columns,
    [B, WP, F*nh*dim] int8, plus per-(row, slot, head) float32 scales
    [B, WP, nh], with WP = ceil(w/8)*8 slots.

The ring forms write their one slot IN PLACE (the JAX functions return
new arrays) and advance `pos` in place on the device, with no host
sync; they return the same tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from lookoncetohear_tpu_torch.ops.attn_step import attention_step


def local_attention(q, k, v, window: int, k_buf=None, v_buf=None):
    """Banded causal attention over full sequences.

    q/k: [B, T, Dk], v: [B, T, Dv]; query t sees keys [t-W+1, t].
    k_buf/v_buf: optional [B, W-1, D*] carried context, time-ordered,
    placed before t=0 (zeros when absent: the stream start).
    Returns (out [B, T, Dv], new_k_buf, new_v_buf), the new buffers
    being the last W-1 frames of [k_buf ++ k]."""
    b, t, dk = q.shape
    dv = v.shape[-1]
    w = window
    scale = float(1.0 / np.sqrt(dk))
    if k_buf is None:
        k_buf = k.new_zeros((b, w - 1, dk))
    if v_buf is None:
        v_buf = v.new_zeros((b, w - 1, dv))
    # global key position of hist[:, i] is i - (w - 1)
    k_hist = torch.cat([k_buf, k], dim=1)
    v_hist = torch.cat([v_buf, v], dim=1)
    new_k_buf = k_hist[:, -(w - 1):]
    new_v_buf = v_hist[:, -(w - 1):]

    # pad T to whole chunks of W; one extra leading zero key makes the
    # chunked history start exactly one chunk before chunk 0, and the
    # band mask keeps the right padding out of sight
    nc = -(-t // w)
    pad_t = nc * w - t
    pad = torch.nn.functional.pad
    qc = pad(q, (0, 0, 0, pad_t)).reshape(b, nc, w, dk)
    kc = pad(k_hist, (0, 0, 1, pad_t)).reshape(b, nc + 1, w, dk)
    vc = pad(v_hist, (0, 0, 1, pad_t)).reshape(b, nc + 1, w, dv)
    k2 = torch.cat([kc[:, :-1], kc[:, 1:]], dim=2)      # [B, nc, 2W, Dk]
    v2 = torch.cat([vc[:, :-1], vc[:, 1:]], dim=2)
    scores = torch.einsum("bnwd,bnxd->bnwx", qc, k2) * scale
    # query i of a chunk sits at concat position W + i; its band is
    # positions [i + 1, W + i]
    i_idx = torch.arange(w, device=q.device)[:, None]
    x_idx = torch.arange(2 * w, device=q.device)[None, :]
    band = (x_idx >= i_idx + 1) & (x_idx <= w + i_idx)
    scores = scores.masked_fill(~band, float("-inf"))
    attn = torch.softmax(scores, dim=-1)
    out = torch.einsum("bnwx,bnxd->bnwd", attn, v2)
    return out.reshape(b, nc * w, dv)[:, :t], new_k_buf, new_v_buf


def causal_banded_attention_full(q, k, v, window: int):
    """Offline causal attention with band `window`: the softmax runs
    over the in-band real positions only (no zero keys before the
    start). q/k/v: [B, T, D]."""
    t, dk = q.shape[1], q.shape[-1]
    scores = torch.einsum("btd,bsd->bts", q, k) * float(1.0 / np.sqrt(dk))
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(t, device=q.device)[None, :]
    mask = (j <= i) & (j > i - window)
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bts,bsd->btd", torch.softmax(scores, dim=-1), v)


def local_attention_step(q_t, k_t, v_t, k_buf, v_buf):
    """One streaming step over a shift buffer: attention over the W-1
    buffer slots plus the current frame, then the buffer shifted by one
    with the current frame appended (a new tensor, outside the kernel).

    q_t/k_t: [B, Dk], v_t: [B, Dv]; k_buf/v_buf: [B, W-1, D*].
    Returns (out [B, Dv], new_k_buf, new_v_buf)."""
    out = attention_step(q_t, k_t, v_t, k_buf, v_buf)
    new_k = torch.cat([k_buf[:, 1:], k_t[:, None].to(k_buf.dtype)], dim=1)
    new_v = torch.cat([v_buf[:, 1:], v_t[:, None].to(v_buf.dtype)], dim=1)
    return out, new_k, new_v


def ring_attend(q_t, k_t, v_t, k_buf, v_buf):
    """Attention over the W-1 (unordered) ring slots plus the current
    frame; the ring may be stored in bfloat16 under a float32 q. The
    caller owns the slot write."""
    return attention_step(q_t, k_t, v_t, k_buf, v_buf)


def local_attention_step_ring(q_t, k_t, v_t, k_buf, v_buf, pos):
    """`ring_attend`, then the current frame written into slot `pos` of
    k_buf/v_buf [B, W-1, D*] and `pos` (int32, one element) advanced to
    (pos + 1) % (W-1), all in place. Returns (out, k_buf, v_buf, pos)."""
    out = ring_attend(q_t, k_t, v_t, k_buf, v_buf)
    slot = pos.reshape(1).long()
    k_buf.index_copy_(1, slot, k_t[:, None].to(k_buf.dtype))
    v_buf.index_copy_(1, slot, v_t[:, None].to(v_buf.dtype))
    pos.add_(1).remainder_(k_buf.shape[1])
    return out, k_buf, v_buf, pos


def quantize_rows(x):
    """Symmetric per-row int8 quantization over the last axis.

    x: [..., D] -> (q8 [..., D] int8, scale [...] float32), x ~= q8 *
    scale. Rounds half to even, like jnp.round."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor, as in quantize_slot_native
    scale = torch.clamp(amax, min=1e-12) / torch.full((), 127.0,
                                                      device=x.device)
    q8 = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q8.to(torch.int8), scale


def ring_attend_int8(q_t, k_t, v_t, k_buf, k_scale, v_buf, v_scale):
    """Attention over an int8 ring (k_buf [B, W-1, Dk] int8 with
    k_scale [B, W-1] float32, v_buf/v_scale alike) plus the current
    frame at full precision. Returns out [B, Dv] in q's type."""
    return attention_step(q_t, k_t, v_t, k_buf, v_buf, k_scale, v_scale)


def local_attention_step_ring_int8(q_t, k_t, v_t, k_buf, k_scale, v_buf,
                                   v_scale, pos):
    """`ring_attend_int8`, then the current frame quantized per row
    (`quantize_rows`) and written with its scales into slot `pos`, and
    `pos` advanced to (pos + 1) % (W-1), all in place.

    Returns (out, k_buf, k_scale, v_buf, v_scale, pos)."""
    out = ring_attend_int8(q_t, k_t, v_t, k_buf, k_scale, v_buf, v_scale)
    slot = pos.reshape(1).long()
    for x, buf, scale in ((k_t, k_buf, k_scale), (v_t, v_buf, v_scale)):
        q8, s = quantize_rows(x)
        buf.index_copy_(1, slot, q8[:, None])
        scale.index_copy_(1, slot, s[:, None])
    pos.add_(1).remainder_(k_buf.shape[1])
    return out, k_buf, k_scale, v_buf, v_scale, pos


def quantize_slot_native(x: torch.Tensor, f: int, n_head: int):
    """Symmetric per-(row, head) int8 quantization of one slot.

    x: [B, F*nh*dim], column order (f, h, d) -> (q8 int8 same shape,
    scale [B, nh] float32). Rounds half to even, like jnp.round."""
    b, dflat = x.shape
    dim = dflat // (f * n_head)
    x4 = x.float().reshape(b, f, n_head, dim)
    amax = x4.abs().amax(dim=(1, 3))                        # [B, nh]
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # product with its reciprocal, which is not always the IEEE quotient
    # that JAX and the ring kernel compute (one ulp off the scale)
    scale = torch.clamp(amax, min=1e-12) / torch.full((), 127.0,
                                                      device=x.device)
    q8 = torch.clamp(torch.round(x4 / scale[:, None, :, None]), -127, 127)
    return q8.to(torch.int8).reshape(b, dflat), scale
