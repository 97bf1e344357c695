"""Streaming int8 ring attention of the serving step (counterpart of
the projection-native "v2" part of `lookoncetohear_tpu/ops/attention.py`).

The ring stores each slot exactly as the projections emit it: flat
(f, head, dim) columns, [B, WP, F*nh*dim] int8, plus per-(row, slot,
head) float32 scales [B, WP, nh], with WP = ceil(w/8)*8 slots. The
write-first step itself (`ring_attend_int8_native`) lives in
`ops/ring_step.py` beside its CUDA kernel.
"""

from __future__ import annotations

import torch


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
