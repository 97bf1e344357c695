"""The int8 ring attention step (`ops/ring_step.py` ->
`csrc/ring_int8_step.cu`), one launch for every row of a block.

In: q, k_t [B, Dk] and v_t [B, Dv] in the compute dtype (Dk = F nh e,
Dv = F nh vd), the w - 1 live slots of the int8 ring [B, w-1, Dk + Dv]
and their float32 scales [B, w-1, 2 nh]. Out: the slot written [B, Dk +
Dv] int8 with its scales, and out [B, Dv].

Operations a row: the scores and the weighted sum over w slots (the
w - 1 of the ring and the current frame), 2 w (Dk + Dv); the current
frame's quantization, 3 (Dk + Dv); the softmax, 5 w nh."""


def work(b: int, f: int, nh: int, e: int, vd: int, w: int,
         elem_bytes: int) -> tuple:
    """(operations, bytes) of one launch."""
    dk, dv = f * nh * e, f * nh * vd
    flops = b * (2 * w * (dk + dv) + 3 * (dk + dv) + 5 * w * nh)
    nbytes = b * (elem_bytes * (2 * dk + 2 * dv)
                  + (w - 1) * (dk + dv + 8 * nh)
                  + (dk + dv + 8 * nh))
    return float(flops), float(nbytes)
