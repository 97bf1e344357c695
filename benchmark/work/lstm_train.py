"""The training recurrence as one function, forward and backward
(`ops/bilstm_scan.py::BiLSTMScan` -> `csrc/bilstm_scan.cu`'s training
kernels and the product of dW_hh), in float32.

In: xp [T, D, N, 4H], W_hh [D, H, 4H], h0 and c0 [D, N, H] (a carried
state; the intra-frequency BiLSTM has none) and dy [T, D, N, H]. Out:
ys [T, D, N, H], dxp [T, D, N, 4H], dW_hh [D, H, 4H], dh0 and dc0 (with
carries). What an implementation saves between the two (cell states,
gates) is its own choice and is not counted.

Operations a row, step and direction: forward 8H^2 (the recurrent
product) + 8H (the projection's add and the cell update); backward 8H^2
(dh through W_hh) + 8H^2 (dW_hh) + 20H (the cell's and the gates'
derivatives). A recompute or a split of a product is not counted."""


def work(t: int, d: int, n: int, h: int, carries: bool) -> tuple:
    """(operations, bytes) of one forward and its backward."""
    steps = t * d * n
    flops = steps * (24 * h * h + 28 * h)
    seq = steps * (4 * h + h)                 # xp + dy in, ys + dxp out
    weights = d * h * 4 * h                   # W_hh in, dW_hh out
    state = 2 * d * n * h if carries else 0   # h0, c0 in; dh0, dc0 out
    return float(flops), float(4 * 2 * (seq + weights + state))
