"""B2, the inference BiLSTM recurrence (`ops/bilstm_scan.py::bilstm_scan`
-> `csrc/bilstm_scan.cu`): xp [T, D, N, 4H] (the input projections with
both biases, float32) and W_hh [D, H, 4H] in; ys [T, D, N, H] and c_T
[D, N, H] out, from zero carries.

Operations a row, step and direction: the recurrent product 2 * H * 4H,
the add of the projection 4H, and the cell update 4H (c = f c + i g,
h = o tanh(c)); the five activations are not counted."""


def work(t: int, d: int, n: int, h: int) -> tuple:
    """(operations, bytes) of one call."""
    steps = t * d * n
    flops = steps * (8 * h * h + 8 * h)
    nbytes = 4 * (steps * 4 * h + d * h * 4 * h + steps * h + d * n * h)
    return float(flops), float(nbytes)
