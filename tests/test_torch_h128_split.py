"""The arithmetic and the tile choice of the H = 128 scan kernels on the
CPU, where no kernel runs: the kernels form the recurrent product on the
tensor cores in TF32 with three products (hi hi + hi lo + lo hi, each
operand split into a TF32 high part and a TF32 remainder), take W_hh's
gate columns in the order `h128_gate_perm` gives, and run on the tile
(R rows, a cluster of C CTAs) that `choose_tile_h128` picks.

`bilstm_scan_tf32x3_reference` emulates that arithmetic in plain
PyTorch; it is held here against the JAX package at the default `Net`'s
widths (H = 128, 4H = 512) and at the tolerances the kernels are held to
on the card against their plain versions: B2 against
`bilstm_scan_pallas` (interpret mode) over 141 steps at atol 2e-5, the
training forward against `lstm_apply` over 500 steps from a carried
state at 1e-4 of the peak. TF32 alone (one product) misses the first.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu.ops import lstm as jlstm
from lookoncetohear_tpu.ops.pallas_lstm import bilstm_scan_pallas
from lookoncetohear_tpu_torch.ops import bilstm_scan as bs

TOL_B2 = 2e-5          # B2 against its plain version, 141 steps
TOL_LONG = 1e-4        # the training forward, of max(1, peak), 500 steps


def _b2_inputs(seed, t=141, b=4):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((t, 2, b, 512)) * 0.5).astype(np.float32)
    w_hh = (rng.standard_normal((2, 128, 512)) * 0.2).astype(np.float32)
    return xp, w_hh


def test_tf32_round_is_round_to_nearest_ties_away():
    """`tf32_round` keeps 10 mantissa bits, rounding to nearest with ties
    away from zero on the bit pattern, as `cvt.rna.tf32.f32`; hi + lo
    gives x back to 2^-22 of |x|."""
    one = 1.0
    cases = {one + 2.0 ** -11: one + 2.0 ** -10,      # a tie: away
             -(one + 2.0 ** -11): -(one + 2.0 ** -10),
             one + 2.0 ** -12: one,                   # below half: down
             one + 3 * 2.0 ** -12: one + 2.0 ** -10,  # above half: up
             2.0 - 2.0 ** -23: 2.0,                   # into the exponent
             0.0: 0.0, float("inf"): float("inf"),
             -float("inf"): -float("inf")}
    x = torch.tensor(list(cases), dtype=torch.float32)
    want = torch.tensor(list(cases.values()), dtype=torch.float32)
    assert torch.equal(bs.tf32_round(x), want)
    assert torch.isnan(bs.tf32_round(torch.tensor([float("nan")]))).all()
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    hi = bs.tf32_round(v)
    # at most 10 mantissa bits: the 13 low bits clear
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((hi - v).abs() <= v.abs() * 2.0 ** -11).all()
    lo = bs.tf32_round(v - hi)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0 ** -22).all()


def test_three_product_b2_matches_the_pallas_kernel():
    """B2's recurrence with the product in three TF32 products against the
    Pallas kernel (interpret mode) at H = 128 over 141 steps, within B2's
    tolerance; a single TF32 product would miss it."""
    xp, w_hh = _b2_inputs(15)
    jys, jc = bilstm_scan_pallas(jnp.asarray(xp), jnp.asarray(w_hh),
                                 interpret=True)
    ys, c_t = bs.bilstm_scan_tf32x3_reference(torch.from_numpy(xp),
                                              torch.from_numpy(w_hh))
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=0,
                               atol=TOL_B2)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(jc), rtol=0,
                               atol=TOL_B2)
    # one TF32 product (hi hi) drifts beyond the tolerance
    h = torch.zeros(2, 4, 128)
    c = torch.zeros(2, 4, 128)
    w = bs.tf32_round(torch.from_numpy(w_hh))
    one = []
    for t in range(xp.shape[0]):
        i, f, g, o = (torch.from_numpy(xp[t]) + bs.tf32_round(h) @ w).split(
            128, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        one.append(h)
    assert np.abs(torch.stack(one).numpy() - np.asarray(jys)).max() > TOL_B2


def test_three_product_forward_matches_jax_lstm_apply():
    """The training forward's recurrence with the three-product split, one
    direction over 500 steps from a carried (h0, c0), against the JAX
    `lstm_apply` at H = 128, within 1e-4 of the peak (y and c_T)."""
    rng = np.random.default_rng(16)
    n, t_len, i_dim = 3, 500, 64
    p = [(rng.standard_normal(s) * 0.1).astype(np.float32)
         for s in ((512, i_dim), (512, 128), (512,), (512,))]
    x = rng.standard_normal((n, t_len, i_dim)).astype(np.float32)
    h0, c0 = (rng.standard_normal((n, 128)).astype(np.float32)
              for _ in range(2))
    jy, (_, jc) = jlstm.lstm_apply(jlstm.LSTMParams(*map(jnp.asarray, p)),
                                   jnp.asarray(x), jnp.asarray(h0),
                                   jnp.asarray(c0))
    w_ih, w_hh, b_ih, b_hh = map(torch.from_numpy, p)
    xp = torch.from_numpy(x) @ w_ih.T + (b_ih + b_hh)
    ys, c_t = bs.bilstm_scan_tf32x3_reference(
        bs.scan_layout(xp, 1), w_hh.T[None], torch.from_numpy(h0)[None],
        torch.from_numpy(c0)[None])
    y = ys[:, 0].permute(1, 0, 2).numpy()
    jy, jc = np.asarray(jy), np.asarray(jc)
    assert np.abs(y - jy).max() <= TOL_LONG * max(1.0, np.abs(jy).max())
    assert np.abs(c_t[0].numpy() - jc).max() <= TOL_LONG * max(
        1.0, np.abs(jc).max())


def test_gate_permutation_round_trips():
    """`h128_gate_perm` is a permutation of the 512 gate columns; its
    column 32 b + 8 gate + i is gate `gate` of unit 8 b + i; each CTA of
    a cluster of 4 or 8 owns a contiguous run of it holding exactly its
    units' four gates; and within an m-pair the accumulator rows g, g + 8,
    16 + g, 24 + g (one lane's) are i, f, g and o of one unit."""
    perm = bs.h128_gate_perm()
    inv = torch.argsort(perm)
    assert torch.equal(torch.sort(perm).values, torch.arange(512))
    assert torch.equal(perm[inv], torch.arange(512))
    assert torch.equal(inv[perm], torch.arange(512))
    j = torch.arange(512)
    gate, unit = perm // 128, perm % 128
    assert torch.equal(gate, j % 32 // 8) and torch.equal(
        unit, j // 32 * 8 + j % 8)
    for c in (4, 8):
        u = 128 // c
        for q in range(c):
            cols = perm[4 * u * q:4 * u * (q + 1)]
            want = torch.cat([torch.arange(u * q, u * (q + 1)) + 128 * g
                              for g in range(4)])
            assert torch.equal(torch.sort(cols).values, want)
    for b in range(16):
        for g in range(8):
            rows = perm[32 * b + torch.tensor([g, g + 8, 16 + g, 24 + g])]
            assert torch.equal(rows // 128, torch.arange(4))
            assert (rows % 128 == 8 * b + g).all()


def test_plain_scan_on_permuted_weights_equals_the_plain_scan():
    """The emulation taking W_hh's columns in the kernels' order and
    putting the gates back (as the kernels do) equals the emulation on
    W_hh as it is, and the plain float32 scan within B2's tolerance."""
    xp, w_hh = (torch.from_numpy(a) for a in _b2_inputs(17, t=40, b=5))
    perm = bs.h128_gate_perm()
    got = bs.bilstm_scan_tf32x3_reference(xp, w_hh, gate_perm=perm)
    same = bs.bilstm_scan_tf32x3_reference(xp, w_hh)
    plain = bs.bilstm_scan_reference(xp, w_hh)
    for a, b, p in zip(got, same, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        torch.testing.assert_close(a, p, rtol=0, atol=TOL_B2)


# clusters of each tile an H100 80GB HBM3 holds at once, as the kernels'
# occupancy reports them (`scan_sweep`: two CTAs an SM at C = 8, one at
# C = 4 and for the training forward's 16-row tile at C = 8)
H100_HELD = {"b2": {(8, 8): 30, (16, 8): 30, (8, 4): 30, (16, 4): 30},
             "fwd": {(8, 8): 30, (16, 8): 15, (8, 4): 30, (16, 4): 30}}


@pytest.mark.parametrize("kernel,n,nd", [("b2", 64, 2), ("fwd", 141, 1)])
def test_tile_choice_puts_the_path_shapes_in_one_wave(kernel, n, nd):
    """On an H100's occupancy the (R, C) choice runs the default Net's
    serving scan (B2, 64 rows, 2 directions) and its inter-time scan
    (the forward, 141 rows, 1 direction) in one wave of clusters, on a
    tile the kernels are built for: 8 rows over 8 CTAs."""
    held = H100_HELD[kernel]
    tile = bs.choose_tile_h128(n, nd, held)
    assert tile == (8, 8)
    assert bs.h128_waves(n, nd, tile, held) == 1


@pytest.mark.parametrize("kernel,n,nd,want", [
    ("b2", 500, 2, (16, 8)), ("b2", 2000, 2, (16, 8)),
    ("fwd", 564, 1, (8, 8)), ("fwd", 4000, 2, (16, 4)),
    ("fwd", 1128, 1, (8, 8)), ("b2", 13, 2, (8, 8))])
def test_tile_choice_minimises_waves_times_cost(kernel, n, nd, want):
    """The choice is the tile of least waves x cost, also where the rows
    need several waves (the full forward's 500 rows, the eval's 2000 and
    564, the training step's 4000 and 1128): the tile `scan_sweep`
    found fastest there on an H100."""
    held = H100_HELD[kernel]
    tile = bs.choose_tile_h128(n, nd, held)
    best = min(bs.h128_waves(n, nd, k, held) * bs.H128_TILE_COST[k]
               for k in bs.H128_TILE_COST)
    assert bs.h128_waves(n, nd, tile, held) * bs.H128_TILE_COST[tile] == \
        best
    assert tile == want
