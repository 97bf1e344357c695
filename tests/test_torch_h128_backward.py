"""The backward of the LSTM recurrence at H = 128 and the reference's
default `Net` in training, PyTorch port vs the JAX package, on the CPU
(no kernel runs here; `tests/test_torch_cuda.py` holds the card's
backward kernel to the plain version):

  * the plain backward (`BiLSTMScan` on the CPU: the reverse loop and
    `scan_weight_grad`) through `lstm_apply` from a carried (h0, c0) at
    T = 1 and 500 and `lstm_apply_bidir` at T = 141, against `jax.grad`
    of the JAX package's `lstm_apply` / `lstm_apply_bidir`, in float64 on
    both sides: every gradient within 1e-4 of its peak, from the gates
    the forward saves (what `BiLSTMScan` does at H = 128) and from xp,
    recomputing them (the H = 64 kernel's plain version);
  * the gates-based plain backward equal to the xp-based one on one
    forward in float64;
  * the backward kernel's arithmetic, emulated in float32
    (`bilstm_train_backward_tf32x3_reference`: the carry dgates W^T in
    three TF32 products, from the forward's saved gates), against
    `jax.grad` of the JAX recurrence in float64 at the same shapes and
    tolerance, and one TF32 product, which misses it;
  * `BiLSTMScan` at H = 128 saves the gates and no tensor of xp's
    storage: its saved bytes are those of gates, y, cs, w_hh and the
    states (at H = 64 it saves xp);
  * a `TSETask` step of the default `Net`'s geometry (chunk 160 + pad
    120, F = 141, H = 128, no attention) at 2 blocks and D = 8 on a
    0.1 s batch: the loss and every parameter gradient against the JAX
    package's in float64, within 1e-4 of each tensor's peak. The JAX
    `Net` cannot be built at L = 0 (see tests/test_torch_default_net.py)
    and takes L = 2, which adds nothing without attention;
  * `remat=True` (every block checkpointed, the JAX package's `remat`)
    gives the same gradients as keeping the activations;
  * the backward's tile choice (clusters of 8 CTAs only).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lookoncetohear_tpu import utils as jutils
from lookoncetohear_tpu.data import loader as jloader
from lookoncetohear_tpu.data.synthetic import SyntheticTSEDataset as JDataset
from lookoncetohear_tpu.ops import lstm as jlstm
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.models.net import EmbedNet, Net
from lookoncetohear_tpu_torch.ops import bilstm_scan as bs
from lookoncetohear_tpu_torch.ops import lstm as tlstm
from lookoncetohear_tpu_torch.weights import (flatten_params,
                                              params_from_jax,
                                              params_to_jax)

TOL = 1e-4          # of each gradient's peak
H = 128
# (directions, steps, carried state): the inter-time LSTM from a carried
# state over one and 500 steps, the intra-frequency BiLSTM over 141 bins
CASES = [(1, 1, True), (1, 500, True), (2, 141, False)]
with open("configs/tsh_synthetic_5k.json") as f:
    TSE_5K = json.load(f)["pl_module_args"]
# the default Net (`Net()`) at 2 blocks and D = 8
DEFAULT_SMALL = dict(embed_dim=256, stft_chunk_size=160, stft_pad_size=120,
                     num_ch=2, D=8, L=0, I=1, J=1, B=2, H=H, use_attn=False,
                     lookahead=True)


@pytest.fixture(autouse=True)
def _one_thread():
    """The plain loops are small ops (several test workers share the
    host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape, scale=1.0):
    return rng.standard_normal(shape) * scale


def _peak_close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


# ---- the plain backward against jax.grad ------------------------------------

@pytest.mark.parametrize("nd,t,carried,saved", [
    pytest.param(*case, saved, id="-".join(map(str, case)) + (
        "-gates" if saved == "gates" else ""))
    for saved in ("xp", "gates") for case in CASES])
def test_plain_backward_matches_jax_grad(nd, t, carried, saved,
                                         monkeypatch):
    """Through the port's LSTM ops in float64: the gradients of x, every
    weight and (h0, c0) of a loss over y and the final states ==
    jax.grad of the JAX package's `lstm_apply` / `lstm_apply_bidir`;
    `BiLSTMScan` saving the forward's gates (as at H = 128) or xp (as
    at H = 64, the gates recomputed)."""
    if saved == "xp":
        monkeypatch.setattr(bs, "GATES_SAVED_AT", ())
    rng = np.random.default_rng(16 + t)
    b, i = 2, 8
    ps = [[_np(rng, s, 0.2) for s in ((4 * H, i), (4 * H, H), (4 * H,),
                                      (4 * H,))] for _ in range(nd)]
    x = _np(rng, (b, t, i))
    gy = _np(rng, (b, t, nd * H))
    gh, gc = _np(rng, (nd, b, H)), _np(rng, (nd, b, H))
    h0, c0 = _np(rng, (b, H), 0.5), _np(rng, (b, H), 0.5)

    def jloss(x, ps, h0, c0):
        if nd == 1:
            y, (ht, ct) = jlstm.lstm_apply(jlstm.LSTMParams(*ps[0]), x,
                                           h0, c0)
            ht, ct = ht[None], ct[None]
        else:
            y, (ht, ct) = jlstm.lstm_apply_bidir(
                jlstm.LSTMParams(*ps[0]), jlstm.LSTMParams(*ps[1]), x)
            ht, ct = jnp.stack(ht), jnp.stack(ct)
        return jnp.sum(y * gy) + jnp.sum(ht * gh) + jnp.sum(ct * gc)

    with jax.enable_x64(True):
        want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
            jnp.asarray(x), [[jnp.asarray(a) for a in p] for p in ps],
            jnp.asarray(h0), jnp.asarray(c0))
        want = jax.tree_util.tree_map(np.asarray, want)
    tx, th0, tc0 = (torch.from_numpy(a).requires_grad_()
                    for a in (x, h0, c0))
    tps = [[torch.from_numpy(a).requires_grad_() for a in p] for p in ps]
    if nd == 1:
        y, (ht, ct) = tlstm.lstm_apply(tlstm.LSTMParams(*tps[0]), tx,
                                       th0 if carried else None,
                                       tc0 if carried else None)
        ht, ct = ht[None], ct[None]
    else:
        y, (ht, ct) = tlstm.lstm_apply_bidir(tlstm.LSTMParams(*tps[0]),
                                             tlstm.LSTMParams(*tps[1]), tx)
        ht, ct = torch.stack(ht), torch.stack(ct)
    loss = (y * torch.from_numpy(gy)).sum() + (ht * torch.from_numpy(
        gh)).sum() + (ct * torch.from_numpy(gc)).sum()
    leaves = [tx, *(a for p in tps for a in p)] + (
        [th0, tc0] if nd == 1 else [])
    got = torch.autograd.grad(loss, leaves)
    wants = [want[0], *(a for p in want[1] for a in p)] + (
        [want[2], want[3]] if nd == 1 else [])
    assert len(got) == len(wants)
    for k, (g, w) in enumerate(zip(got, wants)):
        _peak_close(g.numpy(), w, what=f"gradient {k}")


# ---- the kernel's arithmetic, emulated, against jax.grad -------------------

def _jax_scan_grads(xp, w, h0, c0, dy, dct):
    """jax.grad of sum(y dy) + sum(c_T dc_T) in float64 with respect to
    xp [N, T, D*4H], w [D, H, 4H] and (h0, c0) [D, N, H] (zero where
    None), through the JAX package's recurrence `_lstm_scan` (direction
    1 over reversed time)."""
    nd = w.shape[0]

    def loss(xp, w, h0, c0):
        out = 0.0
        for d in range(nd):
            y, (_, ct) = jlstm._lstm_scan(xp[..., 4 * H * d:4 * H * (d + 1)],
                                          w[d], h0[d], c0[d], H,
                                          reverse=d == 1)
            out = out + jnp.sum(y * dy[..., H * d:H * (d + 1)]) \
                + jnp.sum(ct * dct[d])
        return out

    zero = np.zeros((nd, xp.shape[0], H))
    with jax.enable_x64(True):
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
            *(jnp.asarray(a, jnp.float64) for a in (
                xp, w, zero if h0 is None else h0,
                zero if c0 is None else c0)))
        return [np.asarray(a) for a in g]


def _scan_case(nd, t, carried, seed):
    rng = np.random.default_rng(seed)
    n = 3

    def f32(shape, scale=1.0):
        return _np(rng, shape, scale).astype(np.float32)
    xp, w = f32((n, t, nd * 4 * H), 0.5), f32((nd, H, 4 * H), 0.2)
    h0, c0 = (f32((nd, n, H), 0.5), f32((nd, n, H), 0.5)) if carried \
        else (None, None)
    dy, dct = f32((n, t, nd * H)), f32((nd, n, H))
    return xp, w, h0, c0, dy, dct


def _tf32x1_matmul(a, b):
    return bs.tf32_round(a) @ bs.tf32_round(b)


def _emulated_errors(case, matmul):
    """max |emulated - jax.grad| / peak over dxp, dh0, dc0 and dW_hh."""
    xp, w, h0, c0, dy, dct = case
    want = _jax_scan_grads(*case)
    tt = (lambda a: None if a is None else torch.from_numpy(a))  # noqa
    y, _, cs, gates = bs.bilstm_train_reference(
        tt(xp), tt(w), torch.float32, tt(h0), tt(c0), with_cs=True,
        with_gates=True)
    dxp, dh0, dc0 = bs.bilstm_train_backward_tf32x3_reference(
        gates, tt(w), tt(c0), cs, tt(dy), tt(dct), matmul)
    dw = bs.scan_weight_grad(dxp, y, tt(h0), w.shape[0])
    got = [dxp, dw] + ([dh0, dc0] if h0 is not None else [])
    return [float(np.abs(g.double().numpy() - e).max() / np.abs(e).max())
            for g, e in zip(got, want)]


@pytest.mark.parametrize("nd,t,carried", CASES)
def test_three_product_backward_matches_jax_grad(nd, t, carried):
    """The backward kernel's arithmetic in float32, its product in three
    TF32 products, from the forward's float32 gates, y and cs: dxp,
    dh0, dc0 and dW_hh within 1e-4 of their peaks of jax.grad in
    float64."""
    errs = _emulated_errors(_scan_case(nd, t, carried, 160 + t),
                            bs.tf32x3_matmul)
    assert max(errs) <= TOL, errs


def test_one_tf32_product_misses_the_tolerance():
    """The same backward with one TF32 product a product (hi hi) misses
    1e-4 of the peak over the 141 bins of the intra-frequency scan:
    the three-product split is what holds it."""
    errs = _emulated_errors(_scan_case(2, 141, False, 301), _tf32x1_matmul)
    assert max(errs) > TOL, errs


# ---- the gates-based backward ----------------------------------------------

@pytest.mark.parametrize("nd,t,carried", CASES)
def test_gates_backward_equals_xp_backward(nd, t, carried):
    """On one float64 forward, the backward from the saved gates (one
    product a step) gives the xp-based backward's dxp, dh0 and dc0 (two
    products a step, the gates recomputed) within 1e-12 of each peak."""
    xp, w, h0, c0, dy, dct = (None if a is None else torch.from_numpy(
        a.astype(np.float64)) for a in _scan_case(nd, t, carried, 170 + t))
    y, _, cs, gates = bs.bilstm_train_reference(
        xp, w, torch.float64, h0, c0, with_cs=True, with_gates=True)
    assert gates.shape == xp.shape
    want = bs.bilstm_train_backward_reference(xp, w, h0, c0, y, cs, dy, dct)
    got = bs.bilstm_train_gates_backward_reference(gates, w, c0, cs, dy, dct)
    for g, e in zip(got, want):
        _peak_close(g.numpy(), e.numpy(), tol=1e-12)


@pytest.mark.parametrize("hidden", [128, 64])
def test_bilstm_scan_saves_gates_not_xp(hidden):
    """At H = 128 `BiLSTMScan` saves the forward's gates and no tensor of
    xp's storage, and its saved bytes are those of gates, y, cs, w_hh,
    h0 and c0 (xp's size: nothing more than before); at H = 64 it saves
    xp itself. The gradient still reaches xp."""
    n, t, nd = 3, 5, 1
    g = torch.Generator().manual_seed(hidden)
    xp = torch.randn(n, t, nd * 4 * hidden, generator=g,
                     dtype=torch.float64, requires_grad=True)
    w = torch.randn(nd, hidden, 4 * hidden, generator=g,
                    dtype=torch.float64, requires_grad=True) * 0.1
    h0, c0 = (torch.randn(nd, n, hidden, generator=g, dtype=torch.float64)
              for _ in range(2))
    saved = []

    def pack(v):
        saved.append(v)
        return v
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda v: v):
        y, c_t = bs.bilstm_scan_train(xp, w, h0, c0)
    storages = {v.untyped_storage().data_ptr() for v in saved}
    seq = n * t * nd * hidden
    if hidden == 128:
        assert xp.untyped_storage().data_ptr() not in storages
        assert sum(v.numel() for v in saved) == (
            4 * seq + seq + seq + w.numel() + h0.numel() + c0.numel())
    else:
        assert xp.untyped_storage().data_ptr() in storages
    (y.sum() + c_t.sum()).backward()
    assert xp.grad is not None and torch.isfinite(xp.grad).all()


# ---- the default Net's training step against the JAX package ---------------

def _host_batch(n=2, duration=0.1):
    ds = JDataset(dset="train", n_samples=n, duration=duration,
                  embed_dim=256, n_speakers=4)
    return jloader.collate([ds[i] for i in range(n)])


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype.kind == "f" else np.asarray(a), tree)


def test_default_net_training_step_matches_jax():
    """One `TSETask` loss and backward of the default `Net`'s geometry
    (F = 141, H = 128, no attention; 2 blocks, D = 8) with the loss and
    optimizer settings of configs/tsh_synthetic_5k.json on a 2 x 0.1 s
    synthetic batch, from the JAX package's PRNGKey(0) init: the loss
    and every gradient in float64 within 1e-4 of the JAX package's
    (of each tensor's peak)."""
    args = dict(TSE_5K, model_params=DEFAULT_SMALL)
    jargs = dict(TSE_5K, model_params={**DEFAULT_SMALL, "L": 2})
    host = _host_batch()
    jtask = jutils.import_attr("lookoncetohear_tpu.train.tasks.TSETask")(
        **jargs)
    params = jax.jit(lambda key: jtask.init_params(key, host))(
        jax.random.PRNGKey(0))
    ttask = tutils.import_attr("lookoncetohear_tpu.train.tasks.TSETask")(
        **args)
    assert ttask.model.tfgridnet.n_freqs == 141
    ttask.model.load_state_dict(params_from_jax(flatten_params(params)),
                                strict=True)
    jb = jtask.device_batch(host, train=True)
    tb = ttask.device_batch(host, train=True)
    with jax.enable_x64(True):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda *a: jtask.loss_and_metrics(*a)[0]))(
                _f64(params), _f64(jb), 0)
        jl, want = float(jl), flatten_params(jg)
    ttask.model.double()
    loss = ttask.loss_and_metrics(
        {k: torch.from_numpy(v) for k, v in _f64(tb).items()}, 0)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), jl, rtol=0,
                               atol=TOL * max(1.0, abs(jl)))
    got = params_to_jax({n: p.grad for n, p in
                         ttask.model.named_parameters()})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.abs(w).max() > 0, k
        _peak_close(got[k], w, what=k)


# ---- remat ------------------------------------------------------------------

@pytest.mark.parametrize("model", ["Net", "EmbedNet"])
def test_remat_gives_the_same_gradients(model):
    """Every block checkpointed (`remat`: the backward recomputes each
    block from its input) gives the gradients of keeping the
    activations, bit for bit, and the same output."""
    torch.manual_seed(0)
    if model == "Net":
        make = lambda remat: Net(  # noqa: E731
            embed_dim=32, stft_chunk_size=32, stft_pad_size=16, D=8, B=2,
            H=16, remat=remat, device="cpu")
        args = (torch.randn(2, 2, 32 * 6), torch.randn(2, 1, 32))
    else:
        def make(remat):
            m = EmbedNet(embed_dim=32, n_fft=32, stride=16, num_blocks=2,
                         device="cpu")
            m.net.trunk.remat = remat
            return m
        args = (torch.randn(2, 2, 16 * 12),)
    plain, remat = make(False), make(True)
    remat.load_state_dict(plain.state_dict())
    outs, grads = [], []
    for m in (plain, remat):
        y = m(*args)
        y.square().mean().backward()
        outs.append(y.detach())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert torch.equal(outs[0], outs[1])
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


# ---- the backward's tiles ------------------------------------------------

def test_backward_tiles_are_clusters_of_8():
    """The backward's tiles are R = 8 or 16 rows over clusters of 8 CTAs,
    and `choose_tile_h128` picks among them by waves x cost."""
    assert sorted(bs.h128_tiles("bwd")) == [(8, 8), (16, 8)]
    assert bs.h128_tiles("fwd") is bs.h128_tiles("b2") is bs.H128_TILE_COST
    held = {(8, 8): 15, (16, 8): 15}
    costs = bs.H128_BWD_TILE_COST
    for n, nd in ((4000, 2), (1128, 1), (64, 2), (9, 1)):
        tile = bs.choose_tile_h128(n, nd, held, costs)
        assert tile in costs
        assert bs.h128_waves(n, nd, tile, held) * costs[tile] == min(
            bs.h128_waves(n, nd, k, held) * costs[k] for k in costs)
