"""Training, PyTorch port vs the JAX package, on the CPU: the LSTM
scan's backward, the TSE and embedding tasks' loss, metrics and
gradients, one Adam + clip update and the plateau scheduler, npz
checkpoints both ways, the trainer CLI and `import_attr`.

Tolerances and why:
  * the training scan's layout ([N, T, D*4H] in, [N, T, D*H] out,
    direction 1 run backwards inside): its plain versions == the loops
    in the scan layout on flipped and permuted copies, 1e-6 (the same
    float32 arithmetic in the same order);
  * the scan backward: 1e-5, of each gradient's peak where that is
    over 1 (float32; the plain reverse loop, autograd and `jax.grad`
    differ only in summation order, which over 300 steps moves a
    gradient of ~6 by ~1 ulp per step), and
    `torch.autograd.gradcheck` in float64 at its defaults;
  * the tasks: the loss and metrics in float32, 1e-4 absolute; every
    gradient 1e-4 of its tensor's peak, taken in float64 by both
    frameworks. In float32 a few of the ~10^6 PReLU inputs of a stage
    lie within rounding of 0, where the two frameworks' summation
    orders may take different branches and move one gradient element
    by (1 - alpha) of its upstream gradient (seen: 2e-4 of its tensor's
    peak in EmbedNet's attention output projection); in float64 the
    gradients agree to ~1e-7 of their peaks. A peak under 1e-4 of the
    model's largest (the K LayerNorm's shift, whose true gradient is 0:
    softmax ignores a shift common to all keys) counts as that;
  * one optimizer update: 1e-6 (optax and torch.optim.Adam order the
    bias corrections differently);
  * a port-written checkpoint through the JAX forward: 1e-4 of the
    output's peak, as the model tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lookoncetohear_tpu import utils as jutils
from lookoncetohear_tpu.data import loader as jloader
from lookoncetohear_tpu.data.synthetic import SyntheticTSEDataset as JDataset
from lookoncetohear_tpu.ops import lstm as jlstm
from lookoncetohear_tpu.train.npz_ckpt import load_params
from lookoncetohear_tpu.train.schedule import \
    ReduceLROnPlateau as JPlateau
from lookoncetohear_tpu_torch import trainer as tcli
from lookoncetohear_tpu_torch import utils as tutils
from lookoncetohear_tpu_torch.ops import lstm as tlstm
from lookoncetohear_tpu_torch.ops.bilstm_scan import (
    BiLSTMScan, bilstm_scan_backward_reference, bilstm_scan_cuda,
    bilstm_scan_reference, bilstm_scan_train, bilstm_train_backward_reference,
    bilstm_train_reference, scan_weight_grad)
from lookoncetohear_tpu_torch.train import npz_ckpt
from lookoncetohear_tpu_torch.train.schedule import \
    ReduceLROnPlateau as TPlateau
from lookoncetohear_tpu_torch.train.trainer import (ADAM_BETAS, ADAM_EPS,
                                                    build_task,
                                                    clip_by_global_norm,
                                                    to_device)
from lookoncetohear_tpu_torch.weights import (flatten_params,
                                              params_from_jax,
                                              params_to_jax)
from test_trainer import TINY_EMBED, TINY_TSE


@pytest.fixture(autouse=True)
def _one_thread():
    """These tests run plain loops of small ops (the scan's reverse
    loop, float64 gradients). With several test workers on one host,
    each at torch's default thread count, such loops slow down ~10x
    from oversubscription; one thread keeps them near their solo time
    (~80 s for this file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---- the scan ----------------------------------------------------------------

def _scan_case(seed, t, nd, b, h, states=True):
    """Inputs of the training scan in the models' layouts: xp
    [b, t, nd*4h], w [nd, h, 4h], h0/c0 [nd, b, h], dy [b, t, nd*h],
    dc_T [nd, b, h]."""
    rng = np.random.default_rng(seed)
    xp = _np(rng, (b, t, nd * 4 * h), 0.5)
    w = _np(rng, (nd, h, 4 * h), 0.3)
    h0 = _np(rng, (nd, b, h), 0.5) if states else None
    c0 = _np(rng, (nd, b, h), 0.5) if states else None
    dys = _np(rng, (b, t, nd * h))
    dct = _np(rng, (nd, b, h))
    return xp, w, h0, c0, dys, dct


def _to_scan_np(a, nd):
    """[N, T, D*K] -> [T, D, N, K] with direction 1 time-flipped, in
    numpy: the loops' layout."""
    n, t, dk = a.shape
    a = a.reshape(n, t, nd, dk // nd).transpose(1, 2, 0, 3).copy()
    if nd == 2:
        a[:, 1] = a[::-1, 1]
    return a


@pytest.mark.parametrize("nd", [1, 2])
def test_train_layout_matches_scan_layout(nd):
    """The plain training forward and backward in the models' layouts
    == the scan-layout loops on the same inputs flipped and permuted in
    numpy, outputs mapped back the same way."""
    t, b, h = 7, 3, 8
    xp, w, h0, c0, dys, dct = _scan_case(40 + nd, t, nd, b, h)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    y, c_t, cs = bilstm_train_reference(tt(xp), tt(w), torch.float32,
                                        tt(h0), tt(c0), with_cs=True)
    ys, c_t2, css = bilstm_scan_reference(
        tt(_to_scan_np(xp, nd)), tt(w), torch.float32, tt(h0), tt(c0),
        with_cs=True)
    for got, want in ((y, ys), (cs, css)):
        np.testing.assert_allclose(_to_scan_np(got.numpy(), nd),
                                   want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), c_t2.numpy(), rtol=0, atol=1e-6)
    dxp, dh0, dc0 = bilstm_train_backward_reference(
        tt(xp), tt(w), tt(h0), tt(c0), y, cs, tt(dys), tt(dct))
    want = bilstm_scan_backward_reference(
        tt(_to_scan_np(xp, nd)), tt(w), tt(h0), tt(c0), ys, css,
        tt(_to_scan_np(dys, nd)), tt(dct))
    np.testing.assert_allclose(_to_scan_np(dxp.numpy(), nd),
                               want[0].numpy(), rtol=0, atol=1e-6)
    for got, w_ in zip((dh0, dc0), want[1:]):
        np.testing.assert_allclose(got.numpy(), w_.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("t,nd,states", [(13, 1, True), (13, 2, False),
                                         (29, 2, True)])
def test_scan_backward_reference_matches_autograd(t, nd, states):
    """The explicit reverse loop == autograd through the plain forward."""
    xp, w, h0, c0, dys, dct = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _scan_case(t + nd, t, nd, 3, 8, states))
    leaves = [a.clone().requires_grad_() if a is not None else None
              for a in (xp, w, h0, c0)]
    ys, c_t = bilstm_train_reference(*leaves[:2], torch.float32, *leaves[2:])
    grads = torch.autograd.grad(
        (ys * dys).sum() + (c_t * dct).sum(),
        [a for a in leaves if a is not None])
    ys, c_t, cs = bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                         with_cs=True)
    dxp, dh0, dc0 = bilstm_train_backward_reference(xp, w, h0, c0, ys, cs,
                                                    dys, dct)
    torch.testing.assert_close(dxp, grads[0], atol=1e-5, rtol=0)
    if states:
        torch.testing.assert_close(dh0, grads[2], atol=1e-5, rtol=0)
        torch.testing.assert_close(dc0, grads[3], atol=1e-5, rtol=0)


@pytest.mark.parametrize("nd,states", [(1, True), (1, False), (2, True),
                                       (2, False)])
def test_scan_weight_grad_matches_autograd(nd, states):
    """dW_hh from the plain backward's dxp and the forward's y ==
    autograd through the plain forward: direction 0's h_prev at time t
    is y at t-1 (h0 at t = 0), direction 1's y at t+1 (h0 at T-1)."""
    xp, w, h0, c0, dys, dct = map(
        lambda a: None if a is None else torch.from_numpy(a),
        _scan_case(60 + nd + 2 * states, 11, nd, 4, 8, states))
    wl = w.clone().requires_grad_()
    ys, c_t = bilstm_train_reference(xp, wl, torch.float32, h0, c0)
    (want,) = torch.autograd.grad((ys * dys).sum() + (c_t * dct).sum(), [wl])
    ys, _, cs = bilstm_train_reference(xp, w, torch.float32, h0, c0,
                                       with_cs=True)
    dxp = bilstm_train_backward_reference(xp, w, h0, c0, ys, cs, dys,
                                          dct)[0]
    got = scan_weight_grad(dxp, ys, h0, nd)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("nd", [1, 2])
def test_scan_function_gradcheck_float64(nd):
    rng = np.random.default_rng(nd)
    args = [torch.from_numpy(_np(rng, s, 0.5)).double().requires_grad_()
            for s in ((1, 4, nd * 12), (nd, 3, 12), (nd, 1, 3), (nd, 1, 3))]
    assert torch.autograd.gradcheck(BiLSTMScan.apply, args)
    assert torch.autograd.gradcheck(
        lambda a, b: BiLSTMScan.apply(a, b, None, None), args[:2])


def _lstm_params(rng, i, h):
    return [_np(rng, s, 0.3) for s in ((4 * h, i), (4 * h, h), (4 * h,),
                                       (4 * h,))]


def _grads_close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("t", [13, 300])
def test_bidir_scan_grad_matches_jax(t):
    """`lstm_apply_bidir` with a gradient (BiLSTMScan, the plain reverse
    loop on the CPU) == the JAX scan branch: y and both directions'
    final (h, c), and jax.grad of a loss over all of them; T = 300 also
    runs the JAX package's chunked (rematted) scan."""
    rng = np.random.default_rng(t)
    b, i, h = 3, 6, 8
    pf, pb = _lstm_params(rng, i, h), _lstm_params(rng, i, h)
    x = _np(rng, (b, t, i))
    gy = _np(rng, (b, t, 2 * h))
    gcf, gcb = _np(rng, (b, h)), _np(rng, (b, h))
    ghf, ghb = _np(rng, (b, h)), _np(rng, (b, h))

    def jfwd(x, pf, pb):
        return jlstm.lstm_apply_bidir(
            jlstm.LSTMParams(*pf), jlstm.LSTMParams(*pb), x, fused=False)

    def jloss(x, pf, pb):
        y, ((hf, hb), (cf, cb)) = jfwd(x, pf, pb)
        return jnp.sum(y * gy) + jnp.sum(cf * gcf) + jnp.sum(cb * gcb) \
            + jnp.sum(hf * ghf) + jnp.sum(hb * ghb)

    jargs = (jnp.asarray(x), [jnp.asarray(a) for a in pf],
             [jnp.asarray(a) for a in pb])
    jy, ((jhf, jhb), (jcf, jcb)) = jax.jit(jfwd)(*jargs)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jargs)
    tx = torch.from_numpy(x).requires_grad_()
    tpf = [torch.from_numpy(a).requires_grad_() for a in pf]
    tpb = [torch.from_numpy(a).requires_grad_() for a in pb]
    y, ((hf, hb), (cf, cb)) = tlstm.lstm_apply_bidir(
        tlstm.LSTMParams(*tpf), tlstm.LSTMParams(*tpb), tx)
    _grads_close([a.detach().numpy() for a in (y, hf, hb, cf, cb)],
                 [jy, jhf, jhb, jcf, jcb])
    loss = (y * torch.from_numpy(gy)).sum() \
        + (cf * torch.from_numpy(gcf)).sum() \
        + (cb * torch.from_numpy(gcb)).sum() \
        + (hf * torch.from_numpy(ghf)).sum() \
        + (hb * torch.from_numpy(ghb)).sum()
    tg = torch.autograd.grad(loss, [tx, *tpf, *tpb])
    _grads_close([g.numpy() for g in tg], [jg[0], *jg[1], *jg[2]])


@pytest.mark.parametrize("t", [1, 13, 300])
def test_one_direction_scan_grad_matches_jax(t):
    """`lstm_apply` from a carried (h0, c0) (the inter-time LSTM):
    outputs and the gradients of x, the weights and the state ==
    jax.grad of the JAX `lstm_apply`; T = 1 is the serving step."""
    rng = np.random.default_rng(100 + t)
    b, i, h = 3, 6, 8
    p = _lstm_params(rng, i, h)
    x, h0, c0 = _np(rng, (b, t, i)), _np(rng, (b, h), 0.5), \
        _np(rng, (b, h), 0.5)
    gy, gh, gc = _np(rng, (b, t, h)), _np(rng, (b, h)), _np(rng, (b, h))

    def jloss(x, p, h0, c0):
        y, (ht, ct) = jlstm.lstm_apply(jlstm.LSTMParams(*p), x, h0, c0)
        return jnp.sum(y * gy) + jnp.sum(ht * gh) + jnp.sum(ct * gc)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        jnp.asarray(x), [jnp.asarray(a) for a in p], jnp.asarray(h0),
        jnp.asarray(c0))
    tx, th0, tc0 = (torch.from_numpy(a).requires_grad_() for a in (x, h0, c0))
    tp = [torch.from_numpy(a).requires_grad_() for a in p]
    y, (ht, ct) = tlstm.lstm_apply(tlstm.LSTMParams(*tp), tx, th0, tc0)
    loss = (y * torch.from_numpy(gy)).sum() + (ht * torch.from_numpy(gh)) \
        .sum() + (ct * torch.from_numpy(gc)).sum()
    tg = torch.autograd.grad(loss, [tx, *tp, th0, tc0])
    _grads_close([g.numpy() for g in tg], [jg[0], *jg[1], jg[2], jg[3]])


def test_b2_wrapper_refuses_inputs_that_need_a_gradient():
    """B2 has no backward: handed a tensor that needs one, it raises
    (before anything else, so also here on the CPU) instead of
    returning outputs with the gradient silently cut."""
    xp = torch.zeros(3, 2, 1, 256, requires_grad=True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        bilstm_scan_cuda(xp, torch.zeros(2, 64, 256))
    with torch.no_grad():
        with pytest.raises(ValueError, match="GPU"):
            bilstm_scan_cuda(xp, torch.zeros(2, 64, 256))


def test_scan_train_on_cpu_keeps_the_dtype():
    xp = torch.zeros(2, 4, 32, dtype=torch.float64)
    ys, c_t = bilstm_scan_train(xp, torch.zeros(1, 8, 32,
                                                dtype=torch.float64))
    assert ys.dtype == c_t.dtype == torch.float64


# ---- the tasks -----------------------------------------------------------------

def _host_batch(n=2, duration=0.5, embed_dim=64, dset="train"):
    ds = JDataset(dset=dset, n_samples=n, duration=duration,
                  embed_dim=embed_dim, n_speakers=4)
    return jloader.collate([ds[i] for i in range(n)])


def _pair(cfg, host):
    """The JAX task with its PRNGKey(0) params, and the port's task
    with the same params."""
    jtask = jutils.import_attr(cfg["pl_module"])(**cfg["pl_module_args"])
    # one compiled init (eager, flax runs the model op by op)
    params = jax.jit(lambda key: jtask.init_params(key, host))(
        jax.random.PRNGKey(0))
    ttask = tutils.import_attr(cfg["pl_module"])(**cfg["pl_module_args"])
    ttask.model.load_state_dict(params_from_jax(flatten_params(params)),
                                strict=True)
    return jtask, params, ttask


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype.kind == "f" else np.asarray(a), tree)


def _hold_task(cfg, epochs=(0,), check_batch=None, host=None):
    """The port's task against the JAX task on one batch (`host`, by
    default a synthetic one): the same device batch, the loss and
    metrics in float32, every gradient in float64 (see the head of this
    file)."""
    host = _host_batch() if host is None else host
    jtask, params, ttask = _pair(cfg, host)
    jb = jtask.device_batch(host, train=True)
    tb = ttask.device_batch(host, train=True)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]))
    if check_batch:
        check_batch(tb, host)
    jfn = jax.jit(jtask.loss_and_metrics)
    for epoch in epochs:
        jl, jm = jfn(params, {k: jnp.asarray(v) for k, v in jb.items()},
                     epoch)
        with torch.no_grad():
            loss, metrics = ttask.loss_and_metrics(to_device(tb, "cpu"),
                                                   epoch)
        assert sorted(metrics) == sorted(jm)
        for k, v in metrics.items():
            np.testing.assert_allclose(v.item(), float(jm[k]), atol=1e-4,
                                       rtol=0, err_msg=k)
    with jax.enable_x64(True):
        vg = jax.jit(jax.grad(lambda *a: jtask.loss_and_metrics(*a)[0]))
        jgs = [flatten_params(vg(_f64(params), _f64(jb), e))
               for e in epochs]
    ttask.model.double()
    tb64 = {k: torch.from_numpy(v) for k, v in _f64(tb).items()}
    for epoch, want in zip(epochs, jgs):
        ttask.model.zero_grad(set_to_none=True)
        ttask.loss_and_metrics(tb64, epoch)[0].backward()
        got = params_to_jax({n: p.grad for n, p in
                             ttask.model.named_parameters()})
        assert sorted(got) == sorted(want)
        floor = 1e-4 * max(np.abs(w).max() for w in want.values())
        for k, w in want.items():
            np.testing.assert_allclose(
                got[k], w, rtol=0, err_msg=k,
                atol=1e-4 * max(np.abs(w).max(), floor))


def _tse(**extra):
    cfg = {"pl_module": "lookoncetohear_tpu.train.tasks.TSETask",
           "pl_module_args": json.loads(json.dumps(TINY_TSE))}
    cfg["pl_module_args"].update(extra)
    return cfg


def test_tse_task_loss_and_grads_match_jax():
    _hold_task(_tse())


def test_tse_task_dir_loss_and_aug_match_jax():
    """dir_loss (the direction head's cross-entropy and its metrics)
    and embed_aug_std (the same numpy noise stream on both sides)."""
    cfg = _tse(dir_loss=True, embed_aug_std=0.33)
    cfg["pl_module_args"]["model_params"]["dir_head"] = True

    def moved(tb, host):
        e = np.asarray(host[1]["embedding_gt"], np.float32)
        assert not np.allclose(tb["embedding_gt"], e)
        np.testing.assert_allclose(
            np.linalg.norm(tb["embedding_gt"], axis=-1),
            np.linalg.norm(e, axis=-1), rtol=1e-5)
    _hold_task(cfg, check_batch=moved)


def test_embed_task_loss_and_grads_match_jax():
    """Negatives off (epoch 0) and on (epoch >= neg_loss_start_epoch)."""
    cfg = {"pl_module": "lookoncetohear_tpu.train.tasks.EmbedTask",
           "pl_module_args": dict(TINY_EMBED)}
    _hold_task(cfg, epochs=(0, TINY_EMBED["neg_loss_start_epoch"]))


def test_seeded_build_is_repeatable():
    class H:
        pl_module = "lookoncetohear_tpu.train.tasks.EmbedTask"
        pl_module_args = dict(TINY_EMBED)
    a, b = build_task(H).model, build_task(H).model
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


# ---- optimizer and scheduler ---------------------------------------------------

@pytest.mark.parametrize("clip", [None, 0.5, 1e3])
def test_adam_and_clip_match_optax(clip):
    rng = np.random.default_rng(7)
    shapes = [(5, 3), (7,), (2, 2, 3)]
    params = [_np(rng, s) for s in shapes]
    grads = [_np(rng, s, 0.4) for s in shapes]
    lr = 5e-4
    txs = ([optax.clip_by_global_norm(clip)] if clip else []) + \
        [optax.adam(lr)]
    tx = optax.chain(*txs)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = torch.optim.Adam(tp, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    for step in range(2):
        g = [a * (step + 1) for a in grads]
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a.copy())
        if clip:
            clip_by_global_norm([p.grad for p in tp], clip)
        opt.step()
    for p, q in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                   atol=1e-6, rtol=0)


def test_plateau_matches_jax_step_for_step():
    kw = dict(lr=1.0, mode="min", patience=2, factor=0.5, min_lr=0.05,
              cooldown=1)
    j, t = JPlateau(**kw), TPlateau(**kw)
    metrics = [1.0, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8, 0.8, 0.7, 0.9,
               0.9, 0.9, 0.9, 0.9]
    for m in metrics:
        assert t.step(m) == j.step(m)
        assert t.state_dict() == j.state_dict()
    u = TPlateau(**kw)
    u.load_state_dict(t.state_dict())
    assert u.state_dict() == t.state_dict()
    with pytest.raises(ValueError):
        TPlateau(lr=1.0, mode="avg")


# ---- checkpoints -----------------------------------------------------------------

def test_port_npz_loads_in_the_jax_package(tmp_path):
    """A port-written checkpoint (params + full state) loads with the
    JAX package's `load_params`, and its JAX forward == the port's."""
    cfg = _tse()
    host = _host_batch(n=1)
    jtask, _, ttask = _pair(cfg, host)
    with torch.no_grad():
        for p in ttask.model.parameters():   # not the JAX init any more
            p.mul_(1.01).add_(0.001)
    path = str(tmp_path / "port.ckpt")
    npz_ckpt.save_npz(path, ttask.model, {"epoch": 3, "opt": {"a": {
        "exp_avg": np.ones(2, np.float32)}}})
    params = load_params(path)
    assert npz_ckpt.has_full_state(path)
    assert npz_ckpt.load_full_state(path)["epoch"] == 3
    mix, emb = host[0]["mixture"], host[1]["embedding_gt"]
    want = np.asarray(jtask.forward(params, jnp.asarray(mix),
                                    jnp.asarray(emb)))
    with torch.no_grad():
        got = ttask.model(torch.from_numpy(mix),
                          torch.from_numpy(np.asarray(emb))).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_params_to_jax_inverts_params_from_jax():
    for ckpt in ("checkpoints/tsh_r5_5k_best.npz",
                 "checkpoints/embed_r5_5k_best.npz"):
        with np.load(ckpt) as z:
            flat = {k[3:]: z[k] for k in z.files}
        back = params_to_jax(params_from_jax(flat))
        assert sorted(back) == sorted(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_dir_proj_maps_both_ways():
    from lookoncetohear_tpu_torch.models.net import Net
    net = Net(**{**TINY_TSE["model_params"], "dir_head": True},
              device="cpu")
    flat = params_to_jax(net.state_dict())
    assert flat["dir_proj/kernel"].shape == (16, 33)
    sd = params_from_jax(flat)
    assert torch.equal(sd["dir_proj.weight"], net.dir_proj.weight)


# ---- the CLI ---------------------------------------------------------------------

def _config(tmp_path, n_train=8, epochs=3):
    data = dict(n_samples=n_train, duration=0.5, embed_dim=64, n_speakers=4)
    cfg = dict(_tse(), epochs=epochs, batch_size=4, eval_batch_size=4,
               num_workers=0)
    for split in ("train", "val", "test"):
        cfg[f"{split}_dataset"] = \
            "lookoncetohear_tpu.data.synthetic.SyntheticTSEDataset"
        cfg[f"{split}_data_args"] = dict(data, dset=split,
                                         n_samples=n_train if split ==
                                         "train" else 6)
    path = tmp_path / "tse.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_trains_resumes_tests_and_refuses(tmp_path):
    cfg = _config(tmp_path)
    run = str(tmp_path / "run")
    base = ["--config", cfg, "--run_dir", run, "--device", "cpu"]
    tcli.run(base)
    recs = _metrics(run)
    assert [r["epoch"] for r in recs] == [0, 1, 2]
    assert recs[-1]["train/loss"] < recs[0]["train/loss"]
    assert all(np.isfinite(r["val/loss"]) for r in recs)
    for name in ("last.ckpt", "best.ckpt", "ckpt_meta.json"):
        assert os.path.exists(os.path.join(run, name)), name
    meta = json.load(open(os.path.join(run, "ckpt_meta.json")))
    # the best entry is the highest val/si_snr_i
    best = max(recs, key=lambda r: r["val/si_snr_i"])
    assert meta["best"][0]["epoch"] == best["epoch"]

    with pytest.raises(FileExistsError, match="--resume"):
        tcli.run(base)
    tcli.run(base + ["--resume", "--epochs", "4"])
    recs = _metrics(run)
    assert [r["epoch"] for r in recs] == [0, 1, 2, 3]
    assert recs[-1]["step"] == 8
    state = npz_ckpt.load_full_state(os.path.join(run, "last.ckpt"))
    assert int(state["epoch"]) == 3 and int(state["step"]) == 8

    tcli.run(base + ["--test"])
    test_rec = _metrics(run)[-1]
    assert set(test_rec) == {"test/loss", "test/snr_i", "test/si_snr_i"}

    with pytest.raises(ValueError, match="prerender"):
        tcli.run(base + ["--prerender", str(tmp_path / "cache")])


def test_import_attr_resolves_the_training_paths():
    from lookoncetohear_tpu_torch.train import schedule, tasks
    assert tutils.import_attr(
        "lookoncetohear_tpu.train.tasks.TSETask") is tasks.TSETask
    assert tutils.import_attr(
        "lookoncetohear_tpu_torch.train.tasks.EmbedTask") is tasks.EmbedTask
    assert tutils.import_attr(
        "lookoncetohear_tpu.train.schedule.ReduceLROnPlateau") \
        is schedule.ReduceLROnPlateau
    with pytest.raises(ValueError, match="MixLibriSpeechMotion"):
        tutils.import_attr(
            "lookoncetohear_tpu.data.dataset_variants.MixLibriSpeechMotion")


def test_inference_paths_build_no_graph(tmp_path, monkeypatch):
    """`Net.forward` and `EmbedNet.forward` are differentiable now; the
    engine's step and the eval CLI's batches still keep no graph."""
    import argparse

    from lookoncetohear_tpu_torch import ts_hear_test
    from lookoncetohear_tpu_torch.models.net import Net
    from lookoncetohear_tpu_torch.serve.engine import StreamingEngine
    from lookoncetohear_tpu_torch.weights import save_npz

    params = TINY_TSE["model_params"]
    net = Net(**params, device="cpu")
    eng = StreamingEngine(net, max_streams=2, device="cpu")
    eng.add_stream(0, np.ones(params["embed_dim"], np.float32))
    y = eng.step(np.zeros((2, 2, params["stft_chunk_size"]), np.float32))
    assert y.grad_fn is None and not y.requires_grad

    ckpt = str(tmp_path / "tse.npz")
    save_npz(ckpt, net)
    outs = []
    load = ts_hear_test.load_model

    def spy(*a, **k):
        m = load(*a, **k)
        m.register_forward_hook(lambda mod, i, o: outs.append(o))
        return m

    monkeypatch.setattr(ts_hear_test, "load_model", spy)
    rows = ts_hear_test.run(argparse.Namespace(
        config=_config(tmp_path), run_dir=str(tmp_path), enroll_config="",
        enroll_run_dir="", dset="test", sample=False, num_workers=0,
        ckpt=ckpt, device="cpu"))
    assert len(rows) == 6 and len(outs) == 2
    assert all(o.grad_fn is None and not o.requires_grad for o in outs)
